"""The port's own copy of the JAX package's ``kv/zookeeper.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

ZooKeeper-backed KVStore — the second production KV backend.

Parity target: the reference's kv-utils library is dual-backend — the
same serving core runs against etcd or ZooKeeper, selected per
deployment (reference pom.xml:305-320; ZookeeperSidecarModelMeshTest /
ZookeeperVModelsTest / ModelMeshZkFailTest exercise the ZK side). This
module is that second backend for this framework: ``ZookeeperKV``
speaks the real ZooKeeper client protocol (jute frames, kv/jute.py) and
maps ZK semantics onto the etcd-shaped KVStore contract (kv/store.py):

- revisions: ZK's zxid is a global transaction id, so czxid/mzxid map
  directly onto create_rev/mod_rev; per-key ``version`` is ZK's
  stat.version + 1 (ZK counts from 0, the contract from 1).
- keys: the contract's flat string keys become single znodes directly
  under "/" with "/" and "%" percent-escaped in the node name. Flat
  layout keeps ephemerals legal (ZK ephemerals cannot have children)
  and makes one child-watch on "/" cover every key.
- leases: ZK has no standalone leases — sessions are the lease
  mechanism. ``lease_grant(ttl)`` opens a dedicated ZK session with
  that negotiated timeout and NO automatic heartbeat; keys put under
  the lease are ephemerals of that session; ``lease_keepalive`` pings
  it; ``lease_revoke`` (or missed keepalives) expires it server-side,
  deleting the ephemerals — exactly the SessionNode liveness contract.
- transactions: compares+ops ride ONE ZK multi. version>0 compares are
  check ops; version==0 (must-not-exist) guards fold into the create of
  the same key, or stand alone as an atomic create+delete pair. The
  rarely-used on_failure branch (no caller passes one — serving code
  retries on False) is applied as a second multi after a guard failure
  and documented as not atomic with the guard evaluation.
- watches: ZK watches are one-shot and carry no payload, so the client
  keeps a mirror of the keyspace (child watch on "/" + data watch per
  node — the PathChildrenCache pattern), diffing on every trigger and
  re-arming. Coalescing applies: rapid put/put may deliver one PUT with
  the latest value, and replay below a lost window degrades to
  full-state PUTs — the same contract InMemoryKV documents for
  compacted watch starts (kv/memory.py).
"""

from __future__ import annotations

import logging
import queue
import socket
import threading
from typing import Iterable, Optional

from modelmesh_tpu_torch.kv import jute
from modelmesh_tpu_torch.kv.jute import (
    ERR_BAD_VERSION,
    ERR_NO_NODE,
    ERR_NODE_EXISTS,
    ERR_OK,
    EV_NODE_CHILDREN_CHANGED,
    EV_NODE_CREATED,
    EV_NODE_DATA_CHANGED,
    EV_NODE_DELETED,
    FLAG_EPHEMERAL,
    OP_CHECK,
    OP_CLOSE,
    OP_CREATE2,
    OP_DELETE,
    OP_GET_CHILDREN2,
    OP_GET_DATA,
    OP_MULTI,
    OP_PING,
    OP_SET_DATA,
    XID_PING,
    XID_WATCH_EVENT,
    MultiHeader,
    Reader,
    Stat,
    Writer,
    write_acl_vector,
)
from modelmesh_tpu_torch.kv.store import (
    CasFailed,
    Compare,
    EventType,
    KeyValue,
    KVStore,
    Op,
    WatchCallback,
    WatchEvent,
    WatchHandle,
)
from modelmesh_tpu_torch.utils.lockdebug import mm_lock, mm_rlock

log = logging.getLogger("modelmesh_tpu_torch.kv.zookeeper")


class ZkSessionLost(ConnectionError):
    """The ZK session/connection died (server gone or session expired)."""


class _ZkReplyError(Exception):
    def __init__(self, code: int):
        super().__init__(f"zk reply error {code}")
        self.code = code


def _esc(key: str) -> str:
    return "/" + key.replace("%", "%25").replace("/", "%2F")


def _unesc(name: str) -> str:
    return name.replace("%2F", "/").replace("%25", "%")


def _stat_to_kv(key: str, value: bytes, st: Stat) -> KeyValue:
    return KeyValue(
        key=key,
        value=value,
        create_rev=st.czxid,
        mod_rev=st.mzxid,
        version=st.version + 1,
        lease=st.ephemeral_owner,
    )


class _ZkSession:
    """One ZK protocol session: socket, xid-dispatched request/reply,
    watch-event queue, optional heartbeat."""

    def __init__(self, endpoint: str, timeout_ms: int, auto_ping: bool,
                 connect_timeout_s: float = 5.0, ssl_ctx=None,
                 ssl_hostname: Optional[str] = None):
        host, _, port = endpoint.rpartition(":")
        host = host or "127.0.0.1"
        self._sock = socket.create_connection(
            (host, int(port)), timeout=connect_timeout_s
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if ssl_ctx is not None:
            # A real ensemble's secureClientPort: TLS-wrap the raw socket
            # before the jute handshake. The context is built ONCE by the
            # owning ZookeeperKV (an mTLS context stages the private key
            # through temp files — not something to repeat per reconnect
            # or per lease session).
            try:
                self._sock = ssl_ctx.wrap_socket(
                    self._sock, server_hostname=ssl_hostname or host
                )
            except (OSError, ValueError) as e:
                self._sock.close()
                raise ZkSessionLost(f"zk TLS handshake failed: {e}") from e
        self._send_lock = mm_lock("_ZkSession._send_lock")
        self._xid = 0  #: guarded-by: _xid_lock
        self._xid_lock = mm_lock("_ZkSession._xid_lock")
        #: guarded-by: _pending_lock
        self._pending: dict[int, list] = {}   # xid -> [event, reply|None]
        self._pending_lock = mm_lock("_ZkSession._pending_lock")
        self._ping_waiters: list[threading.Event] = []  #: guarded-by: _pending_lock
        self.dead = threading.Event()
        self.watch_events: "queue.Queue[jute.WatcherEvent]" = queue.Queue()
        self.last_zxid = 0

        # The connect timeout covers the HANDSHAKE too: an accepting-but-
        # wedged server must not hang the constructor (and with it
        # _reconnect, which holds the session swap lock).
        try:
            self._sock.sendall(jute.frame(
                jute.ConnectRequest(timeout_ms=timeout_ms).encode()
            ))
            resp = jute.ConnectResponse.decode(jute.read_frame(self._sock))
        except (OSError, jute.JuteError) as e:
            self._sock.close()
            raise ZkSessionLost(f"zk handshake failed: {e}") from e
        self._sock.settimeout(None)
        if resp.session_id == 0:
            raise ZkSessionLost("zk server rejected the session")
        self.session_id = resp.session_id
        self.timeout_ms = resp.timeout_ms

        self._reader = threading.Thread(
            target=self._read_loop, name="zk-reader", daemon=True
        )
        self._reader.start()
        self._pinger: Optional[threading.Thread] = None
        if auto_ping:
            self._pinger = threading.Thread(
                target=self._ping_loop, name="zk-pinger", daemon=True
            )
            self._pinger.start()

    # -- wire --------------------------------------------------------------

    def _read_loop(self) -> None:
        try:
            while True:
                frame = jute.read_frame(self._sock)
                r = Reader(frame)
                xid = r.int32()
                zxid = r.int64()
                err = r.int32()
                if zxid > 0:
                    self.last_zxid = zxid
                if xid == XID_WATCH_EVENT:
                    self.watch_events.put(jute.WatcherEvent.read(r))
                    continue
                if xid == XID_PING:
                    for ev in self._drain_ping_waiters():
                        ev.set()
                    continue
                with self._pending_lock:
                    slot = self._pending.pop(xid, None)
                if slot is not None:
                    slot[1] = (err, r)
                    slot[0].set()
        except (ConnectionError, OSError, jute.JuteError):
            pass
        finally:
            self._fail_all()

    def _drain_ping_waiters(self) -> list[threading.Event]:
        with self._pending_lock:
            waiters, self._ping_waiters = self._ping_waiters, []
        return waiters

    def _fail_all(self) -> None:
        self.dead.set()
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
            waiters, self._ping_waiters = self._ping_waiters, []
        for slot in pending:
            slot[0].set()
        for ev in waiters:
            ev.set()
        # Wake the watch dispatcher so it can deliver a session-lost signal.
        self.watch_events.put(
            jute.WatcherEvent(0, jute.STATE_EXPIRED, "")
        )

    def _ping_loop(self) -> None:
        interval = max(0.05, self.timeout_ms / 3000.0)
        while not self.dead.wait(interval):
            try:
                self.ping(timeout=self.timeout_ms / 1000.0)
            except ZkSessionLost:
                return

    def request(self, op: int, payload: bytes,
                timeout: float = 30.0) -> tuple[int, Reader]:
        """Send one op; block for its reply. Raises ZkSessionLost on a
        dead session, _ZkReplyError on a non-OK reply code."""
        if self.dead.is_set():
            raise ZkSessionLost("zk session is down")
        with self._xid_lock:
            self._xid += 1
            xid = self._xid
        slot: list = [threading.Event(), None]
        with self._pending_lock:
            self._pending[xid] = slot
        w = Writer()
        w.int32(xid).int32(op).raw(payload)
        try:
            with self._send_lock:
                self._sock.sendall(jute.frame(w.getvalue()))
        except OSError as e:
            self._fail_all()
            raise ZkSessionLost(str(e)) from e
        if not slot[0].wait(timeout) or slot[1] is None:
            with self._pending_lock:
                self._pending.pop(xid, None)  # don't leak the slot
            if self.dead.is_set():
                raise ZkSessionLost("zk session died awaiting reply")
            raise TimeoutError(f"zk op {op} timed out")
        err, reader = slot[1]
        if err != ERR_OK:
            raise _ZkReplyError(err)
        return err, reader

    def ping(self, timeout: float = 5.0) -> None:
        if self.dead.is_set():
            raise ZkSessionLost("zk session is down")
        ev = threading.Event()
        with self._pending_lock:
            self._ping_waiters.append(ev)
        w = Writer()
        w.int32(XID_PING).int32(OP_PING)
        try:
            with self._send_lock:
                self._sock.sendall(jute.frame(w.getvalue()))
        except OSError as e:
            self._fail_all()
            raise ZkSessionLost(str(e)) from e
        if not ev.wait(timeout) or self.dead.is_set():
            if self.dead.is_set():
                raise ZkSessionLost("zk session died awaiting ping")
            raise TimeoutError("zk ping timed out")

    def close(self, clean: bool = True) -> None:
        if clean and not self.dead.is_set():
            try:
                self.request(OP_CLOSE, b"", timeout=2.0)
            except (ZkSessionLost, TimeoutError, _ZkReplyError):
                pass
        self.dead.set()
        try:
            self._sock.close()
        except OSError:
            pass


class _PrefixWatch(WatchHandle):
    def __init__(self, owner: "ZookeeperKV", prefix: str,
                 callback: WatchCallback):
        self._owner = owner
        self.prefix = prefix
        self.callback = callback
        self.cancelled = threading.Event()

    def cancel(self) -> None:
        self.cancelled.set()
        self._owner._remove_watch(self)


class ZookeeperKV(KVStore):
    """KVStore over a ZooKeeper ensemble endpoint ("host:port")."""

    def __init__(self, endpoint: str, session_timeout_ms: int = 10_000,
                 tls=None):
        self._endpoint = endpoint
        self._session_timeout_ms = session_timeout_ms
        host = endpoint.rpartition(":")[0] or "127.0.0.1"
        self._ssl_ctx = tls.ssl_client_context() if tls is not None else None
        self._ssl_hostname = (
            tls.server_hostname(host) if tls is not None else None
        )
        # Rebinds are guarded (_reconnect swap); lock-free READS are the
        # design — data-plane threads grab a reference and race the swap
        # benignly (a dead session surfaces as ZkSessionLost and retries
        # through _reconnect).
        #: guarded-by: _session_lock [rebind]
        self._session = _ZkSession(endpoint, session_timeout_ms,
                                   auto_ping=True, ssl_ctx=self._ssl_ctx,
                                   ssl_hostname=self._ssl_hostname)
        self._closed = threading.Event()
        # Guards the session swap ONLY. Lock order: never hold
        # _session_lock while taking _watch_lock (the dispatcher holds
        # _watch_lock and may need _session_lock to reconnect).
        self._session_lock = mm_lock("ZookeeperKV._session_lock")
        # Serializes RECONNECTORS (held across the replacement connect):
        # N threads hitting ZkSessionLost on one blip cost one handshake
        # + one server-side session, not N. Probing/swapping threads
        # still only ever touch _session_lock, so nothing convoys on a
        # wedged connect except other reconnectors — who would otherwise
        # be connecting themselves.
        self._reconnect_lock = mm_lock("ZookeeperKV._reconnect_lock")
        self._leases: dict[int, _ZkSession] = {}  #: guarded-by: _leases_lock
        self._leases_lock = mm_lock("ZookeeperKV._leases_lock")
        self._watches: list[_PrefixWatch] = []  #: guarded-by: _watch_lock
        # RLock: _sync_mirror_locked emits diffs via _deliver while the
        # mirror lock is held (same thread).
        self._watch_lock = mm_rlock("ZookeeperKV._watch_lock")
        self._mirror: dict[str, KeyValue] = {}  #: guarded-by: _watch_lock
        self._mirror_ready = False  #: guarded-by: _watch_lock
        # The session whose one-shot watches currently back the mirror;
        # the dispatcher resyncs whenever the live session differs (a
        # data-plane _req may swap sessions without arming any watches).
        #: guarded-by: _watch_lock
        self._mirror_session: Optional[_ZkSession] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()

    # -- plumbing ----------------------------------------------------------

    def _reconnect(self, failed: _ZkSession) -> _ZkSession:
        """Replace a dead main session with a fresh one (the ZK client's
        expired-session re-establishment). The replacement connect +
        handshake runs OUTSIDE _session_lock: a wedged endpoint must not
        pin the swap lock for the whole connect timeout (every other
        thread probing the session would convoy behind it) — that lock
        guards only the probe and the swap. Reconnectors serialize on
        _reconnect_lock instead, so a blip that kicks N threads into
        _reconnect performs ONE handshake: the winner connects and
        swaps, the waiters re-probe and adopt its session. Watch state
        heals separately: the caller (or dispatcher) runs a mirror
        resync AFTER the swap — never while holding _session_lock."""
        if self._closed.is_set():
            raise ZkSessionLost("store is closed")
        with self._reconnect_lock:
            with self._session_lock:
                cur = self._session
                if cur is not failed and not cur.dead.is_set():
                    return cur  # an earlier reconnector already swapped
            fresh = _ZkSession(  # analysis-ok: blocking-under-lock — _reconnect_lock exists to serialize exactly this connect; only reconnectors (who would otherwise connect themselves) ever wait on it
                self._endpoint, self._session_timeout_ms, auto_ping=True,
                ssl_ctx=self._ssl_ctx, ssl_hostname=self._ssl_hostname,
            )
            with self._session_lock:
                # Re-check closed at swap time: the connect window is the
                # full handshake timeout, and a close() landing inside it
                # has already closed self._session — installing fresh
                # would leak a live socket + pinger thread past close.
                if self._closed.is_set():
                    winner = None
                else:
                    self._session = fresh
                    winner = fresh
        if winner is None:
            fresh.close(clean=True)
            raise ZkSessionLost("store is closed")
        log.info("zk session re-established (%s)", hex(fresh.session_id))
        return fresh

    def _req(self, op: int, payload: bytes,
             timeout: float = 30.0) -> tuple[int, Reader]:
        """One main-session request with a single reconnect retry.

        Retry caveat (same as any ZK/etcd client): an op applied just
        before the connection died may be applied twice; CAS/txn callers
        are protected by their compares, plain put/delete are idempotent
        at the value level (an extra version bump at worst)."""
        s = self._session
        try:
            return s.request(op, payload, timeout)
        except ZkSessionLost:
            s = self._reconnect(failed=s)
            return s.request(op, payload, timeout)

    def _get_data(self, key: str, watch: bool) -> Optional[KeyValue]:
        """getData (optionally arming a one-shot data watch); None on
        NoNode."""
        try:
            w = Writer()
            w.string(_esc(key)).boolean(watch)
            _, r = self._req(OP_GET_DATA, w.getvalue())
        except _ZkReplyError as e:
            if e.code == ERR_NO_NODE:
                return None
            raise
        value = r.buffer()
        return _stat_to_kv(key, value, Stat.read(r))

    def _list_keys(self, watch: bool = False) -> list[str]:
        w = Writer()
        w.string("/").boolean(watch)
        _, r = self._req(OP_GET_CHILDREN2, w.getvalue())
        n = r.int32()
        return sorted(_unesc(r.string()) for _ in range(n))

    # -- reads -------------------------------------------------------------

    def get(self, key: str) -> Optional[KeyValue]:
        return self._get_data(key, watch=False)

    def range(self, prefix: str) -> list[KeyValue]:
        out = []
        for key in self._list_keys():
            if not key.startswith(prefix):
                continue
            kv = self._get_data(key, watch=False)
            if kv is not None:   # deleted between list and read
                out.append(kv)
        return out

    def range_from(self, prefix: str, start_key: str,
                   limit: int) -> list[KeyValue]:
        # The child listing is names-only; values are fetched just for the
        # requested page, keeping range_paged's working set bounded even
        # though ZK has no server-side range op.
        keys = [
            k for k in self._list_keys()
            if k.startswith(prefix) and k >= start_key
        ]
        out = []
        for key in keys:
            kv = self._get_data(key, watch=False)
            if kv is not None:
                out.append(kv)
            if len(out) >= limit:
                break
        return out

    # -- writes ------------------------------------------------------------

    def _create(self, key: str, value: bytes,
                session: Optional[_ZkSession],
                ephemeral: bool) -> KeyValue:
        w = Writer()
        w.string(_esc(key)).buffer(value)
        write_acl_vector(w)
        w.int32(FLAG_EPHEMERAL if ephemeral else 0)
        if session is None:
            _, r = self._req(OP_CREATE2, w.getvalue())
        else:
            _, r = session.request(OP_CREATE2, w.getvalue())
        r.string()  # actual path
        return _stat_to_kv(key, value, Stat.read(r))

    def _recreate_multi(self, key: str, value: bytes, flags: int,
                        session: Optional[_ZkSession],
                        delete_version: int = -1) -> Optional[KeyValue]:
        """Atomic delete + create of one key (ZK cannot change a node's
        ephemerality or owner in place). None = the multi lost a race;
        caller retries. ``session`` None targets the main session.
        ``delete_version`` guards the delete (ZK wire version, -1 =
        unconditional) — callers repairing a specific committed write
        pass the version they observed so they can never clobber a
        LATER committed write."""
        w = Writer()
        MultiHeader(OP_DELETE, False, -1).write(w)
        w.string(_esc(key)).int32(delete_version)
        MultiHeader(OP_CREATE2, False, -1).write(w)
        w.string(_esc(key)).buffer(value)
        write_acl_vector(w)
        w.int32(flags)
        MultiHeader(-1, True, -1).write(w)
        if session is None:
            _, r = self._req(OP_MULTI, w.getvalue())
        else:
            _, r = session.request(OP_MULTI, w.getvalue())
        ok, payloads = self._read_multi(r)
        if not ok:
            return None
        st_kv = payloads[-1]
        return KeyValue(
            key=key, value=value, create_rev=st_kv.create_rev,
            mod_rev=st_kv.mod_rev, version=st_kv.version, lease=st_kv.lease,
        )

    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        self.check_value_size(value)
        if lease:
            return self._put_ephemeral(key, value, lease)
        for _ in range(8):
            try:
                w = Writer()
                w.string(_esc(key)).buffer(value).int32(-1)
                _, r = self._req(OP_SET_DATA, w.getvalue())
                st = Stat.read(r)
                if st.ephemeral_owner:
                    # Unleased put on a leased key DETACHES the lease
                    # (etcd/InMemoryKV contract): recreate persistent.
                    # Unavoidable ZK deviation: watchers see DELETE+PUT
                    # and the version counter restarts.
                    try:
                        out = self._recreate_multi(key, value, 0, None)
                    except _ZkReplyError as e:
                        # NO_NODE / NODE_EXISTS / BAD_VERSION from the
                        # multi = a concurrent writer won the race between
                        # our probe and the delete+create (e.g. the owner
                        # expired and someone recreated) — retry, don't
                        # surface a transient as a hard failure.
                        if e.code not in (ERR_NO_NODE, ERR_NODE_EXISTS,
                                          ERR_BAD_VERSION):
                            raise
                        continue
                    if out is None:
                        continue  # owner expired mid-detach; retry
                    return out
                return _stat_to_kv(key, value, st)
            except _ZkReplyError as e:
                if e.code != ERR_NO_NODE:
                    raise
            try:
                return self._create(key, value, None, ephemeral=False)
            except _ZkReplyError as e:
                if e.code != ERR_NODE_EXISTS:
                    raise
        raise RuntimeError(f"put({key!r}) lost create/delete races 8 times")

    def _put_ephemeral(self, key: str, value: bytes, lease: int) -> KeyValue:
        with self._leases_lock:
            session = self._leases.get(lease)
        if session is None or session.dead.is_set():
            raise ZkSessionLost(f"lease {lease} is not an open zk session")
        for _ in range(8):
            try:
                return self._create(key, value, session, ephemeral=True)
            except _ZkReplyError as e:
                if e.code != ERR_NODE_EXISTS:
                    raise
            existing = self.get(key)
            if existing is None:
                continue  # deleted under us (owner expiry); create again
            if existing.lease == session.session_id:
                # Same-lease republish (SessionNode.update's heartbeat
                # path): a plain setData — a delete+create here would
                # emit a spurious cluster-wide DELETE and reset the
                # version counter, tripping watch-fed liveness views.
                try:
                    w = Writer()
                    w.string(_esc(key)).buffer(value).int32(-1)
                    _, r = session.request(OP_SET_DATA, w.getvalue())
                    return _stat_to_kv(key, value, Stat.read(r))
                except _ZkReplyError as e:
                    if e.code != ERR_NO_NODE:
                        raise
                    continue
            # Rebind: delete + ephemeral-create atomically on the lease
            # session (etcd put-with-lease re-binds ownership; ZK fixes
            # the owner at creation, so the node is recreated under the
            # new session). None = lost a race (e.g. the old owner
            # expired between probe and delete): retry from the create.
            # A NO_NODE / NODE_EXISTS / BAD_VERSION reply is the same
            # lost race surfacing as an error instead of a failed multi.
            try:
                out = self._recreate_multi(key, value, FLAG_EPHEMERAL, session)
            except _ZkReplyError as e:
                if e.code not in (ERR_NO_NODE, ERR_NODE_EXISTS,
                                  ERR_BAD_VERSION):
                    raise
                continue
            if out is not None:
                return out
        raise RuntimeError(
            f"ephemeral put({key!r}) lost rebind races 8 times"
        )

    def delete(self, key: str) -> bool:
        try:
            w = Writer()
            w.string(_esc(key)).int32(-1)
            self._req(OP_DELETE, w.getvalue())
            return True
        except _ZkReplyError as e:
            if e.code == ERR_NO_NODE:
                return False
            raise

    def put_if_version(
        self, key: str, value: bytes, expected_version: int, lease: int = 0
    ) -> KeyValue:
        """CAS put as ONE native conditional setData RPC.

        The generic txn-based implementation costs three round trips per
        attempt (shape probe, multi, trailing get). On the shared
        xid-serialized socket that made contended CAS loops *unfair*: a
        loser's next attempt always queued its extra RPCs behind the
        winner's next commit, so the same thread won every round and the
        others livelocked until their retry budget ran out (the
        update_or_create_retry_loop failure). ZK's setData takes the
        expected version natively, so the conditional write — and the
        resulting Stat — is a single round trip and every contender
        re-enters the queue on equal footing.
        """
        if lease or expected_version <= 0:
            # Creation (expected 0) and lease-binding writes keep the txn
            # path: both need the create/ownership shape logic.
            return super().put_if_version(key, value, expected_version, lease)
        self.check_value_size(value)
        try:
            w = Writer()
            w.string(_esc(key)).buffer(value).int32(expected_version - 1)
            _, r = self._req(OP_SET_DATA, w.getvalue())
        except _ZkReplyError as e:
            if e.code in (ERR_BAD_VERSION, ERR_NO_NODE):
                raise CasFailed(key) from None
            raise
        st = Stat.read(r)
        if st.ephemeral_owner:
            # The guarded write landed on a leased key: an unleased put
            # DETACHES the lease (etcd/InMemoryKV contract) — recreate
            # persistent, same as put()'s detach path. The value is ours
            # (the CAS committed), only the ownership flag is repaired —
            # so the delete is GUARDED on the ZK version our CAS
            # produced: an unconditional delete+create could clobber a
            # LATER committed write (a lost update on the one method
            # whose whole contract is version-guarded writes).
            zk_ver = st.version
            for _ in range(8):
                try:
                    out = self._recreate_multi(
                        key, value, 0, None, delete_version=zk_ver
                    )
                except _ZkReplyError as e:
                    if e.code not in (ERR_NO_NODE, ERR_NODE_EXISTS,
                                      ERR_BAD_VERSION):
                        raise
                    out = None
                if out is not None:
                    return out
                # The guarded multi failed; re-read to find out why (the
                # in-repo server reports multi op errors in the body, a
                # real ensemble in the reply header — both land here).
                cur = self.get(key)
                if cur is None:
                    # The owner expired and the ephemeral died with it
                    # before the detach landed. Our CAS committed —
                    # repair its persistence, guarded on absence.
                    try:
                        return self._create(key, value, None,
                                            ephemeral=False)
                    except _ZkReplyError as e:
                        if e.code != ERR_NODE_EXISTS:
                            raise
                        continue  # a concurrent creator won; re-examine
                if cur.value == value and not cur.lease:
                    return cur  # another detacher repaired the ownership
                if cur.value == value and cur.lease:
                    # Still ours, still leased: the multi tripped on a
                    # transient (e.g. a same-value republish bumped the
                    # version) — re-guard on what is there NOW.
                    zk_ver = cur.version - 1
                    continue
                # A NEWER write superseded our committed CAS before the
                # detach landed: the current state is that writer's to
                # shape. Our write DID commit — report it as observed.
                return _stat_to_kv(key, value, st)
            raise RuntimeError(
                f"put_if_version({key!r}) lost detach races 8 times"
            )
        return _stat_to_kv(key, value, st)

    def delete_if_version(self, key: str, expected_version: int) -> bool:
        if expected_version <= 0:
            return super().delete_if_version(key, expected_version)
        try:
            w = Writer()
            w.string(_esc(key)).int32(expected_version - 1)
            self._req(OP_DELETE, w.getvalue())
            return True
        except _ZkReplyError as e:
            if e.code in (ERR_BAD_VERSION, ERR_NO_NODE):
                return False
            raise

    # -- transactions ------------------------------------------------------

    def _read_multi(self, r: Reader) -> tuple[bool, list[KeyValue]]:
        """Parse a MultiResponse into (ok, created/updated KeyValues)."""
        ok = True
        out: list[KeyValue] = []
        while True:
            h = MultiHeader.read(r)
            if h.done:
                break
            if h.type == jute.OP_ERROR:
                r.int32()
                ok = False
            elif h.type == OP_CREATE2:
                path = r.string()
                st = Stat.read(r)
                out.append(_stat_to_kv(_unesc(path[1:]), b"", st))
            elif h.type == OP_SET_DATA:
                st = Stat.read(r)
                out.append(_stat_to_kv("", b"", st))
            # delete/check carry no body
        return ok, out

    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        compares = list(compares)
        on_success = list(on_success)
        on_failure = list(on_failure)
        for op in on_success:
            if op.value is not None:
                self.check_value_size(op.value)

        for _attempt in range(8):
            outcome = self._try_txn(compares, on_success)
            if outcome is not None:
                ok, results = outcome
                if not ok and on_failure:
                    # Documented deviation: the else-branch runs as its own
                    # atomic multi AFTER the guard evaluation (ZK multi has
                    # no else arm). No serving caller passes one.
                    return ok, self._apply_ops(on_failure)
                return ok, results
        raise RuntimeError("zk txn lost existence races 8 times")

    def _apply_ops(self, ops: list[Op]) -> list[KeyValue]:
        """Apply ops unconditionally as one atomic multi (the txn
        else-branch; also matches InMemoryKV, which returns the failure
        branch's written KeyValues)."""
        for _ in range(8):
            outcome = self._try_txn([], ops)
            if outcome is not None:
                ok, results = outcome
                if not ok:
                    # No guards to fail: a rejected multi is a server-level
                    # error, not a lost race.
                    raise RuntimeError("zk failure-branch multi rejected")
                return results
        raise RuntimeError("zk failure-branch ops lost races 8 times")

    def _try_txn(
        self, compares: list[Compare], ops: list[Op]
    ) -> Optional[tuple[bool, list[KeyValue]]]:
        """One multi attempt. None = op-shape race (create/setData choice
        went stale between probe and multi) — caller re-probes."""
        must_absent = {c.key for c in compares if c.version == 0}
        creates_for: set[str] = set()
        w = Writer()

        for c in compares:
            if c.version == 0:
                continue  # existence+version ride a check op
            w_h = MultiHeader(OP_CHECK, False, -1)
            w_h.write(w)
            w.string(_esc(c.key)).int32(c.version - 1)

        # Probe current state for every op key (shape + lease ownership;
        # compares guard correctness, the probe only picks op shapes —
        # a stale probe fails the multi with NoNode/NodeExists -> retry).
        probed: dict[str, Optional[KeyValue]] = {}
        for op in ops:
            if op.key in must_absent:
                continue
            probed[op.key] = self.get(op.key)

        for op in ops:
            cur = probed.get(op.key)
            if op.value is None:
                if op.key in must_absent or cur is None:
                    # etcd deletes of absent keys are a no-op; ZK would
                    # fail the multi with NoNode, so the op is elided (the
                    # compares still guard the decision, and a race shows
                    # up as NoNode -> retry).
                    continue
                MultiHeader(OP_DELETE, False, -1).write(w)
                w.string(_esc(op.key)).int32(-1)
            elif op.key in must_absent or cur is None:
                MultiHeader(OP_CREATE2, False, -1).write(w)
                w.string(_esc(op.key)).buffer(op.value)
                write_acl_vector(w)
                w.int32(FLAG_EPHEMERAL if op.lease else 0)
                creates_for.add(op.key)
            elif cur.lease != op.lease:
                # Ownership CHANGES on an EXISTING key (bind to a lease,
                # rebind to another, or DETACH on an unleased put — the
                # etcd/InMemoryKV txn semantics) cannot ride a setData:
                # ZK fixes ephemerality at creation, so the pair deletes
                # and recreates with the target flags. A SAME-lease
                # republish falls through to setData below — no spurious
                # DELETE/version reset for watch-fed liveness views.
                # Residual TOCTOU: an ownership change between probe and
                # multi keeps the setData shape only when both sides
                # agree, where it is also correct.
                MultiHeader(OP_DELETE, False, -1).write(w)
                w.string(_esc(op.key)).int32(-1)
                MultiHeader(OP_CREATE2, False, -1).write(w)
                w.string(_esc(op.key)).buffer(op.value)
                write_acl_vector(w)
                w.int32(FLAG_EPHEMERAL if op.lease else 0)
            else:
                MultiHeader(OP_SET_DATA, False, -1).write(w)
                w.string(_esc(op.key)).buffer(op.value).int32(-1)

        # A must-absent guard with no matching create stands alone as an
        # atomic create+delete pair (create fails NODEEXISTS if present).
        for key in sorted(must_absent - creates_for):
            MultiHeader(OP_CREATE2, False, -1).write(w)
            w.string(_esc(key)).buffer(b"")
            write_acl_vector(w)
            w.int32(0)
            MultiHeader(OP_DELETE, False, -1).write(w)
            w.string(_esc(key)).int32(-1)

        # An all-elided multi (only the done header) is legal: ok, [].
        MultiHeader(-1, True, -1).write(w)
        session, lease_ids = self._txn_session(ops)
        try:
            if session is None:
                _, r = self._req(OP_MULTI, w.getvalue())
            else:
                _, r = session.request(OP_MULTI, w.getvalue())
        except _ZkReplyError as e:
            # A real ensemble reports a failed multi in the ReplyHeader
            # err (the in-repo server replies OK with error results in
            # the body); both shapes must go through classification, or
            # a stale-probe race gets misreported as a guard failure.
            if e.code not in (ERR_NO_NODE, ERR_NODE_EXISTS,
                              ERR_BAD_VERSION):
                raise
            return self._classify_failure(compares)
        ok, raw_results = self._read_multi(r)
        if ok:
            results = self._fill_txn_results(ops, raw_results)
            return True, results
        # Failed multi: find WHY. Guard failures (check BadVersion/NoNode,
        # guard-create NodeExists) mean the compare genuinely failed; a
        # mutation op failing NoNode/NodeExists means the probe went stale.
        return self._classify_failure(compares)

    def _txn_session(self, ops: list[Op]) -> tuple[_ZkSession, set[int]]:
        lease_ids = {op.lease for op in ops if op.lease}
        if not lease_ids:
            return None, set()
        if len(lease_ids) > 1:
            raise ValueError(
                "zk txn cannot create ephemerals under two leases at once"
            )
        with self._leases_lock:
            session = self._leases.get(next(iter(lease_ids)))
        if session is None or session.dead.is_set():
            raise ZkSessionLost("txn lease session is not open")
        return session, lease_ids

    def _fill_txn_results(
        self, ops: list[Op], raw: list[KeyValue]
    ) -> list[KeyValue]:
        """Zip multi-returned stats (in op order) back onto put Ops."""
        out = []
        it = iter(raw)
        for op in ops:
            if op.value is None:
                continue
            try:
                st_kv = next(it)
            except StopIteration:
                kv = self.get(op.key)
                if kv is not None:
                    out.append(kv)
                continue
            out.append(KeyValue(
                key=op.key, value=op.value, create_rev=st_kv.create_rev,
                mod_rev=st_kv.mod_rev, version=st_kv.version,
                lease=op.lease,
            ))
        return out

    def _classify_failure(
        self, compares: list[Compare]
    ) -> Optional[tuple[bool, list[KeyValue]]]:
        """Re-read guard keys: if any compare no longer holds, the txn
        legitimately failed (False). Otherwise the multi tripped on a
        stale probe -> None (retry)."""
        for c in compares:
            kv = self.get(c.key)
            ver = kv.version if kv is not None else 0
            if ver != c.version:
                return False, []
        return None

    # -- watches -----------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        handle = _PrefixWatch(self, prefix, callback)
        with self._watch_lock:
            first = not self._mirror_ready
            if first:
                self._sync_mirror_locked(full=True)
                self._mirror_ready = True
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="zk-watch", daemon=True
                )
                self._dispatcher.start()
            replay: list[WatchEvent] = []
            if start_rev is not None:
                replay = [
                    WatchEvent(EventType.PUT, kv)
                    for kv in sorted(
                        self._mirror.values(), key=lambda kv: kv.mod_rev
                    )
                    if kv.key.startswith(prefix) and kv.mod_rev > start_rev
                ]
            self._watches.append(handle)
            # Replay is delivered under _watch_lock: every live delivery
            # path (_deliver) also serializes on it, so a newer event for
            # the same key cannot overtake the older replayed PUT.
            if replay:
                callback(replay)
        return handle

    def _remove_watch(self, handle: _PrefixWatch) -> None:
        with self._watch_lock:
            if handle in self._watches:
                self._watches.remove(handle)

    def _sync_mirror_locked(self, full: bool = False) -> None:
        """(Re)list children with the child watch re-armed; read + arm data
        watches for keys the mirror lacks; synthesize DELETEs for vanished
        keys.

        ``full=True`` (session swap) also re-reads keys ALREADY in the
        mirror — their data watches died with the old session. On a plain
        NodeChildrenChanged trigger those watches are still armed, so
        re-reading the whole keyspace per child event would make one
        registration O(N) round-trips at registry scale; the incremental
        path touches only the added/removed children."""
        s0 = self._session
        events: list[WatchEvent] = []
        keys = set(self._list_keys(watch=True))
        for key in sorted(keys):
            old = self._mirror.get(key)
            if old is not None and not full:
                continue  # live data watch already covers this key
            kv = self._get_data(key, watch=True)
            if kv is None:
                continue  # vanished between list and read; next trigger
            if old is None or old.mod_rev != kv.mod_rev:
                self._mirror[key] = kv
                events.append(WatchEvent(EventType.PUT, kv, prev=old))
        for key in sorted(set(self._mirror) - keys):
            old = self._mirror.pop(key)
            events.append(WatchEvent(
                EventType.DELETE,
                KeyValue(key=key, value=b"",
                         create_rev=old.create_rev,
                         mod_rev=self._session.last_zxid,
                         version=0),
                prev=old,
            ))
        # If a reconnect raced in mid-sync, some watches were armed on the
        # dying session; recording s0 keeps the dispatcher's identity
        # check failing until a full sync runs on the live session.
        self._mirror_session = s0
        if events:
            self._deliver(events)

    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            s = self._session
            if s.dead.is_set():
                # Outage: re-establish the session (a data-plane _req may
                # already have), then fall through to the resync check.
                try:
                    self._reconnect(failed=s)
                except (ZkSessionLost, ConnectionError, OSError):
                    self._closed.wait(0.3)  #: wall-clock: reconnect backoff against a real ensemble outage
                continue
            if s is not self._mirror_session:
                # The mirror's watches are armed on a PREVIOUS session —
                # whether the dispatcher or a data-plane thread swapped it,
                # re-arm on the live one and diff (PUTs for changes,
                # synthesized DELETEs for the gap — the etcd client's
                # relist-and-rewatch semantics).
                try:
                    with self._watch_lock:
                        self._sync_mirror_locked(full=True)
                except (ZkSessionLost, ConnectionError, OSError):
                    self._closed.wait(0.3)  #: wall-clock: resync backoff against a real ensemble outage
                continue
            try:
                ev = s.watch_events.get(timeout=0.5)
            except queue.Empty:
                self._idle.set()
                continue
            self._idle.clear()
            try:
                self._handle_raw_event(ev)
            except (ZkSessionLost, ConnectionError):
                continue  # outer loop reconnects
            except Exception:  # noqa: BLE001
                log.exception("zk watch dispatch failed")
            finally:
                if s.watch_events.empty():
                    self._idle.set()

    def _handle_raw_event(self, ev: jute.WatcherEvent) -> None:
        if ev.state == jute.STATE_EXPIRED:
            return
        with self._watch_lock:
            if ev.type == EV_NODE_CHILDREN_CHANGED:
                self._sync_mirror_locked()
                return
            if ev.type in (EV_NODE_DATA_CHANGED, EV_NODE_CREATED):
                key = _unesc(ev.path[1:])
                old = self._mirror.get(key)
                kv = self._get_data(key, watch=True)
                if kv is None:
                    if old is not None:
                        self._mirror.pop(key, None)
                        self._deliver([WatchEvent(
                            EventType.DELETE,
                            KeyValue(key=key, value=b"",
                                     create_rev=old.create_rev,
                                     mod_rev=self._session.last_zxid,
                                     version=0),
                            prev=old,
                        )])
                    return
                if old is None or old.mod_rev != kv.mod_rev:
                    self._mirror[key] = kv
                    self._deliver([WatchEvent(EventType.PUT, kv, prev=old)])
                return
            if ev.type == EV_NODE_DELETED:
                key = _unesc(ev.path[1:])
                old = self._mirror.pop(key, None)
                if old is not None:
                    self._deliver([WatchEvent(
                        EventType.DELETE,
                        KeyValue(key=key, value=b"",
                                 create_rev=old.create_rev,
                                 mod_rev=self._session.last_zxid,
                                 version=0),
                        prev=old,
                    )])

    def _deliver(self, events: list[WatchEvent]) -> None:
        with self._watch_lock:
            watches = list(self._watches)
        for handle in watches:
            if handle.cancelled.is_set():
                continue
            batch = [
                e for e in events if e.kv.key.startswith(handle.prefix)
            ]
            if batch:
                try:
                    handle.callback(batch)
                except Exception:  # noqa: BLE001
                    log.exception("zk watch callback failed")

    # -- leases ------------------------------------------------------------

    def lease_grant(self, ttl_s: float) -> int:
        session = _ZkSession(
            self._endpoint, int(ttl_s * 1000), auto_ping=False,
            ssl_ctx=self._ssl_ctx, ssl_hostname=self._ssl_hostname,
        )
        if session.timeout_ms < ttl_s * 1000:
            # The ensemble clamped the session timeout below the requested
            # TTL (maxSessionTimeout): keepalives paced off the requested
            # value would let the lease flap. Surface it loudly.
            log.warning(
                "zk clamped lease ttl %.1fs to %.1fs; pace keepalives off "
                "the effective value or the lease will expire between them",
                ttl_s, session.timeout_ms / 1000.0,
            )
        with self._leases_lock:
            # Prune sessions that died (expiry, ZK blip): SessionNode
            # re-grants on keepalive failure without revoking the old id,
            # so dead entries would otherwise accumulate unbounded.
            for lid in [l for l, s in self._leases.items()
                        if s.dead.is_set()]:
                self._leases.pop(lid).close(clean=False)
            self._leases[session.session_id] = session
        return session.session_id

    def lease_keepalive(self, lease_id: int) -> bool:
        with self._leases_lock:
            session = self._leases.get(lease_id)
            if session is not None and session.dead.is_set():
                self._leases.pop(lease_id).close(clean=False)
                return False
        if session is None:
            return False
        try:
            session.ping(timeout=max(1.0, session.timeout_ms / 1000.0))
            return True
        except (ZkSessionLost, TimeoutError):
            return False

    def lease_revoke(self, lease_id: int) -> None:
        with self._leases_lock:
            session = self._leases.pop(lease_id, None)
        if session is not None:
            session.close(clean=True)

    # -- limits ------------------------------------------------------------

    def max_value_bytes(self) -> Optional[int]:
        # ZK's default jute.maxbuffer frame cap is 1 MiB; leave headroom
        # for the path + stat in the same frame.
        return (1 << 20) - 4096

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._closed.set()
        with self._leases_lock:
            leases = list(self._leases.values())
            self._leases.clear()
        for session in leases:
            session.close(clean=True)
        self._session.close(clean=True)

    def wait_idle(self, timeout: float = 5.0) -> None:
        import time as _time

        deadline = _time.monotonic() + timeout  #: wall-clock: test helper bounding REAL dispatcher-thread progress
        _time.sleep(0.05)  #: wall-clock: lets the wire reader enqueue in-flight events
        while _time.monotonic() < deadline:  #: wall-clock: same wall bound as above
            if self._session.watch_events.empty() and self._idle.is_set():
                _time.sleep(0.05)  #: wall-clock: settle window before re-checking the queue
                if self._session.watch_events.empty():
                    return
            _time.sleep(0.02)  #: wall-clock: polls real dispatcher idleness
