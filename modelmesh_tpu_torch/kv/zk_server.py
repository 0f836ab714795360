"""The port's own copy of the JAX package's ``kv/zk_server.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

In-repo ZooKeeper wire server (jute protocol) — conformance test peer.

The reference validates its second KV backend against real ZooKeeper
servers spun up in tests (ZookeeperSidecarModelMeshTest /
ZookeeperVModelsTest / ModelMeshZkFailTest override the etcd default of
AbstractModelMeshTest). With zero egress, this plays that role for the
ZookeeperKV backend (kv/zookeeper.py): a TCP server speaking the actual
ZooKeeper client protocol — length-prefixed jute frames, session
handshake with server-assigned ids and negotiated timeouts, znode tree
with Stat metadata, one-shot data/child watches, ephemeral cleanup on
session close/expiry, and atomic multi transactions.

Scope: the single-server subset (no ZAB replication, ACLs fixed at
OPEN_ACL_UNSAFE, no SASL). Semantics follow the ZooKeeper programmer's
contract: zxid increments once per write transaction; version checks use
-1 as a wildcard; deletes of non-empty nodes fail NOTEMPTY; sequential
nodes append a %010d counter from the parent's cversion; watches fire
once and must be re-armed; session expiry deletes that session's
ephemerals and fires their watches.
"""

from __future__ import annotations

import logging
import queue
import socket
import socketserver
import threading
import time
from typing import Optional

from modelmesh_tpu_torch.kv import jute
from modelmesh_tpu_torch.kv.jute import (
    ERR_BAD_ARGUMENTS,
    ERR_BAD_VERSION,
    ERR_NODE_EXISTS,
    ERR_NO_NODE,
    ERR_NOT_EMPTY,
    ERR_OK,
    ERR_RUNTIME_INCONSISTENCY,
    ERR_SESSION_EXPIRED,
    EV_NODE_CHILDREN_CHANGED,
    EV_NODE_CREATED,
    EV_NODE_DATA_CHANGED,
    EV_NODE_DELETED,
    FLAG_EPHEMERAL,
    FLAG_SEQUENCE,
    OP_CHECK,
    OP_CLOSE,
    OP_CREATE,
    OP_CREATE2,
    OP_DELETE,
    OP_ERROR,
    OP_EXISTS,
    OP_GET_CHILDREN,
    OP_GET_CHILDREN2,
    OP_GET_DATA,
    OP_MULTI,
    OP_PING,
    OP_SET_DATA,
    OP_SYNC,
    STATE_SYNC_CONNECTED,
    XID_PING,
    XID_WATCH_EVENT,
    MultiHeader,
    Reader,
    Stat,
    Writer,
    read_acl_vector,
)

log = logging.getLogger("modelmesh_tpu_torch.kv.zk_server")


class _ZkError(Exception):
    def __init__(self, code: int):
        super().__init__(f"zk error {code}")
        self.code = code


class _Node:
    __slots__ = (
        "data", "czxid", "mzxid", "ctime", "mtime", "version",
        "cversion", "pzxid", "ephemeral_owner", "children",
    )

    def __init__(self, data: bytes, zxid: int, owner: int = 0):
        now = int(time.time() * 1000)  #: wall-clock: wire-visible znode ctime/mtime stamps — the server emulates a real external ensemble, outside the sim's clock
        self.data = data
        self.czxid = zxid
        self.mzxid = zxid
        self.ctime = now
        self.mtime = now
        self.version = 0
        self.cversion = 0
        self.pzxid = zxid
        self.ephemeral_owner = owner
        self.children: set[str] = set()

    def stat(self) -> Stat:
        return Stat(
            czxid=self.czxid, mzxid=self.mzxid, ctime=self.ctime,
            mtime=self.mtime, version=self.version, cversion=self.cversion,
            aversion=0, ephemeral_owner=self.ephemeral_owner,
            data_length=len(self.data), num_children=len(self.children),
            pzxid=self.pzxid,
        )


def _parent(path: str) -> str:
    if path == "/":
        return ""
    cut = path.rsplit("/", 1)[0]
    return cut or "/"


def _validate_path(path: str) -> None:
    if not path.startswith("/") or (path != "/" and path.endswith("/")):
        raise _ZkError(ERR_BAD_ARGUMENTS)
    if "\x00" in path or "//" in path:
        raise _ZkError(ERR_BAD_ARGUMENTS)


class _Session:
    def __init__(self, sid: int, timeout_ms: int):
        self.sid = sid
        self.timeout_ms = timeout_ms
        self.last_seen = time.monotonic()  #: wall-clock: session-idle tracking for REAL client connections; an external ensemble's clock, not the sim's
        self.ephemerals: set[str] = set()
        self.conn: Optional["_ZkConnHandler"] = None
        self.closed = False


class ZkState:
    """The znode tree + sessions + watches, shared across connections."""

    # Negotiation bounds, as a real ensemble applies (tickTime-derived).
    MIN_TIMEOUT_MS = 100
    MAX_TIMEOUT_MS = 60_000

    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.zxid = 0
        self.nodes: dict[str, _Node] = {"/": _Node(b"", 0)}
        self.sessions: dict[int, _Session] = {}
        self._next_sid = 0x10000
        # One-shot watches: path -> set of sessions to notify.
        self.data_watches: dict[str, set[_Session]] = {}
        self.child_watches: dict[str, set[_Session]] = {}

    # -- session lifecycle -------------------------------------------------

    def open_session(self, timeout_ms: int) -> _Session:
        with self.lock:
            self._next_sid += 1
            t = min(max(timeout_ms, self.MIN_TIMEOUT_MS), self.MAX_TIMEOUT_MS)
            s = _Session(self._next_sid, t)
            self.sessions[s.sid] = s
            return s

    def close_session(self, s: _Session) -> None:
        with self.lock:
            if s.closed:
                return
            s.closed = True
            self.sessions.pop(s.sid, None)
            if s.ephemerals:
                # closeSession is a write transaction: the ephemeral sweep
                # gets its own zxid so liveness DELETEs carry a mod_rev
                # strictly above the writes they undo.
                self.zxid += 1
            for path in sorted(s.ephemerals):
                node = self.nodes.get(path)
                if node is not None and node.ephemeral_owner == s.sid:
                    self._delete_node(path)
            s.ephemerals.clear()
            for watches in (self.data_watches, self.child_watches):
                for peers in watches.values():
                    peers.discard(s)

    def expire_idle_sessions(self) -> list[_Session]:
        now = time.monotonic()  #: wall-clock: expires real wire sessions against their real last_seen stamps
        expired = []
        with self.lock:
            for s in list(self.sessions.values()):
                if (now - s.last_seen) * 1000.0 > s.timeout_ms:
                    expired.append(s)
            for s in expired:
                self.close_session(s)
        # Sever the transport of expired sessions (outside the lock): a
        # real ensemble drops the connection, which is how clients learn
        # their session — and any leases riding it — are gone.
        for s in expired:
            conn = s.conn
            if conn is not None:
                try:
                    conn.request.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        return expired

    def check_live(self, s: "_Session") -> None:
        """Raise SESSIONEXPIRED if ``s`` was closed. Must be called INSIDE
        self.lock before any mutation: the cheap closed-check in _dispatch
        runs unlocked, so the reaper can expire the session between it and
        the mutation — an ephemeral created after the expiry sweep would
        be owned by a dead session and leak forever."""
        if s.closed or s.sid not in self.sessions:
            raise _ZkError(ERR_SESSION_EXPIRED)

    # -- watch plumbing ----------------------------------------------------

    def _arm(self, table: dict[str, set[_Session]], path: str,
             session: _Session) -> None:
        table.setdefault(path, set()).add(session)

    def _fire(self, table: dict[str, set[_Session]], path: str,
              ev_type: int) -> None:
        peers = table.pop(path, None)
        if not peers:
            return
        for s in peers:
            conn = s.conn
            if conn is not None:
                conn.send_watch_event(ev_type, path)

    # -- tree mutations (caller holds lock; one zxid per txn) --------------

    def _create_node(self, path: str, data: bytes, flags: int,
                     session: _Session) -> str:
        parent = _parent(path)
        pnode = self.nodes.get(parent)
        if pnode is None:
            raise _ZkError(ERR_NO_NODE)
        if pnode.ephemeral_owner:
            raise _ZkError(ERR_BAD_ARGUMENTS)  # ephemerals have no children
        if flags & FLAG_SEQUENCE:
            path = f"{path}{pnode.cversion:010d}"
        if path in self.nodes:
            raise _ZkError(ERR_NODE_EXISTS)
        owner = session.sid if flags & FLAG_EPHEMERAL else 0
        node = _Node(data, self.zxid, owner)
        self.nodes[path] = node
        pnode.children.add(path.rsplit("/", 1)[1])
        pnode.cversion += 1
        pnode.pzxid = self.zxid
        if owner:
            session.ephemerals.add(path)
        self._fire(self.data_watches, path, EV_NODE_CREATED)
        self._fire(self.child_watches, parent, EV_NODE_CHILDREN_CHANGED)
        return path

    def _delete_node(self, path: str) -> None:
        node = self.nodes.pop(path)
        parent = _parent(path)
        pnode = self.nodes.get(parent)
        if pnode is not None:
            pnode.children.discard(path.rsplit("/", 1)[1])
            pnode.cversion += 1
            pnode.pzxid = self.zxid
        if node.ephemeral_owner:
            owner = self.sessions.get(node.ephemeral_owner)
            if owner is not None:
                owner.ephemerals.discard(path)
        self._fire(self.data_watches, path, EV_NODE_DELETED)
        self._fire(self.child_watches, path, EV_NODE_DELETED)
        self._fire(self.child_watches, parent, EV_NODE_CHILDREN_CHANGED)

    def _set_data(self, path: str, data: bytes) -> _Node:
        node = self.nodes[path]
        node.data = data
        node.version += 1
        node.mzxid = self.zxid
        node.mtime = int(time.time() * 1000)  #: wall-clock: wire-visible znode mtime stamp, like _Node.__init__
        self._fire(self.data_watches, path, EV_NODE_DATA_CHANGED)
        return node

    # -- op validation (two-phase multi support) ---------------------------

    def _check_create(self, path: str, flags: int,
                      staged_creates: set[str],
                      staged_deletes: set[str],
                      staged_ephemerals: set[str] = frozenset()) -> None:
        _validate_path(path)
        parent = _parent(path)
        parent_live = (
            (parent in self.nodes and parent not in staged_deletes)
            or parent in staged_creates
        )
        if not parent_live:
            # Includes a parent staged for deletion earlier in the SAME
            # multi: phase 1 must reject it, or phase 2 would raise
            # mid-apply after the delete already landed (atomicity).
            raise _ZkError(ERR_NO_NODE)
        pnode = self.nodes.get(parent)
        parent_ephemeral = (
            parent in staged_ephemerals
            or (parent not in staged_creates
                and pnode is not None and pnode.ephemeral_owner != 0)
        )
        if parent_ephemeral:
            raise _ZkError(ERR_BAD_ARGUMENTS)  # ephemerals have no children
        if not flags & FLAG_SEQUENCE:
            exists = (path in self.nodes or path in staged_creates)
            if exists and path not in staged_deletes:
                raise _ZkError(ERR_NODE_EXISTS)

    def _check_delete(self, path: str, version: int,
                      staged_deletes: set[str],
                      staged_creates: set[str] = frozenset()) -> None:
        _validate_path(path)
        if path in staged_creates and path not in staged_deletes:
            # Created earlier in this same multi: version is 0.
            if version not in (-1, 0):
                raise _ZkError(ERR_BAD_VERSION)
            return
        node = self.nodes.get(path)
        if node is None or path in staged_deletes:
            raise _ZkError(ERR_NO_NODE)
        if version != -1 and version != node.version:
            raise _ZkError(ERR_BAD_VERSION)
        live_children = {
            c for c in node.children
            if (path.rstrip("/") + "/" + c) not in staged_deletes
        }
        if live_children:
            raise _ZkError(ERR_NOT_EMPTY)

    def _check_set(self, path: str, version: int,
                   staged_deletes: set[str],
                   staged_creates: set[str] = frozenset()) -> None:
        _validate_path(path)
        if path in staged_creates and path not in staged_deletes:
            if version not in (-1, 0):
                raise _ZkError(ERR_BAD_VERSION)
            return
        node = self.nodes.get(path)
        if node is None or path in staged_deletes:
            raise _ZkError(ERR_NO_NODE)
        if version != -1 and version != node.version:
            raise _ZkError(ERR_BAD_VERSION)


class _ZkConnHandler(socketserver.BaseRequestHandler):
    """One thread per client connection. ``self.server`` is the
    _ThreadingTCP instance, which carries ``.state`` (ZkState) and
    ``.stopping`` (Event) attached by ZkWireServer."""

    HANDSHAKE_TIMEOUT_S = 10.0

    def setup(self) -> None:
        tls_ctx = getattr(self.server, "tls_ctx", None)
        if tls_ctx is not None:
            # Per-connection TLS handshake in the handler thread (never
            # the accept loop — a plaintext or wedged client must not
            # stall other sessions), BOUNDED: a connect-and-hold peer
            # must not pin this thread forever. Failure raises here;
            # socketserver drops the connection.
            self.request.settimeout(self.HANDSHAKE_TIMEOUT_S)
            self.request = tls_ctx.wrap_socket(
                self.request, server_side=True
            )
        self.session: Optional[_Session] = None
        self._send_lock = threading.Lock()
        # Watch events are queued and sent by a dedicated drain thread:
        # _fire() runs under the global ZkState.lock, and a blocking
        # sendall to one slow watcher there would stall every session.
        self._outq: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._sender = threading.Thread(
            target=self._drain_outq, name="zk-conn-send", daemon=True
        )
        # Keep the handshake deadline armed for the ConnectRequest read
        # too — plaintext or TLS, a connect-and-hold peer must not pin
        # this handler thread forever. handle() disarms it once the
        # session is established.
        self.request.settimeout(self.HANDSHAKE_TIMEOUT_S)
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _send(self, payload: bytes) -> None:
        with self._send_lock:
            self.request.sendall(jute.frame(payload))

    def _drain_outq(self) -> None:
        while True:
            payload = self._outq.get()
            if payload is None:
                return
            try:
                self._send(payload)
            except OSError:
                return  # dead conn; reaper will expire the session

    def send_watch_event(self, ev_type: int, path: str) -> None:
        w = Writer()
        w.int32(XID_WATCH_EVENT).int64(self.server.state.zxid).int32(ERR_OK)
        w.raw(jute.WatcherEvent(ev_type, STATE_SYNC_CONNECTED, path).encode())
        self._outq.put(w.getvalue())

    def handle(self) -> None:
        state = self.server.state
        try:
            req = jute.ConnectRequest.decode(jute.read_frame(self.request))
        except (ConnectionError, OSError, jute.JuteError):
            # OSError covers socket.timeout: a silent client that never
            # sent its ConnectRequest inside HANDSHAKE_TIMEOUT_S.
            return
        # Handshake done — steady-state reads block indefinitely (liveness
        # is the ping/reaper protocol's job, not the socket's).
        self.request.settimeout(None)
        self.session = state.open_session(req.timeout_ms)
        self.session.conn = self
        self._sender.start()
        resp = jute.ConnectResponse(
            timeout_ms=self.session.timeout_ms,
            session_id=self.session.sid,
            passwd=b"\x00" * 16,
        )
        try:
            self._send(resp.encode())
            while not self.server.stopping.is_set():
                frame = jute.read_frame(self.request)
                if not self._dispatch(frame):
                    break
        except (ConnectionError, OSError, jute.JuteError):
            pass
        finally:
            # A dropped connection does NOT expire the session immediately
            # (the reaper does, after timeout) — matching ZK, where a
            # client may reconnect. closeSession (clean) expires it now.
            if self.session is not None:
                self.session.conn = None
            self._outq.put(None)  # stop the event drain thread

    def finish(self) -> None:
        # Under TLS, wrap_socket DETACHED the socket socketserver's
        # shutdown_request knows about — close the live (possibly
        # wrapped) one deterministically instead of waiting for GC.
        try:
            self.request.close()
        except OSError:
            pass

    def _reply(self, xid: int, err: int, body: bytes = b"") -> None:
        w = Writer()
        w.int32(xid).int64(self.server.state.zxid).int32(err)
        w.raw(body)
        self._send(w.getvalue())

    def _dispatch(self, frame: bytes) -> bool:
        state = self.server.state
        r = Reader(frame)
        xid = r.int32()
        op = r.int32()
        assert self.session is not None
        if self.session.closed:
            return False  # expired under us; drop the connection
        self.session.last_seen = time.monotonic()  #: wall-clock: liveness stamp for a real client connection
        if op == OP_PING:
            self._reply(XID_PING, ERR_OK)
            return True
        if op == OP_CLOSE:
            with state.lock:
                state.close_session(self.session)
            self._reply(xid, ERR_OK)
            return False
        try:
            body = self._handle_op(op, r)
            self._reply(xid, ERR_OK, body)
        except _ZkError as e:
            self._reply(xid, e.code)
        return True

    def _handle_op(self, op: int, r: Reader) -> bytes:
        state = self.server.state
        s = self.session
        assert s is not None
        if op in (OP_CREATE, OP_CREATE2):
            path = r.string()
            data = r.buffer()
            read_acl_vector(r)
            flags = r.int32()
            with state.lock:
                state.check_live(s)
                state._check_create(path, flags, set(), set())
                state.zxid += 1
                actual = state._create_node(path, data, flags, s)
                w = Writer()
                w.string(actual)
                if op == OP_CREATE2:
                    state.nodes[actual].stat().write(w)
                return w.getvalue()
        if op == OP_DELETE:
            path = r.string()
            version = r.int32()
            with state.lock:
                state.check_live(s)
                state._check_delete(path, version, set())
                state.zxid += 1
                state._delete_node(path)
            return b""
        if op == OP_SET_DATA:
            path = r.string()
            data = r.buffer()
            version = r.int32()
            with state.lock:
                state.check_live(s)
                state._check_set(path, version, set())
                state.zxid += 1
                node = state._set_data(path, data)
                w = Writer()
                node.stat().write(w)
                return w.getvalue()
        if op == OP_EXISTS:
            path = r.string()
            watch = r.boolean()
            _validate_path(path)
            with state.lock:
                node = state.nodes.get(path)
                if watch:
                    # exists-watch arms even on a missing node (fires on
                    # creation) — the one data-watch that may target absence.
                    state._arm(state.data_watches, path, s)
                if node is None:
                    raise _ZkError(ERR_NO_NODE)
                w = Writer()
                node.stat().write(w)
                return w.getvalue()
        if op == OP_GET_DATA:
            path = r.string()
            watch = r.boolean()
            _validate_path(path)
            with state.lock:
                node = state.nodes.get(path)
                if node is None:
                    raise _ZkError(ERR_NO_NODE)
                if watch:
                    state._arm(state.data_watches, path, s)
                w = Writer()
                w.buffer(node.data)
                node.stat().write(w)
                return w.getvalue()
        if op in (OP_GET_CHILDREN, OP_GET_CHILDREN2):
            path = r.string()
            watch = r.boolean()
            _validate_path(path)
            with state.lock:
                node = state.nodes.get(path)
                if node is None:
                    raise _ZkError(ERR_NO_NODE)
                if watch:
                    state._arm(state.child_watches, path, s)
                w = Writer()
                names = sorted(node.children)
                w.int32(len(names))
                for name in names:
                    w.string(name)
                if op == OP_GET_CHILDREN2:
                    node.stat().write(w)
                return w.getvalue()
        if op == OP_CHECK:
            path = r.string()
            version = r.int32()
            with state.lock:
                state._check_set(path, version, set())
            return b""
        if op == OP_SYNC:
            path = r.string()
            w = Writer()
            w.string(path)
            return w.getvalue()
        if op == OP_MULTI:
            return self._handle_multi(r)
        raise _ZkError(ERR_BAD_ARGUMENTS)

    def _handle_multi(self, r: Reader) -> bytes:
        """Atomic multi: validate every op against the current tree (plus
        staged effects), then apply all under ONE zxid — or none."""
        state = self.server.state
        s = self.session
        assert s is not None
        ops: list[tuple] = []
        while True:
            h = MultiHeader.read(r)
            if h.done:
                break
            if h.type in (OP_CREATE, OP_CREATE2):
                path = r.string()
                data = r.buffer()
                read_acl_vector(r)
                flags = r.int32()
                ops.append((h.type, path, data, flags))
            elif h.type == OP_DELETE:
                ops.append((h.type, r.string(), r.int32()))
            elif h.type == OP_SET_DATA:
                path = r.string()
                data = r.buffer()
                version = r.int32()
                ops.append((h.type, path, data, version))
            elif h.type == OP_CHECK:
                ops.append((h.type, r.string(), r.int32()))
            else:
                raise _ZkError(ERR_BAD_ARGUMENTS)

        with state.lock:
            state.check_live(s)
            # Phase 1: validate (sequential semantics via staged sets).
            staged_creates: set[str] = set()
            staged_deletes: set[str] = set()
            staged_ephemerals: set[str] = set()
            fail_idx, fail_code = -1, ERR_OK
            for i, rec in enumerate(ops):
                try:
                    if rec[0] in (OP_CREATE, OP_CREATE2):
                        _, path, _, flags = rec
                        state._check_create(
                            path, flags, staged_creates, staged_deletes,
                            staged_ephemerals,
                        )
                        staged_creates.add(path)
                        staged_deletes.discard(path)
                        if flags & FLAG_EPHEMERAL:
                            staged_ephemerals.add(path)
                        else:
                            staged_ephemerals.discard(path)
                    elif rec[0] == OP_DELETE:
                        _, path, version = rec
                        state._check_delete(
                            path, version, staged_deletes, staged_creates
                        )
                        staged_deletes.add(path)
                        staged_creates.discard(path)
                        staged_ephemerals.discard(path)
                    elif rec[0] == OP_SET_DATA:
                        _, path, _, version = rec
                        state._check_set(
                            path, version, staged_deletes, staged_creates
                        )
                    elif rec[0] == OP_CHECK:
                        _, path, version = rec
                        state._check_set(
                            path, version, staged_deletes, staged_creates
                        )
                except _ZkError as e:
                    fail_idx, fail_code = i, e.code
                    break

            w = Writer()
            if fail_idx >= 0:
                # Failure: every op reports an ErrorResult — the failing op
                # its own code, the rest RUNTIMEINCONSISTENCY.
                for i in range(len(ops)):
                    code = fail_code if i == fail_idx else (
                        ERR_RUNTIME_INCONSISTENCY
                    )
                    MultiHeader(OP_ERROR, False, code).write(w)
                    w.int32(code)
                MultiHeader(-1, True, -1).write(w)
                return w.getvalue()

            # Phase 2: apply, one zxid for the whole transaction.
            state.zxid += 1
            for rec in ops:
                if rec[0] in (OP_CREATE, OP_CREATE2):
                    _, path, data, flags = rec
                    actual = state._create_node(path, data, flags, s)
                    MultiHeader(rec[0], False, ERR_OK).write(w)
                    w.string(actual)
                    if rec[0] == OP_CREATE2:
                        state.nodes[actual].stat().write(w)
                elif rec[0] == OP_DELETE:
                    state._delete_node(rec[1])
                    MultiHeader(OP_DELETE, False, ERR_OK).write(w)
                elif rec[0] == OP_SET_DATA:
                    node = state._set_data(rec[1], rec[2])
                    MultiHeader(OP_SET_DATA, False, ERR_OK).write(w)
                    node.stat().write(w)
                elif rec[0] == OP_CHECK:
                    MultiHeader(OP_CHECK, False, ERR_OK).write(w)
            MultiHeader(-1, True, -1).write(w)
            return w.getvalue()


class _ThreadingTCP(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        # Dropped/garbage/failed-TLS connections are expected traffic for
        # a network server — one debug line, not a stderr traceback.
        import ssl as _ssl
        import sys

        exc = sys.exception()
        if isinstance(exc, (_ssl.SSLError, OSError, jute.JuteError)):
            log.debug("connection from %s dropped: %s", client_address, exc)
            return
        super().handle_error(request, client_address)


class ZkWireServer:
    """Embeddable single-node ZooKeeper-protocol server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 state: Optional[ZkState] = None, tls=None):
        # Passing a previous instance's ``state`` simulates an ensemble
        # restart that kept its on-disk tree: sessions whose connections
        # died with the old process expire by timeout (reaper), deleting
        # their ephemerals — exactly what a rebooted quorum does.
        self.state = state if state is not None else ZkState()
        self.stopping = threading.Event()
        self._tcp = _ThreadingTCP((host, port), _ZkConnHandler)
        # The handler reaches shared state through self.server (the TCP
        # server instance socketserver hands it).
        self._tcp.state = self.state          # type: ignore[attr-defined]  # analysis-ok: state-funnel — name collision: this is the ZkState tree handed to socketserver, not CacheEntry.state
        self._tcp.stopping = self.stopping    # type: ignore[attr-defined]
        self._tcp.tls_ctx = (                 # type: ignore[attr-defined]
            tls.ssl_server_context() if tls is not None else None
        )
        self.port = self._tcp.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._tcp.serve_forever, name="zk-server", daemon=True
        )
        self._reaper = threading.Thread(
            target=self._reap_loop, name="zk-reaper", daemon=True
        )

    def start(self) -> "ZkWireServer":
        self._serve_thread.start()
        self._reaper.start()
        return self

    def _reap_loop(self) -> None:
        while not self.stopping.wait(0.05):  #: wall-clock: server reaper cadence over real wire sessions
            try:
                self.state.expire_idle_sessions()
            except Exception:  # noqa: BLE001
                log.exception("zk session reaper failed")

    def stop(self) -> None:
        self.stopping.set()
        self._tcp.shutdown()
        self._tcp.server_close()
