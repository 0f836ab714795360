"""The port's own copy of the JAX package's ``kv/etcd.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

etcd v3 KVStore backend: the production coordination store.

Talks the real etcd gRPC API (hand-generated field-number-compatible stubs,
protos/etcd_rpc.proto) — the same role etcd plays for the reference via
kv-utils. Mapping notes:

- KVStore.version CAS maps to an etcd Txn comparing mvcc ``version``
  (version=0 asserts absence via CREATE revision compare on etcd; we use
  VERSION EQUAL 0 which etcd defines for non-existent keys).
- Prefix range/watch use etcd's key..range_end convention (prefix+1 bit).
- Leases map 1:1 (grant/keepalive/revoke); keepalive uses the bidi stream
  with single request/response exchanges.

Tested in the default KV matrix (tests/test_kv.py) against the in-repo
etcd-v3-wire server (kv/etcd_server.py) over real gRPC, including the
compaction-cancel recovery path (tests/test_kv_compaction.py). The CI image
carries no etcd binary and has zero egress, so a stock etcd cannot run
in-tree; the wire contract is pinned by the proto's field-number
compatibility with the public etcd v3 API. Point any entrypoint at a real
etcd with ``--kv etcd://host:port`` — no code path differs.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterable, Optional

import grpc

from modelmesh_tpu_torch.utils.grpcopts import message_size_options
from modelmesh_tpu_torch.kv.store import (
    Compare,
    EventType,
    KeyValue,
    KVStore,
    Op,
    WatchCallback,
    WatchEvent,
    WatchHandle,
)
from modelmesh_tpu_torch.proto import etcd_rpc_pb2 as epb
from modelmesh_tpu_torch.runtime import grpc_defs

log = logging.getLogger(__name__)

_KV_SERVICE = "etcdserverpb.KV"
_KV_METHODS = {
    "Range": (epb.RangeRequest, epb.RangeResponse),
    "Put": (epb.PutRequest, epb.PutResponse),
    "DeleteRange": (epb.DeleteRangeRequest, epb.DeleteRangeResponse),
    "Txn": (epb.TxnRequest, epb.TxnResponse),
}
_LEASE_SERVICE = "etcdserverpb.Lease"
_LEASE_METHODS = {
    "LeaseGrant": (epb.LeaseGrantRequest, epb.LeaseGrantResponse),
    "LeaseRevoke": (epb.LeaseRevokeRequest, epb.LeaseRevokeResponse),
}
_WATCH_METHOD = "/etcdserverpb.Watch/Watch"
_KEEPALIVE_METHOD = "/etcdserverpb.Lease/LeaseKeepAlive"


def _prefix_range_end(prefix: bytes) -> bytes:
    """etcd convention: end = prefix with last byte incremented."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] < 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return b"\0"  # whole keyspace


def _to_kv(m: epb.MvccKeyValue) -> KeyValue:
    return KeyValue(
        key=m.key.decode(),
        value=m.value,
        create_rev=m.create_revision,
        mod_rev=m.mod_revision,
        version=m.version,
        lease=m.lease,
    )


class _EtcdWatch(WatchHandle):
    def __init__(self, call):
        self._call = call
        self.cancelled = threading.Event()

    def cancel(self) -> None:
        self.cancelled.set()
        if self._call is not None:
            self._call.cancel()


class EtcdKV(KVStore):
    def __init__(self, target: str, timeout_s: float = 10.0, tls=None):
        from modelmesh_tpu_torch.serving.tls import secure_channel

        self._channel = secure_channel(target, tls)
        self._kv = grpc_defs.make_stub(self._channel, _KV_SERVICE, _KV_METHODS)
        self._lease = grpc_defs.make_stub(
            self._channel, _LEASE_SERVICE, _LEASE_METHODS
        )
        self._timeout = timeout_s
        self._watches: list[_EtcdWatch] = []
        # etcd enforces a server-side request quota (--max-request-bytes,
        # 1.5 MiB default); stay conservatively under it so puts fail here
        # with a clear error instead of an opaque etcdserver rejection.
        from modelmesh_tpu_torch.utils.envs import get_int

        self._max_value_bytes = get_int("MM_ETCD_MAX_VALUE_BYTES")

    # -- reads ------------------------------------------------------------

    def get(self, key: str) -> Optional[KeyValue]:
        resp = self._kv.Range(
            epb.RangeRequest(key=key.encode()), timeout=self._timeout
        )
        return _to_kv(resp.kvs[0]) if resp.kvs else None

    def range(self, prefix: str) -> list[KeyValue]:
        p = prefix.encode()
        resp = self._kv.Range(
            epb.RangeRequest(key=p, range_end=_prefix_range_end(p)),
            timeout=self._timeout,
        )
        return sorted((_to_kv(kv) for kv in resp.kvs), key=lambda kv: kv.key)

    def range_from(self, prefix: str, start_key: str, limit: int):
        # Server-side limited read: [start_key, end(prefix)) with limit —
        # the etcd pagination idiom (count/more are ignored here; the
        # base-class range_paged stops on a short page). start_key is
        # clamped INTO the prefix: a start below it would make etcd scan
        # [start, end) across unrelated prefixes — a cross-prefix leak the
        # in-memory tier's startswith filter never exhibits.
        start = max(start_key, prefix)
        resp = self._kv.Range(
            epb.RangeRequest(
                key=start.encode(),
                range_end=_prefix_range_end(prefix.encode()),
                limit=limit,
            ),
            timeout=self._timeout,
        )
        return sorted(
            (_to_kv(kv) for kv in resp.kvs if kv.key.decode().startswith(prefix)),
            key=lambda kv: kv.key,
        )

    # -- writes -----------------------------------------------------------

    def max_value_bytes(self):
        return self._max_value_bytes

    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        self.check_value_size(value)
        # Atomic put+read-back in one Txn so a concurrent delete/re-put
        # can't make us return another writer's KeyValue (or crash).
        k = key.encode()
        resp = self._kv.Txn(
            epb.TxnRequest(
                success=[
                    epb.RequestOp(
                        request_put=epb.PutRequest(key=k, value=value, lease=lease)
                    ),
                    epb.RequestOp(request_range=epb.RangeRequest(key=k)),
                ],
            ),
            timeout=self._timeout,
        )
        kvs = resp.responses[1].response_range.kvs
        if not kvs:
            raise RuntimeError(f"etcd txn put of {key!r} returned no kv")
        return _to_kv(kvs[0])

    def delete(self, key: str) -> bool:
        resp = self._kv.DeleteRange(
            epb.DeleteRangeRequest(key=key.encode()), timeout=self._timeout
        )
        return resp.deleted > 0

    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        def req_op(o: Op) -> epb.RequestOp:
            if o.value is None:
                return epb.RequestOp(
                    request_delete_range=epb.DeleteRangeRequest(
                        key=o.key.encode()
                    )
                )
            return epb.RequestOp(
                request_put=epb.PutRequest(
                    key=o.key.encode(), value=o.value, lease=o.lease
                )
            )

        # Append a Range op after each branch's Puts so result KeyValues
        # come from the SAME atomic txn (non-atomic read-back could return
        # an interleaved later writer's value) — matching the
        # InMemoryKV/RemoteKV results contract on both branches.
        on_success = list(on_success)
        on_failure = list(on_failure)

        def branch_ops(ops: list[Op]) -> tuple[list, list[int]]:
            req_ops = [req_op(o) for o in ops]
            read_idx = []
            for o in ops:
                if o.value is not None:
                    read_idx.append(len(req_ops))
                    req_ops.append(
                        epb.RequestOp(
                            request_range=epb.RangeRequest(key=o.key.encode())
                        )
                    )
            return req_ops, read_idx

        succ_ops, succ_reads = branch_ops(on_success)
        fail_ops, fail_reads = branch_ops(on_failure)
        resp = self._kv.Txn(
            epb.TxnRequest(
                compare=[
                    epb.Compare(
                        result=epb.Compare.EQUAL,
                        target=epb.Compare.VERSION,
                        key=c.key.encode(),
                        version=c.version,
                    )
                    for c in compares
                ],
                success=succ_ops,
                failure=fail_ops,
            ),
            timeout=self._timeout,
        )
        read_idx = succ_reads if resp.succeeded else fail_reads
        results: list[KeyValue] = []
        for i in read_idx:
            kvs = resp.responses[i].response_range.kvs
            if kvs:
                results.append(_to_kv(kvs[0]))
        return resp.succeeded, results

    # -- watch ------------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        """Watch with a created-ack barrier and lossless auto-resubscribe
        from the last delivered revision (same guarantees as RemoteKV)."""
        p = prefix.encode()
        handle = _EtcdWatch(None)
        created = threading.Event()
        state = {"next_rev": (start_rev + 1) if start_rev is not None else 0}
        # Live key set under the prefix, for compaction resync: when etcd
        # cancels the watch because next_rev was compacted, we re-list and
        # must synthesize DELETEs for keys that vanished inside the gap.
        try:
            state["keys_seen"] = {kv.key for kv in self.range(prefix)}
        except grpc.RpcError:
            state["keys_seen"] = set()

        def resync() -> None:
            """Re-list the prefix; deliver synthesized DELETE+PUT events and
            jump next_rev past the compaction (etcd client-go reflector
            relist-and-rewatch semantics)."""
            resp = self._kv.Range(
                epb.RangeRequest(key=p, range_end=_prefix_range_end(p)),
                timeout=self._timeout,
            )
            current = {m.key.decode(): _to_kv(m) for m in resp.kvs}
            rev = resp.header.revision
            events = [
                WatchEvent(
                    type=EventType.DELETE,
                    kv=KeyValue(
                        key=k, value=b"", create_rev=0, mod_rev=rev, version=0
                    ),
                )
                for k in sorted(state["keys_seen"] - set(current))
            ] + [
                WatchEvent(type=EventType.PUT, kv=current[k])
                for k in sorted(current)
            ]
            state["keys_seen"] = set(current)
            state["next_rev"] = rev + 1
            if events:
                try:
                    callback(events)
                except Exception:  # noqa: BLE001
                    log.exception("etcd resync callback failed")

        def open_stream():
            create = epb.WatchCreateRequest(
                key=p,
                range_end=_prefix_range_end(p),
                start_revision=state["next_rev"],
                # Fragmentation opt-in: a registry-scale event batch (mass
                # txn / lease-revoke sweep) can exceed the gRPC message cap;
                # fragments are reassembled below before delivery so resume
                # fencing still sees whole revisions.
                fragment=True,
                # Progress ticks advance next_rev while idle, so a long-idle
                # watch resubscribes near the head instead of tripping the
                # compaction floor and forcing a full re-list.
                progress_notify=True,
            )
            req_q: "queue.Queue" = queue.Queue()
            req_q.put(
                epb.WatchRequest(create_request=create).SerializeToString()
            )

            def req_iter():
                while True:
                    item = req_q.get()
                    if item is None:
                        return
                    yield item

            call = self._channel.stream_stream(
                _WATCH_METHOD,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )(req_iter())
            handle._call = call
            return call, req_q

        def pump():
            backoff = 0.1
            while not handle.cancelled.is_set():
                req_q = None
                # Partial fragmented batch per stream: reset on reopen —
                # next_rev was not advanced for it, so it replays whole.
                frag_buf: list = []
                try:
                    call, req_q = open_stream()
                    for resp_bytes in call:
                        if handle.cancelled.is_set():
                            return
                        resp = epb.WatchResponse.FromString(resp_bytes)
                        if resp.created:
                            created.set()
                            backoff = 0.1
                        if resp.fragment:
                            frag_buf.extend(resp.events)
                            continue
                        if (
                            not resp.events
                            and not resp.created
                            and not resp.canceled
                            and not frag_buf
                        ):
                            # Progress notification: everything up to
                            # header.revision has been delivered to this
                            # watch. (Skipped mid-fragment-batch: the
                            # batch's revision is not fully delivered yet.)
                            state["next_rev"] = max(
                                state["next_rev"], resp.header.revision + 1
                            )
                            continue
                        if resp.canceled:
                            # etcd cancels a watch whose start_revision was
                            # compacted (compact_revision > 0) — without
                            # handling this, resubscribing at the same
                            # revision is cancelled again forever and the
                            # view silently goes stale.
                            if resp.compact_revision > 0:
                                log.warning(
                                    "etcd watch on %r compacted at rev %d "
                                    "(wanted %d); re-listing",
                                    prefix, resp.compact_revision,
                                    state["next_rev"],
                                )
                                resync()
                            else:
                                log.warning(
                                    "etcd watch on %r canceled by server; "
                                    "resubscribing from rev %d",
                                    prefix, state["next_rev"],
                                )
                            break  # reopen the stream at next_rev
                        # Reassembled batch: buffered fragments + final resp.
                        batch = frag_buf + list(resp.events)
                        frag_buf = []
                        events = [
                            WatchEvent(
                                type=(
                                    EventType.DELETE
                                    if ev.type == epb.MvccEvent.DELETE
                                    else EventType.PUT
                                ),
                                kv=_to_kv(ev.kv),
                            )
                            for ev in batch
                        ]
                        if events:
                            for ev in events:
                                if ev.type is EventType.DELETE:
                                    state["keys_seen"].discard(ev.kv.key)
                                else:
                                    state["keys_seen"].add(ev.kv.key)
                            state["next_rev"] = max(
                                state["next_rev"],
                                max(ev.kv.mod_rev for ev in events) + 1,
                            )
                            try:
                                callback(events)
                            except Exception:  # noqa: BLE001
                                log.exception("etcd watch callback failed")
                except grpc.RpcError:
                    pass
                finally:
                    if req_q is not None:
                        req_q.put(None)
                if handle.cancelled.is_set():
                    return
                log.warning(
                    "etcd watch for %r interrupted; resubscribing from rev %d",
                    prefix, state["next_rev"],
                )
                if handle.cancelled.wait(backoff):
                    return
                backoff = min(backoff * 2, 5.0)

        threading.Thread(
            target=pump, name=f"etcd-watch-{prefix}", daemon=True
        ).start()
        if not created.wait(10.0):  #: wall-clock: bounds a REAL etcd watch subscribe ack; wire latency is physical time
            log.warning("etcd watch on %r: no created ack within 10s", prefix)
        self._watches.append(handle)
        return handle

    # -- leases -----------------------------------------------------------

    def lease_grant(self, ttl_s: float) -> int:
        resp = self._lease.LeaseGrant(
            epb.LeaseGrantRequest(TTL=max(1, int(round(ttl_s)))),
            timeout=self._timeout,
        )
        return resp.ID

    def lease_keepalive(self, lease_id: int) -> bool:
        req = epb.LeaseKeepAliveRequest(ID=lease_id).SerializeToString()
        call = self._channel.stream_stream(
            _KEEPALIVE_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b,
        )(iter([req]))
        try:
            for resp_bytes in call:
                resp = epb.LeaseKeepAliveResponse.FromString(resp_bytes)
                return resp.TTL > 0
        except grpc.RpcError:
            return False
        finally:
            # Don't leave the bidi RPC to garbage collection.
            call.cancel()
        return False

    def lease_revoke(self, lease_id: int) -> None:
        try:
            self._lease.LeaseRevoke(
                epb.LeaseRevokeRequest(ID=lease_id), timeout=self._timeout
            )
        except grpc.RpcError:
            pass

    def retarget(self, target: str, tls=None) -> None:
        """Repoint this client at a different etcd endpoint — e.g. after
        a server restart came back on a fresh port (rebinding a released
        port races every other process on the host for it). Unary stubs
        are rebuilt immediately; live watch pumps read ``self._channel``
        fresh on every (re)subscribe, so they follow the swap at their
        next reconnect without losing their revision cursor, and lease
        keepalives build their stream per call. The old channel is
        closed, which also kicks any pump still blocked on it."""
        from modelmesh_tpu_torch.serving.tls import secure_channel

        old = self._channel
        self._channel = secure_channel(target, tls)
        self._kv = grpc_defs.make_stub(self._channel, _KV_SERVICE, _KV_METHODS)
        self._lease = grpc_defs.make_stub(
            self._channel, _LEASE_SERVICE, _LEASE_METHODS
        )
        old.close()

    def close(self) -> None:
        for w in self._watches:
            w.cancel()
        self._channel.close()
