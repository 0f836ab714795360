"""The port's own copy of the JAX package's ``kv/etcd_server.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

etcd v3 wire-compatible coordination server (single node).

Speaks the real etcd gRPC API (etcdserverpb method paths, mvcc field
numbers — protos/etcd_rpc.proto) over the InMemoryKV engine, including the
behaviors a client must survive in production: global revisions, version
CAS via Txn, leases with TTL expiry, watch streams with start_revision
replay, historical MVCC reads (RangeRequest.revision, with the
ErrCompacted/ErrFutureRev contract — unary and txn-nested), and
COMPACTION — a watch whose start_revision predates the compact floor is
canceled with ``compact_revision`` set, exactly the etcd behavior that
forces clients to re-list (kv/etcd.py's resync path).

Two roles:
- The test double for EtcdKV: the CI image carries no etcd binary and has
  zero egress (the reference forks a real etcd per suite,
  AbstractModelMeshTest.java:83-192 — impossible here), so the full KV
  matrix runs EtcdKV against this server over real gRPC instead. The wire
  contract is pinned by the proto's field-number compatibility with the
  public etcd v3 API.
- A deployable single-node coordination store for clusters that want the
  etcd protocol without operating etcd:
      python -m modelmesh_tpu_torch.kv.etcd_server --port 2379

Request options supported: prev_kv on Put/DeleteRange/Txn-put and on
watches, keys_only/count_only ranges, watch filters (NOPUT/NODELETE),
progress-notify (periodic + on-demand WatchProgressRequest, etcd watch_id
-1 convention), and watch fragmentation (WatchCreateRequest.fragment:
oversized event batches split across responses flagged fragment=true on
all but the last, exactly the etcd reassembly contract).
Limitations vs real etcd (documented, deliberate): no raft/replication, no
auth; watch ranges must be whole-prefix or exact-key (all this
framework's clients use).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent import futures
from typing import Optional

import grpc

from modelmesh_tpu_torch.kv.memory import InMemoryKV
from modelmesh_tpu_torch.kv.store import (
    CompactedRevision,
    EventType,
    FutureRevision,
    KeyValue,
)
from modelmesh_tpu_torch.proto import etcd_rpc_pb2 as epb
from modelmesh_tpu_torch.runtime import grpc_defs
from modelmesh_tpu_torch.utils.grpcopts import message_size_options

# Exact etcd error strings — clients (kv/etcd.py resync, real etcd
# clients) match on them; unary and txn-nested paths must agree.
_ERR_COMPACTED = "etcdserver: mvcc: required revision has been compacted"
_ERR_FUTURE_REV = "etcdserver: mvcc: required revision is a future revision"

log = logging.getLogger(__name__)

_KV_SERVICE = "etcdserverpb.KV"
_KV_METHODS = {
    "Range": (epb.RangeRequest, epb.RangeResponse),
    "Put": (epb.PutRequest, epb.PutResponse),
    "DeleteRange": (epb.DeleteRangeRequest, epb.DeleteRangeResponse),
    "Txn": (epb.TxnRequest, epb.TxnResponse),
    "Compact": (epb.CompactionRequest, epb.CompactionResponse),
}
_LEASE_SERVICE = "etcdserverpb.Lease"
_LEASE_METHODS = {
    "LeaseGrant": (epb.LeaseGrantRequest, epb.LeaseGrantResponse),
    "LeaseRevoke": (epb.LeaseRevokeRequest, epb.LeaseRevokeResponse),
}
_WATCH_METHOD = "/etcdserverpb.Watch/Watch"
_KEEPALIVE_METHOD = "/etcdserverpb.Lease/LeaseKeepAlive"


def _to_mvcc(kv: KeyValue, keys_only: bool = False) -> epb.MvccKeyValue:
    return epb.MvccKeyValue(
        key=kv.key.encode(),
        value=b"" if keys_only else kv.value,
        create_revision=kv.create_rev,
        mod_revision=kv.mod_rev,
        version=kv.version,
        lease=kv.lease,
    )


class EtcdLiteServicer:
    """etcdserverpb.KV + Lease unary methods over InMemoryKV.

    ``progress_interval_s`` is the periodic progress-notify cadence for
    watches created with progress_notify (etcd defaults to ~10 min; tests
    shrink it). ``fragment_bytes`` caps the serialized event payload per
    WatchResponse for fragment-enabled watches (etcd uses its max request
    bytes; shrunk in tests to force multi-fragment batches)."""

    def __init__(
        self,
        store: Optional[InMemoryKV] = None,
        progress_interval_s: float = 600.0,
        fragment_bytes: int = 2 << 20,
    ):
        self.store = store or InMemoryKV()
        self.progress_interval_s = progress_interval_s
        self.fragment_bytes = fragment_bytes

    def _header(self) -> epb.ResponseHeader:
        return epb.ResponseHeader(revision=self.store.revision)

    # -- KV -----------------------------------------------------------------

    def _range_response(self, req: epb.RangeRequest) -> epb.RangeResponse:
        """Snapshot kvs + revision atomically under the store lock, then
        serialize OUTSIDE it: header.revision must be the revision the kvs
        reflect (EtcdKV's compaction resync resumes its watch from
        header.revision and would lose a write landing between an unlocked
        range and header read), but protobuf construction for a large range
        must not stall every put/lease-sweep/watch behind the lock. etcd
        contract: ``count`` is the TOTAL in-range key count regardless of
        limit (clients paginate on it); ``more`` flags truncation. Callers
        may hold the (reentrant) lock already — the Txn branch does."""
        with self.store.locked():
            if req.revision > 0:
                # Historical MVCC read (etcd RangeRequest.revision):
                # reconstructed from the watch-replay history, valid down
                # to the same compaction floor watches resume from.
                kvs = self.store.range_interval_at(
                    req.key.decode(),
                    req.range_end.decode() if req.range_end else "",
                    req.revision,
                )
            else:
                kvs = self._range_locked(
                    req.key.decode(),
                    req.range_end.decode() if req.range_end else "",
                )
            total = len(kvs)
            if req.count_only:
                kvs = []
            elif req.limit > 0:  # etcd: limit <= 0 means unlimited
                kvs = kvs[: req.limit]
            revision = self.store.revision
        # Protobuf construction happens OUTSIDE the lock — a large range
        # (full registry scan) must not stall every put/lease-sweep/watch
        # behind message serialization.
        return epb.RangeResponse(
            header=epb.ResponseHeader(revision=revision),
            kvs=[_to_mvcc(kv, keys_only=req.keys_only) for kv in kvs],
            count=total,
            more=(not req.count_only) and total > len(kvs),
        )

    def Range(self, request, context):
        try:
            return self._range_response(request)
        except CompactedRevision:
            # etcd ErrCompacted wire behavior: OUT_OF_RANGE + this message.
            context.abort(grpc.StatusCode.OUT_OF_RANGE, _ERR_COMPACTED)
        except FutureRevision:
            context.abort(grpc.StatusCode.OUT_OF_RANGE, _ERR_FUTURE_REV)

    def Put(self, request, context):
        prev = None
        try:
            # prev_kv: read-then-put under the (reentrant) store lock so
            # the returned pair is exactly what this put replaced.
            with self.store.locked():
                if request.prev_kv:
                    prev = self.store.get_locked(request.key.decode())
                written = self.store.put_locked(
                    request.key.decode(), request.value, request.lease
                )
        except ValueError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        # header.revision must be THIS put's revision (etcd contract —
        # clients fence on it), not whatever the store moved to since.
        resp = epb.PutResponse(
            header=epb.ResponseHeader(revision=written.mod_rev)
        )
        if prev is not None:
            resp.prev_kv.CopyFrom(_to_mvcc(prev))
        return resp

    def _delete_range_response(
        self, req: epb.DeleteRangeRequest
    ) -> epb.DeleteRangeResponse:
        """List + delete under one store lock: etcd's DeleteRange is atomic —
        a key re-put mid-operation must not be deleted, a key created
        in-range mid-operation must not survive. Shared by the unary RPC
        and the Txn branch (reentrant lock)."""
        # batch(): all deletions share ONE revision, like etcd's atomic
        # DeleteRange (it also holds the store lock for the atomicity).
        with self.store.batch():
            victims = self._range_locked(
                req.key.decode(),
                req.range_end.decode() if req.range_end else "",
            )
            deleted = sum(
                1 for kv in victims if self.store.delete_locked(kv.key)
            )
            revision = self.store.revision
        # Proto construction OUTSIDE the lock (same rule as
        # _range_response): a registry-scale prefix delete with prev_kv
        # must not stall every put/lease-sweep/watch behind serialization.
        # (Txn-nested calls still run inside the txn's outer batch —
        # unavoidable; the unary path is the high-volume one.)
        resp = epb.DeleteRangeResponse(
            header=epb.ResponseHeader(revision=revision), deleted=deleted
        )
        if req.prev_kv:
            resp.prev_kvs.extend(_to_mvcc(kv) for kv in victims)
        return resp

    def DeleteRange(self, request, context):
        return self._delete_range_response(request)

    def Txn(self, request, context):
        # One native txn when the guard set maps to the KVStore Compare
        # shape (version EQUAL) — that covers every client in this repo;
        # other targets evaluated under the same store lock. batch():
        # every write op of the txn shares ONE revision (etcd semantics).
        with self.store.batch():
            ok = all(self._compare(c) for c in request.compare)
            branch = request.success if ok else request.failure
            # Validate before applying ANY op: a put against a dead lease
            # or an unreadable nested historical range must fail the whole
            # txn atomically, not halfway through (etcd's applier checks
            # txn request ranges before applying). Historical reads are
            # EXECUTED here too: their result is independent of this txn's
            # own writes (those land at a higher revision), and applying a
            # write first could advance the compaction floor via the
            # history-cap trim, invalidating a revision validation passed.
            hist_responses: dict[int, epb.RangeResponse] = {}
            for i, op in enumerate(branch):
                if op.HasField("request_put") and op.request_put.lease:
                    if not self.store.lease_exists(op.request_put.lease):
                        context.abort(
                            grpc.StatusCode.FAILED_PRECONDITION,
                            f"lease {op.request_put.lease} does not exist",
                        )
                if op.HasField("request_range") and (
                    op.request_range.revision > 0
                ):
                    try:
                        hist_responses[i] = self._range_response(
                            op.request_range
                        )
                    except CompactedRevision:
                        context.abort(
                            grpc.StatusCode.OUT_OF_RANGE, _ERR_COMPACTED
                        )
                    except FutureRevision:
                        context.abort(
                            grpc.StatusCode.OUT_OF_RANGE, _ERR_FUTURE_REV
                        )
            responses = []
            for i, op in enumerate(branch):
                if op.HasField("request_put"):
                    prev = (
                        self.store.get_locked(op.request_put.key.decode())
                        if op.request_put.prev_kv else None
                    )
                    self.store.put_locked(
                        op.request_put.key.decode(),
                        op.request_put.value,
                        op.request_put.lease,
                    )
                    pr = epb.PutResponse(header=self._header())
                    if prev is not None:
                        pr.prev_kv.CopyFrom(_to_mvcc(prev))
                    responses.append(epb.ResponseOp(response_put=pr))
                elif op.HasField("request_delete_range"):
                    responses.append(
                        epb.ResponseOp(
                            response_delete_range=self._delete_range_response(
                                op.request_delete_range
                            )
                        )
                    )
                elif op.HasField("request_range"):
                    rr = (
                        hist_responses[i]
                        if i in hist_responses
                        else self._range_response(op.request_range)
                    )
                    responses.append(epb.ResponseOp(response_range=rr))
            return epb.TxnResponse(
                header=self._header(), succeeded=ok, responses=responses
            )

    def _range_locked(self, start: str, end: str) -> list[KeyValue]:
        # Caller holds the store RLock (reentrant), so the public interval
        # scan is safe to reuse here.
        return self.store.range_interval(start, end)

    def _compare(self, c: epb.Compare) -> bool:
        """etcd Compare: each target reads its OWN wire field
        (version=4, create_revision=5, mod_revision=6, value=7).
        Caller holds the store lock."""
        kv = self.store.get_locked(c.key.decode())
        if c.target == epb.Compare.VERSION:
            actual, expected = (kv.version if kv else 0), c.version
        elif c.target == epb.Compare.CREATE:
            actual, expected = (kv.create_rev if kv else 0), c.create_revision
        elif c.target == epb.Compare.MOD:
            actual, expected = (kv.mod_rev if kv else 0), c.mod_revision
        else:  # VALUE — byte compare
            actual, expected = (kv.value if kv else b""), c.value
        if c.result == epb.Compare.EQUAL:
            return actual == expected
        if c.result == epb.Compare.NOT_EQUAL:
            return actual != expected
        if c.result == epb.Compare.GREATER:
            return actual > expected
        return actual < expected

    def Compact(self, request, context):
        self.store.compact(request.revision)
        return epb.CompactionResponse(header=self._header())

    # -- Lease --------------------------------------------------------------

    def LeaseGrant(self, request, context):
        ttl = max(1, request.TTL)
        lease_id = self.store.lease_grant(float(ttl))
        return epb.LeaseGrantResponse(
            header=self._header(), ID=lease_id, TTL=ttl
        )

    def LeaseRevoke(self, request, context):
        self.store.lease_revoke(request.ID)
        return epb.LeaseRevokeResponse(header=self._header())

    # -- streams (raw-bytes handlers) ---------------------------------------

    def watch_stream(self, request_iterator, context):
        """Bidi Watch: one stream, sequential create/cancel requests.

        Replays from start_revision via the store history; a start_revision
        at or below the compact floor is answered created+canceled with
        ``compact_revision`` (the etcd ErrCompacted contract)."""
        out_q: "queue.Queue" = queue.Queue(maxsize=1024)
        handles: dict[int, object] = {}
        progress_ids: set[int] = set()
        # Guards progress_ids: mutated by the reader (create/cancel) and
        # snapshotted by progress emissions on the ticker/dispatcher.
        progress_lock = threading.Lock()
        next_watch_id = [0]
        closed = threading.Event()

        def reader():
            try:
                for req_bytes in request_iterator:
                    req = epb.WatchRequest.FromString(req_bytes)
                    if req.HasField("create_request"):
                        self._watch_create(req.create_request, out_q, handles,
                                           next_watch_id, progress_ids,
                                           progress_lock)
                    elif req.HasField("cancel_request"):
                        h = handles.pop(req.cancel_request.watch_id, None)
                        with progress_lock:
                            progress_ids.discard(req.cancel_request.watch_id)
                        if h is not None:
                            h.cancel()
                        out_q.put(
                            epb.WatchResponse(
                                header=self._header(),
                                watch_id=req.cancel_request.watch_id,
                                canceled=True,
                            )
                        )
                    elif req.HasField("progress_request"):
                        # On-demand progress: one response with watch_id -1
                        # (the etcd manual RequestProgress convention).
                        # Routed through the dispatcher barrier so the
                        # advertised revision can never overtake events
                        # still queued for this stream's watches.
                        def answer(rev):
                            try:
                                out_q.put_nowait(epb.WatchResponse(
                                    header=epb.ResponseHeader(revision=rev),
                                    watch_id=-1,
                                ))
                            except queue.Full:
                                pass  # backlogged: events matter more
                        self.store.dispatch_barrier(answer)
            except Exception:  # noqa: BLE001 — stream torn down
                pass
            finally:
                closed.set()
                out_q.put(None)

        def progress_ticker():
            # Periodic progress-notify for watches that asked for it: an
            # empty response whose header carries the current revision, so
            # an idle watcher can bound the staleness of its view. Emitted
            # via the store's dispatcher barrier: a tick enqueued at
            # revision R runs only after every event up to R has been
            # delivered, so the client's next_rev advance on a tick can
            # never skip an undelivered event (etcd synced-watcher rule).
            def emit(rev):
                with progress_lock:
                    ids = sorted(progress_ids)
                hdr = epb.ResponseHeader(revision=rev)
                for wid in ids:
                    if wid in handles:
                        try:
                            out_q.put_nowait(
                                epb.WatchResponse(header=hdr, watch_id=wid)
                            )
                        except queue.Full:
                            pass  # backlogged: events matter more

            while not closed.wait(self.progress_interval_s):
                self.store.dispatch_barrier(emit)

        threading.Thread(target=reader, daemon=True).start()
        threading.Thread(target=progress_ticker, daemon=True).start()
        try:
            while context.is_active():
                resp = out_q.get()
                if resp is None:
                    return
                yield resp.SerializeToString()
        finally:
            closed.set()
            for h in handles.values():
                h.cancel()

    def _watch_create(
        self, create, out_q, handles, next_watch_id, progress_ids,
        progress_lock,
    ) -> None:
        watch_id = next_watch_id[0]
        next_watch_id[0] += 1
        start = create.start_revision
        prefix = create.key.decode()
        exact = not create.range_end  # etcd: empty range_end = single key
        # Server-side event filters + prev_kv attachment (etcd
        # WatchCreateRequest fields 5/6).
        drop_puts = epb.WatchCreateRequest.NOPUT in create.filters
        drop_deletes = epb.WatchCreateRequest.NODELETE in create.filters
        want_prev = create.prev_kv
        fragment = create.fragment

        def to_event(ev) -> epb.MvccEvent:
            out = epb.MvccEvent(
                type=(
                    epb.MvccEvent.DELETE
                    if ev.type is EventType.DELETE
                    else epb.MvccEvent.PUT
                ),
                kv=_to_mvcc(ev.kv),
            )
            if want_prev and ev.prev is not None:
                out.prev_kv.CopyFrom(_to_mvcc(ev.prev))
            return out

        def on_events(events):
            if exact:
                events = [ev for ev in events if ev.kv.key == prefix]
            if drop_puts or drop_deletes:
                events = [
                    ev for ev in events
                    if not (
                        drop_deletes
                        if ev.type is EventType.DELETE else drop_puts
                    )
                ]
            if not events:
                return
            try:
                for resp in self._event_responses(
                    watch_id, [to_event(ev) for ev in events], fragment
                ):
                    out_q.put_nowait(resp)
            except queue.Full:
                # NEVER block here: this runs on the store's single
                # dispatcher thread — a blocking put on the full queue
                # would freeze event delivery for every watcher of the
                # store. Cancel and best-effort notify.
                log.warning("etcd-lite watch backlogged; canceling %d", watch_id)
                h = handles.pop(watch_id, None)
                with progress_lock:
                    progress_ids.discard(watch_id)
                if h is not None:
                    h.cancel()
                cancel_resp = epb.WatchResponse(
                    header=self._header(), watch_id=watch_id, canceled=True,
                )
                # The cancel notice MUST reach the client or its pump waits
                # forever on a dead watch. Make room by dropping queued
                # events (the watch is canceled; the client re-lists anyway)
                # — never block: this runs on the store's one dispatcher.
                while True:
                    try:
                        out_q.put_nowait(cancel_resp)
                        break
                    except queue.Full:
                        try:
                            out_q.get_nowait()
                        except queue.Empty:
                            continue

        # Floor check + registration must be ATOMIC: a compaction (or
        # history-cap trim) between reading compact_rev and registering
        # would route the watch into InMemoryKV's PUT-only full-state
        # fallback with no canceled+compact_revision response — a silently
        # stale watch view. The store lock is reentrant, so store.watch()
        # is safe to call inside it.
        with self.store.locked():
            floor = self.store.compact_rev
            if 0 < start <= floor:
                handle = None
            else:
                handle = self.store.watch(
                    prefix, on_events,
                    start_rev=(start - 1) if start > 0 else None,
                )
        if handle is None:
            out_q.put(epb.WatchResponse(
                header=self._header(), watch_id=watch_id, created=True,
            ))
            out_q.put(epb.WatchResponse(
                header=self._header(), watch_id=watch_id, canceled=True,
                compact_revision=floor + 1,
            ))
            return
        handles[watch_id] = handle
        if create.progress_notify:
            # Become progress-eligible only once SYNCED: the eligibility
            # add rides a dispatcher barrier enqueued after store.watch()
            # queued this watch's replay, so it lands behind those events.
            # A tick barrier already sitting in the dispatcher queue
            # (enqueued before this create on a long-lived multiplexed
            # stream) therefore cannot advertise a revision ahead of the
            # replay — the synced-watcher guarantee holds for replays too.
            def mark_synced(_rev, wid=watch_id):
                if wid in handles:  # skip if canceled meanwhile
                    with progress_lock:
                        progress_ids.add(wid)

            self.store.dispatch_barrier(mark_synced)
        out_q.put(epb.WatchResponse(
            header=self._header(), watch_id=watch_id, created=True,
        ))

    def _event_responses(self, watch_id, mvcc_events, fragment):
        """One WatchResponse per batch — or, for fragment-enabled watches
        whose batch exceeds ``fragment_bytes``, several with fragment=true
        on all but the last (the etcd reassembly contract). The header is
        computed once so every fragment of a batch carries one revision."""
        header = self._header()
        if not fragment:
            return [epb.WatchResponse(
                header=header, watch_id=watch_id, events=mvcc_events,
            )]
        chunks, cur, cur_bytes = [], [], 0
        for ev in mvcc_events:
            sz = ev.ByteSize()
            if cur and cur_bytes + sz > self.fragment_bytes:
                chunks.append(cur)
                cur, cur_bytes = [], 0
            cur.append(ev)
            cur_bytes += sz
        chunks.append(cur)
        return [
            epb.WatchResponse(
                header=header, watch_id=watch_id, events=chunk,
                fragment=(i < len(chunks) - 1),
            )
            for i, chunk in enumerate(chunks)
        ]

    def keepalive_stream(self, request_iterator, context):
        for req_bytes in request_iterator:
            req = epb.LeaseKeepAliveRequest.FromString(req_bytes)
            alive = self.store.lease_keepalive(req.ID)
            ttl = int(self.store.lease_ttl(req.ID) or 0) if alive else 0
            yield epb.LeaseKeepAliveResponse(
                header=self._header(), ID=req.ID, TTL=ttl
            ).SerializeToString()


class _StreamHandler(grpc.GenericRpcHandler):
    def __init__(self, servicer: EtcdLiteServicer):
        self._servicer = servicer

    def service(self, handler_call_details):
        if handler_call_details.method == _WATCH_METHOD:
            return grpc.stream_stream_rpc_method_handler(
                self._servicer.watch_stream,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
        if handler_call_details.method == _KEEPALIVE_METHOD:
            return grpc.stream_stream_rpc_method_handler(
                self._servicer.keepalive_stream,
                request_deserializer=lambda b: b,
                response_serializer=lambda b: b,
            )
        return None


def start_etcd_server(
    port: int = 0,
    store: Optional[InMemoryKV] = None,
    max_workers: int = 16,
    bind_host: str = "127.0.0.1",
    tls=None,
    progress_interval_s: float = 600.0,
    fragment_bytes: int = 2 << 20,
) -> tuple[grpc.Server, int, InMemoryKV]:
    servicer = EtcdLiteServicer(
        store,
        progress_interval_s=progress_interval_s,
        fragment_bytes=fragment_bytes,
    )
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=message_size_options(),
    )
    grpc_defs.add_servicer(server, servicer, _KV_SERVICE, _KV_METHODS)
    grpc_defs.add_servicer(server, servicer, _LEASE_SERVICE, _LEASE_METHODS)
    server.add_generic_rpc_handlers((_StreamHandler(servicer),))
    addr = f"{bind_host}:{port}"
    if tls is not None:
        bound = server.add_secure_port(addr, tls.server_credentials())
    else:
        bound = server.add_insecure_port(addr)
    server.start()
    return server, bound, servicer.store


def main() -> None:
    import argparse
    import signal
    import threading as _threading

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=2379)
    parser.add_argument("--bind-host", default="127.0.0.1")
    parser.add_argument("--tls-cert", default="")
    parser.add_argument("--tls-key", default="")
    parser.add_argument("--tls-ca", default="")
    parser.add_argument("--tls-client-auth", action="store_true")
    args = parser.parse_args()
    logging.basicConfig(level="INFO")
    tls = None
    if args.tls_cert:
        from modelmesh_tpu_torch.serving.tls import TlsConfig

        tls = TlsConfig.from_files(
            args.tls_cert, args.tls_key, args.tls_ca or None,
            require_client_auth=args.tls_client_auth,
        )
    server, port, _ = start_etcd_server(
        port=args.port, bind_host=args.bind_host, tls=tls
    )
    print(f"READY {args.bind_host}:{port}", flush=True)
    stop = _threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.stop(1.0)


if __name__ == "__main__":
    main()
