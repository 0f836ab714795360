"""The port's own copy of the JAX package's ``kv/service.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

MeshKV: the coordination store served over gRPC + its client.

Server side wraps any local KVStore (normally InMemoryKV) and exposes it on
the network; ``RemoteKV`` implements the same KVStore interface over the
wire, so a fleet of separate instance PROCESSES (the reference's
forked-JVM cluster-test tier, AbstractModelMeshClusterTest) shares one
coordination store with full watch/lease semantics — no etcd binary needed.
Production swaps in the etcd backend (kv/etcd.py); both sit behind the same
KVStore interface.

Run standalone:  python -m modelmesh_tpu_torch.kv.service --port 2379
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
from concurrent import futures
from typing import Iterable, Optional

import grpc

from modelmesh_tpu_torch.utils.grpcopts import max_message_bytes, message_size_options
from modelmesh_tpu_torch.kv.memory import InMemoryKV
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
from modelmesh_tpu_torch.proto import mesh_kv_pb2 as kpb
from modelmesh_tpu_torch.runtime import grpc_defs

log = logging.getLogger(__name__)

KV_SERVICE = "mmtpu.kv.MeshKV"
KV_METHODS = {
    "Get": (kpb.GetRequest, kpb.GetResponse),
    "RangePrefix": (kpb.RangeRequest, kpb.RangeResponse),
    "Put": (kpb.PutRequest, kpb.PutResponse),
    "Delete": (kpb.DeleteRequest, kpb.DeleteResponse),
    "Txn": (kpb.TxnRequest, kpb.TxnResponse),
    "LeaseGrant": (kpb.LeaseGrantRequest, kpb.LeaseGrantResponse),
    "LeaseKeepalive": (kpb.LeaseKeepaliveRequest, kpb.LeaseKeepaliveResponse),
    "LeaseRevoke": (kpb.LeaseRevokeRequest, kpb.LeaseRevokeResponse),
}
WATCH_METHOD = f"/{KV_SERVICE}/Watch"


def _to_proto(kv: KeyValue) -> kpb.KeyValue:
    return kpb.KeyValue(
        key=kv.key, value=kv.value, create_rev=kv.create_rev,
        mod_rev=kv.mod_rev, version=kv.version, lease=kv.lease,
    )


def _from_proto(p: kpb.KeyValue) -> KeyValue:
    return KeyValue(
        key=p.key, value=p.value, create_rev=p.create_rev,
        mod_rev=p.mod_rev, version=p.version, lease=p.lease,
    )


class MeshKVServicer:
    def __init__(self, store: KVStore):
        self.store = store

    def Get(self, request, context):
        kv = self.store.get(request.key)
        if kv is None:
            return kpb.GetResponse(found=False)
        return kpb.GetResponse(kv=_to_proto(kv), found=True)

    def RangePrefix(self, request, context):
        if request.start_key or request.limit:
            kvs = self.store.range_from(
                request.prefix,
                request.start_key or request.prefix,
                request.limit or (1 << 31),
            )
        else:
            kvs = self.store.range(request.prefix)
        return kpb.RangeResponse(kvs=[_to_proto(kv) for kv in kvs])

    def Put(self, request, context):
        # Server-side limit enforcement: the client's env may disagree with
        # ours (config skew) — reject with a clear status rather than letting
        # the transport or backing store fail opaquely.
        limit = self.store.max_value_bytes()
        transport = max_message_bytes() - (64 << 10)
        limit = transport if limit is None else min(limit, transport)
        if len(request.value) > limit:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"value of {len(request.value)} bytes exceeds server limit "
                f"{limit} (MM_MAX_MSG_BYTES)",
            )
        try:
            kv = self.store.put(request.key, request.value, request.lease)
        except ValueError as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return kpb.PutResponse(kv=_to_proto(kv))

    def Delete(self, request, context):
        return kpb.DeleteResponse(deleted=self.store.delete(request.key))

    def Txn(self, request, context):
        ok, results = self.store.txn(
            [Compare(c.key, c.version) for c in request.compares],
            [self._op(o) for o in request.on_success],
            [self._op(o) for o in request.on_failure],
        )
        return kpb.TxnResponse(
            succeeded=ok, results=[_to_proto(kv) for kv in results]
        )

    @staticmethod
    def _op(o: kpb.Op) -> Op:
        return Op(
            key=o.key, value=None if o.is_delete else o.value, lease=o.lease
        )

    def watch(self, request_bytes: bytes, context):
        """Server-streaming watch (registered via a generic handler).

        Protocol: the first yielded batch is ALWAYS empty — the "watch
        created" ack. The client blocks on it before returning from
        ``watch()``, closing the register-vs-mutate race. On backlog
        overflow the stream is CLOSED (not silently dropped): the client's
        reconnect logic resubscribes from its last-seen revision, which is
        lossless; dropping batches mid-stream would not be.
        """
        request = kpb.WatchRequest.FromString(request_bytes)
        q: "queue.Queue" = queue.Queue(maxsize=1024)
        overflow = threading.Event()

        def on_events(events):
            try:
                q.put_nowait(events)
            except queue.Full:
                log.warning("watch stream backlogged; closing for resync")
                overflow.set()

        start_rev = None if request.start_rev < 0 else request.start_rev
        resync_batches = None
        floor = getattr(self.store, "compact_rev", 0)
        if start_rev is not None and start_rev < floor:
            # The replay window was compacted: ship the full current state
            # instead and watch from the snapshot revision (atomic — a
            # store that can compact MUST provide snapshot(), otherwise a
            # delete between range() and watch() would be lost silently).
            rev, kvs = self.store.snapshot(request.prefix)
            resync_batches = []
            chunk: list = []
            chunk_bytes = 0
            # Chunk under the message cap: a prefix of large values (e.g.
            # published plans) must not produce one oversized batch that
            # wedges the watch in a permanent resync loop.
            budget = max_message_bytes() // 2
            for kv in kvs:
                ev = kpb.WatchEvent(type=kpb.WatchEvent.PUT, kv=_to_proto(kv))
                sz = ev.ByteSize() + 8
                if chunk and chunk_bytes + sz > budget:
                    resync_batches.append(kpb.WatchBatch(
                        resync=True, resync_rev=rev, events=chunk,
                    ))
                    chunk, chunk_bytes = [], 0
                chunk.append(ev)
                chunk_bytes += sz
            resync_batches.append(kpb.WatchBatch(
                resync=True, resync_rev=rev, resync_end=True, events=chunk,
            ))
            start_rev = rev
        handle = self.store.watch(request.prefix, on_events, start_rev=start_rev)
        try:
            yield kpb.WatchBatch().SerializeToString()  # created ack
            if resync_batches is not None:
                for b in resync_batches:
                    yield b.SerializeToString()
            while context.is_active() and not overflow.is_set():
                try:
                    events = q.get(timeout=0.5)
                except queue.Empty:
                    continue
                batch = kpb.WatchBatch(events=[
                    kpb.WatchEvent(
                        type=(
                            kpb.WatchEvent.DELETE
                            if ev.type is EventType.DELETE
                            else kpb.WatchEvent.PUT
                        ),
                        kv=_to_proto(ev.kv),
                    )
                    for ev in events
                ])
                yield batch.SerializeToString()
        finally:
            handle.cancel()

    def LeaseGrant(self, request, context):
        return kpb.LeaseGrantResponse(
            lease_id=self.store.lease_grant(request.ttl_s)
        )

    def LeaseKeepalive(self, request, context):
        return kpb.LeaseKeepaliveResponse(
            alive=self.store.lease_keepalive(request.lease_id)
        )

    def LeaseRevoke(self, request, context):
        self.store.lease_revoke(request.lease_id)
        return kpb.LeaseRevokeResponse()


class _WatchStreamHandler(grpc.GenericRpcHandler):
    def __init__(self, servicer: MeshKVServicer):
        self._servicer = servicer

    def service(self, handler_call_details):
        if handler_call_details.method != WATCH_METHOD:
            return None
        return grpc.unary_stream_rpc_method_handler(
            self._servicer.watch,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b,
        )


def start_kv_server(
    port: int = 0,
    store: Optional[KVStore] = None,
    max_workers: int = 16,
    bind_host: str = "127.0.0.1",
    tls=None,
) -> tuple[grpc.Server, int, KVStore]:
    """``tls`` (serving.tls.TlsConfig) secures the coordination plane —
    registry records (incl. model_key credential blobs) cross this wire.
    Without it, default to loopback and front with network policy."""
    store = store or InMemoryKV()
    servicer = MeshKVServicer(store)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=message_size_options(),
    )
    grpc_defs.add_servicer(server, servicer, KV_SERVICE, KV_METHODS)
    server.add_generic_rpc_handlers((_WatchStreamHandler(servicer),))
    addr = f"{bind_host}:{port}"
    if tls is not None:
        bound = server.add_secure_port(addr, tls.server_credentials())
    else:
        bound = server.add_insecure_port(addr)
    server.start()
    return server, bound, store


class _RemoteWatch(WatchHandle):
    def __init__(self):
        self.cancelled = threading.Event()
        self._call = None

    def cancel(self) -> None:
        self.cancelled.set()
        if self._call is not None:
            self._call.cancel()


class RemoteKV(KVStore):
    """KVStore over a MeshKV server."""

    def __init__(self, target: str, timeout_s: float = 10.0, tls=None):
        from modelmesh_tpu_torch.serving.tls import secure_channel

        self._channel = secure_channel(target, tls)
        self._stub = grpc_defs.make_stub(self._channel, KV_SERVICE, KV_METHODS)
        # Transport-bound cap (headroom for the proto envelope), fixed at
        # construction so the hot put path doesn't re-read the environment.
        self._max_value_bytes = max_message_bytes() - (64 << 10)
        self._timeout = timeout_s
        self._watches: list[_RemoteWatch] = []
        # Delivery-barrier state (wait_idle). The dict and lock exist
        # from construction — only the barrier watch stream is created
        # lazily (a watch costs a server stream; most clients never
        # call wait_idle) — so two first callers can never each install
        # a fresh dict and orphan the other's sentinel event.
        #: guarded-by: _barrier_lock
        self._barrier_events: dict[str, threading.Event] = {}
        self._barrier_lock = threading.Lock()
        self._barrier_watch: Optional[_RemoteWatch] = None

    def get(self, key: str) -> Optional[KeyValue]:
        resp = self._stub.Get(kpb.GetRequest(key=key), timeout=self._timeout)
        return _from_proto(resp.kv) if resp.found else None

    def range(self, prefix: str) -> list[KeyValue]:
        resp = self._stub.RangePrefix(
            kpb.RangeRequest(prefix=prefix), timeout=self._timeout
        )
        return [_from_proto(kv) for kv in resp.kvs]

    def range_from(self, prefix: str, start_key: str, limit: int):
        resp = self._stub.RangePrefix(
            kpb.RangeRequest(prefix=prefix, start_key=start_key, limit=limit),
            timeout=self._timeout,
        )
        return [_from_proto(kv) for kv in resp.kvs]

    def max_value_bytes(self):
        return self._max_value_bytes

    def put(self, key: str, value: bytes, lease: int = 0) -> KeyValue:
        self.check_value_size(value)
        try:
            resp = self._stub.Put(
                kpb.PutRequest(key=key, value=value, lease=lease),
                timeout=self._timeout,
            )
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.FAILED_PRECONDITION:
                raise ValueError(e.details()) from e
            raise
        return _from_proto(resp.kv)

    def delete(self, key: str) -> bool:
        return self._stub.Delete(
            kpb.DeleteRequest(key=key), timeout=self._timeout
        ).deleted

    def txn(
        self,
        compares: Iterable[Compare],
        on_success: Iterable[Op],
        on_failure: Iterable[Op] = (),
    ) -> tuple[bool, list[KeyValue]]:
        def op(o: Op) -> kpb.Op:
            return kpb.Op(
                key=o.key,
                value=o.value or b"",
                is_delete=o.value is None,
                lease=o.lease,
            )

        resp = self._stub.Txn(
            kpb.TxnRequest(
                compares=[kpb.Compare(key=c.key, version=c.version)
                          for c in compares],
                on_success=[op(o) for o in on_success],
                on_failure=[op(o) for o in on_failure],
            ),
            timeout=self._timeout,
        )
        return resp.succeeded, [_from_proto(kv) for kv in resp.results]

    def watch(
        self,
        prefix: str,
        callback: WatchCallback,
        start_rev: Optional[int] = None,
    ) -> WatchHandle:
        """Subscribe with two durability guarantees the raw stream lacks:

        - Registration barrier: blocks until the server's "created" ack (an
          initial empty batch), so a mutation issued right after watch()
          returns is guaranteed to be observed.
        - Auto-resubscribe: if the stream dies (server restart, network
          blip, server-side backlog close), the pump reconnects from the
          last-seen revision — watch-fed views never go silently stale.
        """
        handle = _RemoteWatch()
        created = threading.Event()
        # Track delivery progress for lossless resubscription, and the live
        # key set so a server-initiated resync can synthesize deletes for
        # keys that vanished inside a compacted replay gap.
        state = {"last_rev": -1 if start_rev is None else start_rev}
        try:
            state["keys_seen"] = {kv.key for kv in self.range(prefix)}
        except grpc.RpcError:
            state["keys_seen"] = set()

        def open_stream():
            req = kpb.WatchRequest(prefix=prefix, start_rev=state["last_rev"])
            call = self._channel.unary_stream(
                WATCH_METHOD,
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )(req.SerializeToString())
            handle._call = call
            return call

        def pump():
            backoff = 0.1
            while not handle.cancelled.is_set():
                try:
                    # A reconnect mid-resync must not leak half a snapshot
                    # into the next stream's resync.
                    state["resync_pending"] = []
                    call = open_stream()
                    first = True
                    for batch_bytes in call:
                        if handle.cancelled.is_set():
                            return
                        if first:
                            first = False
                            created.set()
                            backoff = 0.1
                        batch = kpb.WatchBatch.FromString(batch_bytes)
                        events = [
                            WatchEvent(
                                type=(
                                    EventType.DELETE
                                    if ev.type == kpb.WatchEvent.DELETE
                                    else EventType.PUT
                                ),
                                kv=_from_proto(ev.kv),
                            )
                            for ev in batch.events
                        ]
                        if batch.resync:
                            # Resync state may span several batches (the
                            # server chunks under the message cap): only
                            # after resync_end is the full key set known
                            # and deletes can be synthesized.
                            pending = state.setdefault("resync_pending", [])
                            pending.extend(events)
                            if not batch.resync_end:
                                continue
                            state["resync_pending"] = []
                            events = pending
                            current = {ev.kv.key for ev in events}
                            gone = state["keys_seen"] - current
                            events = [
                                WatchEvent(
                                    type=EventType.DELETE,
                                    kv=KeyValue(
                                        key=k, value=b"", create_rev=0,
                                        mod_rev=batch.resync_rev, version=0,
                                    ),
                                )
                                for k in sorted(gone)
                            ] + events
                            state["keys_seen"] = current
                            state["last_rev"] = max(
                                state["last_rev"], batch.resync_rev
                            )
                            if events:
                                try:
                                    callback(events)
                                except Exception:  # noqa: BLE001
                                    log.exception("watch callback failed")
                            continue
                        for ev in events:
                            if ev.type is EventType.DELETE:
                                state["keys_seen"].discard(ev.kv.key)
                            else:
                                state["keys_seen"].add(ev.kv.key)
                        if events:
                            state["last_rev"] = max(
                                state["last_rev"],
                                max(ev.kv.mod_rev for ev in events),
                            )
                            try:
                                callback(events)
                            except Exception:  # noqa: BLE001
                                log.exception("watch callback failed")
                except grpc.RpcError:
                    pass
                if handle.cancelled.is_set():
                    return
                log.warning(
                    "watch stream for %r interrupted; resubscribing from "
                    "rev %d", prefix, state["last_rev"],
                )
                # After the first successful subscribe, reconnects must
                # replay from last_rev; before it, honor the original mode.
                if created.is_set() and state["last_rev"] < 0:
                    state["last_rev"] = 0
                if handle.cancelled.wait(backoff):
                    return
                backoff = min(backoff * 2, 5.0)

        threading.Thread(target=pump, name=f"kvwatch-{prefix}", daemon=True).start()
        if not created.wait(10.0):  #: wall-clock: bounds a REAL gRPC subscribe ack; wire latency is physical time
            log.warning("watch on %r: no created ack within 10s", prefix)
        self._watches.append(handle)
        return handle

    def lease_grant(self, ttl_s: float) -> int:
        return self._stub.LeaseGrant(
            kpb.LeaseGrantRequest(ttl_s=ttl_s), timeout=self._timeout
        ).lease_id

    def lease_keepalive(self, lease_id: int) -> bool:
        try:
            return self._stub.LeaseKeepalive(
                kpb.LeaseKeepaliveRequest(lease_id=lease_id),
                timeout=self._timeout,
            ).alive
        except grpc.RpcError:
            return False

    def lease_revoke(self, lease_id: int) -> None:
        try:
            self._stub.LeaseRevoke(
                kpb.LeaseRevokeRequest(lease_id=lease_id), timeout=self._timeout
            )
        except grpc.RpcError:
            pass

    def wait_idle(self, timeout: float = 5.0) -> None:
        """Real delivery barrier: write a sentinel under a dedicated watched
        prefix and wait for our own event to arrive. Any event that reached
        the server before the sentinel is delivered before it (per-watch
        FIFO), so earlier watches on this client have seen their events by
        the time this returns (server dispatch is a single ordered queue)."""
        import time as _time
        import uuid as _uuid

        with self._barrier_lock:
            if self._barrier_watch is None:

                def on_barrier(events):
                    with self._barrier_lock:
                        for ev in events:
                            e = self._barrier_events.pop(
                                ev.kv.key.rsplit("/", 1)[-1], None
                            )
                            if e is not None:
                                e.set()

                self._barrier_watch = self.watch("__barrier__/", on_barrier)
        token = _uuid.uuid4().hex  # analysis-ok: det-entropy — one-shot wire barrier token, unique per call by design; never reaches a trace or record
        evt = threading.Event()
        with self._barrier_lock:
            self._barrier_events[token] = evt
        self.put(f"__barrier__/{token}", b"")
        if not evt.wait(timeout):
            raise TimeoutError("kv barrier event did not arrive")
        self.delete(f"__barrier__/{token}")
        # Events for OTHER watches dispatch on their own streams; give their
        # pumps a beat to drain callbacks.
        _time.sleep(0.05)  #: wall-clock: test helper letting real pump threads drain

    def close(self) -> None:
        for w in self._watches:
            w.cancel()
        self._channel.close()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=2379)
    parser.add_argument("--bind-host", default="127.0.0.1")
    parser.add_argument("--tls-cert", default="")
    parser.add_argument("--tls-key", default="")
    parser.add_argument("--tls-ca", default="")
    parser.add_argument("--tls-client-auth", action="store_true")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    tls = None
    if args.tls_cert:
        from modelmesh_tpu_torch.serving.tls import TlsConfig

        tls = TlsConfig.from_files(
            args.tls_cert, args.tls_key, args.tls_ca or None,
            require_client_auth=args.tls_client_auth,
        )
    server, port, _ = start_kv_server(
        args.port, bind_host=args.bind_host, tls=tls
    )
    log.info("mesh kv server on %s:%d (tls=%s)", args.bind_host, port,
             tls is not None)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
