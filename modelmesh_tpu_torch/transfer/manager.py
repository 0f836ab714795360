"""The port's own copy of the JAX package's ``transfer/manager.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Per-instance weight-transfer manager: source resolution + streaming.

Receiver side (``load_weights``, called from the loading pool in place of
a bare ``loader.load``): resolve a ``WeightSource`` for the copy being
materialized —

1. **host tier** — this instance demoted the model earlier (or cached a
   snapshot while serving peers); re-warm is a host->device copy.
2. **live peer** — the registry shows a LOADED copy on a live instance
   (or a host-tier holder advertised in ``host_instances``): stream
   chunked weights over the mesh-internal FetchWeights channel.
3. **wait-for-pending** — no copy exists yet but a STRICTLY OLDER
   loading claim is in flight on a live peer (the flash-crowd shape:
   N-1 receivers arrive while copy #1 is still loading from the store).
   Wait bounded for that load to land, then stream from it — this is
   what turns time-to-N-copies from N store loads into ~one store load
   plus transfers.
4. **store** — the fallback for everything: streaming-incapable
   loaders, no source, peer death or stream error mid-transfer,
   truncated/mismatched streams.

Sender side (``handle_fetch``): serve chunk-indexed fetches from a
``TransferSnapshot`` in the host tier, exporting a loaded copy into the
tier on first demand — N receivers share ONE host-resident snapshot
(O(1) host caching). Snapshots too large for the host budget are not
served (the receiver falls back to the store) so sender RAM stays
strictly bounded by ``MM_HOST_TIER_BYTES``.

Serve-before-fully-loaded: for layer-streamable families
(models/families.py) the loader's ``partial_ready`` callback trips the
entry's PARTIAL phase via the owning instance, which promotes the copy
into the registry so it is advertised/routable mid-transfer.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from typing import TYPE_CHECKING, Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.observability.metrics import Metric as MX
from modelmesh_tpu_torch.runtime.spi import LoadedModel, ModelInfo, WeightChunk
from modelmesh_tpu_torch.serving.entry import EntryState
from modelmesh_tpu_torch.transfer.protocol import (
    FETCH_NOT_AVAILABLE,
    FetchReply,
    TransferSnapshot,
    TransferUnavailable,
    is_layer_streamable,
    model_fingerprint,
    shard_chunk_indices,
    shard_fingerprint,
    snapshot_reply,
)
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.lockdebug import mm_lock

if TYPE_CHECKING:  # pragma: no cover
    from modelmesh_tpu_torch.serving.entry import CacheEntry
    from modelmesh_tpu_torch.serving.instance import ModelMeshInstance

log = logging.getLogger(__name__)

# Distinct senders tried before falling back to the store.
MAX_PEER_ATTEMPTS = 2
# Upper bound on the wait-for-pending phase when no per-type load stats
# exist yet (with stats the bound is 2x the expected load time).
MAX_PENDING_WAIT_S = 30.0
# Re-check cadence while waiting for a pending peer load to land. The
# registry view is watch-fed, so this is a bounded-staleness poll, not
# the discovery mechanism.
PENDING_POLL_S = 0.05


class TransferConfig:
    """Resolved transfer knobs (utils/envs.py registry). Chunk
    granularity (MM_TRANSFER_CHUNK_BYTES) is read by the exporting
    LOADER, not here — it is a property of the serialization, so the
    env registry is its single source of truth."""

    def __init__(
        self,
        peer_fetch: Optional[bool] = None,
        host_tier_bytes: Optional[int] = None,
    ):
        from modelmesh_tpu_torch.utils import envs

        if peer_fetch is None:
            peer_fetch = envs.get_bool("MM_PEER_FETCH")
        if host_tier_bytes is None:
            host_tier_bytes = envs.get_int("MM_HOST_TIER_BYTES")
        self.peer_fetch = peer_fetch
        self.host_tier_bytes = max(int(host_tier_bytes), 0)


class WeightTransferManager:
    """Owned by one ModelMeshInstance; shares its loader, host tier,
    metrics, views, and peer-fetch transport."""

    # Distinct exported-model locks retained before a wholesale reset
    # (a dedup cache, not a registry — clearing only risks one redundant
    # re-export per concurrent fetcher).
    MAX_EXPORT_LOCKS = 4096

    def __init__(self, instance: "ModelMeshInstance"):
        self.instance = instance
        self.cfg = instance.transfer_config
        self.host_tier = instance.host_tier
        self.metrics = instance.metrics
        # Per-MODEL export locks: N concurrent fetches of one model
        # produce ONE snapshot (the export is an expensive device->host
        # readback), while exports of DIFFERENT models never serialize
        # on each other. The guard only protects the lock map.
        self._export_guard = mm_lock("WeightTransferManager._export_guard")
        #: guarded-by: _export_guard
        self._export_locks: dict[str, object] = {}

    # ------------------------------------------------------------------ #
    # receiver side                                                      #
    # ------------------------------------------------------------------ #

    def load_weights(self, ce: "CacheEntry") -> tuple[LoadedModel, str]:
        """Materialize the copy for ``ce``; returns (loaded, source) with
        source in {"store", "peer", "host"}. Never raises for transfer
        problems — those fall back to the store load, whose own failures
        propagate as usual."""
        inst = self.instance
        model_id, info = ce.model_id, ce.info
        loader = inst.loader
        if not loader.supports_weight_streaming:
            return self._store_load(ce)
        fp = model_fingerprint(info)
        partial_cb = self._partial_callback(ce)

        # 1. host-tier re-warm.
        snap = self.host_tier.get(model_id)
        if snap is not None and snap.fingerprint != fp:
            # Same id, different spec (re-registered model): the demoted
            # bytes are for a model that no longer exists.
            self.drop_host_copy(model_id)
            snap = None
        if snap is not None:
            try:
                t0 = _time.perf_counter()  #: wall-clock: perf_counter transfer-throughput metric
                loaded = loader.load_from_stream(
                    model_id, info, iter(snap.chunks),
                    partial_ready=partial_cb,
                )
                self._record_transfer(
                    model_id, MX.LOAD_FROM_HOST_TIER_COUNT,
                    sum(len(c.payload) for c in snap.chunks),
                    _time.perf_counter() - t0,  #: wall-clock: perf_counter transfer-throughput metric
                )
                return loaded, "host"
            except Exception as e:  # noqa: BLE001 — poisoned snapshot
                log.warning(
                    "host-tier re-warm of %s failed (%s); dropping the "
                    "host copy and falling back", model_id, e,
                )
                self.drop_host_copy(model_id)

        # 2./3. peer fetch (ready sender, or wait for a pending load).
        # One deadline bounds the WHOLE peer phase (including re-waits
        # after a failed sender); attempts bound the stream tries.
        if self.cfg.peer_fetch and inst.peer_fetch_transport is not None:
            deadline = get_clock().monotonic() + self._pending_wait_s(
                model_id
            )
            failed: set[str] = set()
            attempts = 0
            while attempts < MAX_PEER_ATTEMPTS:
                sender = self._resolve_sender(model_id, fp, failed, deadline)
                if sender is None:
                    break
                iid, endpoint = sender
                attempts += 1
                try:
                    return self._stream_from(endpoint, iid, ce, fp, partial_cb)
                except TransferUnavailable as e:
                    inst.flightrec.record(
                        "transfer-fault", model=model_id, sender=iid,
                        fatal=False, error=str(e)[:120],
                    )
                    log.info(
                        "peer %s cannot serve weights for %s; trying the "
                        "next source", iid, model_id,
                    )
                    failed.add(iid)
                except Exception as e:  # noqa: BLE001 — peer death etc.
                    self.metrics.inc(
                        MX.TRANSFER_FALLBACK_COUNT, model_id=model_id
                    )
                    inst.flightrec.record(
                        "transfer-fault", model=model_id, sender=iid,
                        fatal=True, error=str(e)[:120],
                    )
                    log.warning(
                        "peer weight stream of %s from %s failed "
                        "mid-transfer (%s); falling back", model_id, iid, e,
                    )
                    failed.add(iid)

        # 4. store.
        return self._store_load(ce)

    def _store_load(self, ce: "CacheEntry") -> tuple[LoadedModel, str]:
        loaded = self.instance.loader.load(ce.model_id, ce.info)
        self.metrics.inc(MX.LOAD_FROM_STORE_COUNT, model_id=ce.model_id)
        return loaded, "store"

    # ------------------------------------------------------------------ #
    # receiver side: shard loads (sharded placement groups)              #
    # ------------------------------------------------------------------ #

    def load_shard_weights(self, ce: "CacheEntry") -> tuple[LoadedModel, str]:
        """Materialize shard ``ce.shard_index`` of ``ce.shard_count`` for
        a placement-group member. Source order:

        1. **same-shard peer** — a live group member holding OUR shard
           index (drain pre-copy, group re-plan): stream its shard
           snapshot under the shard fingerprint (~total/K bytes).
        2. **full-copy slice** — a live FULL copy (or full host-tier
           snapshot): fetch only the shard's leaf range out of the full
           snapshot. Chunks are leaf-ordered, so the range is one
           contiguous chunk block found by binary-searching the chunk
           index on the ``layer`` field (each probe costs one chunk).
        3. **store** — ``loader.load_shard``, like any other fallback.

        Same no-raise contract as ``load_weights`` for transfer faults."""
        inst = self.instance
        model_id = ce.model_id
        loader = inst.loader
        if (
            not loader.supports_weight_streaming
            or not self.cfg.peer_fetch
            or inst.peer_fetch_transport is None
        ):
            return self._shard_store_load(ce)
        failed: set[str] = set()
        for resolve, stream in (
            (self._same_shard_sender, self._stream_shard_from),
            (self._full_copy_sender, self._stream_shard_slice_from),
        ):
            attempts = 0
            while attempts < MAX_PEER_ATTEMPTS:
                sender = resolve(ce, failed)
                if sender is None:
                    break
                iid, endpoint = sender
                attempts += 1
                try:
                    return stream(endpoint, iid, ce)
                except TransferUnavailable as e:
                    inst.flightrec.record(
                        "transfer-fault", model=model_id, sender=iid,
                        fatal=False, error=str(e)[:120],
                    )
                    failed.add(iid)
                except Exception as e:  # noqa: BLE001 — peer death etc.
                    self.metrics.inc(
                        MX.TRANSFER_FALLBACK_COUNT, model_id=model_id
                    )
                    inst.flightrec.record(
                        "transfer-fault", model=model_id, sender=iid,
                        fatal=True, error=str(e)[:120],
                    )
                    log.warning(
                        "shard stream of %s[%d/%d] from %s failed (%s); "
                        "trying the next source", model_id, ce.shard_index,
                        ce.shard_count, iid, e,
                    )
                    failed.add(iid)
        return self._shard_store_load(ce)

    def _shard_store_load(self, ce: "CacheEntry") -> tuple[LoadedModel, str]:
        loaded = self.instance.loader.load_shard(
            ce.model_id, ce.info, ce.shard_index, ce.shard_count
        )
        self.metrics.inc(MX.LOAD_FROM_STORE_COUNT, model_id=ce.model_id)
        return loaded, "store"

    def _same_shard_sender(
        self, ce: "CacheEntry", exclude: set[str],
    ) -> Optional[tuple[str, str]]:
        """A live group member that HOLDS our shard index (promoted, not
        mid-load). Exists during drain pre-copy and index re-plans."""
        inst = self.instance
        mr = inst.registry_view.get(ce.model_id)
        if mr is None or not getattr(mr, "shard_instances", None):
            return None
        live = self._live_ids()
        ranked = sorted(
            (ts, iid) for iid, ts in mr.instance_ids.items()
            if iid != inst.instance_id and iid not in exclude and iid in live
            and iid not in mr.loading_instances
            and mr.shard_instances.get(iid) == ce.shard_index
        )
        for _, iid in ranked:
            return iid, self._endpoint_for(iid)
        return None

    def _full_copy_sender(
        self, ce: "CacheEntry", exclude: set[str],
    ) -> Optional[tuple[str, str]]:
        return self._ready_sender(
            ce.model_id, model_fingerprint(ce.info), exclude
        )

    def _stream_shard_from(
        self, endpoint: str, sender_iid: str, ce: "CacheEntry",
    ) -> tuple[LoadedModel, str]:
        """Stream OUR shard from a same-shard holder (its snapshot is
        exported under the shard fingerprint and carries exactly the
        shard's leaf range)."""
        inst = self.instance
        model_id, info = ce.model_id, ce.info
        sfp = shard_fingerprint(info, ce.shard_index, ce.shard_count)
        with inst.tracer.span(
            "peer-stream", model=model_id, sender=sender_iid,
        ) as sp:
            replies = self._fetch_replies(endpoint, sender_iid, model_id, sfp)
            first = next(replies)
            rx = {"bytes": 0}
            t0 = _time.perf_counter()  #: wall-clock: perf_counter transfer-throughput metric

            def chunks():
                rx["bytes"] += len(first.payload)
                yield first.to_chunk()
                for r in replies:
                    rx["bytes"] += len(r.payload)
                    yield r.to_chunk()

            loaded = inst.loader.load_shard_from_stream(
                model_id, info, ce.shard_index, ce.shard_count, chunks(),
            )
            sp["chunks"] = first.total_chunks
            sp["bytes"] = rx["bytes"]
        self._record_transfer(
            model_id, MX.LOAD_FROM_PEER_COUNT, rx["bytes"],
            _time.perf_counter() - t0,  #: wall-clock: perf_counter transfer-throughput metric
        )
        return loaded, "peer"

    def _stream_shard_slice_from(
        self, endpoint: str, sender_iid: str, ce: "CacheEntry",
    ) -> tuple[LoadedModel, str]:
        """Fetch only OUR shard's leaf range out of a FULL snapshot.

        The full export never splits a chunk across leaves and emits
        leaves in canonical order, so the shard's leaves occupy one
        contiguous chunk block; binary search on the replies' ``layer``
        field finds its start in O(log chunks) probe fetches."""
        inst = self.instance
        model_id, info = ce.model_id, ce.info
        fp = model_fingerprint(info)
        fetch = inst.peer_fetch_transport

        def checked(i: int) -> FetchReply:
            r = fetch(endpoint, model_id, i, fp)
            if not r.ok:
                raise TransferUnavailable(
                    f"{sender_iid} lost the snapshot at chunk {i}"
                )
            return r

        with inst.tracer.span(
            "peer-stream", model=model_id, sender=sender_iid,
        ) as sp:
            first = checked(0)
            total, layers = first.total_chunks, first.total_layers
            want = shard_chunk_indices(
                layers, ce.shard_index, ce.shard_count
            )
            if layers <= 0 or len(want) == 0:
                raise TransferUnavailable(
                    f"{sender_iid} snapshot has no leaf for shard "
                    f"{ce.shard_index}/{ce.shard_count}"
                )
            leaf_lo, leaf_hi = want[0], want[-1]

            def consistent(r: FetchReply) -> FetchReply:
                if r.fingerprint != first.fingerprint or (
                    r.total_chunks != total
                ):
                    raise TransferUnavailable(
                        f"{sender_iid} restarted the snapshot mid-stream"
                    )
                return r

            # Smallest chunk index whose layer >= leaf_lo.
            start = 0
            if first.layer < leaf_lo:
                lo, hi, start = 1, total - 1, total
                while lo <= hi:
                    mid = (lo + hi) // 2
                    probe = consistent(checked(mid))
                    if probe.layer >= leaf_lo:
                        start, hi = mid, mid - 1
                    else:
                        lo = mid + 1
            if start >= total:
                raise TransferUnavailable(
                    f"{sender_iid} snapshot ended before leaf {leaf_lo}"
                )
            rx = {"bytes": 0, "chunks": 0}
            t0 = _time.perf_counter()  #: wall-clock: perf_counter transfer-throughput metric

            def chunks():
                for i in range(start, total):
                    r = consistent(checked(i))
                    if r.layer > leaf_hi:
                        return
                    rx["bytes"] += len(r.payload)
                    rx["chunks"] += 1
                    yield r.to_chunk()

            loaded = inst.loader.load_shard_from_stream(
                model_id, info, ce.shard_index, ce.shard_count, chunks(),
            )
            sp["chunks"] = rx["chunks"]
            sp["bytes"] = rx["bytes"]
        self._record_transfer(
            model_id, MX.LOAD_FROM_PEER_COUNT, rx["bytes"],
            _time.perf_counter() - t0,  #: wall-clock: perf_counter transfer-throughput metric
        )
        return loaded, "peer"

    def _partial_callback(self, ce: "CacheEntry"):
        """Arm serve-before-fully-loaded only for families that declared
        layer-streamability — everyone else serves at ACTIVE."""
        if not is_layer_streamable(ce.info.model_type, ce.info.model_path):
            return None
        inst = self.instance

        def ready(loaded: LoadedModel) -> None:
            inst.begin_partial_serve(ce, loaded)

        return ready

    def _fetch_replies(self, endpoint: str, sender_iid: str, model_id: str,
                       fp: str):
        """Validated chunk-indexed fetch sequence: yields FetchReply
        0..N-1 from the sender, raising ``TransferUnavailable`` on
        NOT_AVAILABLE, truncation, fingerprint mismatch, or a sender
        restart mid-stream. ONE implementation of the receive-side
        protocol validation, shared by the load path (``_stream_from``)
        and the pre-warm path — a new integrity check added here covers
        both."""
        fetch = self.instance.peer_fetch_transport
        first = fetch(endpoint, model_id, 0, fp)
        if not first.ok:
            raise TransferUnavailable(sender_iid)
        yield first
        total = first.total_chunks
        for i in range(1, total):
            r = fetch(endpoint, model_id, i, fp)
            if not r.ok:
                raise TransferUnavailable(
                    f"{sender_iid} lost the snapshot at chunk {i}/{total}"
                )
            if r.fingerprint != first.fingerprint or (
                r.total_chunks != total
            ):
                raise TransferUnavailable(
                    f"{sender_iid} restarted the snapshot mid-stream"
                )
            yield r

    def _stream_from(
        self, endpoint: str, sender_iid: str, ce: "CacheEntry", fp: str,
        partial_cb,
    ) -> tuple[LoadedModel, str]:
        inst = self.instance
        model_id, info = ce.model_id, ce.info
        # The whole chunked transfer is one "peer-stream" span in the
        # load's trace (stage histogram: mm_stage_peer_stream_ms); chunk
        # and byte counts land as attrs when the stream finishes.
        with inst.tracer.span(
            "peer-stream", model=model_id, sender=sender_iid,
        ) as sp:
            replies = self._fetch_replies(endpoint, sender_iid, model_id, fp)
            first = next(replies)
            total = first.total_chunks
            rx = {"bytes": 0}
            t0 = _time.perf_counter()  #: wall-clock: perf_counter transfer-throughput metric

            def chunks():
                rx["bytes"] += len(first.payload)
                yield first.to_chunk()
                for r in replies:
                    rx["bytes"] += len(r.payload)
                    yield r.to_chunk()

            loaded = inst.loader.load_from_stream(
                model_id, info, chunks(), partial_ready=partial_cb,
            )
            sp["chunks"] = total
            sp["bytes"] = rx["bytes"]
        self._record_transfer(
            model_id, MX.LOAD_FROM_PEER_COUNT, rx["bytes"],
            _time.perf_counter() - t0,  #: wall-clock: perf_counter transfer-throughput metric
        )
        return loaded, "peer"

    def _record_transfer(
        self, model_id: str, source_metric, rx_bytes: int, elapsed_s: float,
    ) -> None:
        self.metrics.inc(source_metric, model_id=model_id)
        if rx_bytes:
            self.metrics.inc(
                MX.TRANSFER_RX_BYTES, rx_bytes, model_id=model_id
            )
        if elapsed_s > 0 and rx_bytes:
            self.metrics.set_gauge(
                MX.TRANSFER_THROUGHPUT_MBPS,
                rx_bytes / 1e6 / elapsed_s,
            )

    # -- source resolution -------------------------------------------------

    def _live_ids(self) -> set[str]:
        return {
            iid for iid, _ in self.instance.cluster_view().instances
        }

    def _endpoint_for(self, iid: str) -> str:
        rec = self.instance.instances_view.get(iid)
        endpoint = getattr(rec, "endpoint", "") if rec is not None else ""
        return endpoint or iid

    def _ready_sender(
        self, model_id: str, fp: str, exclude: set[str],
    ) -> Optional[tuple[str, str]]:
        """A live instance that can serve the transfer NOW: a FULLY
        loaded copy first (oldest completion first — most likely fully
        warm), then an advertised host-tier holder. An instance listed in
        ``instance_ids`` that still holds a loading claim is a PARTIAL
        mid-transfer promotion (records.promote_partial) — routable for
        requests but not a weight source yet, so it is skipped here and
        picked up by the pending wait once its stream completes."""
        inst = self.instance
        mr = inst.registry_view.get(model_id)
        if mr is None:
            return None
        live = self._live_ids()
        # Placement-group members hold ONE SHARD, not a full copy — they
        # are listed in instance_ids (routable as a group) but can never
        # serve a full-fingerprint stream.
        shards = getattr(mr, "shard_instances", {}) or {}
        ranked = sorted(
            (ts, iid) for iid, ts in mr.instance_ids.items()
            if iid != inst.instance_id and iid not in exclude and iid in live
            and iid not in mr.loading_instances and iid not in shards
        )
        hosts = sorted(
            (ts, iid)
            for iid, ts in getattr(mr, "host_instances", {}).items()
            if iid != inst.instance_id and iid not in exclude and iid in live
            and iid not in mr.instance_ids
        )
        for _, iid in ranked + hosts:
            return iid, self._endpoint_for(iid)
        return None

    def _resolve_sender(
        self, model_id: str, fp: str, exclude: set[str], deadline: float,
    ) -> Optional[tuple[str, str]]:
        """Ready sender, or wait (until ``deadline``) for a strictly-older
        pending load to land and stream from it. Strict
        (claim_ts, instance_id) ordering means the globally-oldest
        claimant never waits, so a flash crowd cannot deadlock on itself.
        The wait polls WITHOUT the failed-sender exclusion: a sender that
        answered NOT_AVAILABLE (e.g. a PARTIAL holder) becomes retryable
        once the record moves — the caller's attempt cap bounds re-dials."""
        inst = self.instance
        ready = self._ready_sender(model_id, fp, exclude)
        if ready is not None:
            return ready
        mr = inst.registry_view.get(model_id)
        if mr is None:
            return None
        if not self._older_pending(mr):
            return None
        clock = get_clock()
        while clock.monotonic() < deadline:
            clock.sleep(PENDING_POLL_S)
            ready = self._ready_sender(model_id, fp, set())
            if ready is not None:
                return ready
            mr = inst.registry_view.get(model_id)
            if mr is None or not self._older_pending(mr):
                return None  # the awaited load failed/vanished: store
        return None

    def _older_pending(self, mr) -> bool:
        inst = self.instance
        ours = mr.loading_instances.get(inst.instance_id)
        our_key = (
            (ours, inst.instance_id) if ours is not None
            else (1 << 62, inst.instance_id)
        )
        live = self._live_ids()
        return any(
            (ts, iid) < our_key
            for iid, ts in mr.loading_instances.items()
            if iid != inst.instance_id and iid in live
        )

    def _pending_wait_s(self, model_id: str) -> float:
        inst = self.instance
        ce = inst.cache.get_quietly(model_id)
        mtype = ce.info.model_type if ce is not None else ""
        stats = inst.time_stats
        if mtype and stats.samples(mtype) >= stats.min_samples:
            expect_s = stats.expect_ms(mtype) / 1000.0
            bound = max(1.0, expect_s * 2.0)
        else:
            bound = MAX_PENDING_WAIT_S
        return min(bound, inst.load_timeout_s)

    # ------------------------------------------------------------------ #
    # predictive pre-warm (autoscale/)                                   #
    # ------------------------------------------------------------------ #

    def prewarm_host(self, model_id: str) -> bool:
        """Stage a host-tier snapshot WITHOUT materializing a device
        copy: fetch the full chunk stream from a live holder over the
        same FetchWeights channel a scale-up uses and park it in the
        host tier, so a later demand ramp on this instance is a ~ms
        re-warm instead of a cold store load. Strictly best-effort and
        strictly peer-sourced — a model with no live holder is not
        pre-warmed (paying a store load speculatively would compete
        with real loads for store egress). The snapshot is inserted
        with ``put_if_room``: speculative bytes never evict demoted
        (certain) ones."""
        inst = self.instance
        loader = inst.loader
        if (
            not loader.supports_weight_streaming
            or not self.host_tier.enabled
            or not self.cfg.peer_fetch
            or inst.peer_fetch_transport is None
        ):
            return False
        if self.host_tier.peek(model_id) is not None:
            return True
        mr = inst.registry_view.get(model_id)
        if mr is None:
            return False
        info = ModelInfo(
            model_type=mr.model_type,
            model_path=mr.model_path,
            model_key=mr.model_key,
        )
        fp = model_fingerprint(info)
        sender = self._ready_sender(model_id, fp, set())
        if sender is None:
            return False
        iid, endpoint = sender
        try:
            replies = self._fetch_replies(endpoint, iid, model_id, fp)
            first = next(replies)
            # The manifest rides every reply: bail after ONE chunk when
            # the snapshot can never fit the FREE host budget right now
            # (put_if_room below would refuse it anyway) — without this
            # a full host tier would re-download the whole stream from
            # a serving peer on every controller tick.
            free = self.host_tier.capacity_bytes - self.host_tier.used_bytes
            if first.total_bytes > free:
                return False
            chunks = [first.to_chunk()] + [r.to_chunk() for r in replies]
        except Exception as e:  # noqa: BLE001 — sender death, truncation,
            # restart, NOT_AVAILABLE: a pre-warm never falls back to the
            # store, it just doesn't happen this tick
            log.debug(
                "pre-warm fetch of %s from %s failed: %s", model_id, iid, e,
            )
            return False
        snap = TransferSnapshot.build(
            model_id, info, chunks,
            total_bytes=max(
                first.total_bytes, sum(len(c.payload) for c in chunks), 1
            ),
        )
        if not self.host_tier.put_if_room(model_id, snap, snap.total_bytes):
            return False
        # Bytes are accounted (they crossed the transfer channel) but no
        # load-source counter moves: nothing was loaded — that happens
        # at re-warm time, on the LOAD_FROM_HOST_TIER path.
        self.metrics.inc(
            MX.TRANSFER_RX_BYTES,
            sum(len(c.payload) for c in chunks), model_id=model_id,
        )
        self._refresh_host_gauges()
        return True

    # ------------------------------------------------------------------ #
    # sender side                                                        #
    # ------------------------------------------------------------------ #

    def handle_fetch(
        self, model_id: str, chunk_index: int, fingerprint: str = "",
    ) -> FetchReply:
        """Serve one chunk-indexed fetch. Export-on-first-demand: a live
        ACTIVE copy with no snapshot yet is exported into the host tier
        so N receivers share one host-resident serialization."""
        snap = self.host_tier.get(model_id)
        if snap is not None and fingerprint and (
            snap.fingerprint != fingerprint
        ):
            snap = None
        if snap is None:
            snap = self._export_snapshot(model_id, fingerprint)
        reply = snapshot_reply(snap, chunk_index, fingerprint)
        if reply.ok and reply.payload:
            self.metrics.inc(
                MX.TRANSFER_TX_BYTES, len(reply.payload), model_id=model_id
            )
        return reply

    def _export_lock_for(self, model_id: str):
        with self._export_guard:
            if len(self._export_locks) >= self.MAX_EXPORT_LOCKS:
                self._export_locks = {}
            lk = self._export_locks.get(model_id)
            if lk is None:
                lk = self._export_locks[model_id] = mm_lock(
                    "WeightTransferManager._export_lock"
                )
            return lk

    def _export_snapshot(
        self, model_id: str, fingerprint: str,
    ) -> Optional[TransferSnapshot]:
        inst = self.instance
        loader = inst.loader
        if not loader.supports_weight_streaming or not self.host_tier.enabled:
            return None
        ce = inst.cache.get_quietly(model_id)
        if ce is None or ce.loaded is None:
            return None
        # A SHARDED entry exports ONLY its own shard, ONLY under the shard
        # fingerprint (a full-fingerprint fetch against a shard holder
        # answers NOT_AVAILABLE — it does not hold the full weights).
        is_shard = ce.state is EntryState.SHARDED and ce.is_shard
        if is_shard:
            exporter = getattr(loader, "export_shard_weights", None)
            if exporter is None or fingerprint != shard_fingerprint(
                ce.info, ce.shard_index, ce.shard_count
            ):
                return None
        else:
            if ce.state is not EntryState.ACTIVE:
                return None
            exporter = loader.export_weights
            if fingerprint and model_fingerprint(ce.info) != fingerprint:
                return None
        with self._export_lock_for(model_id):
            snap = self.host_tier.peek(model_id)
            if snap is not None and (
                not fingerprint or snap.fingerprint == fingerprint
            ):
                return snap
            try:
                it = exporter(model_id, ce.loaded.handle)
            except Exception as e:  # noqa: BLE001 — runtime export failure
                log.warning("weight export of %s failed: %s", model_id, e)
                return None
            if it is None:
                return None
            chunks = list(it)
            snap = TransferSnapshot.build(
                model_id, ce.info, chunks,
                total_bytes=self._snapshot_bytes(ce, chunks),
            )
            if is_shard:
                snap = dataclasses.replace(snap, fingerprint=fingerprint)
            if not self.host_tier.put(model_id, snap, snap.total_bytes):
                # Too big for the host budget: refuse rather than hold an
                # unaccounted export alive — receiver uses the store.
                return None
            self._refresh_host_gauges()
            return snap

    @staticmethod
    def _snapshot_bytes(ce: "CacheEntry", chunks: list[WeightChunk]) -> int:
        declared = ce.loaded.size_bytes if ce.loaded is not None else 0
        actual = sum(len(c.payload) for c in chunks)
        # Conservative accounting: whichever is larger of the device size
        # the copy represents and the bytes actually resident.
        return max(declared, actual, 1)

    # ------------------------------------------------------------------ #
    # demotion / host-copy lifecycle                                     #
    # ------------------------------------------------------------------ #

    def demote_evicted(self, model_id: str, ce: "CacheEntry") -> bool:
        """Device eviction is about to unload this copy — keep a host-
        resident snapshot so a re-warm is a device copy and peers can
        still fetch from us. Runs OFF the eviction lock, before the
        runtime unload (the handle must still be alive). Best-effort."""
        loader = self.instance.loader
        if (
            not loader.supports_weight_streaming
            or not self.host_tier.enabled
            or ce.loaded is None
            or ce.is_shard  # a shard snapshot under the full-model
            # fingerprint would poison peer fetches; shards re-materialize
            # via the group, not the host tier
        ):
            return False
        if self.host_tier.peek(model_id) is not None:
            return True  # already snapshotted while serving peers
        try:
            it = loader.export_weights(model_id, ce.loaded.handle)
        except Exception as e:  # noqa: BLE001 — demotion is best-effort
            log.warning("demotion export of %s failed: %s", model_id, e)
            return False
        if it is None:
            return False
        chunks = list(it)
        snap = TransferSnapshot.build(
            model_id, ce.info, chunks,
            total_bytes=self._snapshot_bytes(ce, chunks),
        )
        if not self.host_tier.put(model_id, snap, snap.total_bytes):
            return False
        self.metrics.inc(MX.HOST_TIER_DEMOTE_COUNT, model_id=model_id)
        self._refresh_host_gauges()
        return True

    def drop_host_copy(self, model_id: str) -> bool:
        """Remove a host-resident snapshot (model deleted / spec changed /
        poisoned). The registry host-claim cleanup is the instance's job
        (it owns the CAS machinery)."""
        dropped = self.host_tier.remove(model_id) is not None
        with self._export_guard:
            self._export_locks.pop(model_id, None)
        if dropped:
            self._refresh_host_gauges()
        return dropped

    def _refresh_host_gauges(self) -> None:
        self.metrics.set_gauge(
            MX.HOST_TIER_USED_BYTES, self.host_tier.used_bytes
        )
        self.metrics.set_gauge(MX.HOST_TIER_MODELS, len(self.host_tier))
