"""The port's own copy of the JAX package's ``sim/harness.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

In-process simulated cluster: N ModelMeshInstances, no sockets.

Unlike tests/cluster_util.py (real localhost gRPC — the wire-parity
tier), the sim cluster keeps everything in-process and on the virtual
clock: an in-process ``SimLoader`` replaces the gRPC sidecar runtime,
peer forwarding is a direct method call routed through the pod table,
and every instance talks to the shared KV through its own
fault-injectable facade (sim/kv.py). Background tasks run whatever
cadences the scenario's TaskConfig sets (production defaults unless the
scenario compresses them) — virtual time makes either cheap; hour-scale
boundary behavior (reaper grace, surplus-copy age caps) is pinned by the
direct-tick tests in tests/test_sim_cluster.py.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import re
import threading
from typing import Optional

from modelmesh_tpu_torch.observability.tracing import (
    SPAN_HEADER,
    TRACE_HEADER,
    Tracer,
    incoming_parent_span,
    incoming_trace_id,
)
from modelmesh_tpu_torch.runtime.spi import (
    LoadedModel,
    LocalInstanceParams,
    ModelInfo,
    ModelLoader,
    ModelLoadException,
)
from modelmesh_tpu_torch.serving.errors import (
    ModelNotHereError,
    ServiceUnavailableError,
)
from modelmesh_tpu_torch.serving.instance import (
    InstanceConfig,
    InvokeResult,
    ModelMeshInstance,
    RoutingContext,
)
from modelmesh_tpu_torch.serving.tasks import BackgroundTasks, TaskConfig
from modelmesh_tpu_torch.sim.kv import SimKV, SimKVConfig
from modelmesh_tpu_torch.sim.ringlog import RingLog
from modelmesh_tpu_torch.utils import clock as _clock

log = logging.getLogger(__name__)

# Model-id prefixes triggering injected load faults (mirrors runtime/fake).
FAIL_LOAD_PREFIX = "fail-load-"
SLOW_LOAD_PREFIX = "slow-load-"

# "big<N>x-" ids are N x the loader's default size — the sharded-group
# scenarios' way to mint a model no single sim device can hold.
_BIG_PREFIX_RE = re.compile(r"^big(\d+)x-")


class SimLoader(ModelLoader):
    """In-process loader with virtual-time load delays and fault hooks.

    Weight-streaming capable: exports deterministic synthetic chunks
    (``transfer_chunks`` per model, small payloads — the ACCOUNTED size
    is the model's declared size, which is what the host tier and the
    invariants reason about) and re-materializes from a stream. Chunk
    delay defaults to ZERO virtual time: direct-tick tests drive the
    clock manually and a sleeping stream would deadlock them; the
    mid-stream fault hooks key on chunk COUNTS, not time, so scenario
    determinism doesn't need the delay. Scenarios that want transfers
    to consume virtual time opt in via ``transfer_chunk_delay_ms``."""

    def __init__(
        self,
        capacity_bytes: int = 64 << 20,
        default_size_bytes: int = 8 << 20,
        load_delay_ms: float = 0.0,
        load_concurrency: int = 8,
        transfer_chunks: int = 8,
        transfer_chunk_delay_ms: float = 0.0,
    ):
        self.capacity_bytes = capacity_bytes
        self.default_size_bytes = default_size_bytes
        self.load_delay_ms = load_delay_ms
        self.load_concurrency = load_concurrency
        self.transfer_chunks = max(int(transfer_chunks), 1)
        self.transfer_chunk_delay_ms = transfer_chunk_delay_ms
        self.loaded_models: dict[str, int] = {}  #: guarded-by: _lock
        # model_id -> (shard_index, shard_count) for copies materialized
        # through the sharded SPI (invariants cross-check these against
        # the registry's group claims).
        self.shard_coords: dict[str, tuple[int, int]] = {}  #: guarded-by: _lock
        self.load_count = 0  #: guarded-by: _lock
        self.stream_load_count = 0  #: guarded-by: _lock
        self.shard_load_count = 0  #: guarded-by: _lock
        self.unload_count = 0  #: guarded-by: _lock
        # model_id -> extra virtual load delay (the slow-loadModel fault).
        self.slow_models: dict[str, float] = {}  #: guarded-by: _lock
        # model_ids whose next load fails (one-shot unless re-armed).
        self.fail_models: set[str] = set()  #: guarded-by: _lock
        self._lock = threading.Lock()

    def startup(self) -> LocalInstanceParams:
        return LocalInstanceParams(
            capacity_bytes=self.capacity_bytes,
            load_concurrency=self.load_concurrency,
            load_timeout_ms=30_000,
        )

    def load(self, model_id: str, info: ModelInfo) -> LoadedModel:
        with self._lock:
            delay_ms = self.load_delay_ms + self.slow_models.get(model_id, 0)
            fail = model_id in self.fail_models or model_id.startswith(
                FAIL_LOAD_PREFIX
            )
        if model_id.startswith(SLOW_LOAD_PREFIX):
            delay_ms = max(delay_ms, 2_000.0)
        if delay_ms:
            _clock.sleep(delay_ms / 1000.0)
        if fail:
            with self._lock:
                self.fail_models.discard(model_id)
            raise ModelLoadException(f"injected load failure: {model_id}")
        size = self._size_for(model_id)
        with self._lock:
            self.loaded_models[model_id] = size
            self.load_count += 1
        return LoadedModel(handle=model_id, size_bytes=size)

    def predict_size(self, model_id: str, info: ModelInfo) -> int:
        return self._size_for(model_id)

    def model_size(self, model_id: str, handle) -> int:
        with self._lock:
            return self.loaded_models.get(model_id, 0)

    def unload(self, model_id: str) -> None:
        with self._lock:
            self.loaded_models.pop(model_id, None)
            self.shard_coords.pop(model_id, None)
            self.unload_count += 1

    def is_loaded(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self.loaded_models

    def set_slow(self, model_id: str, delay_ms: float) -> None:
        with self._lock:
            self.slow_models[model_id] = delay_ms

    def set_fail_next(self, model_id: str) -> None:
        with self._lock:
            self.fail_models.add(model_id)

    def _size_for(self, model_id: str) -> int:
        m = _BIG_PREFIX_RE.match(model_id)
        if m:
            return self.default_size_bytes * int(m.group(1))
        # Deterministic per-id size (stable across runs — hash() is
        # salted per process, so use a real digest).
        import zlib

        h = zlib.crc32(model_id.encode()) % 1000
        return int(self.default_size_bytes * (0.5 + h / 1000.0))

    # -- weight streaming --------------------------------------------------

    @property
    def supports_weight_streaming(self) -> bool:
        return True

    def export_weights(self, model_id: str, handle):
        from modelmesh_tpu_torch.runtime.spi import WeightChunk

        with self._lock:
            if model_id not in self.loaded_models:
                return None
        n = self.transfer_chunks

        def gen():
            for i in range(n):
                yield WeightChunk(
                    seq=i,
                    # Synthetic but deterministic payload; size accounting
                    # uses the declared model size, not these bytes.
                    payload=f"{model_id}:{i}".encode(),
                    layer=i,
                    last=i == n - 1,
                )

        return gen()

    def load_from_stream(
        self, model_id: str, info: ModelInfo, chunks, partial_ready=None,
    ) -> LoadedModel:
        size = self._size_for(model_id)
        seen = 0
        fired_partial = False
        for chunk in chunks:
            if self.transfer_chunk_delay_ms:
                _clock.sleep(self.transfer_chunk_delay_ms / 1000.0)
            seen += 1
            if (
                partial_ready is not None
                and not fired_partial
                and seen * 2 >= self.transfer_chunks
            ):
                # Half the layers landed: this synthetic runtime can
                # serve from here (the PARTIAL-phase test hook). Register
                # the copy before announcing — the runtime_call probe
                # checks is_loaded().
                fired_partial = True
                with self._lock:
                    self.loaded_models[model_id] = size
                partial_ready(LoadedModel(handle=model_id, size_bytes=size))
        if seen == 0:
            raise ModelLoadException(f"{model_id}: empty weight stream")
        with self._lock:
            self.loaded_models[model_id] = size
            self.stream_load_count += 1
        return LoadedModel(handle=model_id, size_bytes=size)

    # -- sharded execution -------------------------------------------------

    @property
    def supports_sharded_execution(self) -> bool:
        return True

    def _shard_share(self, model_id: str, shard_count: int) -> int:
        return -(-self._size_for(model_id) // max(shard_count, 1))

    def load_shard(
        self, model_id: str, info: ModelInfo, shard_index: int,
        shard_count: int,
    ) -> LoadedModel:
        with self._lock:
            delay_ms = self.load_delay_ms + self.slow_models.get(model_id, 0)
            fail = model_id in self.fail_models or model_id.startswith(
                FAIL_LOAD_PREFIX
            )
        if delay_ms:
            _clock.sleep(delay_ms / 1000.0)
        if fail:
            with self._lock:
                self.fail_models.discard(model_id)
            raise ModelLoadException(f"injected load failure: {model_id}")
        share = self._shard_share(model_id, shard_count)
        with self._lock:
            self.loaded_models[model_id] = share
            self.shard_coords[model_id] = (shard_index, shard_count)
            self.load_count += 1
            self.shard_load_count += 1
        return LoadedModel(handle=model_id, size_bytes=share)

    def export_shard_weights(self, model_id: str, handle):
        """Synthetic shard stream: ``transfer_chunks`` stands in for the
        model's leaf count, so this shard's slice of it (global layer
        indices, like the real loader) is what goes on the wire."""
        from modelmesh_tpu_torch.runtime.spi import WeightChunk
        from modelmesh_tpu_torch.transfer.protocol import shard_chunk_indices

        with self._lock:
            if model_id not in self.loaded_models:
                return None
            coords = self.shard_coords.get(model_id)
        if coords is None:
            return None
        layers = list(shard_chunk_indices(self.transfer_chunks, *coords))

        def gen():
            for pos, layer in enumerate(layers):
                yield WeightChunk(
                    seq=pos,
                    payload=f"{model_id}:{layer}".encode(),
                    layer=layer,
                    last=pos == len(layers) - 1,
                )

        return gen()

    def load_shard_from_stream(
        self, model_id: str, info: ModelInfo, shard_index: int,
        shard_count: int, chunks,
    ) -> LoadedModel:
        from modelmesh_tpu_torch.transfer.protocol import shard_chunk_indices

        seen: set[int] = set()
        for chunk in chunks:
            if self.transfer_chunk_delay_ms:
                _clock.sleep(self.transfer_chunk_delay_ms / 1000.0)
            seen.add(chunk.layer)
        want = set(
            shard_chunk_indices(self.transfer_chunks, shard_index,
                                shard_count)
        )
        if seen != want:
            raise ModelLoadException(
                f"{model_id}: shard {shard_index}/{shard_count} stream "
                f"delivered layers {sorted(seen)}, expected {sorted(want)}"
            )
        share = self._shard_share(model_id, shard_count)
        with self._lock:
            self.loaded_models[model_id] = share
            self.shard_coords[model_id] = (shard_index, shard_count)
            self.stream_load_count += 1
            self.shard_load_count += 1
        return LoadedModel(handle=model_id, size_bytes=share)


class SimPod:
    def __init__(self, instance: ModelMeshInstance, tasks: BackgroundTasks,
                 loader: SimLoader):
        self.instance = instance
        self.tasks = tasks
        self.loader = loader
        self.alive = True

    @property
    def iid(self) -> str:
        return self.instance.instance_id


class SimCluster:
    """Build under an installed VirtualClock; drive via the scenario
    runner (sim/scenario.py) or directly in tests."""

    def __init__(
        self,
        n: int = 3,
        seed: int = 0,
        kv_config: Optional[SimKVConfig] = None,
        task_config: Optional[TaskConfig] = None,
        capacity_bytes: int = 64 << 20,
        start_tasks: bool = True,
        load_delay_ms: float = 50.0,
        instance_kwargs: Optional[dict] = None,
        service_base_ms: float = 0.0,
        service_congestion_ms: float = 0.0,
        service_scope: str = "fleet",
        service_congestion_cap: int = 0,
    ):
        self.seed = seed
        # Virtual-time service-cost model for runtime calls: each
        # dispatch costs base + congestion * (concurrent dispatches - 1)
        # virtual ms. ``service_scope`` picks what "concurrent" means:
        # "fleet" (default) counts dispatches FLEET-GLOBAL (one shared
        # accelerator domain — overload scenarios test admission
        # control, not placement spread); "instance" prices each pod's
        # dispatches independently, so COPY COUNT and placement spread
        # change latency — the model the autoscale scenarios need (more
        # copies = less per-pod concurrency = lower tail). Zero costs
        # keep the historical instantaneous runtime; without a
        # congestion term there is no tail for either controller to
        # protect.
        if service_scope not in ("fleet", "instance"):
            raise ValueError(f"unknown service_scope {service_scope!r}")
        self.service_base_ms = service_base_ms
        self.service_congestion_ms = service_congestion_ms
        self.service_scope = service_scope
        # Congestion ceiling (concurrent dispatches counted beyond the
        # first; 0 = uncapped). A real runtime bounds its admission
        # queue, so per-dispatch cost saturates instead of growing with
        # an unbounded backlog — without the cap, one deep pre-recovery
        # backlog prices NEW requests for as long as its slowest sleeper
        # lives, and no scaling action can ever look recovered.
        self.service_congestion_cap = int(service_congestion_cap)
        # scope key ("" fleet-global, else instance id) -> in-flight count
        self._service_inflight: dict[str, int] = {}  #: guarded-by: _service_lock
        self._service_lock = threading.Lock()
        self.kv = SimKV(seed=seed, config=kv_config)
        self.task_config = task_config or TaskConfig()
        #: shared-ok: scenario-driver state — the script step and upgrade coordinator run on one thread at a time
        self.pods: list[SimPod] = []
        # Instances this scenario demanded copies of (feeds the
        # availability invariant).
        self.demanded: set[str] = set()
        # Per-request outcome log:
        # (virtual_ms, model_id, ok, error, virtual_latency_ms).
        # The reconfiguration scenarios' no-failure-spike check and the
        # SLO invariant read this — "no demanded model unserved at any
        # virtual instant" and "p99 within objective at every
        # checkpoint" are asserted over the observed probe traffic, not
        # just quiescence. Bounded ring (MM_SIM_LOG_EVENTS): unbounded
        # per-probe accumulation is a memory blowup at macro scale.
        self.request_log = RingLog()
        # instance_id -> virtual ms it died (kill or post-drain); the
        # runner merges this into the dead-placement grace bookkeeping
        # for deaths IT didn't schedule (e.g. rolling-upgrade waves).
        #: shared-ok: scenario-driver state — the script step and upgrade coordinator run on one thread at a time
        self.deaths: dict[str, int] = {}
        # Drain reports by instance id (reconfig/drain.py), for scenario
        # checks (non-vacuity: the drained pod really migrated copies).
        #: shared-ok: scenario-driver state — the script step and upgrade coordinator run on one thread at a time
        self.drain_reports: dict = {}
        # reconfig/rolling.py UpgradeReport of the last rolling_upgrade.
        self.upgrade_report = None
        # Defaults reused when a scenario adds replacement instances
        # mid-run (rolling upgrade waves).
        self._default_instance = dict(
            capacity_bytes=capacity_bytes,
            start_tasks=start_tasks,
            load_delay_ms=load_delay_ms,
            **(instance_kwargs or {}),
        )
        # Transfer-progress fault hooks: fn(sender_iid, model_id,
        # chunk_index) called on EVERY peer chunk fetch before it is
        # served — scenarios arm mid-stream faults here (kill or
        # partition the sender after K chunks). List mutation is
        # GIL-atomic; hooks run on the fetching thread.
        self._transfer_hooks: list = []
        # (model_id, action, sender_iid) for every armed fault that
        # actually FIRED — scenario checks assert on this so a fault
        # that never triggered (stream never started) fails loudly
        # instead of passing vacuously.
        self.transfer_faults_fired: list[tuple[str, str, str]] = []
        # Batched data plane observability: one row per batched runtime
        # dispatch — (virtual_ms, instance_id, batch_size, distinct
        # models). Scenario checks assert the queue/flush state machine
        # coalesced concurrent requests under virtual time. Same bound
        # as request_log.
        self.batch_dispatches = RingLog()
        #: shared-ok: scenario-driver state — the script step and upgrade coordinator run on one thread at a time
        self._n = 0
        for _ in range(n):
            self.add_instance(
                capacity_bytes=capacity_bytes,
                start_tasks=start_tasks,
                load_delay_ms=load_delay_ms,
                **(instance_kwargs or {}),
            )
        # The fleet must see itself before a scenario starts killing it.
        for pod in self.pods:
            pod.instance.instances_view.wait_for(
                lambda v: len(v) >= n, timeout=10
            )

    # -- construction ------------------------------------------------------

    def add_instance(
        self,
        capacity_bytes: int = 64 << 20,
        start_tasks: bool = True,
        load_delay_ms: float = 50.0,
        **config_kwargs,
    ) -> SimPod:
        iid = f"sim-{self._n}"
        self._n += 1
        loader = SimLoader(
            capacity_bytes=capacity_bytes, load_delay_ms=load_delay_ms
        )
        # trace_sample=1 unless the scenario overrides: scenario trace
        # assertions must be deterministic, not a sampling coin flip.
        config_kwargs.setdefault("trace_sample", 1)
        inst = ModelMeshInstance(
            self.kv.for_instance(iid),
            loader,
            InstanceConfig(
                instance_id=iid,
                endpoint=iid,  # direct-call transport routes by id
                load_timeout_s=20,
                space_wait_s=5.0,
                min_churn_age_ms=0,
                **config_kwargs,
            ),
            peer_call=self._peer_call,
            peer_fetch=self._peer_fetch,
            runtime_call=self._runtime_call,
            # Deterministic batched twin: sim instances run the full
            # continuous-batching queue (serving/batching.py) under
            # virtual time, dispatching through the same per-pod checks
            # as the single-call path.
            runtime_call_batch=functools.partial(
                self._runtime_call_batch, iid
            ),
        )
        tasks = BackgroundTasks(inst, self.task_config)
        pod = SimPod(inst, tasks, loader)
        self.pods.append(pod)
        if start_tasks:
            tasks.start()
        return pod

    # -- in-process transport ----------------------------------------------

    def _find(self, endpoint: str) -> Optional[SimPod]:
        for pod in self.pods:
            if pod.iid == endpoint or pod.instance.config.endpoint == endpoint:
                return pod
        return None

    def _peer_call(
        self, endpoint: str, model_id: str, method, payload: bytes,
        headers, ctx: RoutingContext,
    ) -> InvokeResult:
        pod = self._find(endpoint)
        if pod is None or not pod.alive:
            raise ServiceUnavailableError(endpoint)
        # Emulate the wire's trace handoff (MeshInternalServicer.Forward):
        # the receiving pod re-opens the propagated trace in ITS tracer,
        # parented under the sender's forward span — even though the call
        # runs on the sender's thread here.
        headers = list(headers)
        tid = incoming_trace_id(headers)
        parent = incoming_parent_span(headers)
        if tid:
            # Like the wire servicer: the context is re-attached fresh on
            # any further outbound hop, never replayed from this list.
            headers = [
                (k, v) for k, v in headers
                if k not in (TRACE_HEADER, SPAN_HEADER)
            ]
        with pod.instance.tracer.trace(
            tid, model_id, method or "", parent_span=parent,
        ) if tid else contextlib.nullcontext():
            result = pod.instance.invoke_model(
                model_id, method, payload, headers, ctx, sync=True
            )
        # The wire piggybacks the responder's load on every Forward
        # response (mm-load trailer); the direct-call transport carries
        # the SAME feedback so scenarios exercise the real LoadView
        # decay/staleness machinery under virtual time.
        result.feedback = pod.instance.load_feedback()
        return result

    def _peer_fetch(self, endpoint: str, model_id: str, chunk_index: int,
                    fingerprint: str):
        """Direct-call FetchWeights transport with mid-stream fault
        injection: every chunk runs the armed transfer hooks first, then
        re-checks the sender — a hook that killed or partitioned the
        sender makes THIS chunk fail exactly like the wire would."""
        pod = self._find(endpoint)
        if pod is None or not pod.alive:
            raise ServiceUnavailableError(endpoint)
        for hook in list(self._transfer_hooks):
            hook(pod.iid, model_id, chunk_index)
        if not pod.alive or self.kv.is_partitioned(pod.iid):
            # A KV partition models a full network partition for the
            # instance: the transfer channel is unreachable too.
            raise ServiceUnavailableError(endpoint)
        # Trace handoff, as on the gRPC FetchWeights surface: the
        # fetching load's trace context (live on this thread) re-opens
        # in the SENDER pod's tracer so its chunk serving joins the
        # tree — once per transfer (chunk 0), like the wire servicer.
        tid = Tracer.current_trace_id() if chunk_index == 0 else ""
        if not tid:
            return pod.instance.handle_weight_fetch(
                model_id, chunk_index, fingerprint
            )
        with pod.instance.tracer.trace(
            tid, model_id, "FetchWeights",
            parent_span=Tracer.current_span_id(),
        ), pod.instance.tracer.span("serve-chunk", chunk=chunk_index):
            return pod.instance.handle_weight_fetch(
                model_id, chunk_index, fingerprint
            )

    def add_transfer_hook(self, hook) -> None:
        self._transfer_hooks.append(hook)

    def arm_transfer_fault(
        self, model_id: str, after_chunks: int, action: str,
    ) -> None:
        """One-shot mid-stream fault: once ``after_chunks`` chunks of
        ``model_id`` have been served, ``kill`` or ``partition`` the
        SENDER — the receiver's next chunk fetch fails and its store
        fallback must take over."""
        state = {"served": 0, "fired": False}

        def hook(sender_iid: str, mid: str, chunk_index: int) -> None:
            if mid != model_id or state["fired"]:
                return
            state["served"] += 1
            if state["served"] <= after_chunks:
                return
            state["fired"] = True
            self.transfer_faults_fired.append((model_id, action, sender_iid))
            log.info(
                "transfer fault: %s sender %s after %d chunks of %s",
                action, sender_iid, after_chunks, mid,
            )
            if action == "kill":
                self.kill(sender_iid)
            elif action == "partition":
                self.partition(sender_iid)
            else:
                raise ValueError(f"unknown transfer fault action {action}")

        self.add_transfer_hook(hook)

    def _service_delay(self, iid: str) -> None:
        """Charge one runtime dispatch its virtual service cost under
        the congestion model (no-op when unconfigured). The concurrency
        key is the serving pod under scope="instance", fleet-global
        otherwise."""
        if not self.service_base_ms and not self.service_congestion_ms:
            return
        key = iid if self.service_scope == "instance" else ""
        with self._service_lock:
            inflight = self._service_inflight.get(key, 0) + 1
            self._service_inflight[key] = inflight
        try:
            queued = inflight - 1
            if self.service_congestion_cap > 0:
                queued = min(queued, self.service_congestion_cap)
            delay_ms = self.service_base_ms + (
                self.service_congestion_ms * queued
            )
            if delay_ms > 0:
                _clock.sleep(delay_ms / 1000.0)
        finally:
            with self._service_lock:
                self._service_inflight[key] -= 1

    def _runtime_call(
        self, ce, method, payload: bytes, headers, cancel_event=None
    ) -> bytes:
        # ce.loaded.handle is the model id; the entry's OWNING loader is
        # found through the serving instance the entry lives in — but the
        # runtime_call closure is per-instance-agnostic here, so resolve
        # by membership (a model can be loaded on several pods).
        mid = ce.model_id
        for pod in self.pods:
            if pod.alive and pod.instance.cache.get_quietly(mid) is ce:
                if not pod.loader.is_loaded(mid):
                    raise ModelNotHereError(pod.iid, mid)
                self._service_delay(pod.iid)
                return f"{mid}:sim".encode()
        raise ModelNotHereError("?", mid)

    def _runtime_call_batch(
        self, iid: str, items, cancel_event=None
    ) -> list:
        """Batched twin of ``_runtime_call``: per-item results are
        byte-identical to N solo calls (the batched-vs-sequential
        identity), with per-item isolation — a model the pod's loader
        lost fails only its own slot. Each dispatch is recorded with
        its virtual timestamp for scenario assertions."""
        from modelmesh_tpu_torch.cache.lru import now_ms
        from modelmesh_tpu_torch.runtime.spi import ModelNotLoadedError

        pod = self._find(iid)
        self.batch_dispatches.append((
            now_ms(), iid, len(items),
            len({item.model_id for item in items}),
        ))
        # One batched dispatch = one service charge (that is the point
        # of batching); congestion still scales with concurrent
        # dispatches — fleet-global, like every service charge (see the
        # constructor comment).
        self._service_delay(iid)
        out: list = []
        for item in items:
            mid = item.model_id
            if pod is None or not pod.alive or not pod.loader.is_loaded(mid):
                out.append(ModelNotLoadedError(mid))
            else:
                out.append(f"{mid}:sim".encode())
        return out

    # -- faults ------------------------------------------------------------

    def pod(self, i: int) -> SimPod:
        return self.pods[i]

    def by_id(self, iid: str) -> SimPod:
        pod = self._find(iid)
        if pod is None:
            raise KeyError(iid)
        return pod

    def spawn(self, instance_version: str = "") -> SimPod:
        """Add a replacement instance with the cluster's construction
        defaults — the rolling-upgrade 'new pod at the new version'."""
        kwargs = dict(self._default_instance)
        if instance_version:
            kwargs["instance_version"] = instance_version
        return self.add_instance(**kwargs)

    def drain(self, iid: str):
        """Graceful drain + terminate (reconfig/drain.py semantics): the
        instance pre-copies its hot copies to survivors, deregisters,
        and only then dies. Returns the DrainReport."""
        from modelmesh_tpu_torch.reconfig.drain import DrainController

        pod = self.by_id(iid)
        if not pod.alive:
            return None
        report = DrainController(pod.instance).drain()
        self.drain_reports[iid] = report
        self.kill(iid)
        return report

    def rolling_upgrade(
        self, target_version: str, max_unavailable: int = 1,
    ):
        """Drive the fleet to ``target_version`` in drain waves — the
        reconfig/rolling.py coordinator with its hooks mapped onto this
        cluster. Runs synchronously on the calling (worker) thread."""
        from modelmesh_tpu_torch.reconfig.rolling import RollingUpgradeCoordinator

        def list_instances():
            return [
                (p.iid, p.instance._build_instance_record())
                for p in self.live_pods()
            ]

        def replace(_old_iid: str, version: str) -> str:
            return self.spawn(version).iid

        def wait_ready(expect_n: int) -> None:
            # Readiness = every live pod SEES every live pod (the
            # replacements included) — a raw count would be satisfied by
            # the killed pods' not-yet-deleted records and let the next
            # wave start while replacements are invisible to routing.
            live_ids = {p.iid for p in self.live_pods()}
            for pod in self.live_pods():
                pod.instance.instances_view.wait_for(
                    lambda v: live_ids <= {iid for iid, _ in v.items()},
                    timeout=10,
                )

        coordinator = RollingUpgradeCoordinator(
            target_version,
            list_instances=list_instances,
            drain_instance=self.drain,
            replace_instance=replace,
            wait_ready=wait_ready,
            max_unavailable=max_unavailable,
        )
        report = coordinator.run()
        self.upgrade_report = report
        return report

    def kill(self, iid: str) -> None:
        """Crash an instance: tasks stop, the serving surface vanishes,
        the session lease is revoked (peers see the ephemeral record
        disappear) — no graceful migration."""
        pod = self.by_id(iid)
        if not pod.alive:
            return
        self.deaths.setdefault(iid, _clock.get_clock().now_ms())
        pod.alive = False
        pod.tasks.stop()
        pod.instance.shutting_down = True
        pod.instance.loading_pool.shutdown()
        pod.instance._session.close()
        pod.instance._election.close()
        pod.instance.registry_view.close()
        pod.instance.instances_view.close()

    def partition(self, iid: str) -> None:
        self.kv.partition(iid)

    def heal(self, iid: str) -> None:
        self.kv.heal(iid)

    def expire_lease(self, iid: str) -> bool:
        pod = self.by_id(iid)
        return self.kv.expire_instance_session(pod.instance._session.key)

    def slow_load(self, iid: str, model_id: str, delay_ms: float) -> None:
        self.by_id(iid).loader.set_slow(model_id, delay_ms)

    def fail_next_load(self, iid: str, model_id: str) -> None:
        self.by_id(iid).loader.set_fail_next(model_id)

    # -- workload ----------------------------------------------------------

    def live_pods(self) -> list[SimPod]:
        return [p for p in self.pods if p.alive]

    def first_live(self) -> SimPod:
        pods = self.live_pods()
        if not pods:
            raise RuntimeError("no live instances")
        return pods[0]

    def register(self, model_id: str, model_type: str = "sim",
                 scheme: str = "mem") -> None:
        # ``scheme`` picks the model-path family: "mem" (default) is a
        # store-only spec, a layer-streamable family name (e.g. "mlp")
        # makes the model eligible for sharded placement groups.
        try:
            self.first_live().instance.register_model(
                model_id, ModelInfo(model_type, f"{scheme}://{model_id}")
            )
        except Exception as e:  # noqa: BLE001 — registration may race faults
            log.debug("sim register(%s) raced a fault: %s", model_id, e)

    def ensure(self, model_id: str, chain: int = 0) -> None:
        self.demanded.add(model_id)
        try:
            self.first_live().instance.ensure_loaded(
                model_id, sync=False, chain=chain
            )
        except Exception as e:  # noqa: BLE001 — demand may race faults
            log.debug("sim ensure(%s) raced a fault: %s", model_id, e)

    def invoke(self, model_id: str, via: Optional[str] = None) -> None:
        """One probe request, entered at ``via`` (default: first live
        pod), traced end-to-end (sim pods trace every root), and logged
        as (virtual_ms, model, ok, error, virtual_latency_ms) — the SLO
        invariant's observed-traffic witness."""
        self.demanded.add(model_id)
        clock = _clock.get_clock()
        now = clock.now_ms()
        try:
            pod = self.by_id(via) if via else self.first_live()
            with pod.instance.tracer.trace("", model_id, "/sim/Predict"):
                pod.instance.invoke_model(model_id, "/sim/Predict", b"x", [])
        except Exception as e:  # noqa: BLE001 — demand may race faults
            self.request_log.append(
                (now, model_id, False, f"{type(e).__name__}: {e}",
                 clock.now_ms() - now)
            )
            log.debug("sim invoke(%s) raced a fault: %s", model_id, e)
        else:
            self.request_log.append(
                (now, model_id, True, "", clock.now_ms() - now)
            )

    def unregister(self, model_id: str) -> None:
        try:
            self.first_live().instance.unregister_model(model_id)
            self.demanded.discard(model_id)
        except Exception as e:  # noqa: BLE001
            log.debug("sim unregister(%s) raced a fault: %s", model_id, e)

    # -- quiescence --------------------------------------------------------

    def pools_pending(self) -> int:
        """Queued/running async janitorial tasks (deregisters, unloads,
        deletion cleanups) across live pods. Non-zero at invariant time
        means a registry mutation is still in flight — the source of the
        registry_cache_convergence flake the quiesce drain closes."""
        total = 0
        for pod in self.live_pods():
            inst = pod.instance
            total += inst._unload_pool.pending + inst._cleanup_pool.pending
        return total

    def quiesce_async_work(
        self, clock, step_ms: int = 2_000, wall_timeout_s: float = 10.0,
    ) -> bool:
        """Pump virtual time until every pod's cleanup/unload pool is
        idle (a pending task may be sleeping on injected virtual
        latency). Wall-bounded: a task wedged on something external
        (e.g. an unreleased hold gate) times out rather than hanging the
        run — the caller's inline janitor pass then repairs whatever the
        stuck mutation would have."""
        import time as _wall

        deadline = _wall.monotonic() + wall_timeout_s  #: wall-clock: bounds REAL pool-thread progress (docstring above) — the clock is the thing being pumped here
        while self.pools_pending():
            if _wall.monotonic() >= deadline:  #: wall-clock: same wall bound as above
                return False
            clock.advance(step_ms)
            _wall.sleep(0.001)  #: wall-clock: yields to real pool threads between virtual pumps
        return True

    # -- teardown ----------------------------------------------------------

    def close(self) -> None:
        for pod in self.pods:
            if pod.alive:
                pod.tasks.stop()
                try:
                    pod.instance.shutdown()
                except Exception:  # noqa: BLE001 — faults may be armed
                    pass
                pod.alive = False
        self.kv.close()
