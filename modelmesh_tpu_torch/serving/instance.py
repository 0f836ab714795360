"""The port's own copy of the JAX package's ``serving/instance.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

ModelMeshInstance: the serving-instance core.

The equivalent of the reference's ModelMesh.java central class, decomposed:
this module owns local model lifecycle + request routing; background tasks
live in serving/tasks.py, the gRPC surfaces in serving/api.py, vmodels in
serving/vmodels.py.

Responsibilities (reference call stacks in SURVEY.md section 3):
- initialize: loader startup -> capacity; KV tables + views; instance
  session node; leader election                      (initialize :524)
- registerModel/unregisterModel/getStatus/ensureLoaded (:3074-3247)
- invoke_model: the routing uber-method — local fast path, cache-hit
  forwarding with exclusion lists, cache-miss placement + local load
  (invokeModel :3421-4001)
- load lifecycle: CAS registry placement, priority queue, space wait,
  sizing, failure bookkeeping                         (loadLocal :5028,
  CacheEntry.run :2145)
- eviction -> unload accounting + deregistration      (onEviction :2867)
- instance-record publishing with change suppression  (publishInstanceRecord
  :5391)
- shutdown migration: deregister, trigger copies elsewhere, drain
  (preShutdown :6959)
"""

from __future__ import annotations

import logging
import threading
import time as _time
import uuid
from typing import Callable, Optional

from modelmesh_tpu_torch.cache.lru import WeightedLRUCache, now_ms
from modelmesh_tpu_torch.kv.session import LeaderElection, SessionNode
from modelmesh_tpu_torch.kv.store import CasFailed, KVStore
from modelmesh_tpu_torch.kv.table import (
    BucketedKVTable,
    KVTable,
    TableEvent,
    TableView,
)
from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
from modelmesh_tpu_torch.placement.strategy import (
    LOAD_HERE,
    ClusterView,
    PlacementRequest,
    PlacementStrategy,
)
from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch.runtime.spi import (
    ModelInfo,
    ModelLoader,
    ModelLoadException,
    ModelNotLoadedError,
)
from modelmesh_tpu_torch.serving.batching import BatchCancelled, RequestBatcher
from modelmesh_tpu_torch.serving.entry import (
    CacheEntry,
    EntryState,
    PrioritizedLoadingPool,
    UnloadTracker,
    bytes_to_units,
)
from modelmesh_tpu_torch.serving.errors import (
    ModelNotFoundError,
    ModelNotHereError,
    NoCapacityError,
    ReadOnlyModeError,
    RequestCancelledError,
    ServiceUnavailableError,
)
from modelmesh_tpu_torch.observability.metrics import Metric as MX
from modelmesh_tpu_torch.observability.tracing import Tracer, outgoing_headers
from modelmesh_tpu_torch.serving.rate import RateTracker
from modelmesh_tpu_torch.serving.route_cache import LoadFeedback, RouteCache
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.lockdebug import mm_lock
from modelmesh_tpu_torch.utils.pool import BoundedDaemonPool

log = logging.getLogger(__name__)

MAX_ITERATIONS = 8          # routing loop bound (reference :283)
# Reject churn: when full, don't evict entries younger than this for a new
# load (reference minChurnAgeMs, :3872-3884).
DEFAULT_MIN_CHURN_AGE_MS = 60_000
# Backdate applied to explicit registrations so fresh-but-unused models are
# first victims (reference backdates 1h/6h, ModelMesh.java:3097-3147).
REGISTRATION_BACKDATE_MS = 3_600_000


class _NoPublishLease(Exception):
    """Session lease not live yet — the merged promote+publish txn cannot
    ride it; fall back to the plain promote CAS."""


class RoutingContext:
    """Per-request routing state (proto mesh_internal.RoutingContext)."""

    __slots__ = (
        "hop", "exclude_serve", "exclude_load", "visited",
        "dest_instance", "chain_load_count", "known_size_bytes",
        "last_used_ms", "cancel_event",
    )

    EXTERNAL = 0
    INTERNAL = 1
    HIT_ONLY = 2
    LOAD_LOCAL_ONLY = 3
    HOP_NAMES = ("external", "internal", "hit-only", "load-local")

    def __init__(
        self,
        hop: int = EXTERNAL,
        exclude_serve: Optional[set[str]] = None,
        exclude_load: Optional[set[str]] = None,
        visited: Optional[set[str]] = None,
        dest_instance: str = "",
        chain_load_count: int = 0,
        known_size_bytes: int = 0,
        last_used_ms: int = 0,
        cancel_event=None,
    ):
        self.hop = hop
        self.exclude_serve = exclude_serve or set()
        self.exclude_load = exclude_load or set()
        self.visited = visited or set()
        self.dest_instance = dest_instance
        self.chain_load_count = chain_load_count
        self.known_size_bytes = known_size_bytes
        self.last_used_ms = last_used_ms
        # threading.Event set when the external client disconnects; checked
        # on routing iterations and inside blocking waits so cancelled
        # requests stop consuming slots (ModelMeshApi.java:709-729).
        self.cancel_event = cancel_event

    @property
    def cancelled(self) -> bool:
        return self.cancel_event is not None and self.cancel_event.is_set()


class InvokeResult:
    __slots__ = ("payload", "served_by", "status", "feedback")

    def __init__(self, payload: bytes, served_by: str, status: str,
                 feedback=None):
        self.payload = payload
        self.served_by = served_by
        self.status = status
        # Piggybacked load feedback (route_cache.LoadFeedback) from the
        # IMMEDIATE peer a Forward was sent to — the mm-load response
        # trailer on the wire, attached directly by the sim/bench
        # transports. None on local results and feedback-less peers.
        self.feedback = feedback


# peer_call(instance_record.endpoint, model_id, method, payload, headers, ctx)
PeerCall = Callable[..., InvokeResult]


class InstanceConfig:
    def __init__(
        self,
        instance_id: Optional[str] = None,
        kv_prefix: str = "mm",
        endpoint: str = "",
        zone: str = "",
        location: str = "",
        labels: Optional[list[str]] = None,
        instance_version: str = "",
        load_timeout_s: Optional[float] = None,
        space_wait_s: float = 30.0,
        min_churn_age_ms: int = DEFAULT_MIN_CHURN_AGE_MS,
        publish_interval_s: float = 8.0,
        read_only: Optional[bool] = None,
        load_fastpath: Optional[bool] = None,
        publish_coalesce_ms: Optional[int] = None,
        peer_fetch: Optional[bool] = None,
        host_tier_bytes: Optional[int] = None,
        drain_on_sigterm: Optional[bool] = None,
        drain_timeout_ms: Optional[int] = None,
        trace_sample: Optional[int] = None,
        slo_spec: Optional[str] = None,
        slo_window_ms: Optional[int] = None,
        batch_max: Optional[int] = None,
        batch_window_us: Optional[int] = None,
        route_d: Optional[int] = None,
        feedback_decay_ms: Optional[int] = None,
        admission: Optional[bool] = None,
        admission_queue_ms: Optional[int] = None,
        sharded: Optional[bool] = None,
        sharded_max_shards: Optional[int] = None,
    ):
        self.instance_id = instance_id or f"i-{uuid.uuid4().hex[:8]}"  # analysis-ok: det-entropy — deliberately unique process identity; every replay-bearing path (sim, scenarios) passes an explicit instance_id
        self.kv_prefix = kv_prefix.rstrip("/")
        self.endpoint = endpoint
        self.zone = zone
        self.location = location
        self.labels = labels or []
        self.instance_version = instance_version
        self.load_timeout_s = load_timeout_s
        self.space_wait_s = space_wait_s
        self.min_churn_age_ms = min_churn_age_ms
        self.publish_interval_s = publish_interval_s
        # KV-migration read-only mode (reference readOnlyMode,
        # ModelMesh.java:200-204): registry mutations are blocked and
        # reaper pruning suppressed while the operator migrates between
        # disjoint KV stores (copies registered in the OTHER store look
        # like dead instances from here and must not be pruned).
        if read_only is None:
            from modelmesh_tpu_torch.utils import envs

            read_only = bool(envs.get_int("MM_KV_READ_ONLY"))
        self.read_only = read_only
        # Cold-start/scale-up fast path (MM_LOAD_FASTPATH): activate an
        # entry as soon as the runtime load returns (sizing becomes an
        # overlapped follow-up correction) and fan secondary chained
        # copies out concurrently at claim time instead of hop-by-hop
        # after each completion.
        if load_fastpath is None:
            from modelmesh_tpu_torch.utils import envs

            load_fastpath = envs.get_bool("MM_LOAD_FASTPATH")
        self.load_fastpath = load_fastpath
        # Trailing-flush window for NON-forced instance-record publishes
        # (MM_PUBLISH_COALESCE_MS, 0 = publish inline): a mass load/unload
        # storm collapses its O(models) advertisement refreshes into O(1)
        # KV puts. force=True always bypasses.
        if publish_coalesce_ms is None:
            from modelmesh_tpu_torch.utils import envs

            publish_coalesce_ms = envs.get_int("MM_PUBLISH_COALESCE_MS")
        self.publish_coalesce_ms = publish_coalesce_ms
        # Live scale-up transfer path (transfer/): peer-to-peer weight
        # streaming (MM_PEER_FETCH) and the host-RAM staging tier budget
        # (MM_HOST_TIER_BYTES, 0 disables the tier). Both are inert
        # unless the loader declares supports_weight_streaming. (Chunk
        # granularity, MM_TRANSFER_CHUNK_BYTES, belongs to the exporting
        # loader's serialization — no per-instance knob here.)
        from modelmesh_tpu_torch.utils import envs as _envs

        if peer_fetch is None:
            peer_fetch = _envs.get_bool("MM_PEER_FETCH")
        self.peer_fetch = peer_fetch
        if host_tier_bytes is None:
            host_tier_bytes = _envs.get_int("MM_HOST_TIER_BYTES")
        self.host_tier_bytes = host_tier_bytes
        # Graceful drain (reconfig/drain.py): pre_shutdown runs the
        # DrainController (DRAINING advertisement, survivor pre-copy over
        # the transfer path, then deregister) instead of the legacy
        # immediate shutting_down migration. MM_DRAIN_TIMEOUT_MS bounds
        # the pre-copy pass.
        if drain_on_sigterm is None:
            drain_on_sigterm = _envs.get_bool("MM_DRAIN_ON_SIGTERM")
        self.drain_on_sigterm = drain_on_sigterm
        if drain_timeout_ms is None:
            drain_timeout_ms = _envs.get_int("MM_DRAIN_TIMEOUT_MS")
        self.drain_timeout_ms = drain_timeout_ms
        # Observability substrate: head-sampling for minted trace roots
        # (MM_TRACE_SAMPLE; 1 = trace every request — the sim pins this
        # so scenario assertions are deterministic) and the declarative
        # per-model-class SLO spec (MM_SLO_SPEC grammar,
        # observability/slo.py).
        if trace_sample is None:
            trace_sample = _envs.get_int("MM_TRACE_SAMPLE")
        self.trace_sample = trace_sample
        if slo_spec is None:
            slo_spec = _envs.get("MM_SLO_SPEC")
        self.slo_spec = slo_spec
        # Sliding attainment window (MM_SLO_WINDOW_MS). Overridable per
        # instance so sims/benches can judge burn over their own (much
        # shorter) timelines without touching process env state.
        if slo_window_ms is None:
            slo_window_ms = _envs.get_int("MM_SLO_WINDOW_MS")
        self.slo_window_ms = slo_window_ms
        # Batched data plane (serving/batching.py): continuous-batching
        # micro-batch queue in front of the runtime call. batch_max <= 1
        # disables the queue; the window (µs) bounds how long a batch
        # leader waits for the batch to fill (0 = dispatch immediately —
        # batches still form behind in-flight dispatches). Only engaged
        # when the loader really batches (supports_batched_dispatch) or
        # a batched runtime call is injected.
        if batch_max is None:
            batch_max = _envs.get_int("MM_BATCH_MAX")
        self.batch_max = batch_max
        if batch_window_us is None:
            batch_window_us = _envs.get_int("MM_BATCH_WINDOW_US")
        self.batch_window_us = batch_window_us
        # Load-aware fused routing (serving/route_cache.py): candidate
        # sampled per pick (MM_ROUTE_D; 1 = the old single-winner cache,
        # regression-pinned) and the staleness horizon for piggybacked
        # load feedback (MM_FEEDBACK_DECAY_MS). Admission control
        # (serving/admission.py): SLO-burn-modulated per-class shedding
        # at the external edge (MM_ADMISSION, default off) with a
        # bounded pre-shed queue window (MM_ADMISSION_QUEUE_MS).
        if route_d is None:
            route_d = _envs.get_int("MM_ROUTE_D")
        self.route_d = route_d
        if feedback_decay_ms is None:
            feedback_decay_ms = _envs.get_int("MM_FEEDBACK_DECAY_MS")
        self.feedback_decay_ms = feedback_decay_ms
        if admission is None:
            admission = _envs.get_bool("MM_ADMISSION")
        self.admission = admission
        if admission_queue_ms is None:
            admission_queue_ms = _envs.get_int("MM_ADMISSION_QUEUE_MS")
        self.admission_queue_ms = admission_queue_ms
        # Sharded execution (MM_SHARDED): models too big for any single
        # instance place as multi-instance GROUPS (one weight shard per
        # member, SHARDED entry state; routing targets only complete
        # groups). MM_SHARDED_MAX_SHARDS bounds the group width. Inert
        # unless the loader declares supports_sharded_execution.
        if sharded is None:
            sharded = _envs.get_bool("MM_SHARDED")
        self.sharded = sharded
        if sharded_max_shards is None:
            sharded_max_shards = _envs.get_int("MM_SHARDED_MAX_SHARDS")
        self.sharded_max_shards = sharded_max_shards


class ModelMeshInstance:
    def __init__(
        self,
        store: KVStore,
        loader: ModelLoader,
        config: Optional[InstanceConfig] = None,
        strategy: Optional[PlacementStrategy] = None,
        peer_call: Optional[PeerCall] = None,
        runtime_call: Optional[Callable[..., bytes]] = None,
        metrics=None,
        constraints=None,
        upgrade_tracker=None,
        probation=None,
        peer_fetch=None,
        runtime_call_batch=None,
    ):
        """``peer_call(endpoint, model_id, method, payload, headers, ctx)``
        forwards to a peer (gRPC in production, direct-call in tests).
        ``runtime_call(entry, method, payload, headers, cancel_event=None)``
        executes inference against the local runtime (defaults to
        SidecarRuntime.call_model when the loader is a SidecarRuntime); a
        callable without the cancel_event parameter is still accepted —
        cancellation then can't interrupt the call itself, only the waits
        around it. ``runtime_call_batch(items, cancel_event=None) ->
        list[bytes | Exception]`` executes a whole micro-batch (aligned
        results; Exception entries fail individual items) — when given,
        or when the loader declares ``supports_batched_dispatch``, the
        continuous-batching queue (serving/batching.py) engages in front
        of the runtime call. ``peer_fetch(endpoint, model_id, chunk_index,
        fingerprint) -> FetchReply`` pulls one weight chunk from a peer
        (the mesh-internal FetchWeights channel; gRPC in production,
        direct-call in the sim/bench) — None disables peer streaming on
        this instance regardless of config.peer_fetch."""
        self.config = config or InstanceConfig()
        self.instance_id = self.config.instance_id
        self.load_fastpath = self.config.load_fastpath
        self.store = store
        self.loader = loader
        self.strategy = strategy or GreedyStrategy()
        self._peer_call = peer_call
        self._runtime_call = runtime_call or self._default_runtime_call
        import inspect as _inspect

        try:
            self._runtime_call_cancellable = (
                "cancel_event"
                in _inspect.signature(self._runtime_call).parameters
            )
        except (TypeError, ValueError):
            self._runtime_call_cancellable = False
        self.shutting_down = False
        # Admin drain via dynamic config `disable` (ModelMesh.java:1008-1061):
        # stop taking NEW loads/placements; keep serving what's loaded.
        self.disabled = False
        # Graceful drain in progress (reconfig/drain.py): advertised in
        # the instance record so peers stop placing here and deprioritize
        # us as a serve target while the drain pre-copies to survivors.
        # Written only through set_draining so every drain-state flip
        # lands in the flight recorder (state-funnel rule).
        #: state-funnel: set_draining
        self.draining = False
        # Dynamic config `log_each_invocation`.
        self.log_each_invocation = False
        self.is_leader = False
        if metrics is None:
            from modelmesh_tpu_torch.observability.metrics import NoopMetrics

            metrics = NoopMetrics()
        self.metrics = metrics
        # Optional placement filters (serving/constraints.py): model-type ->
        # label requirements, and rolling-update replicaset avoidance.
        self.constraints = constraints
        self.upgrade_tracker = upgrade_tracker
        # Bootstrap fail-fast (serving/health.py): early load outcomes are
        # reported while the probation window is armed. The window is
        # re-stamped after loader.startup() below (it can block for minutes
        # on a cold accelerator claim).
        self.probation = probation

        params = loader.startup()
        if probation is not None:
            probation.reset_window()
        self.params = params
        self.load_timeout_s = (
            self.config.load_timeout_s
            if self.config.load_timeout_s is not None
            else params.load_timeout_ms / 1000.0
        )

        from modelmesh_tpu_torch.observability.flightrec import FlightRecorder
        from modelmesh_tpu_torch.observability.slo import SloTracker
        from modelmesh_tpu_torch.serving.timestats import TimeStats

        # A Noop backend gets no sink at all: the SLO tracker's amortized
        # gauge export sorts its window, and the tracer's stage lookup is
        # a dict probe per span — neither belongs on the hot path when
        # nothing renders the result.
        from modelmesh_tpu_torch.observability.metrics import NoopMetrics as _Noop

        sink = None if isinstance(self.metrics, _Noop) else self.metrics
        self.tracer = Tracer(
            self.instance_id, metrics=sink,
            sample_n=self.config.trace_sample,
        )
        self.flightrec = FlightRecorder(instance_id=self.instance_id)
        self.slo = SloTracker(
            spec=self.config.slo_spec, metrics=sink,
            window_ms=self.config.slo_window_ms,
        )
        self.time_stats = TimeStats()
        # Strategies that accept per-type load-time stats (greedy's warming
        # penalty and wait-vs-reroute bound) get this instance's tracker.
        for strat in (self.strategy, getattr(self.strategy, "fallback", None)):
            if strat is None:
                continue
            if hasattr(strat, "time_stats"):
                strat.time_stats = self.time_stats
            if hasattr(strat, "constraints") and strat.constraints is None:
                strat.constraints = self.constraints

        self.cache: WeightedLRUCache[str, CacheEntry] = WeightedLRUCache(
            params.capacity_units, eviction_listener=self._on_eviction
        )
        self.unload_tracker = UnloadTracker(params.capacity_units)
        self.loading_pool = PrioritizedLoadingPool(params.load_concurrency)
        # Bounded pools for janitorial work: a mass unregistration of a
        # full cache must queue behind a few workers, not spawn a thread
        # per model (reference ModelMesh.java:2807-2814 uses a shared
        # pool). Two pools, not one — unload tasks release
        # unload_tracker reservations that wait_for_space depends on, so
        # they must never queue behind KV-heavy deletion cleanups during
        # an outage (KV RPCs are 10 s-deadline-bounded, runtime UnloadModel
        # 30 s-bounded, and CAS loops give up, so tasks cannot wedge
        # forever — but head-of-line delay on accounting would still fail
        # unrelated loads). Daemon workers: a task stuck on a dying KV
        # must not block interpreter exit.
        self._cleanup_pool = BoundedDaemonPool(max_workers=4, name="del-clean")
        self._unload_pool = BoundedDaemonPool(max_workers=4, name="unloads")
        self.rate = RateTracker()
        #: guarded-by: _model_rates_lock
        self._model_rates: dict[str, RateTracker] = {}
        self._model_rates_lock = mm_lock("ModelMeshInstance._model_rates_lock")
        # model_id -> failfast-until timestamp (KV-outage sentinels).
        #: shared-ok: GIL-atomic sentinel map; a lost prune/insert costs one extra registry probe, never a wrong answer
        self._kv_failfast: dict[str, int] = {}
        # Request-path fast path: the epoch-keyed ClusterView snapshot
        # (rebuilt only when the instances view moves) and the per-model
        # candidate-set route memo (serving/route_cache.py) with its
        # load-feedback view. Created before the registry listener below
        # is registered — it invalidates through this cache. The
        # d-choices sampler seed derives from the instance id:
        # deterministic per pod (sim replay) but spread across a fleet.
        import zlib as _zlib

        self.route_cache = RouteCache(
            route_d=self.config.route_d,
            feedback_decay_ms=self.config.feedback_decay_ms,
            seed=_zlib.crc32(self.instance_id.encode()),
        )
        #: shared-ok: benign last-writer-wins memo — concurrent rebuilds install equally-fresh views (see cluster_view)
        self._cluster_view_cache: Optional[ClusterView] = None
        # Local in-flight gauge for the piggybacked feedback trailer:
        # requests currently executing against THIS runtime (between the
        # concurrency-gate acquire and release in _invoke_local). A
        # dedicated lock, not a racy int — feedback drift would
        # permanently skew peers' view of us.
        self._inflight = 0  #: guarded-by: _inflight_lock
        self._inflight_lock = mm_lock("ModelMeshInstance._inflight_lock")
        # Admission controller at the external edge (serving/
        # admission.py): priorities and burn rates come from THIS
        # instance's SLO tracker; sheds are typed, counted, and flight-
        # recorded. Off (the default) it is a single attribute check.
        from modelmesh_tpu_torch.serving.admission import AdmissionController

        self.admission_controller = AdmissionController(
            self.slo,
            enabled=self.config.admission,
            queue_ms=self.config.admission_queue_ms,
            metrics=sink,
            flightrec=self.flightrec,
        )

        # Weight-transfer subsystem (transfer/): host-RAM staging tier +
        # peer-to-peer streaming manager. The host-tier eviction listener
        # only SCHEDULES the registry host-claim cleanup — it runs under
        # the tier's lock.
        from modelmesh_tpu_torch.cache.lru import HostTier
        from modelmesh_tpu_torch.transfer.manager import (
            TransferConfig,
            WeightTransferManager,
        )

        self.transfer_config = TransferConfig(
            peer_fetch=self.config.peer_fetch,
            host_tier_bytes=self.config.host_tier_bytes,
        )
        self.host_tier = HostTier(
            self.transfer_config.host_tier_bytes,
            eviction_listener=self._on_host_tier_evict,
        )
        self.peer_fetch_transport = peer_fetch
        self.transfer = WeightTransferManager(self)

        # Batched data plane (serving/batching.py): engaged only when
        # there is a REAL batched dispatch to gain from — an injected
        # runtime_call_batch (sim/bench twins) or a loader whose
        # call_model_batch executes the micro-batch as one kernel
        # (models/server.py). A loader whose batch path merely loops
        # over singles would SERIALIZE what used to run concurrently,
        # so it keeps the classic one-at-a-time path.
        self._runtime_call_batch = runtime_call_batch or (
            loader.call_model_batch
            if getattr(loader, "supports_batched_dispatch", False)
            else None
        )
        self.batcher: Optional[RequestBatcher] = None
        if self._runtime_call_batch is not None and self.config.batch_max > 1:
            self.batcher = RequestBatcher(
                self._batch_call_one,
                self._batch_call_many,
                group_key=getattr(loader, "batch_group_key", None),
                batch_max=self.config.batch_max,
                window_us=self.config.batch_window_us,
                metrics=self.metrics,
                flightrec=self.flightrec,
            )

        prefix = self.config.kv_prefix
        # Live registry-migration fence (kv/migrate.py): while an
        # operator-run flat->bucketed migration advertises its epoch,
        # the registry table dual-reads (bucketed preferred) and every
        # CAS against a flat-read record moves it — the fleet keeps
        # serving through the layout change.
        from modelmesh_tpu_torch.kv.migrate import MigrationFence

        self.migration_fence = MigrationFence(store, prefix)
        # Bucketed (128): scans page bucket-by-bucket so no range RPC
        # carries the whole 100k-model registry (reference ModelMesh.java:169).
        self.registry: KVTable[ModelRecord] = BucketedKVTable(
            store, f"{prefix}/registry", ModelRecord,
            migration_fence=self.migration_fence,
        )
        self.registry_view: TableView[ModelRecord] = TableView(self.registry)
        self.instances: KVTable[InstanceRecord] = KVTable(
            store, f"{prefix}/instances", InstanceRecord
        )
        self.instances_view: TableView[InstanceRecord] = TableView(self.instances)

        # Cached self-advertisement, reused as the cluster-view fallback
        # until our published record round-trips through the watch —
        # refreshed only on publish, not rebuilt per request. Rebinds are
        # guarded; lock-free reads (cluster_view) see old-or-new whole.
        #: guarded-by: _publish_lock [rebind]
        self._self_record = self._build_instance_record()
        self._session = SessionNode(
            store,
            f"{prefix}/instances/{self.instance_id}",
            self._self_record.to_bytes(),
            ttl_s=10.0,
        )
        self._session.start()
        self._election = LeaderElection(
            store, f"{prefix}/leader", self.instance_id, self._on_leader_change
        )
        self._election.start()
        # Fleet-wide plan distribution: any strategy that can adopt a
        # published GlobalPlan (the JAX strategy) follows the leader's
        # solves via a KV watch — non-leaders serve the central plan too,
        # not just the process that happened to solve it.
        self._plan_follower = None
        if hasattr(self.strategy, "adopt"):
            from modelmesh_tpu_torch.placement.plan_sync import PlanFollower

            self._plan_follower = PlanFollower(store, prefix, self.strategy)
        self._publish_lock = mm_lock("ModelMeshInstance._publish_lock")
        # Serializes standalone advertisement puts in BUILD order (see
        # _publish_now). Only publishers ever take it — never the load
        # or request paths — so a wedged KV round trip convoys at most
        # other publishers, exactly like the pre-fast-path behavior.
        self._publish_io_lock = mm_lock("ModelMeshInstance._publish_io_lock")
        #: guarded-by: _publish_lock
        self._last_published: Optional[InstanceRecord] = None
        # Publish coalescer state (trailing-flush window; see
        # publish_instance_record).
        self._coalesce_lock = mm_lock("ModelMeshInstance._coalesce_lock")
        # cancel()-able one-shot from Clock.call_later (threading.Timer or
        # a virtual timer handle).
        self._publish_timer = None  #: guarded-by: _coalesce_lock
        self._shutdown_publishes = False  #: guarded-by: _coalesce_lock
        # Watch-driven deletion cleanup (reference registers a registry
        # listener at ModelMesh.java:629; the deletion handler at :2807
        # removes local copies at :2814): when a model is unregistered
        # ANYWHERE, every holder drops its copy within watch latency
        # instead of serving a deleted model until the next janitor pass.
        self.registry_view.add_listener(self._on_registry_event)
        log.info(
            "instance %s up: %d units capacity, %d load threads",
            self.instance_id, params.capacity_units, params.load_concurrency,
        )

    # ------------------------------------------------------------------ #
    # cluster views                                                      #
    # ------------------------------------------------------------------ #

    def cluster_view(self) -> ClusterView:
        """Epoch-cached immutable snapshot: the instances table is copied
        only when the watch-fed view actually moved, not per request —
        steady-state routing shares one ClusterView object (and its
        cached live/placeable/live_map derivations) across requests."""
        view = self._cluster_view_cache
        if view is not None and view.epoch == self.instances_view.epoch:
            return view
        epoch, items = self.instances_view.snapshot()
        self_rec = None
        if not any(iid == self.instance_id for iid, _ in items):
            # A node always knows itself: right after startup our own
            # published record may not have round-tripped through the async
            # KV watch yet, and an empty view would make placement reject
            # the first request (NoCapacityError) instead of loading here.
            # The fallback record is the cached self-advertisement
            # (refreshed on publish), not a per-request rebuild.
            self_rec = self._self_record
            items.append((self.instance_id, self_rec))
        view = ClusterView(instances=tuple(items), epoch=epoch)
        # Benign race: concurrent rebuilds both install a view at-least-as
        # fresh as the epoch they recorded; last writer wins.
        self._cluster_view_cache = view
        if self_rec is not None and self_rec is not self._self_record:
            # A publish slipped between reading the fallback and installing
            # the view; its cache invalidation may have fired BEFORE our
            # install and been overwritten (the epoch alone can't catch
            # this — our own unreflected publishes don't move it). Drop
            # the just-installed view; every interleaving converges: a
            # publish after this re-check invalidates after our install.
            self._cluster_view_cache = None
        return view

    # KV outage fail-fast: after a registry read error, requests for THAT
    # model fail immediately (UNAVAILABLE) for a cooldown window instead of
    # hammering the dead store, then self-heal — per-model sentinels like
    # the reference's KVSTORE_LOAD_FAILURE cache entries
    # (ModelMesh.java:5295-5350). Models already in the local cache or the
    # watch-fed view are unaffected (serving continues through an outage).
    KV_FAILFAST_COOLDOWN_MS = 30_000

    def _registry_get_failfast(self, model_id: str):
        until = self._kv_failfast.get(model_id, 0)
        if now_ms() < until:
            raise ServiceUnavailableError(
                f"registry unavailable for {model_id} (cooling down)"
            )
        try:
            mr = self.registry.get(model_id)
            self._kv_failfast.pop(model_id, None)
            return mr
        except Exception as e:  # noqa: BLE001 — any store error trips it
            now = now_ms()
            # Prune expired sentinels on insert so externally-driven id
            # churn can't grow the dict without bound.
            if len(self._kv_failfast) > 1024:
                self._kv_failfast = {
                    k: v for k, v in self._kv_failfast.items() if v > now
                }
            self._kv_failfast[model_id] = now + self.KV_FAILFAST_COOLDOWN_MS
            log.error("registry read of %s failed; failing fast for %ds: %s",
                      model_id, self.KV_FAILFAST_COOLDOWN_MS // 1000, e)
            raise ServiceUnavailableError(f"registry unavailable: {e}") from e

    def _model_rate(self, model_id: str) -> RateTracker:
        with self._model_rates_lock:
            rt = self._model_rates.get(model_id)
            if rt is None:
                rt = self._model_rates[model_id] = RateTracker()
            return rt

    def model_rpm(self, model_id: str, window_minutes: int = 5) -> int:
        with self._model_rates_lock:
            rt = self._model_rates.get(model_id)
        return rt.rpm(window_minutes) if rt else 0

    def _drop_model_rate(self, model_id: str) -> None:
        with self._model_rates_lock:
            self._model_rates.pop(model_id, None)

    def _on_leader_change(self, is_leader: bool) -> None:
        self.is_leader = is_leader
        log.info("instance %s leader=%s", self.instance_id, is_leader)

    # ------------------------------------------------------------------ #
    # instance record publishing                                         #
    # ------------------------------------------------------------------ #

    def _build_instance_record(self) -> InstanceRecord:
        cache = getattr(self, "cache", None)
        return InstanceRecord(
            start_ts=now_ms(),
            lru_ts=(cache.oldest_time() or 0) if cache else 0,
            model_count=len(cache) if cache else 0,
            capacity_units=self.params.capacity_units if hasattr(self, "params") else 0,
            used_units=(cache.weight if cache else 0)
            + (self.unload_tracker.pending_units if hasattr(self, "unload_tracker") else 0),
            loading_in_progress=0,
            req_per_minute=self.rate.rpm() if hasattr(self, "rate") else 0,
            shutting_down=self.shutting_down,
            disabled=self.disabled,
            draining=self.draining,
            endpoint=self.config.endpoint,
            location=self.config.location,
            zone=self.config.zone,
            labels=list(self.config.labels),
            instance_version=self.config.instance_version,
        )

    def set_draining(self, value: bool) -> None:
        """The ONE write funnel for the ``draining`` flag (state-funnel
        rule, like ``CacheEntry._transition_locked``): every drain-state
        flip lands in the flight recorder, so a shutdown investigation
        can see exactly when the instance stopped accepting placements.
        Callers publish the record themselves — flipping and advertising
        are separate steps by design (the drain controller forces the
        publish so the epoch bump is immediate)."""
        prev = self.draining
        self.draining = value
        if prev != value:
            self.flightrec.record("drain-flag", to=str(value).lower())

    def publish_instance_record(self, force: bool = False) -> None:
        """Refresh our advertisement; suppress no-op updates (reference
        change-suppression, ModelMesh.java:5440-5468).

        Non-forced publishes coalesce behind a trailing-flush window
        (``publish_coalesce_ms``): the first request arms a one-shot
        flush timer, later requests inside the window ride it, and the
        flush publishes the freshest record — a mass load/unload storm
        issues O(1) puts instead of O(models). ``force=True`` bypasses
        the window (and disarms any pending flush: the forced publish
        already carries the freshest state)."""
        window_ms = self.config.publish_coalesce_ms
        if not force and window_ms > 0:
            with self._coalesce_lock:
                if self._shutdown_publishes:
                    return
                if self._publish_timer is None:
                    # Clock-injected one-shot: a threading.Timer under
                    # SystemClock; a virtual-deadline timer under the sim.
                    self._publish_timer = get_clock().call_later(
                        window_ms / 1000.0, self._publish_flush,
                        name="publish-coalesce",
                    )
            return
        if force:
            with self._coalesce_lock:
                t, self._publish_timer = self._publish_timer, None
            if t is not None:
                t.cancel()
        self._publish_now(force)

    def _publish_flush(self) -> None:
        """Trailing edge of the coalesce window (timer thread)."""
        with self._coalesce_lock:
            self._publish_timer = None
        try:
            self._publish_now(force=False)
        except Exception:  # noqa: BLE001 — periodic publisher will retry
            log.warning("coalesced publish flush failed", exc_info=True)

    def _build_publish_record_locked(self) -> InstanceRecord:
        """Build the advertisement (start_ts carried from the last
        publish) and refresh the cluster-view self-fallback — on every
        publish ATTEMPT, suppressed/coalesced or not: the fallback should
        carry the freshest self-observation without per-request rebuilds,
        and the cached view must be dropped too — while the fallback is
        in use (our record not yet in the watch-fed table) our own
        publishes don't move the table epoch, so the epoch check alone
        would pin the startup-era self record indefinitely. Shared by
        the standalone publish and the promote-piggybacked publish so
        the bookkeeping cannot fork. Callers hold _publish_lock."""
        rec = self._build_instance_record()
        prev = self._last_published
        if prev is not None:
            rec.start_ts = prev.start_ts
        self._self_record = rec
        self._cluster_view_cache = None
        return rec

    def _publish_now(self, force: bool = False) -> None:
        # The KV put runs OUTSIDE _publish_lock (the PR-3 promote-txn
        # rule generalized): a slow advertisement round trip must not
        # convoy load completions (_promote_loaded's bookkeeping) or the
        # record-build fast path on that lock — it guards only the
        # suppression/self-record bookkeeping. Publishers instead
        # serialize with EACH OTHER on _publish_io_lock, taken BEFORE the
        # build: build order == put order == install order, so the final
        # KV state and the _last_published suppression reference always
        # carry the newest build (two racing publishers can never commit
        # out of order and then suppress the repair forever).
        with self._publish_io_lock:
            with self._publish_lock:
                prev = self._last_published
                rec = self._build_publish_record_locked()
                if not force and prev is not None and self._adverts_close(
                    prev, rec
                ):
                    # Suppression cross-check: _promote_loaded's
                    # piggybacked publish commits OUTSIDE the io lock
                    # (its txn must never convoy on a wedged
                    # advertisement put), so an interleave can leave the
                    # committed KV record older than _last_published.
                    # Before suppressing, verify the advertisement the
                    # cluster actually sees (watch-fed self record)
                    # matches too — if it diverged, OR the record is
                    # gone entirely (an expired/deleted ephemeral the
                    # watch reported), publish to repair instead of
                    # suppressing the repair forever. `seen is None`
                    # before the first publish round-trips the watch
                    # just costs a redundant put in a tiny window.
                    seen = self.instances_view.get(self.instance_id)
                    if seen is not None and self._adverts_close(seen, rec):
                        return
            self._session.update(rec.to_bytes())  # analysis-ok: blocking-under-lock — _publish_io_lock exists to serialize advertisement puts in build order; only publishers take it, never the load/request path
            with self._publish_lock:
                self._last_published = rec
        self._publish_gauges()

    @staticmethod
    def _adverts_close(prev: InstanceRecord, rec: InstanceRecord) -> bool:
        """Change-suppression equivalence for two advertisements
        (reference ModelMesh.java:5440-5468): no material movement in
        the fields placement decisions read."""
        return (
            prev.model_count == rec.model_count
            and abs(prev.used_units - rec.used_units) < 8
            and prev.shutting_down == rec.shutting_down
            and abs(prev.req_per_minute - rec.req_per_minute)
            < max(10, prev.req_per_minute // 10)
        )

    def _publish_gauges(self) -> None:
        self.metrics.set_gauge(MX.MODELS_LOADED, len(self.cache))
        self.metrics.set_gauge(MX.CACHE_USED_UNITS, self.cache.weight)
        self.metrics.set_gauge(MX.CACHE_CAPACITY_UNITS, self.cache.capacity)
        self.metrics.set_gauge(
            MX.PENDING_UNLOAD_UNITS, self.unload_tracker.pending_units
        )
        self.metrics.set_gauge(MX.INSTANCE_RPM, self.rate.rpm())
        oldest = self.cache.oldest_time()
        self.metrics.set_gauge(
            MX.LRU_AGE_SECONDS, (now_ms() - oldest) / 1000.0 if oldest else 0
        )
        # Load-feedback view (route_cache.LoadView): per-peer decayed
        # scores + worst staleness, exported on the publisher cadence —
        # never from the request path. Prune fully-decayed slots first
        # AND retire their gauge series: rolling restarts mint fresh
        # instance ids, and either the map or the exported series would
        # otherwise grow without bound.
        lv = self.route_cache.load_view
        now = now_ms()
        for iid in lv.prune(now):
            self.metrics.clear_gauge(
                MX.ROUTE_LOAD_SCORE, label=f'instance="{iid}"'
            )
        for iid in list(lv._slots):
            self.metrics.set_gauge(
                MX.ROUTE_LOAD_SCORE, round(lv.score(iid, now), 3),
                label=f'instance="{iid}"',
            )
        stale = lv.staleness_ms(now)
        self.metrics.set_gauge(
            MX.ROUTE_FEEDBACK_AGE_MS, stale if stale is not None else 0
        )
        # Sharded placement groups this instance participates in, and how
        # many of those are incomplete (routing blocked until the group
        # fills) — per the local registry view, so the numbers converge
        # within watch latency rather than costing KV reads per scrape.
        groups = incomplete = 0
        for _mid, ce, _ts in self.cache.descending_items():
            if not ce.is_shard:
                continue
            groups += 1
            gmr = self.registry_view.get(ce.model_id)
            if gmr is None or not gmr.group_complete:
                incomplete += 1
        self.metrics.set_gauge(MX.SHARDED_GROUP_COUNT, groups)
        self.metrics.set_gauge(MX.SHARDED_GROUP_INCOMPLETE, incomplete)

    # ------------------------------------------------------------------ #
    # management API                                                     #
    # ------------------------------------------------------------------ #

    def register_model(
        self, model_id: str, info: ModelInfo, load_now: bool = False,
        sync: bool = False,
    ) -> ModelRecord:
        if self.config.read_only:
            # Migration read-only mode: re-register of an EXISTING model is
            # tolerated as a no-op read (reference: the existing-record
            # branch skips the readOnly rejection, ModelMesh.java:3112-3131);
            # creating a NEW record is rejected.
            existing = self.registry.get(model_id)
            if existing is None:
                raise ReadOnlyModeError(
                    f"registerModel({model_id}) rejected in read-only mode"
                )
            log.warning(
                "read-only mode: registerModel(%s) served as no-op", model_id
            )
            if load_now:
                self.ensure_loaded(model_id, sync=sync)
                existing = self.registry.get(model_id) or existing
            return existing

        def create(cur: Optional[ModelRecord]) -> ModelRecord:
            if cur is not None:
                # Idempotent re-register with same info keeps the record.
                cur.model_type = info.model_type
                cur.model_path = info.model_path
                cur.model_key = info.model_key
                return cur
            mr = ModelRecord(
                model_type=info.model_type,
                model_path=info.model_path,
                model_key=info.model_key,
                last_used=now_ms() - REGISTRATION_BACKDATE_MS,
            )
            return mr

        mr = self.registry.update_or_create(model_id, create)
        if load_now:
            self.ensure_loaded(model_id, sync=sync)
            mr = self.registry.get(model_id) or mr
        return mr

    def unregister_model(self, model_id: str) -> bool:
        if self.config.read_only:
            raise ReadOnlyModeError(
                f"unregisterModel({model_id}) rejected in read-only mode"
            )
        mr = self.registry.get(model_id)
        if mr is None:
            return False
        # Evict local copy first, then remove the registration. Remote
        # holders clean up via the registry deletion watch
        # (_on_registry_event) within watch latency — the analog of the
        # reference's registry-listener deletion handler
        # (ModelMesh.java:2807-2814).
        self._remove_local(model_id)
        return self.registry.delete(model_id)

    def get_status(self, model_id: str) -> tuple[str, ModelRecord | None]:
        """-> (status, record): status in NOT_FOUND/NOT_LOADED/LOADING/
        LOADED/LOADING_FAILED."""
        ce = self.cache.get_quietly(model_id)
        # Authoritative read: the watch-fed view lags mutations (e.g. an
        # unregister a moment ago would still show LOADED); management
        # status RPCs are rare enough to pay the direct KV get.
        mr = self.registry.get(model_id)
        if mr is None:
            return "NOT_FOUND", None
        if mr.shard_count:
            # Sharded group: LOADED means the WHOLE group is complete and
            # live — a single landed shard (even ours) is not servable.
            live = {iid for iid, _ in self.instances_view.items()}
            held = {
                idx for iid, idx in mr.shard_instances.items()
                if iid in mr.instance_ids and iid in live
            }
            if held >= set(range(mr.shard_count)):
                return "LOADED", mr
            if any(iid in live for iid in mr.loading_instances):
                return "LOADING", mr
            if mr.load_exhausted():
                return "LOADING_FAILED", mr
            return "NOT_LOADED", mr
        if ce is not None and ce.state.is_servable:
            # PARTIAL counts as LOADED: the copy is admitting requests.
            return "LOADED", mr
        if ce is not None and ce.state.is_loading:
            return "LOADING", mr
        # Cross-check placements against LIVE instances: a record whose
        # every holder died seconds ago must not report LOADED for up to
        # the 10-min reaper prune (the reference checks liveness in
        # getStatus).
        live = {iid for iid, _ in self.instances_view.items()}
        if any(iid in live for iid in mr.instance_ids):
            return "LOADED", mr
        if any(iid in live for iid in mr.loading_instances):
            return "LOADING", mr
        if mr.load_exhausted():
            return "LOADING_FAILED", mr
        return "NOT_LOADED", mr

    def ensure_loaded(
        self, model_id: str, last_used_ms: int = 0, sync: bool = False,
        exclude: Optional[set[str]] = None, chain: int = 0,
    ) -> str:
        """Place/load a copy somewhere (no inference). Returns final status."""
        ctx = RoutingContext(
            hop=RoutingContext.INTERNAL,
            exclude_load=set(exclude or ()),
            last_used_ms=last_used_ms or now_ms(),
            chain_load_count=chain,
        )
        result = self.invoke_model(model_id, None, b"", [], ctx, sync=sync)
        return result.status

    # ------------------------------------------------------------------ #
    # the routing uber-method                                            #
    # ------------------------------------------------------------------ #

    def invoke_model(
        self,
        model_id: str,
        method: Optional[str],
        payload: bytes,
        headers: list[tuple[str, str]],
        ctx: Optional[RoutingContext] = None,
        sync: bool = True,
    ) -> InvokeResult:
        ctx = ctx or RoutingContext()
        ctx.visited.add(self.instance_id)
        # Per-request thread renaming (reference names handler threads
        # invoke-<hoptype>-<modelId>, ModelMesh.java:3462) — makes py-spy /
        # faulthandler / load-timeout stack dumps self-describing. Restored
        # on exit: gRPC server threads are pooled.
        _thread = threading.current_thread()
        _prev_name = _thread.name
        hop_name = (
            RoutingContext.HOP_NAMES[ctx.hop]
            if 0 <= ctx.hop < len(RoutingContext.HOP_NAMES)
            else str(ctx.hop)
        )
        _thread.name = f"invoke-{hop_name}-{model_id}"
        try:
            if ctx.hop != RoutingContext.EXTERNAL:
                return self._invoke_model_inner(
                    model_id, method, payload, headers, ctx, sync
                )
            # External completion feeds the SLO attainment window (one
            # sample per request, never per hop). Latency through the
            # injectable clock so the sim's windows carry virtual time.
            # The admission gate runs BEFORE the window opens and a shed
            # never records into it: the controller's burn signal must
            # judge the health of SERVED traffic — counting its own
            # sheds as breach would latch the throttle on forever.
            cls = self._model_class(model_id)
            self.admission_controller.admit(
                cls, cancel_event=ctx.cancel_event
            )
            clock = get_clock()
            t0 = clock.monotonic()
            ok = False
            try:
                result = self._invoke_model_inner(
                    model_id, method, payload, headers, ctx, sync
                )
                ok = True
                return result
            finally:
                self.slo.record(cls, (clock.monotonic() - t0) * 1e3, ok)
        finally:
            _thread.name = _prev_name

    def _model_class(self, model_id: str) -> str:
        """SLO class of a model = its model_type (watch-fed view read;
        unknown models fall to the spec's default class)."""
        mr = self.registry_view.get(model_id)
        return mr.model_type if mr is not None else ""

    def _invoke_model_inner(
        self,
        model_id: str,
        method: Optional[str],
        payload: bytes,
        headers: list[tuple[str, str]],
        ctx: RoutingContext,
        sync: bool,
    ) -> InvokeResult:
        if self.log_each_invocation:
            log.info(
                "invoke model=%s method=%s bytes=%d hop=%d visited=%s",
                model_id, method, len(payload), ctx.hop, sorted(ctx.visited),
            )

        if ctx.hop == RoutingContext.HIT_ONLY:
            ce = self.cache.get(model_id)
            if ce is None or ce.state in (EntryState.FAILED, EntryState.REMOVED):
                raise ModelNotHereError(self.instance_id, model_id)
            return self._invoke_local(
                ce, method, payload, headers, sync=sync,
                chain_count=ctx.chain_load_count,
                cancel_event=ctx.cancel_event,
            )

        last_exc: Optional[Exception] = None
        # A pure placement op (method None) with ourselves excluded must not
        # be satisfied by our own copy — the caller wants a copy elsewhere
        # (ensureLoaded-with-exclusions, reference ModelMesh.java:3348).
        skip_local = method is None and self.instance_id in ctx.exclude_load
        for _ in range(MAX_ITERATIONS):
            if ctx.cancelled:
                raise RequestCancelledError(model_id)
            # 1. local fast path
            ce = None if skip_local else self.cache.get(model_id)
            if ce is not None and ce.is_shard and method is not None:
                # Group atomicity: a shard serves inference only while
                # its group is COMPLETE — a partial group is never
                # routable, so fall through to routing (which re-plans).
                gmr = self.registry_view.get(model_id)
                if gmr is None or not gmr.group_complete:
                    # The watch-fed view lags a group that JUST
                    # completed — one authoritative read lets the local
                    # member serve instead of bouncing the request.
                    try:
                        gmr = self._registry_get_failfast(model_id)
                    except ServiceUnavailableError:
                        gmr = None
                    if gmr is None or not gmr.group_complete:
                        ce = None
            if ce is not None and ce.state not in (
                EntryState.FAILED, EntryState.REMOVED
            ):
                try:
                    return self._invoke_local(
                        ce, method, payload, headers, sync=sync,
                        chain_count=ctx.chain_load_count,
                        cancel_event=ctx.cancel_event,
                    )
                except ModelNotHereError as e:
                    last_exc = e  # runtime lost it; cleanup already done
                except ModelLoadException as e:
                    last_exc = e
                    ctx.exclude_load.add(self.instance_id)

            mr = self.registry_view.get(model_id)
            if mr is None:
                mr = self._registry_get_failfast(model_id)
            if mr is None:
                raise ModelNotFoundError(model_id)
            if mr.shard_count and not mr.group_complete:
                # Same view-lag heal for routing: a stale record for a
                # group that already completed would send the request
                # back through the miss loop (which re-plans the same
                # group and spins out the iteration budget). A genuinely
                # incomplete group is unchanged by the re-read.
                try:
                    amr = self._registry_get_failfast(model_id)
                except ServiceUnavailableError:
                    amr = None
                if amr is not None and amr.group_complete:
                    mr = amr

            # Registration-out-of-date self-heal: the record lists a copy
            # on THIS instance but the cache has none (lost to a KV-outage
            # load crash, an eviction race, or a restart under a preserved
            # registry). Unpruned, the serve loop skips self and the miss
            # loop hard-excludes self via all_placements — a one-instance
            # cluster could never serve the model again. The reference's
            # hit loop prunes its own stale registration the same way.
            if (
                not skip_local
                and (
                    self.instance_id in mr.instance_ids
                    or self.instance_id in mr.loading_instances
                )
                and (ce is None or ce.state is EntryState.REMOVED)
            ):
                # Covers stale LOADING claims too: a load that crashed
                # into a KV outage leaves its claim in loading_instances
                # with no cache entry behind it. The cache insert precedes
                # the registry claim in _load_local, so a genuinely
                # in-flight local load (ce present) is never pruned.
                mr = self._prune_stale_self(model_id) or mr

            if ctx.hop == RoutingContext.LOAD_LOCAL_ONLY:
                ce = self._load_local(model_id, mr, ctx)
                if ce is None:
                    raise NoCapacityError(self.instance_id)
                return self._invoke_local(
                    ce, method, payload, headers, sync=sync,
                    chain_count=ctx.chain_load_count,
                    cancel_event=ctx.cancel_event,
                )

            # 2. cache-hit loop: forward to a loaded copy
            with self.tracer.span("route-select", model=model_id) as _sp:
                target = self._choose_serve_target(model_id, mr, ctx)
                _sp["target"] = target or ""
            if target is not None:
                try:
                    return self._forward(
                        target, model_id, method, payload, headers, ctx,
                        hop=RoutingContext.INTERNAL,
                    )
                except (ModelNotHereError, ServiceUnavailableError) as e:
                    # The routed candidate just failed in practice —
                    # demote it WITHIN the cached set (d>1: survivors
                    # keep their ranking, so the thundering retry
                    # spreads over them instead of re-herding at one
                    # recomputed winner; d=1 keeps the old invalidate)
                    # and stamp the decaying LoadView penalty so every
                    # model's picks avoid the instance while fresh.
                    self._demote_route(model_id, target, type(e).__name__)
                    ctx.exclude_serve.add(target)
                    last_exc = e
                    continue
                except ModelLoadException as e:
                    # Serve target was a LOADING copy whose load failed (or
                    # timed out) — exclude it on both axes and re-route.
                    self._demote_route(model_id, target, "ModelLoadException")
                    ctx.exclude_serve.add(target)
                    ctx.exclude_load.add(target)
                    last_exc = e
                    continue

            # 3. cache-miss loop: place a new copy.
            if mr.load_exhausted():
                raise ModelLoadException(
                    f"{model_id}: load failed on "
                    f"{sorted(mr.load_failures)}: "
                    f"{[m for _, m in mr.load_failures.values()][:2]}"
                )
            # Hard exclusions forbid loading there at all; visited peers are
            # additionally excluded from *forward* targets (loop prevention)
            # but do not forbid loading on ourselves.
            # Failure exclusion is time-aware: an entry past
            # MM_LOAD_FAILURE_EXPIRY_MS stops excluding immediately,
            # without waiting for the leader reaper to prune the record.
            hard_exclude = (
                ctx.exclude_load | mr.all_placements | mr.active_failures()
            )
            views = self.cluster_view().instances
            if self.constraints is not None:
                hard_exclude |= self.constraints.non_candidates(
                    mr.model_type, views
                )
            strategy_exclude = hard_exclude | (ctx.visited - {self.instance_id})
            if self.upgrade_tracker is not None:
                strategy_exclude |= self.upgrade_tracker.likely_replaced(views)
            if not ctx.known_size_bytes:
                ctx.known_size_bytes = self._predict_size_bytes(model_id, mr)
            req = PlacementRequest(
                model_id=model_id,
                model=mr,
                required_units=bytes_to_units(ctx.known_size_bytes),
                requesting_instance=self.instance_id,
                exclude=frozenset(strategy_exclude),
                last_used_ms=ctx.last_used_ms or now_ms(),
            )
            # Sharded-execution branch: a model too big for ANY single
            # placeable instance (or one already carrying a shard group)
            # is placed as a multi-instance placement GROUP instead of a
            # single copy — the single-copy path below could only fail.
            if self._sharded_applicable(mr, req.required_units):
                status = self._place_sharded_group(
                    model_id, mr, req, ctx,
                    wait=sync or method is not None,
                )
                if status is None:
                    raise NoCapacityError(
                        f"no placement group can host sharded {model_id} "
                        f"(excluded: {sorted(strategy_exclude)})"
                    )
                if method is None:
                    return InvokeResult(b"", self.instance_id, status)
                if status != "LOADED":
                    raise ModelLoadException(
                        f"{model_id}: placement group did not complete "
                        f"in time", timeout=True,
                    )
                continue  # group complete: the serve loop routes to it
            target = self.strategy.choose_load_target(req, self.cluster_view())
            self.flightrec.record(
                "placement", model=model_id, target=target or "",
                hop=ctx.hop,
            )
            if target in (LOAD_HERE, self.instance_id):
                ce = self._load_local(model_id, mr, ctx)
                if ce is not None:
                    return self._invoke_local(
                        ce, method, payload, headers, sync=sync,
                        chain_count=ctx.chain_load_count,
                        cancel_event=ctx.cancel_event,
                    )
                ctx.exclude_load.add(self.instance_id)
                last_exc = last_exc or NoCapacityError(self.instance_id)
                continue
            if target is None:
                raise NoCapacityError(
                    f"no instance can load {model_id} "
                    f"(excluded: {sorted(strategy_exclude)})"
                )
            try:
                return self._forward(
                    target, model_id, method, payload, headers, ctx,
                    hop=RoutingContext.LOAD_LOCAL_ONLY,
                )
            except (
                ModelNotHereError, NoCapacityError, ServiceUnavailableError
            ) as e:
                ctx.exclude_load.add(target)
                last_exc = e
                continue

        raise last_exc or ModelLoadException(
            f"{model_id}: routing iterations exhausted"
        )

    def _demote_route(self, model_id: str, target: str, err: str) -> None:
        """Failed-forward demotion bookkeeping (ONE funnel for both
        except branches above: cache demotion + metric + flightrec)."""
        self.route_cache.demote(model_id, target)
        self.metrics.inc(MX.ROUTE_DEMOTE_COUNT, model_id=model_id)
        self.flightrec.record(
            "route-demote", model=model_id, target=target, err=err,
        )

    def _choose_serve_target(
        self, model_id: str, mr: ModelRecord, ctx: RoutingContext
    ) -> Optional[str]:
        """Serve-target selection: candidate-set memo + d-choices pick.

        The memo is consulted only when the request carries no serve
        exclusions — the forward-failure retry loop must always re-decide
        (and it also demotes, see the except branches above). A hit is
        valid only while the registry record version, the instances-view
        epoch, and the warming-clock bucket all match what the ranking
        was derived from; the exclusion signature is the cache key, so a
        hit can never return an excluded instance. The pick samples
        MM_ROUTE_D candidates against the piggybacked LoadView scores
        (route_cache.pick); strategies without a candidate-set export
        keep the old single-winner flow.
        """
        if mr.shard_count and not mr.group_complete:
            # Sharded model with an incomplete group: no member may serve
            # (group atomicity) — the miss loop re-plans instead.
            return None
        exclude = ctx.exclude_serve | ctx.visited | {self.instance_id}
        cache = self.route_cache
        rank = getattr(self.strategy, "rank_serve_candidates", None)
        if not cache.enabled or ctx.exclude_serve or rank is None:
            return self.strategy.choose_serve_target(
                mr, self.cluster_view(), frozenset(exclude)
            )
        sig = frozenset(exclude)
        cands = cache.lookup(
            model_id, sig, mr.version, self.instances_view.epoch
        )
        if cands is not None:
            return cache.pick(cands)
        view = self.cluster_view()
        cands = rank(mr, view, sig)
        if not cands:
            return None
        # Keyed on the snapshot actually used (view.epoch), not the
        # live epoch — if the view moved mid-decision the entry is
        # already stale and the next lookup recomputes.
        cache.store(model_id, sig, mr.version, view.epoch, cands)
        return cache.pick(cands)

    # ------------------------------------------------------------------ #
    # local invocation                                                   #
    # ------------------------------------------------------------------ #

    def _invoke_local(
        self, ce: CacheEntry, method: Optional[str], payload: bytes,
        headers: list[tuple[str, str]], sync: bool = True,
        chain_count: int = 0, cancel_event=None,
    ) -> InvokeResult:
        if not sync and ce.state.is_loading:
            # The chain must propagate even when the async request rides
            # an IN-FLIGHT load it didn't start: this entry's own
            # chain_load_count is whatever its original request carried,
            # so a later ensure(chain=N) landing mid-load would silently
            # truncate the fan-out (fresh loads fire in _load_local,
            # servable hits below — this was the remaining gap). The
            # fan-out excludes all current placements including our
            # loading claim, and _chain_fired keeps every path
            # single-shot.
            if chain_count > 0 and ce.claim_chain_fire():
                self._spawn_chain(ce.model_id, ce.last_used, chain_count)
            return InvokeResult(b"", self.instance_id, "LOADING")
        if not ce.state.is_servable:
            # The request is riding a load (cache miss): track how long it
            # waited (reference cache-miss-delay metric). A PARTIAL
            # streamed copy is already servable — no miss recorded.
            self.metrics.inc(MX.CACHE_MISS_COUNT, model_id=ce.model_id)
            t_wait = _time.perf_counter()  #: wall-clock: perf_counter latency metric (load-wait stage)
            with self.tracer.span("load-wait", model=ce.model_id):
                ok = self._wait_entry_active(ce, cancel_event=cancel_event)
            self.metrics.observe(
                MX.CACHE_MISS_DELAY,
                (_time.perf_counter() - t_wait) * 1e3, ce.model_id,  #: wall-clock: perf_counter latency metric
            )
            if not ok:
                raise ModelLoadException(
                    f"{ce.model_id}: timed out waiting for load", timeout=True
                )
        elif not self._wait_entry_active(ce, cancel_event=cancel_event):
            raise ModelLoadException(
                f"{ce.model_id}: timed out waiting for load", timeout=True
            )
        if not ce.state.is_servable:
            raise ModelNotHereError(self.instance_id, ce.model_id)
        if method is None:
            # ensure-loaded op: presence is the result. A chain count must
            # still propagate even though the copy already exists here —
            # otherwise ensure_loaded(chain=N) silently truncates whenever
            # the first target is already a holder (the fresh-load path
            # fires its own chain in _run_load; the _chain_fired flag
            # prevents double-fire).
            if chain_count > 0 and ce.claim_chain_fire():
                self._spawn_chain(ce.model_id, ce.last_used, chain_count)
            return InvokeResult(b"", self.instance_id, "LOADED")
        if not ce.before_invoke(cancel_event=cancel_event):
            if cancel_event is not None and cancel_event.is_set():
                raise RequestCancelledError(ce.model_id)
            raise ModelLoadException(f"{ce.model_id}: concurrency gate timeout")
        with self._inflight_lock:
            self._inflight += 1
        try:
            t0 = _time.perf_counter()  #: wall-clock: perf_counter latency metric (runtime invoke)
            with self.tracer.span("runtime-call", model=ce.model_id):
                if self.batcher is not None:
                    # Batched data plane: ride (or lead) a micro-batch.
                    # The span stays open on THIS thread for the whole
                    # submit, so a request executed by a batch leader
                    # still assembles its own span tree. A PARTIAL
                    # streamed copy is batchable only solo.
                    try:
                        out = self.batcher.submit(
                            ce.model_id, method, payload, headers,
                            cancel_event=cancel_event,
                            solo_only=ce.state is EntryState.PARTIAL,
                            ctx=ce,
                        )
                    except BatchCancelled:
                        raise RequestCancelledError(ce.model_id) from None
                elif self._runtime_call_cancellable:
                    out = self._runtime_call(
                        ce, method, payload, headers,
                        cancel_event=cancel_event,
                    )
                else:
                    out = self._runtime_call(ce, method, payload, headers)
            ce.record_latency((_time.perf_counter() - t0) * 1e3)  #: wall-clock: perf_counter latency metric
            self.rate.record()
            self._model_rate(ce.model_id).record()
            self.cache.get(ce.model_id)  # LRU touch
            self.metrics.inc(MX.INVOKE_LOCAL_COUNT, model_id=ce.model_id)
            return InvokeResult(out, self.instance_id, "LOADED")
        except ModelNotHereError:
            # Runtime claims NOT_FOUND for a model we think is loaded — the
            # Triton refresh quirk: purge and let the caller retry elsewhere
            # (reference cleanup-unload, SidecarModelMesh.java:961-988).
            self._remove_local(ce.model_id)
            raise
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            ce.after_invoke()

    def load_feedback(self) -> "LoadFeedback":
        """This instance's current load, in the shape peers piggyback on
        Forward responses (route_cache.LoadFeedback): locally-executing
        request count, batch-queue depth (PR-13's RequestBatcher), and
        the drain flag. Cheap enough for every response — two attribute
        reads and a lock-free counter."""
        with self._inflight_lock:
            inflight = self._inflight
        depth = self.batcher.queue_depth() if self.batcher is not None else 0
        return LoadFeedback(
            self.instance_id, inflight, depth,
            draining=self.draining or self.shutting_down,
        )

    def _map_runtime_error(self, exc: Exception, model_id: str):
        """THE runtime-error-to-serving-exception mapping, shared by the
        single-call and batched data planes (per-item and collective):
        NOT_FOUND — as ModelNotLoadedError or a gRPC status — becomes
        ModelNotHereError (the purge-and-retry trigger), other gRPC
        errors become ApplierError, anything else passes through."""
        import grpc

        from modelmesh_tpu_torch.serving.errors import ApplierError

        if isinstance(exc, ModelNotLoadedError):
            return ModelNotHereError(self.instance_id, model_id)
        if isinstance(exc, grpc.RpcError):
            if exc.code() == grpc.StatusCode.NOT_FOUND:
                return ModelNotHereError(self.instance_id, model_id)
            return ApplierError(exc.code().name, exc.details() or "")
        return exc

    def _default_runtime_call(
        self, ce: CacheEntry, method: str, payload: bytes,
        headers: list[tuple[str, str]], cancel_event=None,
    ) -> bytes:
        call_model = getattr(self.loader, "call_model", None)
        if call_model is None:
            raise NotImplementedError(
                "loader has no call_model; pass runtime_call to the instance"
            )
        try:
            return call_model(
                ce.model_id, method, payload, headers,
                cancel_event=cancel_event,
            )
        except Exception as e:
            mapped = self._map_runtime_error(e, ce.model_id)
            if mapped is e:
                raise
            raise mapped from e

    # -- batched dispatch plumbing (serving/batching.py) ----------------- #

    def _batch_call_one(self, req) -> bytes:
        """Zero-copy passthrough for an uncontended request: the exact
        single-call runtime path the unbatched data plane takes."""
        ce = req.ctx
        if self._runtime_call_cancellable:
            return self._runtime_call(
                ce, req.method, req.payload, req.headers,
                cancel_event=req.cancel_event,
            )
        return self._runtime_call(ce, req.method, req.payload, req.headers)

    def _batch_call_many(self, items, cancel_event=None) -> list:
        """Batched dispatch: hand the micro-batch to the loader (or the
        injected batched runtime call) and run _map_runtime_error over
        the outcome — per-item entries and collectively-raised failures
        alike — so the batched and unbatched data planes can never
        diverge in retry vocabulary (NOT_FOUND triggers purge-and-retry
        for every affected member)."""
        try:
            outs = self._runtime_call_batch(items, cancel_event=cancel_event)
        except Exception as e:
            mapped = self._map_runtime_error(e, items[0].model_id)
            if mapped is e:
                raise
            raise mapped from e
        return [
            self._map_runtime_error(out, item.model_id)
            if isinstance(out, Exception) else out
            for item, out in zip(items, outs)
        ]

    def _trigger_chained_load(self, ce: CacheEntry) -> None:
        """Chained copy loads: each instance that completes a chained load
        triggers the NEXT copy with itself and all existing placements
        excluded (reference triggerChainedLoadIfNecessary,
        ModelMesh.java:4560-4585) — distributing an N-copy ensureLoaded
        across the fleet one hop at a time instead of hammering one caller.
        Under ``load_fastpath`` the chain already fanned out concurrently
        at claim time (``_load_local``); the ``_chain_fired`` flag keeps
        this completion-time trigger from double-firing it.
        """
        remaining = getattr(ce, "chain_load_count", 0)
        if remaining <= 0 or not ce.claim_chain_fire():
            return
        self._spawn_chain(ce.model_id, ce.last_used, remaining)

    def _spawn_chain(self, model_id: str, last_used: int, remaining: int) -> None:
        """Dispatch ``remaining`` secondary copies on a background thread.

        Fast path (``load_fastpath``): ``_fanout_chain`` — all
        ``remaining`` placements are issued CONCURRENTLY, so the copies
        load in parallel across the fleet and time-to-N-copies approaches
        max(load) instead of N x load.

        Legacy path: one hop that propagates ``chain=remaining-1`` to the
        target, which fires the next copy only after ITS load completes —
        the reference's hop-by-hop distribution.
        """
        if self.load_fastpath:
            threading.Thread(
                target=self._fanout_chain,
                args=(model_id, last_used, remaining),
                name=f"chain-{model_id}", daemon=True,
            ).start()
            return

        def chain():
            try:
                mr = self.registry.get(model_id)
                if mr is None:
                    return
                self.ensure_loaded(
                    model_id,
                    last_used_ms=last_used,
                    sync=False,
                    exclude=set(mr.all_placements) | {self.instance_id},
                    chain=remaining - 1,
                )
            except Exception as e:  # noqa: BLE001 — chain is best-effort
                log.debug("chained load of %s stopped: %s", model_id, e)

        threading.Thread(
            target=chain, name=f"chain-{model_id}", daemon=True
        ).start()

    def _fanout_chain(self, model_id: str, last_used: int, remaining: int) -> None:
        """Concurrent chained fan-out (runs on the chain thread).

        ``sync`` does not traverse the internal Forward hop (a forwarded
        placement blocks until the remote load completes), so concurrency
        comes from DIRECTED parallel placements: a sequential pre-pass
        picks ``remaining`` distinct targets with the strategy (local,
        no KV writes), then one worker per target places a copy with
        every OTHER known instance excluded — concurrent placements can
        never collapse onto one instance, and each worker places at most
        one copy, so the chain budget is a hard ceiling on fan-out copies
        even when the first load later fails. A top-up pass repairs
        under-delivery (a directed placement that failed, or collapsed
        onto an instance that joined mid-fan-out and absorbed several
        workers) — but the chain owes ``remaining`` NEW copies beyond
        the surviving original placements only: a first-load failure (or
        an original copy evicted meanwhile) shrinks the target instead
        of baiting the top-up into replacing copies it never owed.
        """
        try:
            mr = self.registry.get(model_id)
            if mr is None or mr.load_exhausted():
                return
            originals = set(mr.all_placements)
            view = self.cluster_view()
            known = {iid for iid, _ in view.instances}
            units = bytes_to_units(self._predict_size_bytes(model_id, mr))
            exclude = set(mr.all_placements) | {self.instance_id}
            targets: list[str] = []
            for _ in range(remaining):
                req = PlacementRequest(
                    model_id=model_id,
                    model=mr,
                    required_units=units,
                    requesting_instance=self.instance_id,
                    exclude=frozenset(exclude),
                    last_used_ms=last_used or now_ms(),
                )
                target = self.strategy.choose_load_target(req, view)
                if target is None or target in (LOAD_HERE, self.instance_id):
                    break
                targets.append(target)
                exclude.add(target)

            def place(target: str) -> None:
                try:
                    self.ensure_loaded(
                        model_id,
                        last_used_ms=last_used,
                        sync=False,
                        exclude=(known | {self.instance_id}) - {target},
                        chain=0,
                    )
                except Exception as e:  # noqa: BLE001 — best-effort
                    log.debug(
                        "fan-out placement of %s on %s failed: %s",
                        model_id, target, e,
                    )

            workers = [
                threading.Thread(
                    target=place, args=(t,),
                    name=f"chain-{model_id}-{t}", daemon=True,
                )
                for t in targets
            ]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
            # Top-up: place until the fleet holds `remaining` copies
            # beyond the SURVIVING originals. The target is recomputed
            # per attempt, so an original that failed or was evicted
            # shrinks it (never replaced), while a worker collapse onto
            # a mid-fan-out joiner (copies short, all budget nominally
            # spent) is repaired. Bounded attempts; each gated on a
            # fresh authoritative read.
            for _ in range(remaining):
                mr = self.registry.get(model_id)
                if mr is None or mr.load_exhausted():
                    return
                placements = set(mr.all_placements)
                want = remaining + len(originals & placements)
                if len(placements) >= want:
                    return
                self.ensure_loaded(
                    model_id,
                    last_used_ms=last_used,
                    sync=False,
                    exclude=placements | {self.instance_id},
                    chain=0,
                )
        except Exception as e:  # noqa: BLE001 — chain is best-effort
            log.debug("chained fan-out of %s stopped: %s", model_id, e)

    # ------------------------------------------------------------------ #
    # sharded placement groups                                           #
    # ------------------------------------------------------------------ #

    def _sharded_applicable(self, mr: ModelRecord, required_units: int) -> bool:
        """Should the miss loop plan a placement GROUP for this model?
        Yes for models already carrying a group (keep coordinating it)
        and for layer-streamable models too big for ANY single placeable
        instance — gated on the knob and the loader capability, so a
        store-only deployment keeps the old fail-to-place behavior."""
        if not self.config.sharded:
            return False
        if not getattr(self.loader, "supports_sharded_execution", False):
            return False
        if mr.shard_count:
            return True
        from modelmesh_tpu_torch.transfer.protocol import is_layer_streamable

        if not is_layer_streamable(mr.model_type, mr.model_path):
            return False
        caps = [
            rec.capacity_units for _, rec in self.cluster_view().placeable()
        ]
        return bool(caps) and required_units > max(caps)

    @staticmethod
    def _group_missing(mr: ModelRecord, live: set) -> list[int]:
        """Shard indices with no LIVE holder or claimer — the signal that
        a group needs (re-)planning rather than just more patience."""
        if not mr.shard_count:
            return []
        missing = []
        for idx in range(mr.shard_count):
            if not any(
                i == idx and iid in live
                and (iid in mr.instance_ids or iid in mr.loading_instances)
                for iid, i in mr.shard_instances.items()
            ):
                missing.append(idx)
        return missing

    def _place_sharded_group(
        self, model_id: str, mr: ModelRecord, req: PlacementRequest,
        ctx: RoutingContext, wait: bool,
    ) -> Optional[str]:
        """Coordinate a sharded placement group: pick K distinct members
        with the strategy (smallest K whose per-shard share fits, up to
        MM_SHARDED_MAX_SHARDS), commit the WHOLE group in ONE registry
        CAS (``begin_shard_group`` — assignments, claims, epoch bump),
        then poke each member with a normal LOAD_LOCAL_ONLY placement op
        (no new wire surface; each member reads its own shard index from
        the record). Returns "LOADED" once the group is complete,
        "LOADING" when placed but not yet complete (or wait=False), None
        when the fleet cannot host the group."""
        view = self.cluster_view()
        live = set(view.live_map)
        shard_count = mr.shard_count
        if not shard_count or self._group_missing(mr, live):
            choose = getattr(self.strategy, "choose_group_targets", None)
            if choose is None:
                return None
            caps = [rec.capacity_units for _, rec in view.placeable()]
            if not caps:
                return None
            max_shards = max(int(self.config.sharded_max_shards), 2)
            k_lo = max(2, -(-req.required_units // max(caps)), shard_count)
            assignments: Optional[dict[str, int]] = None
            for k in range(k_lo, max_shards + 1):
                shard_units = max(1, -(-req.required_units // k))
                plan = choose(req, view, k, shard_units)
                if plan:
                    assignments, shard_count = plan, k
                    break
            if assignments is None:
                return None
            ts = now_ms()

            def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
                if cur is None:
                    return None
                cur.begin_shard_group(assignments, shard_count, ts)
                return cur

            try:
                mr = self.registry.update_or_create(model_id, mutate)
            except CasFailed:
                # A concurrent coordinator committed its own plan — ride
                # that group instead of fighting over epochs.
                self.flightrec.record("cas-failed", op="shard-group",
                                      model=model_id)
                mr = self.registry.get(model_id)
            if mr is None:
                raise ModelNotFoundError(model_id)
            if mr.shard_count:
                shard_count = mr.shard_count
            self.metrics.inc(MX.SHARDED_GROUP_PLAN_COUNT, model_id=model_id)
            self.flightrec.record(
                "sharded-group", op="plan", model=model_id,
                shards=shard_count, epoch=mr.group_epoch,
                members=",".join(sorted(mr.shard_instances)),
            )
        # Poke every member that is not yet a servable holder of its
        # shard. Remote pokes block until the remote shard is servable,
        # so they run concurrently; the self-poke only enqueues.
        pending = [
            iid for iid in mr.shard_instances
            if iid not in mr.instance_ids
        ]
        record = mr

        def poke_ctx() -> RoutingContext:
            return RoutingContext(
                hop=RoutingContext.INTERNAL,
                known_size_bytes=ctx.known_size_bytes,
                last_used_ms=ctx.last_used_ms,
            )

        if self.instance_id in pending:
            self._load_local(model_id, record, poke_ctx())
            pending.remove(self.instance_id)

        def poke(target: str) -> None:
            try:
                self._forward(
                    target, model_id, None, b"", [], poke_ctx(),
                    hop=RoutingContext.LOAD_LOCAL_ONLY,
                )
            except Exception as e:  # noqa: BLE001 — group converges via re-plan
                self.flightrec.record(
                    "sharded-group", op="poke-failed", model=model_id,
                    target=target, err=type(e).__name__,
                )
                log.debug("shard poke of %s to %s failed: %s",
                          model_id, target, e)

        for target in pending:
            threading.Thread(
                target=poke, args=(target,),
                name=f"shard-poke-{model_id}-{target}", daemon=True,
            ).start()
        if not wait:
            return "LOADING"
        clock = get_clock()
        budget_s = (self.params.load_timeout_ms or 120_000) / 1000.0
        deadline = clock.monotonic() + budget_s
        while True:
            cur = self.registry.get(model_id)
            if cur is None:
                raise ModelNotFoundError(model_id)
            if cur.shard_count and cur.group_complete:
                return "LOADED"
            if cur.load_exhausted():
                raise ModelLoadException(
                    f"{model_id}: shard load failed on "
                    f"{sorted(cur.load_failures)}"
                )
            if clock.monotonic() >= deadline:
                return "LOADING"
            clock.sleep(0.05)

    def replan_shard_for_drain(
        self, model_id: str, deadline_mono: float,
    ) -> bool:
        """Drain-time group move: pre-copy OUR shard to a survivor before
        this member drops it — the group keeps a servable holder of every
        index throughout, so a half-drained group never stops serving.
        The survivor is CASed in as a SECOND holder of our shard index
        (``shard_instances`` allows the overlap); only after it is
        servable does the caller drop the local copy, whose
        ``remove_instance`` then pops just us (the twin keeps the group
        alive). Returns True when the survivor copy is servable."""
        mr = self.registry.get(model_id)
        if mr is None or not mr.shard_count:
            return False
        my_idx = mr.shard_index_of(self.instance_id)
        if my_idx is None:
            return True  # re-planned away already: nothing to hand off
        shard_units = max(
            1,
            -(-bytes_to_units(self._predict_size_bytes(model_id, mr))
              // mr.shard_count),
        )
        view = self.cluster_view()
        members = set(mr.shard_instances)
        cands = sorted(
            (
                (iid, rec) for iid, rec in view.placeable()
                if iid not in members and iid != self.instance_id
                and rec.free_units >= shard_units
            ),
            key=lambda p: (-p[1].free_units, p[0]),
        )
        if not cands:
            return False
        survivor = cands[0][0]
        ts = now_ms()

        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            if cur.shard_index_of(self.instance_id) != my_idx:
                return cur  # group re-planned mid-drain; nothing owed
            cur.shard_instances[survivor] = my_idx
            cur.claim_loading(survivor, ts)
            return cur

        try:
            if self.registry.update_or_create(model_id, mutate) is None:
                return True  # unregistered: nothing to hand off
        except CasFailed:
            return False
        self.flightrec.record(
            "sharded-group", op="drain-replan", model=model_id,
            shard=my_idx, target=survivor,
        )
        try:
            self._forward(
                survivor, model_id, None, b"", [],
                RoutingContext(hop=RoutingContext.INTERNAL),
                hop=RoutingContext.LOAD_LOCAL_ONLY,
            )
        except Exception as e:  # noqa: BLE001 — poll below decides
            log.debug("drain shard poke of %s to %s failed: %s",
                      model_id, survivor, e)
        clock = get_clock()
        while clock.monotonic() < deadline_mono:
            cur = self.registry.get(model_id)
            if cur is None:
                return True
            if cur.shard_index_of(self.instance_id) != my_idx:
                return True  # re-planned away mid-wait
            if (
                survivor in cur.instance_ids
                and cur.shard_index_of(survivor) == my_idx
            ):
                return True
            clock.sleep(0.05)
        return False

    # ------------------------------------------------------------------ #
    # local load lifecycle                                               #
    # ------------------------------------------------------------------ #

    def _predict_size_bytes(self, model_id: str, mr: ModelRecord) -> int:
        predicted = self.loader.predict_size(
            model_id, ModelInfo(mr.model_type, mr.model_path, mr.model_key)
        )
        return predicted or self.params.default_model_size_bytes

    def _local_load_allowed(self, required_units: int) -> bool:
        """Churn guard: when full, don't evict recently-used entries
        (reference :3872-3884)."""
        if self.shutting_down or self.disabled or self.draining:
            return False
        free = self.cache.capacity - self.cache.weight
        if free >= required_units:
            return True
        oldest = self.cache.oldest_time()
        return oldest is not None and (
            now_ms() - oldest >= self.config.min_churn_age_ms
        )

    def _load_local(
        self, model_id: str, mr: ModelRecord, ctx: RoutingContext
    ) -> Optional[CacheEntry]:
        """Insert a cache entry and enqueue the load. Returns the (possibly
        pre-existing) entry, or None if loading here isn't allowed."""
        existing = self.cache.get_quietly(model_id)
        if existing is not None and existing.state not in (
            EntryState.FAILED, EntryState.REMOVED
        ):
            return existing

        info = ModelInfo(mr.model_type, mr.model_path, mr.model_key)
        if not ctx.known_size_bytes:
            ctx.known_size_bytes = self._predict_size_bytes(model_id, mr)
        units = bytes_to_units(ctx.known_size_bytes)
        # Sharded group member: this instance loads ONE SHARD, accounted
        # at its share of the model. The watch-fed view can lag the group
        # CAS that assigned us — when the full size would not even fit,
        # one authoritative re-read closes that window before the load is
        # misrecorded as a capacity failure.
        shard_index = (
            mr.shard_index_of(self.instance_id) if mr.shard_count else None
        )
        if shard_index is None and units > self.cache.capacity:
            try:
                fresh = self.registry.get(model_id)
            except Exception:  # noqa: BLE001 — KV hiccup: keep the view
                fresh = None
            if fresh is not None:
                mr = fresh
                shard_index = (
                    mr.shard_index_of(self.instance_id)
                    if mr.shard_count else None
                )
        shard_count = mr.shard_count if shard_index is not None else 0
        if shard_index is not None:
            units = max(1, -(-units // shard_count))
        if not self._local_load_allowed(units):
            return None
        if units > self.cache.capacity:
            self._record_load_failure(
                model_id, f"model size {units}u exceeds instance capacity"
            )
            return None

        last_used = ctx.last_used_ms or now_ms()
        ce = CacheEntry(model_id, info, weight_units=units, last_used=last_used)
        ce.chain_load_count = ctx.chain_load_count
        if shard_index is not None:
            ce.shard_index = shard_index
            ce.shard_count = shard_count
            ce.group_epoch = mr.group_epoch
            # Chains place extra FULL copies; a shard scales by group
            # re-planning instead.
            ce.chain_load_count = 0
        # Observability linkage: state transitions flow into the flight
        # recorder, and the load (which runs on a pool thread with no
        # request context) inherits the initiating request's trace id +
        # open span so the load's trace record joins the same tree.
        ce.recorder = self.flightrec
        ce.trace_id = Tracer.current_trace_id()
        ce.trace_parent = Tracer.current_span_id()
        prev = self.cache.put_if_absent(model_id, ce, units, last_used=last_used)
        if prev is not None:
            return prev

        # CAS our loading claim into the registry (reference loadLocal
        # conflict analysis, ModelMesh.java:5199-5255); promoted to a loaded
        # placement when the load completes.
        try:
            def place(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
                if cur is None:
                    return None  # unregistered concurrently
                cur.claim_loading(self.instance_id, now_ms())
                return cur

            if self.registry.update_or_create(model_id, place) is None:
                self.cache.remove_if_value(model_id, ce)
                ce.remove()
                raise ModelNotFoundError(model_id)
        except CasFailed:
            self.flightrec.record("cas-failed", op="claim-loading",
                                  model=model_id)
            self.cache.remove_if_value(model_id, ce)
            ce.remove()
            raise

        ce.queued_ms = now_ms()
        # Guarded transition, NOT a bare state write: a registry-deletion
        # cleanup racing this insert can have already REMOVED the entry
        # (remove_if_value succeeded between put_if_absent and here), and
        # clobbering REMOVED -> QUEUED would let _run_load load and
        # re-promote a model that was just unregistered. On failure the
        # submit below is harmless: _run_load's own guarded transitions
        # abandon a terminal entry immediately.
        ce.try_transition(EntryState.QUEUED)
        urgent = ctx.hop != RoutingContext.INTERNAL
        self.loading_pool.submit(
            lambda: self._run_load(ce), urgent=urgent, last_used=last_used
        )
        # Concurrent chained fan-out: secondary copies start placing as
        # soon as the FIRST copy's loading claim is in the registry (just
        # CASed above) rather than after its load completes — the whole
        # chain loads in parallel across the fleet.
        if (
            self.load_fastpath
            and ctx.chain_load_count > 0
            and ce.claim_chain_fire()
        ):
            self._spawn_chain(model_id, last_used, ctx.chain_load_count)
        return ce

    def _run_load(self, ce: CacheEntry) -> None:
        """Loading-pool task. All state advances go through the entry's
        guarded transitions so a concurrent eviction (-> REMOVED) is never
        clobbered; if the entry is removed after the runtime load happened,
        the runtime copy is released here.

        Pipelined fast path (``load_fastpath``): the entry activates and
        serves traffic as soon as ``loader.load`` returns a usable handle
        — the predicted size keeps holding the cache slot — and the
        ``model_size`` RPC runs as an overlapped follow-up whose guarded
        weight correction (``_correct_sizing``) can never touch an entry
        a concurrent eviction removed. Serial path (fastpath off, or the
        loader reported its size inline): size first, then activate."""
        model_id = ce.model_id
        # Anchor the queue-delay at submit time (set in _load_local), not at
        # worker pickup — otherwise the metric reads ~0 exactly when the
        # loading pool is saturated.
        queued_ms = getattr(ce, "queued_ms", None) or now_ms()
        # The load runs on a pool thread: re-open the initiating request's
        # trace (ce.trace_id, parented under its open span) so cache-miss
        # wait, peer stream, and activation appear in ONE tree. An
        # untraced origin mints (sampled) its own load trace.
        with self.tracer.trace(
            getattr(ce, "trace_id", ""), model_id, "load",
            parent_span=getattr(ce, "trace_parent", ""),
        ):
            self._run_load_traced(ce, queued_ms)

    def _run_load_traced(self, ce: CacheEntry, queued_ms: int) -> None:
        model_id = ce.model_id
        try:
            if self.loader.requires_unload:
                if not ce.try_transition(EntryState.WAITING):
                    return
                if not self._wait_space(ce):
                    raise ModelLoadException(
                        f"{model_id}: timed out waiting for unload space",
                        timeout=True,
                    )
            # Stamp the load start BEFORE the LOADING broadcast: waiters
            # wake on that transition to re-base onto the per-type load
            # budget, and must never observe LOADING with no start time
            # (they would silently fall back to the flat cap).
            ce.load_started_ms = now_ms()
            if not ce.try_transition(EntryState.LOADING):
                return
            self.metrics.observe(
                MX.QUEUE_DELAY, ce.load_started_ms - queued_ms, model_id
            )
            if ce.is_shard:
                # Sharded group member: materialize OUR shard (same-shard
                # peer stream, sliced full snapshot, or store) and settle
                # in SHARDED. No sizing phase — the shard share is the
                # loader's deterministic fraction of the measured total.
                loaded, _source = self.transfer.load_shard_weights(ce)
                if self.probation is not None:
                    self.probation.record_success()
                if loaded.size_bytes:
                    new_units = bytes_to_units(loaded.size_bytes)
                    if new_units != ce.weight_units and (
                        self.cache.update_weight(model_id, new_units)
                        is not None
                    ):
                        ce.weight_units = new_units
                self._activate_shard(ce, loaded)
                return
            # Weight-source resolution (transfer/): host-tier re-warm or
            # peer stream when available, model store otherwise — with
            # in-manager fallback to the store on any mid-transfer error.
            loaded, _source = self.transfer.load_weights(ce)
            # The runtime demonstrably works — disarm bootstrap probation
            # even if this entry is removed before activation below.
            if self.probation is not None:
                self.probation.record_success()
            size_bytes = loaded.size_bytes
            if not size_bytes and self.load_fastpath:
                # Serve-before-sizing: waiters wake NOW; the sizing RPC
                # and weight/registry correction overlap live traffic.
                if self._activate(ce, loaded):
                    self._correct_sizing(ce, loaded)
                return
            if not size_bytes and ce.try_transition(EntryState.SIZING):
                t_size = _time.perf_counter()  #: wall-clock: perf_counter latency metric (sizing)
                size_bytes = self.loader.model_size(model_id, loaded.handle)
                self.metrics.observe(
                    MX.SIZING_TIME, (_time.perf_counter() - t_size) * 1e3,  #: wall-clock: perf_counter latency metric
                    model_id,
                )
            if size_bytes:
                new_units = bytes_to_units(size_bytes)
                if new_units != ce.weight_units:
                    if self.cache.update_weight(model_id, new_units) is not None:
                        ce.weight_units = new_units
                    loaded = type(loaded)(
                        handle=loaded.handle,
                        size_bytes=size_bytes,
                        max_concurrency=loaded.max_concurrency,
                    )
            self._activate(ce, loaded)
        except ModelLoadException as e:
            self._load_failed(ce, str(e))
        except Exception as e:  # noqa: BLE001 — any load error is a failure
            self._load_failed(ce, f"{type(e).__name__}: {e}")

    def _activate(self, ce: CacheEntry, loaded) -> bool:
        """Finalize a runtime load: ACTIVE (unless removed meanwhile — then
        the runtime copy is released), registry promotion with the
        instance-record publish riding the same txn, chained-load trigger,
        load metrics. Returns True when the entry activated."""
        model_id = ce.model_id
        if not ce.complete_load(loaded):
            # Removed (evicted/unregistered) while we were loading.
            self.loader.unload(model_id)
            return False
        published = self._promote_loaded(model_id, size_units=ce.weight_units)
        self._trigger_chained_load(ce)
        self.metrics.inc(MX.LOAD_COUNT, model_id=model_id)
        if ce.load_started_ms:
            elapsed = now_ms() - ce.load_started_ms
            self.metrics.observe(MX.LOAD_TIME, elapsed, model_id)
            self.time_stats.record(ce.info.model_type, elapsed)
        if not published:
            self.publish_instance_record()
        return True

    def _activate_shard(self, ce: CacheEntry, loaded) -> bool:
        """Finalize a shard load: SHARDED state (terminal and servable —
        but routable only once the whole group is complete), registry
        promotion (which is what completes the group when the last shard
        lands), load metrics. No chained loads: groups scale by re-plan."""
        model_id = ce.model_id
        if not ce.complete_shard(loaded):
            self.loader.unload(model_id)
            return False
        published = self._promote_loaded(model_id, size_units=ce.weight_units)
        self.metrics.inc(MX.LOAD_COUNT, model_id=model_id)
        self.metrics.inc(MX.SHARDED_SHARD_LOAD_COUNT, model_id=model_id)
        if ce.load_started_ms:
            elapsed = now_ms() - ce.load_started_ms
            self.metrics.observe(MX.LOAD_TIME, elapsed, model_id)
            self.time_stats.record(ce.info.model_type, elapsed)
        self.flightrec.record(
            "sharded-group", op="shard-loaded", model=model_id,
            shard=ce.shard_index, shards=ce.shard_count,
            epoch=ce.group_epoch,
        )
        if not published:
            self.publish_instance_record()
        return True

    def begin_partial_serve(self, ce: CacheEntry, loaded) -> None:
        """Serve-before-fully-loaded: a streamed transfer has landed
        enough layers for this layer-streamable copy to admit requests.
        Move the entry to PARTIAL (waiters wake immediately) and promote
        the copy into the registry so the partial copy is advertised and
        routable mid-transfer; the stream's completion finalizes it to
        ACTIVE through the normal ``_activate`` path."""
        if not ce.begin_partial(loaded):
            return  # evicted/failed mid-stream: the stream outcome decides
        self.metrics.inc(MX.PARTIAL_SERVE_COUNT, model_id=ce.model_id)
        log.info(
            "%s serving partially-streamed (promoting mid-transfer)",
            ce.model_id,
        )
        # partial=True keeps our loading claim beside the promotion:
        # routable for requests, but flagged to peers as not-yet-a-
        # transfer-source (and their pending waits keep their anchor).
        if not self._promote_loaded(
            ce.model_id, size_units=ce.weight_units, partial=True
        ):
            self.publish_instance_record()

    def _correct_sizing(self, ce: CacheEntry, loaded) -> None:
        """Overlapped follow-up of a serve-before-sizing activation: run
        the ``model_size`` RPC and re-account the entry from its predicted
        weight to the measured one. Guarded throughout — the entry is
        already ACTIVE and serving, so a sizing failure only keeps the
        prediction, and the correction applies through
        ``update_weight_if_value`` so a concurrently evicted (or replaced)
        copy is never touched."""
        model_id = ce.model_id
        try:
            t_size = _time.perf_counter()  #: wall-clock: perf_counter latency metric (overlapped sizing)
            size_bytes = self.loader.model_size(model_id, loaded.handle)
            self.metrics.observe(
                MX.SIZING_TIME, (_time.perf_counter() - t_size) * 1e3,  #: wall-clock: perf_counter latency metric
                model_id,
            )
        except Exception as e:  # noqa: BLE001 — keep serving on prediction
            log.warning(
                "post-activation sizing of %s failed (serving continues "
                "on the predicted size): %s", model_id, e,
            )
            return
        if not size_bytes:
            return
        new_units = bytes_to_units(size_bytes)
        if new_units == ce.weight_units:
            return
        if not self.cache.update_weight_if_value(model_id, ce, new_units):
            return  # evicted/replaced during sizing: nothing to correct
        ce.weight_units = new_units
        ce.loaded = type(loaded)(
            handle=loaded.handle,
            size_bytes=size_bytes,
            max_concurrency=loaded.max_concurrency,
        )

        # The promotion advertised the predicted units to the global
        # solver — correct the record only when the measurement moved it.
        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            cur.size_units = new_units
            return cur

        try:
            self.registry.update_or_create(model_id, mutate)
        except CasFailed:
            log.warning("size-correction CAS gave up for %s", model_id)
        self.publish_instance_record()

    def _promote_loaded(
        self, model_id: str, size_units: int = 0, partial: bool = False,
    ) -> bool:
        """CAS the loaded promotion into the registry, with the refreshed
        instance-record advertisement riding the SAME store txn (the
        batched-mutation fast path: one KV round trip where the serial
        pipeline paid a promote CAS plus a separate publish put). Returns
        True when the publish rode the txn — the caller can then skip its
        standalone publish entirely. ``partial``: a mid-transfer (PARTIAL)
        promotion keeps the loading claim so peers know the copy is not a
        transfer source yet (records.promote_partial)."""

        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            if partial:
                cur.promote_partial(self.instance_id, now_ms())
            else:
                cur.promote_loaded(self.instance_id, now_ms())
            if size_units:
                cur.size_units = size_units
            return cur

        try:
            if not self.load_fastpath:
                raise _NoPublishLease  # serial baseline: plain CAS below
            with self._publish_lock:
                rec = self._build_publish_record_locked()
                op = self._session.publish_op(rec.to_bytes())
            if op is None:
                raise _NoPublishLease
            # The txn runs OUTSIDE _publish_lock: CAS retries are KV
            # round trips, and concurrent load completions must not
            # convoy on the lock (it guards only the bookkeeping).
            # Interleaved publishes are each self-consistent — the
            # suppression state follows whichever record committed last.
            self.registry.batch_mutate([(model_id, mutate)], [op])
            with self._publish_lock:
                self._last_published = rec
            self._publish_gauges()
            return True
        except CasFailed:
            # The record mutation gave up AND the piggybacked publish
            # never committed — let the caller's coalesced publish carry
            # the advertisement on its own.
            self.flightrec.record("cas-failed", op="promote-txn",
                                  model=model_id)
            log.warning("promote-loaded CAS gave up for %s", model_id)
            return False
        except _NoPublishLease:
            pass
        except Exception as e:  # noqa: BLE001 — e.g. session lease died
            log.warning(
                "merged promote+publish txn for %s failed (%s); "
                "falling back to a plain promote", model_id, e,
            )
        try:
            self.registry.update_or_create(model_id, mutate)
        except CasFailed:
            log.warning("promote-loaded CAS gave up for %s", model_id)
        return False

    def _wait_entry_active(self, ce: CacheEntry, cancel_event=None) -> bool:
        """Wait for an entry to activate, with a per-type bound on the LOAD
        phase only (reference TimeStats at ModelMesh.java:4351).

        Event-driven: the entry's condition variable broadcasts on every
        state transition, so the waiter sleeps for exactly its remaining
        budget and wakes at activation / failure / removal with
        notification latency — no polling-cadence slack. Intermediate
        transitions (QUEUED -> LOADING sets ``load_started_ms``) also wake
        it, re-basing the per-type load budget the moment the runtime load
        actually starts. Only a request carrying a ``cancel_event`` still
        slices its sleep: cancellation arrives on a foreign Event that
        cannot notify this condition.

        The overall wait is capped by the flat load_timeout*1.5 bound — it
        covers queueing behind a saturated loading pool, where per-type
        stats say nothing. Once the runtime load actually starts
        (load_started_ms set), a healthy load of this type should finish
        within mean+3σ; allow twice that (floored for cold starts) from
        the load start before declaring it stuck.
        """
        clock = get_clock()
        cap_s = self.load_timeout_s * 1.5
        mtype = ce.info.model_type
        if self.time_stats.samples(mtype) >= self.time_stats.min_samples:
            expect_s = self.time_stats.expect_ms(mtype) / 1000.0
            load_budget_s = min(cap_s, max(5.0, expect_s * 2.0))
        else:
            # Cold start: no per-type evidence yet — only the flat bound
            # applies (a 10s default budget would abort healthy slow first
            # loads and cascade duplicate copies).
            load_budget_s = cap_s
        deadline = clock.monotonic() + cap_s
        state = ce.state
        while True:
            if state.is_servable:
                return True
            if state is EntryState.FAILED:
                raise ModelLoadException(ce.error or "load failed")
            if state is EntryState.REMOVED:
                return False
            if cancel_event is not None and cancel_event.is_set():
                # The client is gone: stop pinning this handler thread on
                # the load (the load itself continues for other waiters).
                raise RequestCancelledError(ce.model_id)
            now = clock.monotonic()
            remaining = deadline - now
            started = ce.load_started_ms
            if started:
                remaining = min(
                    remaining,
                    load_budget_s - (now_ms() - started) / 1000.0,
                )
            if remaining <= 0:
                self.metrics.inc(MX.LOAD_TIMEOUT_COUNT, model_id=ce.model_id)
                self._log_loader_stacks(ce.model_id)
                return False
            if cancel_event is not None:
                remaining = min(remaining, 0.25)
            state = ce.await_transition(state, remaining)

    def _log_loader_stacks(self, model_id: str) -> None:
        """On a load timeout, capture the loading-pool threads' live stacks
        (the reference captures the stuck thread's stacktrace on load
        timeout, ModelMesh.java:2313-2318) — the single most useful
        artifact for diagnosing a wedged runtime."""
        ce = self.cache.get_quietly(model_id)
        if ce is not None and getattr(ce, "_stacks_logged", False):
            return  # N waiters timing out on one load: dump once
        if ce is not None:
            ce._stacks_logged = True
        import sys
        import traceback

        frames = sys._current_frames()
        stacks = []
        for t in threading.enumerate():
            if not t.name.startswith("loader-") or t.ident not in frames:
                continue
            frame = frames[t.ident]
            # Idle pool threads park in threading's cv.wait — only busy
            # (potentially stuck) threads are diagnostic signal.
            if frame.f_code.co_filename.endswith("threading.py"):
                continue
            stack = "".join(traceback.format_stack(frame))
            stacks.append(f"--- {t.name} ---\n{stack}")
        if stacks:
            log.warning(
                "load timeout for %s; loading-thread stacks:\n%s",
                model_id, "\n".join(stacks),
            )

    def _wait_space(self, ce: CacheEntry) -> bool:
        # The entry's weight is already inserted in the cache; what we wait
        # for is pending unloads to drain so that total (cache + pending)
        # fits capacity.
        return self.unload_tracker.wait_for_space(
            lambda: self.cache.weight, 0, timeout_s=self.config.space_wait_s
        )

    def _load_failed(self, ce: CacheEntry, message: str) -> None:
        log.warning("load of %s failed: %s", ce.model_id, message)
        # An entry that BEGAN partial serving has a provisional runtime
        # copy resident (the partial_ready contract: servable = device
        # memory allocated) — the terminal failure must release it like
        # _activate's removed-entry branch does, or the partially-
        # streamed weights leak with no entry left to ever trigger the
        # unload. Sticky flag, not the state: a concurrent eviction may
        # have moved a PARTIAL entry to REMOVED already (the eviction
        # skipped the unload — the copy was never was_active).
        was_partial = getattr(ce, "partial_started", False)
        if self.probation is not None:
            self.probation.record_failure(ce.model_id, message)
        self.metrics.inc(MX.LOAD_FAILED_COUNT, model_id=ce.model_id)
        ce.fail(message)
        self.cache.remove_if_value(ce.model_id, ce)
        if was_partial:
            if self.loader.requires_unload:
                self._async_unload(ce.model_id, ce.weight_units)
            else:
                model_id = ce.model_id
                self._submit_unload(lambda: self.loader.unload(model_id))
        self._record_load_failure(ce.model_id, message)
        self.publish_instance_record()

    def _record_load_failure(self, model_id: str, message: str) -> None:
        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            cur.remove_instance(self.instance_id)
            cur.add_load_failure(self.instance_id, message)
            return cur

        try:
            self.registry.update_or_create(model_id, mutate)
        except CasFailed:
            log.warning("failure-record CAS gave up for %s", model_id)

    # ------------------------------------------------------------------ #
    # eviction / removal                                                 #
    # ------------------------------------------------------------------ #

    def _on_eviction(self, model_id: str, ce: CacheEntry, last_used: int) -> None:
        """Cache evicted an entry (capacity pressure). Called under the
        eviction lock — NO blocking work here: KV deregistration and the
        runtime unload run on a separate thread so the inference hot path
        (which takes the same lock) never stalls on KV round trips."""
        log.info("evicting %s (last used %d)", model_id, last_used)
        self.metrics.inc(MX.EVICT_COUNT, model_id=model_id)
        if last_used:
            self.metrics.observe(
                MX.EVICT_AGE, (now_ms() - last_used) / 1000.0, model_id
            )
        was_active = ce.state is EntryState.ACTIVE
        # SHARDED holds device memory like ACTIVE does (its shard of the
        # group) — eviction must unload it; it just never demotes into the
        # host tier (a shard snapshot under the full-model fingerprint
        # would poison peer fetches).
        was_resident = was_active or ce.state is EntryState.SHARDED
        ce.remove()
        units = ce.weight_units
        do_unload = was_resident and self.loader.requires_unload
        if do_unload:
            self.unload_tracker.unload_started(units)

        self._drop_model_rate(model_id)

        def post_evict():
            try:
                # Flush the batch queue before the runtime copy drops:
                # parked requests ride a final (drain-flagged) dispatch
                # against the still-live handle instead of racing the
                # unload below. Runs on the unload pool — never under
                # the eviction lock.
                if self.batcher is not None:
                    self.batcher.flush(model_id, timeout_s=2.0)
                # Demote-to-host ahead of the full drop: export the
                # weights into the host tier BEFORE the runtime unload
                # releases the handle, so a re-warm is a device copy and
                # peers can keep fetching from this host. Only full
                # (was-ACTIVE) copies demote; best-effort by design.
                demoted = was_active and self.transfer.demote_evicted(
                    model_id, ce
                )
                self._deregister(
                    model_id, record_unload_time=True, demoted=demoted
                )
            finally:
                if do_unload:
                    try:
                        self.loader.unload(model_id)
                    finally:
                        self.unload_tracker.unload_finished(units)
                        self.publish_instance_record()

        self._submit_unload(post_evict)

    def _on_host_tier_evict(self, model_id: str, snap, size_bytes: int) -> None:
        """Host tier evicted a snapshot (host-capacity pressure). Called
        under the tier's lock — schedule the registry host-claim cleanup,
        never CAS inline."""
        self.metrics.inc(MX.HOST_TIER_EVICT_COUNT, model_id=model_id)
        self._cleanup_pool.submit(self._drop_host_claim, model_id)

    def _drop_host_claim(self, model_id: str) -> None:
        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            cur.drop_host_copy(self.instance_id)
            return cur

        try:
            self.registry.update_or_create(model_id, mutate)
        except CasFailed:
            log.warning("host-claim drop CAS gave up for %s", model_id)
        except Exception:  # noqa: BLE001 — stale claims are reaper-pruned
            pass

    def _claim_host_copy(self, model_id: str) -> bool:
        """Advertise this instance as a host-tier holder (the pre-warm
        twin of _drop_host_claim): receivers rank advertised holders as
        peer-fetch sources and re-warm targets."""
        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            cur.claim_host_copy(self.instance_id)
            return cur

        try:
            self.registry.update_or_create(model_id, mutate)
            return True
        except CasFailed:
            log.warning("host-claim CAS gave up for %s", model_id)
            return False
        except Exception:  # noqa: BLE001 — an unadvertised snapshot is
            # harmless; the next pre-warm pass (or demote) re-claims
            return False

    def demote_surplus_copy(self, model_id: str) -> bool:
        """Autoscale scale-down actuation (autoscale/controller.py):
        drop the local device copy but demote its weights into the host
        tier first, so a demand reversal re-warms with a host->device
        copy (~9 ms) instead of re-paying the cold store load (~82 ms).
        The host claim is advertised with the deregistration, exactly
        like a drain's cold-copy demotion."""
        ce = self.cache.get_quietly(model_id)
        if ce is None or ce.state is not EntryState.ACTIVE:
            return False
        if not self._remove_local(model_id, demote=True):
            return False
        self.metrics.inc(MX.SCALE_DOWN_COUNT, model_id=model_id)
        return True

    def prewarm_host_copy(self, model_id: str) -> bool:
        """Predictive pre-warm actuation (autoscale/controller.py):
        stage a host-tier snapshot of ``model_id`` streamed from a live
        holder (never the store) and advertise the host claim, so the
        forecast ramp is absorbed by the re-warm path. Best-effort; the
        snapshot is speculative and never evicts demoted copies
        (HostTier.put_if_room)."""
        if not self.transfer.prewarm_host(model_id):
            return False
        self._claim_host_copy(model_id)
        return True

    def handle_weight_fetch(
        self, model_id: str, chunk_index: int, fingerprint: str = "",
    ):
        """Sender side of the mesh-internal FetchWeights channel (served
        beside Forward): one chunk of this instance's snapshot of the
        model, from the host tier (exporting a live copy on first
        demand)."""
        # Deliberately NOT gated on shutting_down: graceful drain
        # (pre_shutdown migration) is exactly when peers streaming our
        # copies is most valuable, and the runtime handle is still alive
        # for the whole migration pass. A copy torn down mid-fetch just
        # yields NOT_AVAILABLE / a transport error — the receiver's
        # store fallback covers it like any other mid-stream fault.
        reply = self.transfer.handle_fetch(model_id, chunk_index, fingerprint)
        if not reply.ok and self.host_tier.peek(model_id) is None:
            # Self-heal a dangling host claim: a receiver dialed us as an
            # advertised host-tier source but the snapshot is gone (the
            # demote/evict CAS race) and we have nothing else to serve —
            # drop the claim so the fleet stops ranking us.
            mr = self.registry_view.get(model_id)
            if mr is not None and self.instance_id in getattr(
                mr, "host_instances", {}
            ):
                self._cleanup_pool.submit(self._drop_host_claim, model_id)
        return reply

    def _on_registry_event(self, event, model_id: str, record) -> None:
        """Registry watch listener: prompt local-copy cleanup on deletion.

        Runs on the KV watch dispatcher thread, which must never block on
        KV round-trips — the actual cleanup (CAS deregister + runtime
        unload) is queued onto the bounded cleanup pool.
        """
        # Any registry movement (copy added/removed/promoted, load failed,
        # deletion) drops the memoized route for the model. The version
        # check in _choose_serve_target already rejects stale entries once
        # the VIEW catches up; this eagerly frees the slot and keeps the
        # cache from holding routes for deleted models.
        self.route_cache.invalidate(model_id)
        if event is not TableEvent.DELETED:
            # Sharded-group membership is registry-authoritative: if an
            # update shows OUR shard claim gone or re-indexed (group torn
            # down by atomic eviction, re-planned to another holder), the
            # local shard is dead weight — queue its teardown. Keyed on
            # the claim itself, not the group epoch: epoch is advisory.
            ce = self.cache.get_quietly(model_id)
            if (
                ce is not None and ce.is_shard and record is not None
                and (
                    not record.shard_count
                    or record.shard_index_of(self.instance_id)
                    != ce.shard_index
                )
            ):
                self._cleanup_pool.submit(
                    self._teardown_stale_shard, model_id, ce
                )
            return
        # A deleted model's host-tier snapshot is dead weight (the record
        # that advertised it is gone): release the RAM promptly.
        self.transfer.drop_host_copy(model_id)
        if self.cache.get_quietly(model_id) is None:
            return
        self._cleanup_pool.submit(self._cleanup_deleted_model, model_id)
        # False return (pool shut down) means the instance is stopping —
        # nothing left worth cleaning.

    def _cleanup_deleted_model(self, model_id: str) -> None:
        # Re-registration may race the delete event: authoritative re-read —
        # only drop the copy if the model is still gone from the registry.
        try:
            if self.registry.get(model_id) is not None:
                return
        except Exception:  # noqa: BLE001 — KV outage: janitor will retry
            return
        if not self._remove_local(model_id):
            return
        log.info(
            "unloaded %s: deleted from registry (watch-driven cleanup)",
            model_id,
        )
        self.publish_instance_record()
        # The pre-read narrows but cannot close the delete/re-register race:
        # a re-registration landing between the read and the removal just
        # had a fresh copy torn down. Converge instead of trying to be
        # atomic — if the record is back, restore a copy somewhere.
        try:
            if self.registry.get(model_id) is not None:
                log.info(
                    "%s re-registered during deletion cleanup; re-placing",
                    model_id,
                )
                self.ensure_loaded(model_id)
        except Exception:  # noqa: BLE001 — best-effort; demand-load covers
            pass

    def _teardown_stale_shard(self, model_id: str, ce: CacheEntry) -> None:
        """Drop a local shard whose registry claim vanished or moved.

        Watch events lag and re-plans race: re-read the authoritative
        record and keep the shard if our claim is intact after all."""
        try:
            mr = self.registry.get(model_id)
        except Exception:  # noqa: BLE001 — KV hiccup: next event retries
            return
        if (
            mr is not None
            and mr.shard_count == ce.shard_count
            and mr.shard_index_of(self.instance_id) == ce.shard_index
        ):
            return  # claim intact — the watch event was stale
        if self.cache.get_quietly(model_id) is not ce:
            return  # entry already replaced/removed; nothing owed
        if self._remove_local(model_id):
            self.flightrec.record(
                "sharded-group", op="teardown", model=model_id,
                shard=ce.shard_index, shards=ce.shard_count,
            )
            self.publish_instance_record()

    def _remove_local(self, model_id: str, demote: bool = False) -> bool:
        # Deliberate removal (unregister / deletion cleanup / shutdown
        # migration) drops the host-tier snapshot too — unlike capacity
        # eviction, which demotes into it. The registry host claim falls
        # with remove_instance in _deregister below. ``demote=True``
        # (drain of a cold copy, reconfig/drain.py) follows the eviction
        # convention instead: snapshot into the host tier BEFORE the
        # runtime unload releases the handle and advertise the host claim
        # with the deregistration, so the copy stays a peer-fetch source
        # for the rest of the drain window.
        ce = self.cache.get_quietly(model_id)
        if ce is None:
            if not demote:
                self.transfer.drop_host_copy(model_id)
            return False
        # Batch-queue drain integration: flush parked requests
        # through a final dispatch BEFORE the copy drops, so a drain's
        # zero-gap guarantee extends to requests already queued behind
        # an in-flight micro-batch.
        if self.batcher is not None and ce.state.is_servable:
            self.batcher.flush(model_id, timeout_s=2.0)
        demoted = False
        if demote:
            demoted = ce.state is EntryState.ACTIVE and (
                self.transfer.demote_evicted(model_id, ce)
            )
        else:
            self.transfer.drop_host_copy(model_id)
        if not self.cache.remove_if_value(model_id, ce):
            return False
        was_resident = ce.state in (EntryState.ACTIVE, EntryState.SHARDED)
        ce.remove()
        self._drop_model_rate(model_id)
        self._deregister(model_id, demoted=demoted)
        if was_resident and self.loader.requires_unload:
            self._async_unload(model_id, ce.weight_units)
        return True

    def _async_unload(self, model_id: str, units: int) -> None:
        self.unload_tracker.unload_started(units)

        def do_unload():
            try:
                self.loader.unload(model_id)
            finally:
                self.unload_tracker.unload_finished(units)
                self.metrics.inc(MX.UNLOAD_COUNT, model_id=model_id)
                self.publish_instance_record()

        self._submit_unload(do_unload)

    def _submit_unload(self, fn) -> None:
        """Run ``fn`` on the unload pool; after shutdown, fall back to a
        one-off daemon thread so accounting started by the caller (the
        unload_tracker reservation) still completes during shutdown
        migration. (Deletion cleanup deliberately has no such fallback —
        after shutdown there is nothing left worth cleaning.)"""
        if not self._unload_pool.submit(fn):
            threading.Thread(target=fn, daemon=True).start()

    # How young a loading claim survives the stale-self prune: a fresh
    # claim with no cache entry behind it is far more likely a concurrent
    # load racing this prune (its CAS landed between our trigger read and
    # the mutate below) than a crashed load — those are minutes stale by
    # the time the serve loop trips over them.
    _PRUNE_CLAIM_GRACE_MS = 2_000

    def _prune_stale_self(self, model_id: str) -> Optional["ModelRecord"]:
        """Drop OUR stale entry from a record's loaded set (cache disagrees
        with the registry about us). Returns the updated record, or None
        when the CAS gave up — the caller keeps its current view and the
        next iteration (or the reaper) retries."""

        class _NothingToPrune(Exception):
            pass

        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            # Re-read the cache INSIDE the CAS callback: the prune was
            # triggered from a pre-CAS cache read, and _load_local inserts
            # the cache entry before CAS'ing its registry claim — so a
            # load that started since the trigger is visible here. Without
            # this, the freshly CAS'd claim would be transiently dropped
            # and concurrent placements could double-load the model.
            # get_quietly: a registry-repair probe must not refresh the
            # entry's LRU recency (same as the trigger-path check).
            ce = self.cache.get_quietly(model_id)
            if ce is not None and ce.state is not EntryState.REMOVED:
                raise _NothingToPrune(cur)
            was_loaded = cur.instance_ids.pop(self.instance_id, None)
            claim_ts = cur.loading_instances.get(self.instance_id)
            was_loading = None
            if claim_ts is not None and (
                now_ms() - claim_ts >= self._PRUNE_CLAIM_GRACE_MS
            ):
                was_loading = cur.loading_instances.pop(
                    self.instance_id, None
                )
            if was_loaded is None and was_loading is None:
                # The trigger came from a lagging watch view; the REAL
                # record is already clean. Abort instead of CAS-writing
                # identical content (version bump + spurious cluster-wide
                # watch event), and hand the fresh record back.
                raise _NothingToPrune(cur)
            log.info(
                "pruned stale self-%s of %s (registry disagrees with "
                "the local cache)",
                "registration" if was_loaded is not None
                else "loading claim", model_id,
            )
            return cur

        try:
            return self.registry.update_or_create(model_id, mutate)
        except _NothingToPrune as e:
            return e.args[0]
        except CasFailed:
            log.warning("stale-self prune CAS gave up for %s", model_id)
            return None
        except Exception:  # noqa: BLE001 - KV outage: fail-fast covers it
            return None

    def _deregister(
        self, model_id: str, record_unload_time: bool = False,
        demoted: bool = False,
    ) -> None:
        def mutate(cur: Optional[ModelRecord]) -> Optional[ModelRecord]:
            if cur is None:
                return None
            cur.remove_instance(self.instance_id)
            # Re-check snapshot residency INSIDE the CAS callback: a
            # concurrent demotion of another model can have already
            # evicted ours from the host tier, and its scheduled
            # _drop_host_claim may have run (as a no-op) before this
            # claim commits — advertising a claim with nothing behind it
            # would strand receivers on NOT_AVAILABLE until we reload.
            # (handle_fetch self-heals the residual CAS-in-flight window.)
            if demoted and self.host_tier.peek(model_id) is not None:
                # The device copy is gone but a host-tier snapshot stays:
                # advertise it as a peer-fetch source (transfer/ tier).
                cur.claim_host_copy(self.instance_id, now_ms())
            if record_unload_time:
                cur.last_unload_ms = now_ms()
            return cur

        try:
            self.registry.update_or_create(model_id, mutate)
        except CasFailed:
            self.flightrec.record("cas-failed", op="deregister",
                                  model=model_id)
            log.warning("deregister CAS gave up for %s", model_id)

    # ------------------------------------------------------------------ #
    # forwarding                                                         #
    # ------------------------------------------------------------------ #

    def _forward(
        self, target: str, model_id: str, method: Optional[str],
        payload: bytes, headers: list[tuple[str, str]],
        ctx: RoutingContext, hop: int,
    ) -> InvokeResult:
        rec = self.instances_view.get(target)
        if rec is None:
            raise ServiceUnavailableError(target)
        if self._peer_call is None:
            raise ServiceUnavailableError(
                f"no peer transport configured (target {target})"
            )
        fwd_ctx = RoutingContext(
            hop=hop,
            exclude_serve=set(ctx.exclude_serve),
            exclude_load=set(ctx.exclude_load),
            visited=set(ctx.visited),
            dest_instance=target,
            chain_load_count=ctx.chain_load_count,
            known_size_bytes=ctx.known_size_bytes,
            last_used_ms=ctx.last_used_ms,
            cancel_event=ctx.cancel_event,
        )
        self.metrics.inc(MX.INVOKE_FORWARD_COUNT, model_id=model_id)
        # Own-outstanding accounting brackets the dispatch: the sender's
        # zero-staleness half of the load score (concurrent picks from
        # THIS instance spread immediately instead of herding on the
        # last piggybacked report).
        lv = self.route_cache.load_view
        lv.begin(target)
        try:
            with self.tracer.span("forward", target=target, hop=hop):
                result = self._peer_call(
                    rec.endpoint or target, model_id, method, payload,
                    outgoing_headers(headers), fwd_ctx,
                )
        finally:
            lv.end(target)
        # Piggybacked load feedback from the IMMEDIATE peer (the one we
        # route to — served_by may be a further hop, but the queue we
        # would join is the peer's): decays into the LoadView driving
        # every subsequent d-choices pick. getattr: stub transports in
        # older tests return bare InvokeResult-shaped objects.
        fb = getattr(result, "feedback", None)
        if fb is not None:
            lv.note(fb)
        return result

    # ------------------------------------------------------------------ #
    # shutdown                                                           #
    # ------------------------------------------------------------------ #

    def pre_shutdown(self, deadline_s: Optional[float] = None) -> None:
        """Graceful shutdown migration. Default path (MM_DRAIN_ON_SIGTERM):
        the reconfig DrainController — advertise DRAINING while still
        serving, pre-copy hot models to survivors over the transfer path
        (each local copy is dropped only after its survivor is servable:
        zero serving gap), host-tier demote the cold ones, then flip
        shutting_down and deregister. Legacy path (knob off): the
        reference preShutdown shape (ModelMesh.java:6959-7143) — flip
        shutting_down first, then migrate best-effort."""
        if deadline_s is None:
            deadline_s = self.config.drain_timeout_ms / 1000.0
        if self.config.drain_on_sigterm:
            from modelmesh_tpu_torch.reconfig.drain import DrainController

            DrainController(self, deadline_s=deadline_s).drain()
            return
        clock = get_clock()
        self.shutting_down = True
        self.publish_instance_record(force=True)
        deadline = clock.monotonic() + deadline_s
        recent_cutoff = now_ms() - 3_600_000
        items = list(self.cache.descending_items())  # MRU -> LRU
        for model_id, ce, last_used in items:
            remaining = deadline - clock.monotonic()
            if remaining <= 0:
                break
            if last_used >= recent_cutoff and not self.shutdown_skip_migration:
                try:
                    self.ensure_loaded(
                        model_id, last_used_ms=last_used, sync=True,
                        exclude={self.instance_id},
                    )
                except Exception as e:  # noqa: BLE001 — best-effort migration
                    log.warning("migration of %s failed: %s", model_id, e)
            self._remove_local(model_id)
        for model_id, _, _ in list(self.cache.descending_items()):
            self._remove_local(model_id)

    shutdown_skip_migration = False

    def shutdown(self) -> None:
        # Disarm the publish coalescer first: a trailing flush firing
        # after the session closes would republish a dead instance.
        with self._coalesce_lock:
            self._shutdown_publishes = True
            timer, self._publish_timer = self._publish_timer, None
        if timer is not None:
            timer.cancel()
        self.loading_pool.shutdown()
        self._cleanup_pool.shutdown()
        self._unload_pool.shutdown()
        if self._plan_follower is not None:
            self._plan_follower.close()
        self._election.close()
        self._session.close()
        self.registry_view.close()
        self.instances_view.close()
        self.migration_fence.close()
        close = getattr(self.loader, "close", None)
        if close:
            close()
