"""Registry of the environment knobs the port reads.

The port's own copy of the reference registry's accessors, holding only
the knobs the port reads: the placement solve's, the model runtime's, the
cluster layer's (the KV tables, plan distribution, greedy fallback, route
cache and the lock/race/clock debug aids), the serving instance's and the
serving pod's (static registration, bootstrap probation, request-header
log context and the autoscale controller), the launcher's, the remote
KV backends' and the simulator's. ``get`` raises ``KeyError`` for an unregistered name, so a
typo'd knob fails at the call site instead of silently reading the
default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    kind: str          # str | int | float | bool | json | path | list
    default: str
    help: str
    consumer: str      # module that reads it


_ENGINE = "placement/torch_engine.py"
_SERVER = "models/server.py"

REGISTRY: dict[str, EnvVar] = {
    e.name: e
    for e in [
        # MM_SOLVER_*: operator overrides of SolveConfig (empty = the
        # compiled default), read when a config is built from the env.
        EnvVar("MM_SOLVER_SINKHORN_ITERS", "int", "",
               "Sinkhorn iterations per solve (default 10)", _ENGINE),
        EnvVar("MM_SOLVER_AUCTION_ITERS", "int", "",
               "auction price-repair iterations (default 40)", _ENGINE),
        EnvVar("MM_SOLVER_TAU", "float", "",
               "Gumbel sampling temperature; 0 = deterministic argmax",
               _ENGINE),
        EnvVar("MM_SOLVER_LSE_IMPL", "str", "",
               "dense-tier Sinkhorn LSE kernels: auto (default — the CUDA "
               "kernels for CUDA tensors, their plain PyTorch versions "
               "for CPU tensors) | cuda (CUDA tensors required)", _ENGINE),
        EnvVar("MM_SOLVER_LOAD_IMPL", "str", "",
               "auction implied-load histogram: auto | scatter", _ENGINE),
        EnvVar("MM_SOLVER_NOISE_IMPL", "str", "",
               "rounding noise generator: hash | threefry (JAX's PRNG; "
               "routes the solve to the dense tier)",
               _ENGINE),
        EnvVar("MM_SOLVER_FINAL_SELECT", "str", "",
               "auction epilogue selection: exact | approx | none",
               _ENGINE),
        EnvVar("MM_SOLVER_SINKHORN_TOL", "float", "",
               "Sinkhorn early-exit tolerance on relative L1 row-marginal "
               "error (0/unset = fixed iteration budget)", _ENGINE),
        EnvVar("MM_SOLVER_SINKHORN_CHUNK", "int", "",
               "iterations per Sinkhorn convergence check (default 4)",
               _ENGINE),
        EnvVar("MM_SOLVER_AUCTION_STALL_TOL", "float", "",
               "auction early-exit stall tolerance (0/unset = fixed "
               "budget)", _ENGINE),
        EnvVar("MM_SOLVER_SPARSE", "str", "",
               "sparse top-K solve path: auto (default), 1/on forces "
               "sparse, 0/off forces dense", _ENGINE),
        EnvVar("MM_SOLVER_TOPK", "int", "",
               "candidate instances gathered per model on the sparse path "
               "(default 24)", _ENGINE),
        EnvVar("MM_SOLVER_SPARSE_IMPL", "str", "",
               "sparse-path kernel backend: auto (default — the CUDA "
               "kernels for CUDA tensors, their plain PyTorch versions "
               "for CPU tensors) | cuda (CUDA tensors required)", _ENGINE),
        EnvVar("MM_SOLVER_INCREMENTAL_MAX_DIRTY_FRAC", "float", "0.05",
               "dirty-row fraction ceiling for the incremental re-solve "
               "(frozen column potentials/prices); above it — or when "
               "the merged overflow fails the quality gate — the refresh "
               "falls back to a full warm solve; 0 disables incremental",
               _ENGINE),
        # The model runtime's knobs, with the reference's defaults.
        EnvVar("MM_FUSED_DISPATCH", "bool", "1",
               "fused cross-model dispatch on the model runtime: "
               "co-located same-architecture models of a layer-streamable "
               "family share one batch group and execute a multi-model "
               "micro-batch as ONE stacked (vmapped) call, falling back "
               "per-model when the group's membership moved", _SERVER),
        EnvVar("MM_TRANSFER_CHUNK_BYTES", "int", str(1 << 20),
               "weight-transfer chunk granularity (bytes per chunk), read "
               "by the exporting loader's serializer", _SERVER),
        EnvVar("MM_SHARDED_MESH_DEVICES", "int", "0",
               "serving-mesh width for sharded execution "
               "(parallel/mesh.py serving_mesh): weight matrices are "
               "column-split across the first this many of the store's "
               "devices; 0 (default) = every one of them",
               "parallel/mesh.py"),
        EnvVar("MM_MAX_MSG_BYTES", "int", str(16 << 20),
               "gRPC message cap on every server/channel",
               "utils/grpcopts.py"),
        # The registry, plan distribution and greedy fallback's knobs
        # (the cluster layer), with the reference's types and defaults.
        EnvVar("MM_MAX_PLAN_BYTES", "int", str(12 << 20),
               "published placement-plan byte budget",
               "placement/plan_sync.py"),
        EnvVar("MM_LOCK_DEBUG", "bool", "0",
               "instrumented Lock/Condition wrappers: record per-thread "
               "acquisition stacks and assert lock-acquisition order "
               "against the witness graph derived by tools/analysis "
               "(raises LockOrderViolation with a held-locks dump on an "
               "inversion); read at lock CREATION time — set it before "
               "constructing instances. Debug/test aid, not for "
               "production", "utils/lockdebug.py"),
        EnvVar("MM_RACE_DEBUG", "bool", "0",
               "FastTrack-lite vector-clock happens-before data-race "
               "sanitizer: mm_lock/mm_rlock/mm_condition carry "
               "release->acquire clock edges (plus thread create/join, "
               "pool submit->run, call_later schedule->fire), and "
               "@racedebug.tracked classes record per-field access "
               "epochs, raising DataRaceViolation with both conflicting "
               "stacks on an unordered access. Read at lock/instance "
               "CREATION time — set it before building a cluster. "
               "Debug/test aid, not for production",
               "utils/racedebug.py"),
        EnvVar("MM_CLOCK_DEBUG", "bool", "0",
               "runtime witness for the clock-discipline static rule: "
               "while a VirtualClock is installed, wall-clock reads "
               "(time.time/monotonic/sleep/perf_counter) from "
               "modelmesh_tpu_torch code raise WallClockViolation unless the "
               "call line carries a `#: wall-clock: <reason>` "
               "annotation — the same grammar the static analyzer "
               "enforces; read at clock-install time. Debug/test aid, "
               "not for production", "utils/clockdebug.py"),
        EnvVar("MM_LOAD_FAILURE_EXPIRY_MS", "int", str(15 * 60 * 1000),
               "how long a recorded load failure excludes an instance "
               "from re-load placement (default 15 min; reference "
               "ModelMesh.java:219-224)", "records.py"),
        EnvVar("MM_UPGRADE_MAX_UNAVAILABLE", "int", "1",
               "rolling-upgrade wave width (reconfig/rolling.py): at most "
               "this many instances drain concurrently per wave",
               "reconfig/rolling.py"),
        EnvVar("MM_FEEDBACK_DECAY_MS", "int", "5000",
               "staleness horizon for piggybacked load feedback: a "
               "peer's reported in-flight/queue-depth score decays "
               "linearly to zero over this window, so silence degrades "
               "the pick gracefully toward the greedy prior instead of "
               "acting on stale load", "serving/route_cache.py"),
        EnvVar("MM_ROUTE_CACHE", "bool", "1",
               "memoize the per-model serve-route candidate set on the "
               "request hot path (invalidated by registry version, "
               "instances-view epoch, warming-clock bucket; failed "
               "candidates demoted in place)",
               "serving/route_cache.py"),
        EnvVar("MM_ROUTE_CACHE_TTL_MS", "int", "1000",
               "route-cache warming-clock bucket width: bounds how long a "
               "time-dependent (warming/ride-the-load) routing decision "
               "can be served from cache", "serving/route_cache.py"),
        EnvVar("MM_ROUTE_D", "int", "2",
               "power-of-d-choices width for the serve pick: each request "
               "samples the greedy winner plus d-1 random cached "
               "candidates and takes the lowest capability-weighted load "
               "score (piggybacked feedback). 1 = the old single-winner "
               "route cache, bit-identical (regression-pinned parity "
               "mode)", "serving/route_cache.py"),
        # The serving instance's knobs (its cache, load pipeline,
        # batching, admission, observability, weight transfer and drain),
        # with the reference's types and defaults.
        EnvVar("MM_ADMISSION", "bool", "0",
               "SLO-burn-rate admission control at the external-API "
               "edge (serving/admission.py): when a class burns error "
               "budget at/above 1x, lower-priority classes (MM_SLO_SPEC "
               "order; the first clause is never shed) are token-bucket "
               "throttled — briefly queued, then shed with a typed "
               "overload error (RESOURCE_EXHAUSTED + mm-overload "
               "trailer). Off (default): zero request-path cost",
               "serving/admission.py"),
        EnvVar("MM_ADMISSION_QUEUE_MS", "int", "50",
               "bounded wait for a token before a throttled request is "
               "shed: absorbs bursts without letting sustained overload "
               "build a real queue; 0 sheds immediately",
               "serving/admission.py"),
        EnvVar("MM_BATCH_MAX", "int", "8",
               "continuous-batching micro-batch ceiling on the runtime "
               "data plane (serving/batching.py): concurrent requests "
               "for one model (or one fused family group) ride a single "
               "batched dispatch of up to this many requests; <= 1 "
               "disables the batch queue entirely. Engaged only for "
               "loaders with a real batched dispatch "
               "(supports_batched_dispatch) or an injected batched "
               "runtime call — an uncontended request always takes the "
               "zero-copy passthrough", "serving/instance.py"),
        EnvVar("MM_BATCH_WINDOW_US", "int", "0",
               "micro-batch fill window (microseconds): how long a batch "
               "leader waits for parked requests to fill the batch "
               "before dispatching below MM_BATCH_MAX. 0 (default) "
               "dispatches immediately — batches still form behind "
               "in-flight dispatches (continuous batching), with no "
               "timer on the uncontended path", "serving/instance.py"),
        EnvVar("MM_DRAIN_ON_SIGTERM", "bool", "1",
               "graceful drain on SIGTERM (reconfig/drain.py): mark the "
               "instance DRAINING, pre-copy hot models to survivors over "
               "the transfer/ peer-stream path (host-tier demote the cold "
               "ones), wait for survivor copies to be servable, then "
               "deregister; 0 falls back to the legacy immediate "
               "shutting_down migration", "serving/instance.py"),
        EnvVar("MM_DRAIN_TIMEOUT_MS", "int", "30000",
               "drain deadline: models not yet migrated when it expires "
               "are deregistered without pre-copy (bounded serving gap "
               "instead of an unbounded shutdown)",
               "serving/instance.py"),
        EnvVar("MM_FLIGHTREC_EVENTS", "int", "4096",
               "flight-recorder ring capacity (structured events: state "
               "transitions, placement decisions, CAS outcomes, transfer "
               "faults, drain phases); 0 disables recording; dump via "
               "the ***FLIGHTREC*** diagnostic id",
               "observability/flightrec.py"),
        EnvVar("MM_HOST_TIER_BYTES", "int", str(256 << 20),
               "host-RAM staging tier budget per instance (bytes): "
               "device-evicted copies demote to a host snapshot so "
               "re-warm is a device copy and peer fetches are served "
               "O(1) from host RAM; 0 disables the tier (and demotion)",
               "serving/instance.py"),
        EnvVar("MM_KV_READ_ONLY", "int", "0",
               "KV-migration read-only mode: block model add/remove, "
               "suppress reaper pruning", "serving/instance.py"),
        EnvVar("MM_LOAD_FASTPATH", "bool", "1",
               "pipelined model-load lifecycle: activate entries as soon "
               "as the runtime load returns (sizing becomes an overlapped "
               "guarded correction) and fan chained secondary copies out "
               "concurrently at claim time instead of hop-by-hop after "
               "each completion", "serving/instance.py"),
        EnvVar("MM_LOG_REQUEST_HEADERS", "list", "",
               "headers copied into the per-request log context "
               "(header or header=field)", "observability/logctx.py"),
        EnvVar("MM_PEER_FETCH", "bool", "1",
               "peer-to-peer weight streaming on scale-up: a new copy "
               "streams chunked weights from an already-loaded live peer "
               "(or a host-tier holder) over the mesh-internal "
               "FetchWeights channel instead of the model store, with "
               "store fallback on peer death or stream error; inert for "
               "loaders without supports_weight_streaming",
               "serving/instance.py"),
        EnvVar("MM_PUBLISH_COALESCE_MS", "int", "100",
               "trailing-flush window coalescing NON-forced instance-"
               "record publishes (0 = publish inline; force=True always "
               "bypasses): a mass load/unload storm issues O(1) "
               "advertisement puts instead of O(models)",
               "serving/instance.py"),
        EnvVar("MM_SHARDED", "bool", "1",
               "sharded execution for oversized models: a model too big "
               "for any single instance is placed as a multi-instance "
               "GROUP (one weight shard per member, co-planned by the "
               "placement strategy) and served through the SHARDED entry "
               "state; routing targets only COMPLETE groups. Inert for "
               "loaders without supports_sharded_execution — without it "
               "an oversized model fails to place exactly as before",
               "serving/instance.py"),
        EnvVar("MM_SHARDED_MAX_SHARDS", "int", "8",
               "ceiling on placement-group width: an oversized model "
               "shards into the SMALLEST K whose per-shard share fits "
               "the fleet, up to this many members; a model needing "
               "more fails to place", "serving/instance.py"),
        EnvVar("MM_SLO_SPEC", "str",
               "default:p99<250ms,availability>0.999",
               "declarative per-model-class SLOs, ';'-separated classes: "
               "class:obj,obj where obj is p50<Nms / p95<Nms / p99<Nms / "
               "availability>F; class = model_type, 'default' catches "
               "the rest (observability/slo.py grammar)",
               "serving/instance.py"),
        EnvVar("MM_SLO_WINDOW_MS", "int", "60000",
               "sliding window over which SLO attainment / burn rate are "
               "computed from request completions",
               "observability/slo.py"),
        EnvVar("MM_TRACE_CAPACITY", "int", "256",
               "bounded ring of finished traces kept per instance "
               "(retrievable via the ***TRACES*** diagnostic id)",
               "observability/tracing.py"),
        EnvVar("MM_TRACE_SAMPLE", "int", "32",
               "head-sampling for MINTED trace roots: 1-in-N external "
               "requests open a trace (1 = trace everything); adopted "
               "mm-trace-id headers always record, so a sampled request "
               "is traced end-to-end across every hop",
               "serving/instance.py"),
        # The serving pod's surfaces (serving/bootstrap.py,
        # serving/health.py) and the autoscale controller (serving/
        # tasks.py, autoscale/controller.py): the reference's types,
        # defaults and help.
        EnvVar("MM_STATIC_MODELS", "json", "",
               "models/vmodels registered at startup",
               "serving/bootstrap.py"),
        EnvVar("MM_PROBATION_S", "float", "360",
               "bootstrap fail-fast window seconds (0 disables)",
               "serving/health.py"),
        EnvVar("MM_PROBATION_FAILURES", "int", "3",
               "early load failures that abort bootstrap",
               "serving/health.py"),
        EnvVar("MM_AUTOSCALE", "str", "legacy",
               "the ONE copy-scaling authority: legacy (default — the "
               "10s rate-task scale-up + janitor cluster-full "
               "scale-down, behaviorally identical to before the "
               "autoscale/ subsystem), burn (the SLO-burn-rate "
               "controller: pre-breach copy adds over the fast weight "
               "paths, demote-to-host scale-down, predictive host-tier "
               "pre-warming; the legacy scalers are suppressed), or "
               "off (no scaling at all)", "serving/tasks.py"),
        EnvVar("MM_AUTOSCALE_BURN_UP", "float", "0.5",
               "class burn rate at/above which the controller scales "
               "its models up (1.0 = burning exactly at error budget; "
               "below 1 means the controller acts BEFORE breach)",
               "autoscale/controller.py"),
        EnvVar("MM_AUTOSCALE_BURN_DOWN", "float", "0.25",
               "class burn rate below which a class counts as calm; "
               "surplus copies demote to the host tier only after "
               "idle_ticks_down consecutive calm ticks",
               "autoscale/controller.py"),
        EnvVar("MM_AUTOSCALE_HOLDDOWN_MS", "int", "5000",
               "per-model hold after an autoscale copy add: no further "
               "add until the previous one landed (copy count moved) "
               "or this window expired", "autoscale/controller.py"),
        EnvVar("MM_AUTOSCALE_PREWARM", "bool", "1",
               "predictive pre-warming in burn mode: the leader "
               "publishes a forecast-driven pre-warm plan and targets "
               "stage host-tier snapshots streamed from live holders "
               "so demand ramps re-warm in ~ms instead of paying cold "
               "store loads", "autoscale/controller.py"),
        # The launcher (serving/main.py) and the remote KV backends
        # (kv/etcd.py): the reference's types, defaults and help.
        EnvVar("MM_KV_URI", "str", "",
               "coordination store URI; default for --kv (the k8s "
               "manifests also substitute it into args directly)",
               "serving/main.py"),
        EnvVar("MM_LOG_LEVEL", "str", "INFO",
               "process log level", "serving/main.py"),
        EnvVar("MM_TYPE_CONSTRAINTS", "path", "",
               "live-watched type-constraints JSON file",
               "serving/main.py"),
        EnvVar("MM_PAYLOAD_PROCESSORS", "list", "",
               "payload processor URIs", "serving/main.py"),
        EnvVar("MM_PER_MODEL_METRICS", "bool", "0",
               "add a model_id label to per-request metrics "
               "(accepts 1/0, true/false, yes/no, on/off; cardinality "
               "opt-in, reference's per-model flag)",
               "serving/main.py"),
        EnvVar("MM_ZONE", "str", "",
               "placement zone advertised in the instance record",
               "serving/main.py"),
        EnvVar("MM_LABELS", "list", "",
               "comma-separated placement labels (type constraints)",
               "serving/main.py"),
        EnvVar("MM_ETCD_MAX_VALUE_BYTES", "int", str(1 << 20),
               "etcd value budget (server --max-request-bytes quota)",
               "kv/etcd.py"),
        EnvVar("MM_SIM_SEED", "int", "0",
               "base seed for the deterministic cluster simulator's "
               "randomized exploration (python -m modelmesh_tpu_torch.sim); "
               "the same seed replays the identical fault schedule",
               "sim/explore.py"),
        EnvVar("MM_SIM_STEPS", "int", "40",
               "random fault/workload events generated per simulated "
               "scenario seed", "sim/explore.py"),
        EnvVar("MM_SIM_LOG_EVENTS", "int", "262144",
               "bound on SimCluster's per-request and batch-dispatch "
               "observation rings (total-order seq retained; 0 = "
               "unbounded, the pre-ring behavior) — macro-scale runs "
               "must not accumulate per-probe rows forever",
               "sim/ringlog.py"),
    ]
}


def get(name: str) -> Optional[str]:
    """Raw read; raises KeyError for unregistered names."""
    spec = REGISTRY[name]
    return os.environ.get(name, spec.default or None)


def get_int(name: str) -> int:
    spec = REGISTRY[name]
    if not spec.default and not os.environ.get(name):
        raise ValueError(f"{name} is unset and has no default")
    try:
        return int(os.environ.get(name, spec.default))
    except ValueError:
        return int(spec.default)


def get_float(name: str) -> float:
    spec = REGISTRY[name]
    if not spec.default and not os.environ.get(name):
        raise ValueError(f"{name} is unset and has no default")
    try:
        return float(os.environ.get(name, spec.default))
    except ValueError:
        return float(spec.default)


def get_bool(name: str) -> bool:
    """Boolean knob: accepts 1/0, true/false, yes/no, on/off (any case).
    Junk raises — a silently-disabled opt-in is the failure mode this
    registry exists to prevent."""
    raw = str(os.environ.get(name, REGISTRY[name].default)).strip().lower()
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"{name}={raw!r} is not a boolean")


def get_list(name: str) -> list[str]:
    raw = get(name) or ""
    return [s.strip() for s in raw.split(",") if s.strip()]
