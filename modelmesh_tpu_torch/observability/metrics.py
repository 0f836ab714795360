"""The port's own copy of the JAX package's ``observability/metrics.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Metrics facade: no-op / Prometheus / StatsD backends.

Capability parity with the reference's Metrics layer (Metrics.java:63,
PrometheusMetrics :153, StatsDMetrics :444; metric inventory in
Metric.java:29-108): a small facade the serving core calls, with pluggable
backends. The Prometheus backend is hand-rolled (text exposition 0.0.4 over
a threaded HTTP server, default port 2112 like the reference's netty
endpoint); StatsD pushes UDP. No third-party client libraries.
"""

from __future__ import annotations

import enum
import http.server
import logging
import socket
import threading
from typing import Optional, Sequence

from modelmesh_tpu_torch.utils.lockdebug import mm_lock

log = logging.getLogger(__name__)


class Metric(enum.Enum):
    """Metric inventory (name, kind, help). Mirrors the reference's set at
    the capability level: request counts/timings per stage, load/unload
    lifecycle, cache state, instance state."""

    # counters
    API_REQUEST_COUNT = ("mm_api_request_count", "counter", "external inference requests")
    API_REQUEST_FAILED = ("mm_api_request_failed", "counter", "failed external requests")
    INVOKE_LOCAL_COUNT = ("mm_invoke_local_count", "counter", "locally served invocations")
    INVOKE_FORWARD_COUNT = ("mm_invoke_forward_count", "counter", "forwarded invocations")
    LOAD_COUNT = ("mm_load_count", "counter", "model loads")
    LOAD_FAILED_COUNT = ("mm_load_failed_count", "counter", "failed model loads")
    UNLOAD_COUNT = ("mm_unload_count", "counter", "model unloads")
    EVICT_COUNT = ("mm_evict_count", "counter", "cache evictions")
    SCALE_UP_COUNT = ("mm_scale_up_count", "counter", "copy scale-ups requested")
    SCALE_DOWN_COUNT = ("mm_scale_down_count", "counter", "surplus copies dropped")
    CACHE_MISS_COUNT = ("mm_cache_miss_count", "counter", "requests that required a load")
    LOAD_TIMEOUT_COUNT = ("mm_load_timeout_count", "counter", "waits that hit the load bound")
    CANCEL_COUNT = ("mm_cancel_count", "counter", "client-cancelled requests")
    MULTI_MODEL_COUNT = ("mm_multi_model_count", "counter", "multi-model fan-out calls")
    # weight-transfer subsystem (transfer/): per-source load counters +
    # stream accounting
    LOAD_FROM_STORE_COUNT = ("mm_load_source_store_count", "counter",
                             "loads materialized from the model store")
    LOAD_FROM_PEER_COUNT = ("mm_load_source_peer_count", "counter",
                            "loads streamed from a live peer")
    LOAD_FROM_HOST_TIER_COUNT = ("mm_load_source_host_count", "counter",
                                 "loads re-warmed from the host-RAM tier")
    TRANSFER_FALLBACK_COUNT = ("mm_transfer_fallback_count", "counter",
                               "peer streams abandoned mid-transfer (fell back to store)")
    TRANSFER_TX_BYTES = ("mm_transfer_tx_bytes_total", "counter",
                         "weight bytes served to peer fetchers")
    TRANSFER_RX_BYTES = ("mm_transfer_rx_bytes_total", "counter",
                         "weight bytes received over transfer streams")
    HOST_TIER_DEMOTE_COUNT = ("mm_host_tier_demote_count", "counter",
                              "evicted copies demoted into the host tier")
    HOST_TIER_EVICT_COUNT = ("mm_host_tier_evict_count", "counter",
                             "snapshots evicted from the host tier")
    PARTIAL_SERVE_COUNT = ("mm_partial_serve_count", "counter",
                           "copies that began serving mid-transfer (PARTIAL)")
    # batched data plane (serving/batching.py): flush-reason counters
    BATCH_FLUSH_FULL_COUNT = ("mm_batch_flush_full_count", "counter",
                              "micro-batches dispatched at MM_BATCH_MAX")
    BATCH_FLUSH_WINDOW_COUNT = ("mm_batch_flush_window_count", "counter",
                                "micro-batches dispatched below max "
                                "(window expired / queue drained)")
    BATCH_FLUSH_DRAIN_COUNT = ("mm_batch_flush_drain_count", "counter",
                               "micro-batches flushed by a drain before "
                               "the copy dropped")
    # Load-aware routing + admission control (serving/route_cache.py,
    # serving/admission.py)
    ROUTE_DEMOTE_COUNT = ("mm_route_demote_count", "counter",
                          "forward failures demoted within a cached "
                          "candidate set")
    ADMISSION_SHED_COUNT = ("mm_admission_shed_count", "counter",
                            "requests shed at the admission edge "
                            "(per-class token bucket empty past the "
                            "queue window)")
    # Autoscale controller (autoscale/controller.py): decision counters —
    # one increment per recorded decision, mirrored in the flight
    # recorder's autoscale-* events.
    AUTOSCALE_UP_COUNT = ("mm_autoscale_up_count", "counter",
                          "burn-driven copy adds issued by the "
                          "autoscale controller")
    AUTOSCALE_DOWN_COUNT = ("mm_autoscale_down_count", "counter",
                            "surplus copies demoted to the host tier "
                            "by the autoscale controller")
    AUTOSCALE_PREWARM_COUNT = ("mm_autoscale_prewarm_count", "counter",
                               "host-tier snapshots staged ahead of "
                               "forecast demand")
    # Sharded execution (placement groups): plan/load decision counters,
    # mirrored in the flight recorder's sharded-group events.
    SHARDED_GROUP_PLAN_COUNT = ("mm_sharded_group_plan_count", "counter",
                                "placement groups planned (group CAS "
                                "committed; includes top-up re-plans)")
    SHARDED_SHARD_LOAD_COUNT = ("mm_sharded_shard_load_count", "counter",
                                "weight shards loaded locally (any "
                                "source: peer shard stream, sliced full "
                                "snapshot, or store)")
    # histograms (ms)
    API_REQUEST_TIME = ("mm_api_request_time_ms", "histogram", "request latency")
    # Per-stage latency decomposition: closed tracing spans export here
    # (observability/tracing.py) so p99 can be attributed to a stage
    # instead of eyeballed from totals.
    STAGE_ROUTE_SELECT = ("mm_stage_route_select_ms", "histogram",
                          "serve/load target selection time (traced requests)")
    STAGE_LOAD_WAIT = ("mm_stage_load_wait_ms", "histogram",
                       "cache-miss wait for a local load (traced requests)")
    STAGE_PEER_STREAM = ("mm_stage_peer_stream_ms", "histogram",
                         "peer weight-stream duration (traced loads)")
    STAGE_RUNTIME_INVOKE = ("mm_stage_runtime_invoke_ms", "histogram",
                            "runtime inference call time (traced requests)")
    STAGE_FORWARD_HOP = ("mm_stage_forward_hop_ms", "histogram",
                         "internal forward hop round trip (traced requests)")
    LOAD_TIME = ("mm_load_time_ms", "histogram", "model load time")
    QUEUE_DELAY = ("mm_queue_delay_ms", "histogram", "load queue delay")
    CACHE_MISS_DELAY = ("mm_cache_miss_delay_ms", "histogram", "wait for load on miss")
    PLACEMENT_SOLVE_TIME = ("mm_placement_solve_time_ms", "histogram", "global plan solve time")
    SIZING_TIME = ("mm_sizing_time_ms", "histogram", "model sizing duration")
    EVICT_AGE = ("mm_evict_age_seconds", "histogram", "entry age at eviction")
    REQUEST_BYTES = ("mm_request_payload_bytes", "histogram", "request payload size")
    RESPONSE_BYTES = ("mm_response_payload_bytes", "histogram", "response payload size")
    # batched data plane (serving/batching.py): per-dispatch shape
    BATCH_OCCUPANCY = ("mm_batch_occupancy", "histogram",
                       "requests per dispatched micro-batch")
    FUSED_GROUP_SIZE = ("mm_fused_group_size", "histogram",
                        "distinct models per fused cross-model dispatch")
    # gauges
    MODELS_LOADED = ("mm_models_loaded", "gauge", "local loaded model count")
    CACHE_USED_UNITS = ("mm_cache_used_units", "gauge", "cache units in use")
    CACHE_CAPACITY_UNITS = ("mm_cache_capacity_units", "gauge", "cache capacity units")
    PENDING_UNLOAD_UNITS = ("mm_pending_unload_units", "gauge", "units awaiting unload")
    INSTANCE_RPM = ("mm_instance_rpm", "gauge", "instance requests/min")
    LRU_AGE_SECONDS = ("mm_lru_age_seconds", "gauge", "age of oldest cache entry")
    TRANSFER_THROUGHPUT_MBPS = ("mm_transfer_throughput_mbps", "gauge",
                                "last completed transfer's MB/s")
    HOST_TIER_USED_BYTES = ("mm_host_tier_used_bytes", "gauge",
                            "host-RAM staging tier bytes in use")
    HOST_TIER_MODELS = ("mm_host_tier_models", "gauge",
                        "snapshots resident in the host tier")
    # Leader-published cluster totals (reaper cadence; reference leader
    # gauges, Metric.java cluster scope).
    CLUSTER_INSTANCES = ("mm_cluster_instances", "gauge", "live instances (leader)")
    CLUSTER_MODELS = ("mm_cluster_models", "gauge", "registered models (leader)")
    CLUSTER_COPIES = ("mm_cluster_copies", "gauge", "total model copies (leader)")
    CLUSTER_CAPACITY_UNITS = ("mm_cluster_capacity_units", "gauge", "fleet cache capacity (leader)")
    CLUSTER_USED_UNITS = ("mm_cluster_used_units", "gauge", "fleet cache usage (leader)")
    # SLO attainment engine (observability/slo.py): windowed per-model-
    # class gauges, labeled slo_class="...".
    SLO_ATTAINMENT = ("mm_slo_attainment", "gauge",
                      "fraction of windowed requests meeting the class SLO")
    SLO_BURN_RATE = ("mm_slo_burn_rate", "gauge",
                     "error-budget burn rate (1 = burning exactly at budget)")
    # Sharded execution: group-health gauges (leaderless — each instance
    # reports the groups it coordinates/participates in from its view).
    SHARDED_GROUP_COUNT = ("mm_sharded_group_count", "gauge",
                           "sharded placement groups this instance holds "
                           "a shard of")
    SHARDED_GROUP_INCOMPLETE = ("mm_sharded_group_incomplete", "gauge",
                                "of those, groups missing at least one "
                                "servable shard (not routable)")
    # Load-feedback view (serving/route_cache.LoadView): per-peer decayed
    # load score (labeled instance="...") and worst feedback staleness.
    ROUTE_LOAD_SCORE = ("mm_route_load_score", "gauge",
                        "decayed piggybacked load score per peer instance")
    ROUTE_FEEDBACK_AGE_MS = ("mm_route_feedback_age_ms", "gauge",
                             "age of the OLDEST live load-feedback slot")

    def __init__(self, metric_name: str, kind: str, help_: str):
        self.metric_name = metric_name
        self.kind = kind
        self.help = help_


DEFAULT_BUCKETS_MS = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000, 120000
)


class Metrics:
    """Facade base: every backend implements these three."""

    def inc(self, metric: Metric, value: float = 1.0, model_id: str = "") -> None:
        pass

    def observe(self, metric: Metric, value_ms: float, model_id: str = "") -> None:
        pass

    def set_gauge(self, metric: Metric, value: float, label: str = "") -> None:
        """``label`` is an optional pre-formatted extra label pair
        (e.g. 'slo_class="default"') for gauges that carry one series
        per key; empty keeps the classic unlabeled gauge."""
        pass

    def clear_gauge(self, metric: Metric, label: str = "") -> None:
        """Drop one (metric, label) gauge series — the retirement hook
        for per-entity series whose entity is gone (a churned peer's
        `mm_route_load_score`). No-op for push backends (StatsD): a
        series that stops being pushed simply ages out server-side."""
        pass

    def close(self) -> None:
        pass


class NoopMetrics(Metrics):
    pass


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = list(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class _MetricStripe:
    """One lock's worth of counter/histogram state (see PrometheusMetrics)."""

    __slots__ = ("lock", "counters", "hists")

    def __init__(self):
        self.lock = mm_lock("_MetricStripe.lock")
        self.counters: dict[tuple[str, str], float] = {}  #: guarded-by: lock
        self.hists: dict[tuple[str, str], _Histogram] = {}  #: guarded-by: lock


# Stripes for the request-path recording locks. 8 comfortably separates
# the handful of distinct metrics one request touches; power of two so
# the index is a mask.
_N_STRIPES = 8


class PrometheusMetrics(Metrics):
    """In-memory registry + /metrics HTTP endpoint (text format 0.0.4).

    ``per_model`` adds a model_id label to counters/histograms that carry
    one (cardinality opt-in, like the reference's per-model metrics flag).

    Recording is striped: each (metric, label) key hashes to one of
    ``_N_STRIPES`` independently-locked shards, so the 4+ metric updates
    a request handler makes don't all serialize on a single process-wide
    lock under concurrent handlers. A key lives in exactly one stripe, so
    the scrape-time merge in render() is collision-free and the rendered
    text is identical to the single-lock version.
    """

    def __init__(
        self,
        port: int = 0,
        per_model: bool = False,
        instance_id: str = "",
        start_server: bool = True,
    ):
        self._lock = mm_lock("PrometheusMetrics._lock")  # gauges (rare)
        self._stripes = [_MetricStripe() for _ in range(_N_STRIPES)]
        # (metric name, extra label pair or "") -> value
        self._gauges: dict[tuple[str, str], float] = {}  #: guarded-by: _lock
        self.per_model = per_model
        self.instance_id = instance_id
        self.port = 0
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        if start_server:
            self._start_http(port)

    # -- recording -----------------------------------------------------------

    def _label(self, model_id: str) -> str:
        return model_id if (self.per_model and model_id) else ""

    def inc(self, metric: Metric, value: float = 1.0, model_id: str = "") -> None:
        key = (metric.metric_name, self._label(model_id))
        stripe = self._stripes[hash(key) & (_N_STRIPES - 1)]  # analysis-ok: det-hash — order-free stripe sharding: render() merges every stripe, so WHICH stripe a key lands on is invisible
        with stripe.lock:
            stripe.counters[key] = stripe.counters.get(key, 0.0) + value

    def observe(self, metric: Metric, value_ms: float, model_id: str = "") -> None:
        key = (metric.metric_name, self._label(model_id))
        stripe = self._stripes[hash(key) & (_N_STRIPES - 1)]  # analysis-ok: det-hash — same order-free stripe sharding as inc()
        with stripe.lock:
            hist = stripe.hists.get(key)
            if hist is None:
                hist = stripe.hists[key] = _Histogram(DEFAULT_BUCKETS_MS)
            hist.observe(value_ms)

    def set_gauge(self, metric: Metric, value: float, label: str = "") -> None:
        with self._lock:
            self._gauges[(metric.metric_name, label)] = value

    def clear_gauge(self, metric: Metric, label: str = "") -> None:
        with self._lock:
            self._gauges.pop((metric.metric_name, label), None)

    # -- exposition ----------------------------------------------------------

    def _process_lines(self) -> list[str]:
        """Process-level exports, the analog of the reference's hotspot
        collectors (prometheus/hotspot/*: JVM memory, GC, FD gauges) for a
        CPython process. Read at scrape time; every read is best-effort
        (a platform missing /proc or `resource` just drops those lines)."""
        import gc
        import sys as _sys

        lines: list[str] = []
        inst = (
            '{instance="%s"}' % self.instance_id if self.instance_id else ""
        )

        def emit(name: str, kind: str, help_: str, value: float) -> None:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name}{inst} {value}")

        try:
            import resource

            ru = resource.getrusage(resource.RUSAGE_SELF)
            # ru_maxrss unit: KiB on Linux, bytes on macOS.
            scale = 1 if _sys.platform == "darwin" else 1024
            emit("mm_process_max_rss_bytes", "gauge",
                 "peak resident set size", ru.ru_maxrss * scale)
            emit("mm_process_cpu_seconds_total", "counter",
                 "user+system CPU time", ru.ru_utime + ru.ru_stime)
            try:
                with open("/proc/self/statm") as f:
                    rss_pages = int(f.read().split()[1])
                emit("mm_process_rss_bytes", "gauge",
                     "current resident set size",
                     rss_pages * resource.getpagesize())
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001
            pass
        try:
            import os as _os

            emit("mm_process_open_fds", "gauge", "open file descriptors",
                 len(_os.listdir("/proc/self/fd")))
        except Exception:  # noqa: BLE001
            pass
        try:
            emit("mm_process_threads", "gauge", "live python threads",
                 threading.active_count())
            emit("mm_python_gc_pending_gen0", "gauge",
                 "objects pending in gc gen 0", gc.get_count()[0])
            emit("mm_python_gc_collections_total", "counter",
                 "completed gc collections (all generations)",
                 sum(s["collections"] for s in gc.get_stats()))
        except Exception:  # noqa: BLE001
            pass
        return lines

    def render(self) -> str:
        by_name: dict[str, Metric] = {m.metric_name: m for m in Metric}
        lines: list[str] = self._process_lines()
        inst = (
            f'instance="{self.instance_id}"' if self.instance_id else ""
        )

        def labels(extra: str = "") -> str:
            parts = [p for p in (inst, extra) if p]
            return "{" + ",".join(parts) + "}" if parts else ""

        # HELP/TYPE must appear exactly once per metric NAME; repeating them
        # per label-set makes scrapers reject the whole page.
        seen_meta: set[str] = set()

        def meta(name: str, kind: str) -> None:
            if name in seen_meta:
                return
            seen_meta.add(name)
            m = by_name.get(name)
            if m:
                lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {kind}")

        # Merge the stripes under their own locks (a key lives in exactly
        # one stripe, so updates cannot collide); histograms are copied to
        # a consistent (counts, total, count) snapshot so a concurrent
        # observe can't tear a row mid-render. The merged output sorts
        # identically to the old single-dict registry.
        counters: dict[tuple[str, str], float] = {}
        hists: dict[tuple[str, str], tuple] = {}
        for stripe in self._stripes:
            with stripe.lock:
                counters.update(stripe.counters)
                for key, h in stripe.hists.items():
                    hists[key] = (h.buckets, list(h.counts), h.total, h.count)
        with self._lock:
            gauges = dict(self._gauges)
        for (name, model), v in sorted(counters.items()):
            meta(name, "counter")
            extra = f'model_id="{model}"' if model else ""
            lines.append(f"{name}{labels(extra)} {v}")
        for (name, extra), v in sorted(gauges.items()):
            meta(name, "gauge")
            lines.append(f"{name}{labels(extra)} {v}")
        for (name, model), (buckets, counts, total, count) in sorted(
            hists.items()
        ):
            meta(name, "histogram")
            extra = f'model_id="{model}"' if model else ""
            cum = 0
            for b, c in zip(buckets, counts):
                cum += c
                le = f'le="{b}"'
                lab = labels(", ".join(x for x in (extra, le) if x) if extra else le)
                lines.append(f"{name}_bucket{lab} {cum}")
            cum += counts[-1]
            le = 'le="+Inf"'
            lab = labels(", ".join(x for x in (extra, le) if x) if extra else le)
            lines.append(f"{name}_bucket{lab} {cum}")
            lines.append(f"{name}_sum{labels(extra)} {total}")
            lines.append(f"{name}_count{labels(extra)} {count}")
        return "\n".join(lines) + "\n"

    def _start_http(self, port: int) -> None:
        metrics = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request logging
                pass

        self._server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, name="metrics-http", daemon=True
        ).start()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()


class StatsDMetrics(Metrics):
    """Minimal UDP statsd push (counter ``|c``, gauge ``|g``, timer ``|ms``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125,
                 prefix: str = "mm"):
        self._addr = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._prefix = prefix

    def _send(self, payload: str) -> None:
        try:
            self._sock.sendto(payload.encode(), self._addr)
        except OSError:
            pass  # fire and forget

    def inc(self, metric: Metric, value: float = 1.0, model_id: str = "") -> None:
        self._send(f"{self._prefix}.{metric.metric_name}:{value}|c")

    def observe(self, metric: Metric, value_ms: float, model_id: str = "") -> None:
        self._send(f"{self._prefix}.{metric.metric_name}:{value_ms}|ms")

    def set_gauge(self, metric: Metric, value: float, label: str = "") -> None:
        # StatsD has no label concept: a labeled gauge (per-SLO-class
        # series) maps onto a name suffix — 'slo_class="llm"' becomes
        # mm.mm_slo_attainment.llm — so classes never collapse into one
        # flapping series.
        name = metric.metric_name
        if label:
            suffix = label.split("=", 1)[-1].strip('"').replace(".", "_")
            if suffix:
                name = f"{name}.{suffix}"
        self._send(f"{self._prefix}.{name}:{value}|g")

    def close(self) -> None:
        self._sock.close()
