"""Observability: metrics facade, clock-aware tracing, SLO attainment and
the flight recorder; the port's copy of the JAX package's
``observability/`` (the payload processors come with the API slice)."""

from modelmesh_tpu_torch.observability.flightrec import (
    FLIGHTREC_DUMP_ID,
    FlightRecorder,
)
from modelmesh_tpu_torch.observability.slo import (
    SloObjectives,
    SloTracker,
    parse_slo_spec,
)
from modelmesh_tpu_torch.observability.tracing import (
    TRACE_DUMP_ID,
    Tracer,
    incoming_trace_id,
    outgoing_headers,
)
from modelmesh_tpu_torch.observability.metrics import (
    Metric,
    Metrics,
    NoopMetrics,
    PrometheusMetrics,
    StatsDMetrics,
)

__all__ = [
    "FLIGHTREC_DUMP_ID",
    "FlightRecorder",
    "SloObjectives",
    "SloTracker",
    "TRACE_DUMP_ID",
    "Tracer",
    "incoming_trace_id",
    "outgoing_headers",
    "parse_slo_spec",
    "Metric",
    "Metrics",
    "NoopMetrics",
    "PrometheusMetrics",
    "StatsDMetrics",
]
