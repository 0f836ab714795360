"""The port's own copy of the JAX package's ``observability/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Observability: metrics facade, payload processors, clock-aware
tracing, SLO attainment, and the flight recorder (docs/observability.md)."""

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
from modelmesh_tpu_torch.observability.payloads import (
    AsyncPayloadProcessor,
    CompositePayloadProcessor,
    LoggingPayloadProcessor,
    MatchingPayloadProcessor,
    Payload,
    PayloadProcessor,
    RemotePayloadProcessor,
    build_processor,
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
    "AsyncPayloadProcessor",
    "CompositePayloadProcessor",
    "LoggingPayloadProcessor",
    "MatchingPayloadProcessor",
    "Payload",
    "PayloadProcessor",
    "RemotePayloadProcessor",
    "build_processor",
]
