"""The port's own copy of the JAX package's ``observability/tracing.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Clock-aware distributed tracing — the "real tracing" the reference lacks.

The reference makes do with thread renaming, MDC headers, and stage metrics
(SURVEY §5.1, explicitly flagged "give the new framework real tracing").
Here every traced request gets a trace: a trace id minted at the API
surface (or adopted from an incoming ``mm-trace-id`` header), propagated to
peers on EVERY mesh-internal hop — Forward, FetchWeights, EnsureLoaded,
drain pre-copies — with named spans recorded around each stage (route
select, cache-miss load wait, peer weight stream, runtime call, forward).
No external collector dependency (the image carries none): finished traces
land in a bounded in-memory ring, retrievable through the ``***TRACES***``
diagnostic id on GetModelStatus — the same secret-id channel as the state
dump — and assembled cross-instance by the sim's TraceCollector.

Time goes through ``utils/clock`` (the process-wide injectable seam):
absolute span timestamps are ``clock.now_ms()`` and durations come from
``clock.monotonic()`` — so a trace recorded under the simulation's
``VirtualClock`` carries VIRTUAL timestamps/durations (a 2 s virtual load
shows as 2000 ms even though microseconds of wall time passed), while
production pays one attribute hop into ``time``.

Spans form a tree: every span carries ``span_id`` + ``parent_id`` and an
``instance`` attribute; the trace context is a contextvar holding the
open-span stack, and ``outgoing_headers`` attaches both the trace id and
the CURRENT span id, so the receiving hop's root record parents itself
under the sender's forward span — one request, one tree, many instances.

Cost control: the hot path is ~6 µs/request (PR-2), so always-on tracing
would be a >50% tax. Minted roots are head-sampled 1-in-``sample_n``
(``MM_TRACE_SAMPLE``); ADOPTED trace ids always record, so a sampled
request is traced end-to-end across every hop it touches. A disabled or
not-sampled trace leaves no context: ``span`` is a no-op and no headers
are attached.

The placement refresh has span records of its own (``RefreshSpans``, at
the end of this file): the leader's refresh is background work that no
request trace covers, and its spans go where the solve's device work is
measured, into ``plan.stats`` and onto a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from typing import Optional

from modelmesh_tpu_torch.utils.clock import get_clock

TRACE_HEADER = "mm-trace-id"
# Sender's open span at hop time — the receiving hop's parent link.
SPAN_HEADER = "mm-parent-span"
TRACE_DUMP_ID = "***TRACES***"

DEFAULT_CAPACITY = 256
DEFAULT_SAMPLE_N = 1

_current: contextvars.ContextVar[Optional["_Trace"]] = contextvars.ContextVar(
    "mm_trace", default=None
)


class _Trace:
    __slots__ = ("trace_id", "spans", "start_ms", "t0", "stack")

    def __init__(self, trace_id: str, start_ms: int, t0: float):
        self.trace_id = trace_id
        self.spans: list[dict] = []
        self.start_ms = start_ms     # absolute (virtual in the sim)
        self.t0 = t0                 # clock.monotonic() anchor
        self.stack: list[str] = []   # open span ids, root first


# Span name -> stage-latency histogram. Populated lazily to avoid a
# metrics import on module load (and an import cycle via serving).
_STAGE_METRICS: dict[str, object] = {}


def _stage_metric(name: str):
    if not _STAGE_METRICS:
        from modelmesh_tpu_torch.observability.metrics import Metric as MX

        _STAGE_METRICS.update({
            "route-select": MX.STAGE_ROUTE_SELECT,
            "load-wait": MX.STAGE_LOAD_WAIT,
            "peer-stream": MX.STAGE_PEER_STREAM,
            "runtime-call": MX.STAGE_RUNTIME_INVOKE,
            "forward": MX.STAGE_FORWARD_HOP,
        })
    return _STAGE_METRICS.get(name)


class Tracer:
    """Per-instance trace collector (bounded ring of finished traces).

    ``metrics`` (any observability.metrics.Metrics) receives per-stage
    millisecond histograms as spans close — the stage-latency
    decomposition the macro-bench asserts against. ``sample_n`` > 1
    head-samples minted roots (adopted ids always record)."""

    def __init__(self, instance_id: str = "", capacity: Optional[int] = None,
                 metrics=None, sample_n: Optional[int] = None):
        if capacity is None:
            from modelmesh_tpu_torch.utils import envs

            capacity = envs.get_int("MM_TRACE_CAPACITY")
        self.instance_id = instance_id
        self.capacity = max(int(capacity), 1)
        self.metrics = metrics
        self.sample_n = max(int(sample_n if sample_n is not None else
                                DEFAULT_SAMPLE_N), 1)
        self.enabled = True
        self._lock = threading.Lock()
        self._ring: list[dict] = []  #: guarded-by: _lock
        # Unique-enough ids without uuid4-per-span: a per-tracer salt plus
        # a counter (itertools.count.__next__ is GIL-atomic).
        self._salt = uuid.uuid4().hex[:6]  # analysis-ok: det-entropy — once-per-tracer process-identity salt; sim assertions key on span STRUCTURE and propagated parent links, never on id values
        self._span_seq = itertools.count(1)
        self._sample_seq = itertools.count(1)

    def _span_id(self) -> str:
        return f"{self.instance_id or 't'}.{self._salt}.{next(self._span_seq):x}"

    # -- request lifecycle --------------------------------------------------

    def trace(self, trace_id: str = "", model_id: str = "", method: str = "",
              parent_span: str = "") -> "_TraceCM":
        """Open a trace for one request; finishes into the ring.

        An explicit ``trace_id`` (adopted from an upstream hop) always
        records; minted roots are sampled 1-in-``sample_n``. The context
        manager yields the trace id, or "" when this request is
        untraced (disabled / sampled out) — spans inside are then
        no-ops. Class-based CM: this wraps EVERY external request, so
        the untraced entry/exit must cost a couple of attribute reads,
        not a generator frame (and minted ids come from the tracer's
        salt+counter — uuid4-per-request is microseconds of entropy I/O
        on some kernels)."""
        return _TraceCM(self, trace_id, model_id, method, parent_span)

    def span(self, name: str, **attrs) -> "_Span":
        """Record a named stage; no-op when no trace is open (background
        work stays untraced rather than allocating orphan spans). The
        context manager yields a mutable attr dict — entries added
        inside the block land on the finished span (e.g. chunk counts
        known only at stream end). Class-based CM, not a generator: this
        sits on the request hot path where untraced entry/exit must cost
        one contextvar read, not a generator frame."""
        return _Span(self, name, attrs)

    def maybe_mint(self) -> str:
        """Sampling-aware root-id mint for callers that must share ONE
        trace id across several trace() opens (multi-model fan-out:
        every member records under the request's id). Returns "" when
        this root is sampled out — the caller then skips tracing
        entirely, because handing "" to N members would make each mint
        (and sample) its own fragment."""
        if not self.enabled:
            return ""
        n = self.sample_n
        if n > 1 and next(self._sample_seq) % n != 1:
            return ""
        return f"{self._salt}{next(self._span_seq):08x}"

    # -- introspection ------------------------------------------------------

    @staticmethod
    def current_trace_id() -> str:
        t = _current.get()
        return t.trace_id if t is not None else ""

    @staticmethod
    def current_span_id() -> str:
        t = _current.get()
        return t.stack[-1] if t is not None and t.stack else ""

    def recent(self, n: int = 50) -> list[dict]:
        with self._lock:
            return list(self._ring[-n:])


class _TraceCM:
    """One request's trace context (see Tracer.trace)."""

    __slots__ = ("tracer", "trace_id", "model_id", "method", "parent_span",
                 "t", "root_id", "token")

    def __init__(self, tracer: Tracer, trace_id: str, model_id: str,
                 method: str, parent_span: str):
        self.tracer = tracer
        self.trace_id = trace_id
        self.model_id = model_id
        self.method = method
        self.parent_span = parent_span
        self.t: Optional[_Trace] = None

    def __enter__(self) -> str:
        tracer = self.tracer
        if not tracer.enabled:
            return self.trace_id
        trace_id = self.trace_id
        if not trace_id:
            n = tracer.sample_n
            if n > 1 and next(tracer._sample_seq) % n != 1:
                return ""
            trace_id = f"{tracer._salt}{next(tracer._span_seq):08x}"
        clock = get_clock()
        t = _Trace(trace_id, clock.now_ms(), clock.monotonic())
        self.t = t
        self.root_id = tracer._span_id()
        t.stack.append(self.root_id)
        self.token = _current.set(t)
        return trace_id

    def __exit__(self, exc_type, exc, tb) -> bool:
        t = self.t
        if t is None:
            return False
        _current.reset(self.token)
        tracer = self.tracer
        record = {
            "trace_id": t.trace_id,
            "span_id": self.root_id,
            "parent_id": self.parent_span,
            "instance": tracer.instance_id,
            "model_id": self.model_id,
            "method": self.method,
            "start_ms": t.start_ms,
            "duration_ms": round((get_clock().monotonic() - t.t0) * 1e3, 3),
            "spans": t.spans,
        }
        if exc_type is not None:
            record["error"] = exc_type.__name__
        with tracer._lock:
            ring = tracer._ring
            ring.append(record)
            if len(ring) > tracer.capacity:
                del ring[: len(ring) - tracer.capacity]
        return False


class _Span:
    """One stage measurement (see Tracer.span)."""

    __slots__ = ("tracer", "name", "attrs", "t", "sid", "start_ms", "t0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t: Optional[_Trace] = None

    def __enter__(self) -> dict:
        t = _current.get()
        self.t = t
        if t is None:
            return self.attrs
        clock = get_clock()
        self.sid = self.tracer._span_id()
        t.stack.append(self.sid)
        self.start_ms = clock.now_ms()
        self.t0 = clock.monotonic()
        return self.attrs

    def __exit__(self, exc_type, exc, tb) -> bool:
        t = self.t
        if t is None:
            return False
        t.stack.pop()
        clock = get_clock()
        dur_ms = round((clock.monotonic() - self.t0) * 1e3, 3)
        span = {
            "name": self.name,
            "span_id": self.sid,
            "parent_id": t.stack[-1] if t.stack else "",
            "instance": self.tracer.instance_id,
            "start_ms": self.start_ms,
            "at_ms": round(self.start_ms - t.start_ms, 3),
            "duration_ms": dur_ms,
        }
        if exc_type is not None:
            span["error"] = exc_type.__name__
        if self.attrs:
            span.update(self.attrs)
        t.spans.append(span)
        tracer = self.tracer
        if tracer.metrics is not None:
            stage = _stage_metric(self.name)
            if stage is not None:
                tracer.metrics.observe(stage, dur_ms)
        return False


def incoming_trace_id(headers) -> str:
    """Extract the propagated trace id from a header list without
    materializing a dict on the hot path."""
    return next((v for k, v in headers if k == TRACE_HEADER), "")


def incoming_parent_span(headers) -> str:
    """The sender-side span the receiving hop should parent under."""
    return next((v for k, v in headers if k == SPAN_HEADER), "")


def outgoing_headers(headers: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Headers for a peer/runtime hop with the trace context attached
    (once): the trace id plus the CURRENT span id as the parent link."""
    t = _current.get()
    if t is None or any(k == TRACE_HEADER for k, _ in headers):
        return headers
    out = headers + [(TRACE_HEADER, t.trace_id)]
    if t.stack:
        out.append((SPAN_HEADER, t.stack[-1]))
    return out


# -- placement refresh spans -------------------------------------------------

REFRESH_SPAN = "mm.refresh"

# The device layers a solve marks on its stream, in the order it runs
# them: each ``<layer>_device_ms`` runs from the previous mark (the
# dispatch's start for the first) to the layer's own.
DEVICE_LAYERS = ("cost", "transport", "auction")

_refresh: contextvars.ContextVar[Optional["RefreshSpans"]] = (
    contextvars.ContextVar("mm_refresh_spans", default=None)
)


class RefreshSpans:
    """One placement refresh's spans, marks and counts, resolved into its
    plan's ``stats`` after the solve's readback wait (``resolve``).

    The refresh (``TorchPlacementStrategy.refresh``, the pipelined
    refresher's ``submit``, ``solve_plan``) makes the record current
    (``current()``) while its snapshot and dispatch run; ``PendingSolve``
    carries it to ``finalize_plan``. A span (``refresh_span`` on the
    current record, ``record_span`` on a given one):

    - adds its host time (``time.perf_counter``) to ``host_ms[name]``;
    - only while a ``torch.profiler`` records (its flag, read once a
      span), opens a ``record_function`` range ``mm.refresh.<name>``, on
      the clock of the device operations in the trace;
    - with ``mark=True``, ends a device layer (``mark``).

    Marks are taken on the solve's device (``begin_solve``): a timing
    ``torch.cuda.Event`` on the current stream of a CUDA device, read
    with ``elapsed_time`` only once the readback's own event has
    completed (no host sync); the host clock on the CPU, where the solve
    is synchronous and a layer's interval is its host interval; none on
    a mesh (``device=None``)."""

    __slots__ = ("host_ms", "counts", "marks", "device", "gate_wait_ms",
                 "_profiler")

    def __init__(self):
        from torch.autograd import profiler

        self._profiler = profiler
        self.host_ms: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.marks: dict[str, object] = {}
        self.device = None
        # Host time blocked at the dispatch's gates (``device.item``).
        self.gate_wait_ms: Optional[float] = None

    def current(self) -> "_CurrentRefresh":
        """Context manager: this record is current (``refresh_span`` and
        ``refresh_count`` reach it), under a root range ``mm.refresh``
        while a profiler records."""
        return _CurrentRefresh(self)

    def begin_solve(self, device) -> None:
        """A dispatch starts on ``device`` (None: a mesh, no device
        marks). An earlier dispatch's marks go: a refresh whose
        incremental re-solve fell back to a full one reports the last."""
        import torch

        self.device = None if device is None else torch.device(device)
        self.marks = {}
        self.mark("start")

    def mark(self, name: str, event=None) -> None:
        """Note where ``name`` ends on the solve's stream: ``event`` (a
        timing CUDA event already recorded there) or a new one."""
        dev = self.device
        if dev is None:
            return
        if dev.type != "cuda":
            self.marks[name] = time.perf_counter()
            return
        if event is None:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(dev))
        self.marks[name] = event

    def resolve(self, stats: dict) -> None:
        """Write the record into ``stats``: ``rpm_read_ms``, the counts,
        ``gate_wait_ms``, and from the marks ``<layer>_device_ms`` and
        ``solve_device_ms`` (dispatch start to the readback's copy). Call
        after the readback wait: every mark has completed by then."""
        if "rpm" in self.host_ms:
            stats["rpm_read_ms"] = self.host_ms["rpm"]
        stats.update(self.counts)
        if self.gate_wait_ms is not None:
            stats["gate_wait_ms"] = self.gate_wait_ms
        marks = self.marks
        start = marks.get("start")
        if start is None or "done" not in marks:
            return
        cuda = self.device.type == "cuda"

        def since(mark):
            if cuda:
                return start.elapsed_time(mark)
            return (mark - start) * 1e3

        last = 0.0
        for layer in DEVICE_LAYERS:
            if layer in marks:
                at = since(marks[layer])
                stats[f"{layer}_device_ms"] = at - last
                last = at
        stats["solve_device_ms"] = since(marks["done"])


class _CurrentRefresh:
    __slots__ = ("rec", "token", "range")

    def __init__(self, rec: RefreshSpans):
        self.rec = rec

    def __enter__(self) -> RefreshSpans:
        rec = self.rec
        self.token = _refresh.set(rec)
        self.range = None
        if rec._profiler._is_profiler_enabled:
            self.range = rec._profiler.record_function(REFRESH_SPAN)
            self.range.__enter__()
        return rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        _refresh.reset(self.token)
        return False


class _RefreshSpan:
    """One span of a refresh (see ``RefreshSpans``)."""

    __slots__ = ("rec", "name", "mark", "range", "t0")

    def __init__(self, rec: RefreshSpans, name: str, mark: bool):
        self.rec = rec
        self.name = name
        self.mark = mark

    def __enter__(self) -> None:
        rec = self.rec
        self.range = None
        if rec._profiler._is_profiler_enabled:
            self.range = rec._profiler.record_function(
                f"{REFRESH_SPAN}.{self.name}")
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.rec
        ms = (time.perf_counter() - self.t0) * 1e3
        rec.host_ms[self.name] = rec.host_ms.get(self.name, 0.0) + ms
        if self.mark and exc_type is None:
            rec.mark(self.name)
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        return False


_NO_SPAN = contextlib.nullcontext()


def current_refresh() -> Optional[RefreshSpans]:
    return _refresh.get()


def record_span(rec: Optional[RefreshSpans], name: str, mark: bool = False):
    """A span of ``rec``; a no-op without one."""
    if rec is None:
        return _NO_SPAN
    return _RefreshSpan(rec, name, mark)


def refresh_span(name: str, mark: bool = False):
    """A span of the current refresh; with none current (the ops called
    directly) one contextvar read and nothing more."""
    return record_span(_refresh.get(), name, mark)


def refresh_count(name: str, n: int) -> None:
    """Add ``n`` to the current refresh's count ``name`` (none current:
    nothing)."""
    rec = _refresh.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)
