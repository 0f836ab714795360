"""The port's own copy of the JAX package's ``observability/slo.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

SLO attainment engine: declarative per-model-class objectives.

The routing/overload work (RouteBalance, overload-penalty shedding —
PAPERS.md) and the million-user macro-bench (ROADMAP item 3) both need
the same primitive: "is this model class meeting its latency/availability
objective RIGHT NOW, and how fast is it burning budget?" — computed from
request completions, not eyeballed from dashboards. This module is that
primitive; ``sim/invariants.slo_attained`` machine-checks it in scenarios.

Spec grammar (``MM_SLO_SPEC``):

    class:obj[,obj...][;class:obj...]
    obj := p50<Nms | p95<Nms | p99<Nms | availability>F

e.g. ``default:p99<250ms,availability>0.999;llm:p99<2000ms``. A class is
the model's ``model_type``; ``default`` catches everything without an
exact class entry. Malformed specs raise at parse time — a silently
inert SLO is the failure mode this registry-style strictness prevents.

Mechanics: per resolved class, a sliding window (``MM_SLO_WINDOW_MS``,
bounded count) of ``(ts_ms, latency_ms, ok)`` samples, appended from the
request path under a tiny per-class lock. ``attainment()`` computes the
empirical percentiles + availability against the class objectives;
``export()`` publishes ``mm_slo_attainment`` (good-event fraction) and
``mm_slo_burn_rate`` gauges, labeled ``slo_class="..."``. Export is
amortized from ``record`` (every ``EXPORT_EVERY`` samples) so the hot
path never computes a percentile.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Optional

from modelmesh_tpu_torch.utils.clock import get_clock

EXPORT_EVERY = 512

_OBJ_RE = re.compile(
    r"^(?:(p50|p95|p99)<(\d+(?:\.\d+)?)ms|availability>(0?\.\d+|1(?:\.0+)?))$"
)


@dataclasses.dataclass(frozen=True)
class SloObjectives:
    """One model class's objectives; None = not constrained."""

    model_class: str
    p50_ms: Optional[float] = None
    p95_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    availability: Optional[float] = None

    @property
    def latency_bound_ms(self) -> Optional[float]:
        """The per-request 'good event' latency threshold (tightest
        tail bound wins: p99 if set, else p95, else p50)."""
        for b in (self.p99_ms, self.p95_ms, self.p50_ms):
            if b is not None:
                return b
        return None

    @property
    def good_target(self) -> float:
        """Implied good-event fraction target: the availability target
        combined with the fraction the tail percentile promises."""
        avail = self.availability if self.availability is not None else 1.0
        if self.p99_ms is not None:
            return avail * 0.99
        if self.p95_ms is not None:
            return avail * 0.95
        if self.p50_ms is not None:
            return avail * 0.50
        return avail


def parse_slo_spec(spec: str) -> dict[str, SloObjectives]:
    """Parse the MM_SLO_SPEC grammar; raises ValueError on junk."""
    out: dict[str, SloObjectives] = {}
    for clause in (c.strip() for c in spec.split(";") if c.strip()):
        cls, sep, body = clause.partition(":")
        if not sep or not cls.strip() or not body.strip():
            raise ValueError(f"SLO clause {clause!r} is not class:objectives")
        cls = cls.strip()
        fields: dict = {}
        for obj in (o.strip() for o in body.split(",") if o.strip()):
            m = _OBJ_RE.match(obj)
            if m is None:
                raise ValueError(
                    f"SLO objective {obj!r} (class {cls}) — expected "
                    "p50<Nms / p95<Nms / p99<Nms / availability>F"
                )
            if m.group(1):
                fields[f"{m.group(1)}_ms"] = float(m.group(2))
            else:
                fields["availability"] = float(m.group(3))
        if cls in out:
            raise ValueError(f"duplicate SLO class {cls!r}")
        out[cls] = SloObjectives(model_class=cls, **fields)
    if not out:
        raise ValueError(f"empty SLO spec {spec!r}")
    return out


def _percentile(sorted_vals: list[float], q: float) -> float:
    # Nearest-rank on the sorted window (the SRE convention: small
    # windows report the max for tail quantiles rather than optimistic
    # interpolation).
    n = len(sorted_vals)
    idx = min(n - 1, max(0, int(q * n + 0.999999) - 1))
    return sorted_vals[idx]


@dataclasses.dataclass
class SloSnapshot:
    model_class: str
    requests: int
    availability: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    good_fraction: float
    attained: bool
    burn_rate: float
    violations: list[str]


class _Window:
    __slots__ = ("lock", "samples")

    def __init__(self):
        self.lock = threading.Lock()
        # (ts_ms, latency_ms, ok), append-ordered
        self.samples: list[tuple[int, float, bool]] = []  #: guarded-by: lock


class SloTracker:
    """Windowed attainment tracker fed by request completions."""

    MAX_SAMPLES = 2048  # per class, beside the time window

    def __init__(self, spec: Optional[str] = None, metrics=None,
                 window_ms: Optional[int] = None):
        from modelmesh_tpu_torch.utils import envs

        if spec is None:
            spec = envs.get("MM_SLO_SPEC")
        if window_ms is None:
            window_ms = envs.get_int("MM_SLO_WINDOW_MS")
        self.spec = spec
        self.objectives = parse_slo_spec(spec)
        self.metrics = metrics
        self.window_ms = int(window_ms)
        self._lock = threading.Lock()
        self._windows: dict[str, _Window] = {}  #: guarded-by: _lock [rebind]
        self._since_export = 0

    # -- recording (request hot path) --------------------------------------

    def resolve_class(self, model_class: str) -> str:
        """Exact class entry, else 'default', else the first class (a
        spec with no default still tracks everything somewhere)."""
        if model_class in self.objectives:
            return model_class
        if "default" in self.objectives:
            return "default"
        return next(iter(self.objectives))

    def _window(self, cls: str) -> _Window:
        w = self._windows.get(cls)  # GIL-atomic read; entries never die
        if w is None:
            with self._lock:
                w = self._windows.setdefault(cls, _Window())
        return w

    def record(self, model_class: str, latency_ms: float, ok: bool) -> None:
        cls = self.resolve_class(model_class)
        w = self._window(cls)
        now = get_clock().now_ms()
        cutoff = now - self.window_ms
        with w.lock:
            s = w.samples
            s.append((now, latency_ms, ok))
            # Prune from the head only when stale/oversized — amortized O(1).
            if len(s) > self.MAX_SAMPLES or s[0][0] < cutoff:
                keep = len(s) - self.MAX_SAMPLES
                i = 0
                for i, (ts, _, _) in enumerate(s):
                    if ts >= cutoff and i >= keep:
                        break
                if i:
                    del s[:i]
        if self.metrics is None:
            return
        self._since_export += 1  # approximate under races; cadence only
        if self._since_export >= EXPORT_EVERY:
            self._since_export = 0
            self.export()

    # -- evaluation ---------------------------------------------------------

    def attainment(self, model_class: str = "default") -> SloSnapshot:
        cls = self.resolve_class(model_class)
        obj = self.objectives[cls]
        w = self._window(cls)
        now = get_clock().now_ms()
        cutoff = now - self.window_ms
        with w.lock:
            window = [s for s in w.samples if s[0] >= cutoff]
        n = len(window)
        if n == 0:
            return SloSnapshot(cls, 0, 1.0, 0.0, 0.0, 0.0, 1.0, True, 0.0, [])
        lat = sorted(v for _, v, _ in window)
        ok_n = sum(1 for _, _, ok in window if ok)
        avail = ok_n / n
        p50, p95, p99 = (
            _percentile(lat, 0.50), _percentile(lat, 0.95),
            _percentile(lat, 0.99),
        )
        bound = obj.latency_bound_ms
        good = sum(
            1 for _, v, ok in window
            if ok and (bound is None or v <= bound)
        ) / n
        violations: list[str] = []
        for name, got, want in (
            ("p50", p50, obj.p50_ms), ("p95", p95, obj.p95_ms),
            ("p99", p99, obj.p99_ms),
        ):
            if want is not None and got > want:
                violations.append(f"{cls}: {name}={got:.1f}ms > {want:g}ms")
        if obj.availability is not None and avail < obj.availability:
            violations.append(
                f"{cls}: availability={avail:.5f} < {obj.availability:g}"
            )
        target = obj.good_target
        budget = max(1e-9, 1.0 - target)
        burn = (1.0 - good) / budget
        return SloSnapshot(
            model_class=cls, requests=n, availability=avail,
            p50_ms=p50, p95_ms=p95, p99_ms=p99, good_fraction=good,
            attained=not violations, burn_rate=burn, violations=violations,
        )

    def classes(self) -> list[str]:
        """Classes that have recorded at least one completion."""
        return list(self._windows)

    def export(self) -> None:
        """Publish per-class attainment/burn gauges (amortized from
        ``record``; call directly for a fresh scrape)."""
        if self.metrics is None:
            return
        from modelmesh_tpu_torch.observability.metrics import Metric as MX

        for cls in self.classes():
            snap = self.attainment(cls)
            label = f'slo_class="{cls}"'
            self.metrics.set_gauge(MX.SLO_ATTAINMENT, round(snap.good_fraction, 6),
                                   label=label)
            self.metrics.set_gauge(MX.SLO_BURN_RATE, round(snap.burn_rate, 4),
                                   label=label)
