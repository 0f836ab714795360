"""The port's own copy of the JAX package's ``sim/engine.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Event-driven fleet simulation core: a single-threaded virtual-time
event heap replacing thread-per-pod at fleet scale.

The scripted harness (sim/harness.py + sim/scenario.py) runs every pod
as a full ``ModelMeshInstance`` on real threads — perfect fidelity,
but 3–4 pods is the practical ceiling: every virtual step costs a wall
yield so product threads run, and every pod carries its full task
stack. Fleet-scale questions (does burn-rate autoscaling hold p99
through a 1000-pod diurnal day? does admission starve the wrong class
when routing feedback lags?) need orders of magnitude more pods and
requests than threads can simulate.

This module is the fast path: ``EventLoop`` owns a ``VirtualClock``
and a heap of (due_ms, seq) events; ``ModeledInstance`` is a
lightweight state machine standing in for a pod (copy states with
load/unload latencies, bytes accounting with LRU eviction, a host
snapshot tier, an mm-load-style load_ewma estimate, per-class burn
windows); ``ModeledFleet`` reproduces the control planes on top —
power-of-d routing with load feedback, demand loading, legacy
rate-task/janitor scaling or burn-rate authority with forecaster
pre-warming (the REAL ``autoscale.forecast.DemandForecaster``, not a
model of it), and modeled per-class admission throttles. Every
constant is calibrated against the real stack's defaults (see
``FleetConfig`` field comments; docs/testing.md documents the fidelity
contract and tests/test_sim_engine.py pins modeled-vs-full parity).

Two drive modes share the loop:

* pure modeled (``step_ms=0``): the clock jumps event-to-event —
  nothing else waits on it, so a virtual day is just the cost of its
  events (the macro bench's hot loop; see ``EventLoop.run``).
* bridged (``step_ms>0``): bounded advances with a wall yield per
  step, exactly the historical ``ScenarioRunner`` drive loop — full-
  fidelity ``ModelMeshInstance`` threads woken by the same
  ``VirtualClock`` run between steps. ScenarioRunner now schedules its
  scripted events on an ``EventLoop`` and drives it in this mode, so
  existing scenarios run unchanged while sharing one core.

Determinism: the heap orders by (due_ms, seq); seq is assigned in
schedule order, and all scheduling is single-threaded, so a run is a
pure function of (config, seed). No wall time, no unseeded draws —
the macro replay gate (tests/test_bench_macro.py) asserts bit-for-bit
digest equality across runs.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time as _wall
import zlib
from collections import deque
from typing import Callable, Optional

from modelmesh_tpu_torch.autoscale.forecast import DemandForecaster
from modelmesh_tpu_torch.observability.slo import SloObjectives, parse_slo_spec
from modelmesh_tpu_torch.utils import clock as _clock

__all__ = [
    "EventLoop",
    "FleetConfig",
    "ModeledInstance",
    "ModeledFleet",
    "RouteResult",
]


class _Ev:
    """One scheduled callback. ``args`` is a plain tuple (re-used, never
    copied) and cancellation is a flag flip, so the hot loop allocates
    nothing beyond the heap entry itself."""

    __slots__ = ("due_ms", "seq", "fn", "args", "cancelled")

    def __init__(self, due_ms: int, seq: int, fn: Callable, args: tuple):
        self.due_ms = due_ms
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False

    def __lt__(self, other: "_Ev") -> bool:
        return (self.due_ms, self.seq) < (other.due_ms, other.seq)


class EventLoop:
    """Virtual-time discrete-event loop over an injectable clock.

    Single-threaded: ``schedule_*`` and ``run`` must be called from the
    driving thread. Handlers read ``loop.now_ms`` (== clock.now_ms())
    instead of touching the clock — one seam, one reader.
    """

    def __init__(self, clock: Optional[_clock.VirtualClock] = None):
        self.clock = clock if clock is not None else _clock.VirtualClock()
        self._heap: list[_Ev] = []
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self._seq = 0
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self.now_ms: int = self.clock.now_ms()
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self.events_processed = 0

    # -- scheduling --------------------------------------------------------

    def schedule_at(self, due_ms: int, fn: Callable, *args) -> _Ev:
        ev = _Ev(int(due_ms), self._seq, fn, args)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def schedule_in(self, delay_ms: float, fn: Callable, *args) -> _Ev:
        return self.schedule_at(self.now_ms + int(delay_ms), fn, *args)

    @staticmethod
    def cancel(ev: _Ev) -> None:
        ev.cancelled = True

    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)

    # -- driving -----------------------------------------------------------

    def run(
        self,
        until_ms: int,
        step_ms: int = 0,
        yield_s: float = 0.0,
    ) -> None:
        """Advance virtual time to ``until_ms``, firing every event due
        on the way (due <= until_ms fires; the clock lands exactly on
        ``until_ms``).

        ``step_ms=0``: pure modeled mode — the clock jumps straight to
        each event's due time and lands exactly on ``until_ms``.
        ``step_ms>0``: bridged mode — every advance is a FULL step
        followed by a real ``yield_s`` sleep so threads blocked on this
        VirtualClock (full-fidelity pods' timers, keepalives, watchers)
        get to run. Bridged semantics are the historical ScenarioRunner
        drive loop, bit-for-bit: events fire when a step lands at/past
        their due time (observed timestamps quantize onto the step
        grid) and the clock overshoots ``until_ms`` by up to one step.
        """
        heap = self._heap
        clock = self.clock
        until_ms = int(until_ms)
        while True:
            # Drop cancelled heads, then fire everything already due.
            # (Re-reading the clock per fire keeps now_ms honest when a
            # handler advances the clock itself — scenario clock_jump.)
            while heap and (heap[0].cancelled or heap[0].due_ms <= self.now_ms):
                ev = heapq.heappop(heap)
                if ev.cancelled:
                    continue
                if ev.due_ms > until_ms:
                    heapq.heappush(heap, ev)
                    break
                self.events_processed += 1
                ev.fn(*ev.args)
                self.now_ms = clock.now_ms()
            now = self.now_ms
            if now >= until_ms and not (
                heap and not heap[0].cancelled and heap[0].due_ms <= until_ms
            ):
                break
            if step_ms > 0:
                delta = step_ms
            else:
                next_due = until_ms
                if heap and not heap[0].cancelled and heap[0].due_ms < next_due:
                    next_due = heap[0].due_ms
                delta = max(next_due - now, 0)
            if delta > 0:
                clock.advance(delta)
                self.now_ms = clock.now_ms()
            if step_ms > 0 and yield_s > 0:
                _wall.sleep(yield_s)  #: wall-clock: yields the advancing thread so bridged full-fidelity threads run between virtual steps

    def drain(self) -> None:
        """Fire every remaining event immediately at the current virtual
        time (ScenarioRunner's 'leftover events past the horizon fire
        anyway' semantics)."""
        heap = self._heap
        while heap:
            ev = heapq.heappop(heap)
            if not ev.cancelled:
                self.events_processed += 1
                ev.fn(*ev.args)


# ---------------------------------------------------------------------------
# Modeled fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Calibration constants for the modeled fleet. Every default is
    pinned to the real stack's default (source in the field comment);
    tests/test_sim_engine.py::test_parity_* gate drift."""

    # -- data plane (SimCluster congestion model, sim/harness.py) ----------
    service_base_ms: float = 2.0
    service_congestion_ms: float = 1.0
    service_congestion_cap: int = 64
    # -- copy lifecycle (SimLoader defaults + PR-6/PR-15 measurements) -----
    load_delay_ms: float = 50.0       # SimLoader load_delay_ms default
    unload_delay_ms: float = 5.0      # SimLoader unload_delay_ms default
    peer_stream_frac: float = 0.2     # peer weight stream ≈ 0.2x store load
    host_rewarm_frac: float = 0.11    # host-tier re-warm 9ms vs 82ms cold
    default_size_bytes: int = 1       # SimLoader crc32 sizing base
    capacity_bytes: int = 64          # modeled accelerator cache units
    host_budget_bytes: int = 128      # modeled host snapshot tier
    load_timeout_ms: int = 30_000     # cold wait bound before a request fails
    # -- routing (routing defaults: MM_ROUTE_D, mm-load feedback) ----------
    route_d: int = 2                  # power-of-d candidate set size
    # -- authority (serving/tasks.py + autoscale/controller.py defaults) ---
    authority: str = "legacy"         # "legacy" | "burn" | "off"
    scale_up_rpm: float = 2000.0      # DEFAULT_SCALE_UP_RPM per copy
    max_copies: int = 8               # DEFAULT_MAX_COPIES
    rate_interval_s: float = 10.0     # TaskConfig.rate_interval_s
    janitor_interval_s: float = 360.0  # TaskConfig.janitor_interval_s
    second_copy_max_age_s: float = 600.0  # janitor surplus-copy age cap
    autoscale_interval_s: float = 10.0    # AutoscaleConfig.interval_s
    burn_up: float = 0.5              # MM_AUTOSCALE_BURN_UP
    burn_flash: float = 2.0           # flash threshold: copy doubling
    burn_down: float = 0.25           # MM_AUTOSCALE_BURN_DOWN
    idle_ticks_down: int = 3          # calm ticks before scale-down
    min_burn_samples: int = 5         # window floor before burn is trusted
    max_models_per_tick: int = 4      # AutoscaleConfig.max_models_per_tick
    holddown_ms: int = 5_000          # MM_AUTOSCALE_HOLDDOWN_MS
    window_ms: int = 10_000           # SloTracker window
    prewarm: bool = True              # forecaster-driven host pre-warming
    # -- SLO / admission (observability/slo.py, routing/admission.py) ------
    slo_spec: str = "default:p99<250ms"
    admission: bool = False
    admission_floor: float = 0.01     # lowest admitted fraction per class


def model_size_bytes(model_id: str, default: int = 1) -> int:
    """SimLoader._size_for's sizing, bit-for-bit: crc32-hashed spread in
    [0.5x, 1.5x) of the default size."""
    h = zlib.crc32(model_id.encode()) % 1000
    return max(1, int(default * (0.5 + h / 1000.0)))


class _Copy:
    """One placement on one instance. States: 'loading' (bytes reserved,
    not servable), 'active' (servable), 'host' (host snapshot only —
    cheap to re-warm, not servable)."""

    __slots__ = ("phase", "ready_ms", "size", "last_used_ms", "source")

    def __init__(self, phase: str, ready_ms: int, size: int,
                 now_ms: int, source: str):
        self.phase = phase
        self.ready_ms = ready_ms
        self.size = size
        self.last_used_ms = now_ms
        self.source = source  # "store" | "peer" | "host"


class _BurnWindow:
    """Windowed per-class good/total aggregate — the SloTracker burn
    computation (burn = (1-good)/budget over the trailing window)
    applied to slot-level aggregates instead of per-request records."""

    __slots__ = ("buf", "bad", "total")

    def __init__(self):
        self.buf: deque = deque()  # (ts_ms, bad, total)
        self.bad = 0
        self.total = 0

    def observe(self, ts_ms: int, bad: int, total: int) -> None:
        self.buf.append((ts_ms, bad, total))
        self.bad += bad
        self.total += total

    def prune(self, cutoff_ms: int) -> None:
        buf = self.buf
        while buf and buf[0][0] < cutoff_ms:
            _, b, t = buf.popleft()
            self.bad -= b
            self.total -= t

    def burn(self, now_ms: int, window_ms: int, good_target: float,
             min_samples: int) -> Optional[float]:
        """SloTracker's burn: (1 - good_fraction) / error_budget.
        None when the window holds too few samples to judge (the
        controller's min_burn_samples gate)."""
        self.prune(now_ms - window_ms)
        if self.total < min_samples:
            return None
        good = 1.0 - (self.bad / self.total)
        budget = 1.0 - good_target
        if budget <= 0.0:
            return 0.0 if good >= 1.0 else math.inf
        return (1.0 - good) / budget


class ModeledInstance:
    """Lightweight pod stand-in: copy map + bytes accounting + load_ewma
    estimate + per-class burn windows. All mutation happens on the
    EventLoop thread — no locks."""

    __slots__ = (
        "iid", "capacity_bytes", "host_budget", "copies", "host_used",
        "used_bytes", "load_ewma", "slot_load", "served", "alive",
        "partitioned", "burn",
    )

    def __init__(self, iid: str, capacity_bytes: int, host_budget: int):
        self.iid = iid
        self.capacity_bytes = capacity_bytes
        self.host_budget = host_budget
        self.copies: dict[str, _Copy] = {}
        self.host_used = 0
        self.used_bytes = 0       # active + loading bytes
        self.load_ewma = 0.0       # mm-load analog: smoothed concurrency
        self.slot_load = 0.0      # concurrency accumulated this slot
        self.served = 0
        self.alive = True
        self.partitioned = False
        self.burn: dict[str, _BurnWindow] = {}

    @property
    def routable(self) -> bool:
        return self.alive and not self.partitioned

    def servable(self, mid: str) -> bool:
        c = self.copies.get(mid)
        return c is not None and c.phase == "active"

    def observe_class(self, cls: str, ts_ms: int, bad: int, total: int) -> None:
        w = self.burn.get(cls)
        if w is None:
            w = self.burn[cls] = _BurnWindow()
        w.observe(ts_ms, bad, total)

    def burn_rate(self, cls: str, now_ms: int, window_ms: int,
                  good_target: float, min_samples: int) -> Optional[float]:
        w = self.burn.get(cls)
        if w is None:
            return None
        return w.burn(now_ms, window_ms, good_target, min_samples)

    def lru_evictable(self, keep: str) -> list[str]:
        """Active copies other than ``keep``, LRU-first."""
        items = [
            (c.last_used_ms, mid) for mid, c in self.copies.items()
            if c.phase == "active" and mid != keep
        ]
        items.sort()
        return [mid for _, mid in items]


class _ModelState:
    __slots__ = (
        "mid", "cls", "size", "holders", "rpm", "last_used_ms",
        "holddown_until_ms", "registered_ms",
    )

    def __init__(self, mid: str, cls: str, size: int, now_ms: int):
        self.mid = mid
        self.cls = cls
        self.size = size
        self.holders: dict[str, int] = {}  # iid -> copy birth ts (insertion order)
        self.rpm = 0.0
        self.last_used_ms = now_ms
        self.holddown_until_ms = 0
        self.registered_ms = now_ms


class RouteResult:
    """Aggregate outcome of routing one (model, slot) flow: latency
    buckets as (latency_ms, count) pairs plus shed/failed counts."""

    __slots__ = ("served", "shed", "failed", "lat")

    def __init__(self):
        self.served = 0
        self.shed = 0
        self.failed = 0
        self.lat: list[tuple[float, int]] = []


class ModeledFleet:
    """The crowd: N ModeledInstances plus modeled routing, demand
    loading, autoscale authority, and admission — all calibrated against
    the real control planes (FleetConfig field comments name sources).

    The workload generator calls ``route_slot(mid, n, slot_ms)`` once
    per (model, slot) with an aggregate request count; everything else
    (control cadences, copy-ready flips, fault overlays) rides the
    EventLoop.
    """

    def __init__(self, loop: EventLoop, n: int,
                 config: Optional[FleetConfig] = None, seed: int = 0):
        self.loop = loop
        self.cfg = config or FleetConfig()
        self.seed = seed
        self.instances: list[ModeledInstance] = [
            ModeledInstance(
                f"pod-{i}", self.cfg.capacity_bytes, self.cfg.host_budget_bytes
            )
            for i in range(n)
        ]
        self.models: dict[str, _ModelState] = {}
        self.slo = parse_slo_spec(self.cfg.slo_spec)
        # Admission throttle per class: admitted fraction in (floor, 1].
        # Clause order in the spec is priority order; the first clause
        # is never shed (routing/admission.py semantics).
        self._slo_order = list(self.slo)
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self.throttle: dict[str, float] = {c: 1.0 for c in self.slo}
        self.forecaster = DemandForecaster() if self.cfg.prewarm else None
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self._calm_ticks: dict[str, int] = {}
        # Scale/churn observability for invariants and the bench tail.
        #: shared-ok: single-threaded EventLoop state — ticks, routing, and faults all run on the loop thread
        self.counters = {
            "scale_up": 0, "scale_down": 0, "loads_store": 0,
            "loads_peer": 0, "loads_host": 0, "evictions": 0,
            "sheds": 0, "cold_fails": 0, "prewarms": 0,
        }
        self._start_ticks()

    # -- setup -------------------------------------------------------------

    def _start_ticks(self) -> None:
        cfg = self.cfg
        if cfg.authority == "legacy":
            self.loop.schedule_in(
                cfg.rate_interval_s * 1000.0, self._rate_tick
            )
            self.loop.schedule_in(
                cfg.janitor_interval_s * 1000.0, self._janitor_tick
            )
        elif cfg.authority == "burn":
            self.loop.schedule_in(
                cfg.autoscale_interval_s * 1000.0, self._burn_tick
            )
        if cfg.admission:
            # Throttle refresh shares the autoscale cadence floor; the
            # real refresher runs at 250ms but the modeled slot grid is
            # coarser, so per-slot pressure updates happen in
            # _refresh_admission called from route feedback instead.
            self.loop.schedule_in(1_000.0, self._admission_tick)

    def class_of(self, mid: str) -> str:
        ms = self.models.get(mid)
        return ms.cls if ms is not None else "default"

    def objectives(self, cls: str) -> Optional[SloObjectives]:
        return self.slo.get(cls) or self.slo.get("default")

    def register(self, mid: str, cls: str = "default") -> None:
        if mid not in self.models:
            self.models[mid] = _ModelState(
                mid, cls, model_size_bytes(mid, self.cfg.default_size_bytes),
                self.loop.now_ms,
            )

    def unregister(self, mid: str) -> None:
        ms = self.models.pop(mid, None)
        if ms is None:
            return
        for iid in list(ms.holders):
            self._drop_copy(ms, iid, to_host=False)

    # -- copy lifecycle ----------------------------------------------------

    def _inst(self, iid: str) -> ModeledInstance:
        return self.instances[int(iid.rsplit("-", 1)[1])]

    def _load_latency_ms(self, inst: ModeledInstance, ms: _ModelState,
                         have_peer: bool) -> tuple[float, str]:
        cfg = self.cfg
        base = cfg.load_delay_ms * (ms.size / max(cfg.default_size_bytes, 1))
        c = inst.copies.get(ms.mid)
        if c is not None and c.phase == "host":
            return base * cfg.host_rewarm_frac, "host"
        if have_peer:
            return base * cfg.peer_stream_frac, "peer"
        return base, "store"

    def _evict_for(self, inst: ModeledInstance, need: int, keep: str) -> bool:
        """Free ``need`` bytes via LRU eviction (evicted actives demote
        to host snapshots when the host tier has room — the real cache's
        second-chance tier). False when impossible."""
        if inst.capacity_bytes - inst.used_bytes >= need:
            return True
        for mid in inst.lru_evictable(keep):
            self._drop_copy(self.models[mid], inst.iid, to_host=True)
            self.counters["evictions"] += 1
            if inst.capacity_bytes - inst.used_bytes >= need:
                return True
        return inst.capacity_bytes - inst.used_bytes >= need

    def _drop_copy(self, ms: _ModelState, iid: str, to_host: bool) -> None:
        inst = self._inst(iid)
        c = inst.copies.get(ms.mid)
        if c is None:
            return
        if c.phase in ("active", "loading"):
            inst.used_bytes -= c.size
            ms.holders.pop(iid, None)
        if c.phase == "host":
            inst.host_used -= c.size
            del inst.copies[ms.mid]
            return
        if to_host and inst.host_used + c.size <= inst.host_budget:
            c.phase = "host"
            inst.host_used += c.size
        else:
            del inst.copies[ms.mid]

    def add_copy(self, mid: str, iid: Optional[str] = None) -> bool:
        """Start loading one more copy (place on the least-loaded fitting
        routable instance when ``iid`` is None). Returns False when no
        instance can take it."""
        ms = self.models.get(mid)
        if ms is None:
            return False
        inst = self._inst(iid) if iid else self._pick_target(ms)
        if inst is None or not inst.routable or mid in ms.holders:
            return False
        if not self._evict_for(inst, ms.size, keep=mid):
            return False
        have_peer = any(
            self._inst(h).servable(mid) for h in ms.holders
        )
        lat, source = self._load_latency_ms(inst, ms, have_peer)
        now = self.loop.now_ms
        prior = inst.copies.get(mid)
        if prior is not None and prior.phase == "host":
            inst.host_used -= prior.size
        ready = now + int(lat)
        inst.copies[mid] = _Copy("loading", ready, ms.size, now, source)
        inst.used_bytes += ms.size
        ms.holders[inst.iid] = now
        self.counters["loads_" + source] += 1
        self.loop.schedule_at(ready, self._copy_ready, inst, mid)
        return True

    def _copy_ready(self, inst: ModeledInstance, mid: str) -> None:
        c = inst.copies.get(mid)
        if c is not None and c.phase == "loading" and inst.alive:
            c.phase = "active"

    def _pick_target(self, ms: _ModelState) -> Optional[ModeledInstance]:
        best, best_key = None, None
        for inst in self.instances:
            if not inst.routable or inst.iid in ms.holders:
                continue
            # Least-loaded by load_ewma, then most free bytes; index
            # breaks ties deterministically.
            key = (
                inst.load_ewma + inst.slot_load,
                inst.used_bytes / max(inst.capacity_bytes, 1),
            )
            if best_key is None or key < best_key:
                best, best_key = inst, key
        return best

    # -- data plane --------------------------------------------------------

    def route_slot(self, mid: str, n: int, slot_ms: int) -> RouteResult:
        """Route ``n`` requests arriving for ``mid`` uniformly over one
        slot. Returns aggregate latency buckets; feeds mm-load, burn
        windows (via the caller's observe step), rpm, and demand loads.
        """
        res = RouteResult()
        if n <= 0:
            return res
        ms = self.models.get(mid)
        now = self.loop.now_ms
        if ms is None:
            res.failed = n
            return res
        cfg = self.cfg
        ms.last_used_ms = now
        # EWMA demand rate (per-minute), tau ~= 3 slots.
        inst_rate = n * 60_000.0 / max(slot_ms, 1)
        alpha = 1.0 - math.exp(-1.0 / 3.0)
        ms.rpm += alpha * (inst_rate - ms.rpm)
        # Admission: classes under throttle shed a deterministic
        # fraction at the door (rounded half-up so tiny flows still
        # shed under full throttle).
        if cfg.admission:
            frac = self.throttle.get(ms.cls, 1.0)
            if frac < 1.0:
                shed = n - int(n * frac)
                if shed > 0:
                    # Sheds carry NO latency sample: rejected at the
                    # door, they never reach the runtime — they count
                    # against availability (slo_attained), not the
                    # served-latency distribution.
                    res.shed = shed
                    self.counters["sheds"] += shed
                    n -= shed
                if n <= 0:
                    return res
        holders = [
            self._inst(h) for h in ms.holders
            if self._inst(h).routable and self._inst(h).servable(mid)
        ]
        if not holders:
            return self._route_cold(ms, n, res)
        self._route_warm(ms, holders, n, slot_ms, res)
        return res

    def _route_cold(self, ms: _ModelState, n: int, res: RouteResult) -> RouteResult:
        """No active copy: requests wait on the (possibly just-started)
        load; beyond the timeout they fail — the real path's bounded
        cold-start wait."""
        cfg = self.cfg
        now = self.loop.now_ms
        loading = [
            self._inst(h) for h in ms.holders
            if self._inst(h).routable
            and self._inst(h).copies.get(ms.mid) is not None
            and self._inst(h).copies[ms.mid].phase == "loading"
        ]
        if not loading:
            if not self.add_copy(ms.mid):
                res.failed = n
                self.counters["cold_fails"] += n
                return res
            loading = [
                self._inst(h) for h in ms.holders
                if self._inst(h).copies.get(ms.mid) is not None
                and self._inst(h).copies[ms.mid].phase == "loading"
            ]
            if not loading:
                res.failed = n
                self.counters["cold_fails"] += n
                return res
        ready = min(i.copies[ms.mid].ready_ms for i in loading)
        wait = max(ready - now, 0)
        if wait > cfg.load_timeout_ms:
            res.failed = n
            self.counters["cold_fails"] += n
            return res
        lat = wait + cfg.service_base_ms
        res.served = n
        res.lat.append((lat, n))
        inst = loading[0]
        inst.served += n
        return res

    def _route_warm(self, ms: _ModelState, holders: list[ModeledInstance],
                    n: int, slot_ms: int, res: RouteResult) -> None:
        """Power-of-d over active holders, as a flow: the d-candidate
        least-loaded choice spreads the slot's n requests across holders
        in proportion to available headroom (water-filling on the
        load_ewma estimate), with a 1/(2d) uniform leak modeling the
        imperfection of sampling d candidates instead of all. d<=1 is
        the legacy single-winner greedy (herding preserved on purpose).
        """
        cfg = self.cfg
        now = self.loop.now_ms
        svc_frac = cfg.service_base_ms / max(slot_ms, 1)
        for h in holders:
            h.copies[ms.mid].last_used_ms = now
        if len(holders) == 1 or cfg.route_d <= 1:
            holders.sort(key=lambda h: (h.load_ewma + h.slot_load, h.iid))
            shares = [(holders[0], n)]
        else:
            leak = 1.0 / (2.0 * cfg.route_d)
            uniform = n * leak / len(holders)
            fill_n = n - uniform * len(holders)
            shares_f = self._water_fill(holders, fill_n, svc_frac)
            shares = []
            rem = n
            for h, f in shares_f[:-1]:
                k = max(0, min(int(round(f + uniform)), rem))
                shares.append((h, k))
                rem -= k
            shares.append((shares_f[-1][0], rem))
        for inst, k in shares:
            if k <= 0:
                continue
            # Concurrency an arriving request sees: the smoothed prior
            # load (mm-load feedback) plus everything already routed to
            # this instance THIS slot (other models share the pod), plus
            # this flow's own contribution. end_slot() folds slot_load
            # into the smoothed estimate.
            inst.slot_load += k * svc_frac
            conc = inst.load_ewma + inst.slot_load
            queued = max(conc - 1.0, 0.0)
            if cfg.service_congestion_cap > 0:
                queued = min(queued, float(cfg.service_congestion_cap))
            lat = cfg.service_base_ms + cfg.service_congestion_ms * queued
            res.lat.append((lat, k))
            res.served += k
            inst.served += k

    @staticmethod
    def _water_fill(holders: list[ModeledInstance], n: float,
                    svc_frac: float) -> list[tuple[ModeledInstance, float]]:
        """Distribute n requests so post-assignment load equalizes
        (perfect least-loaded flow assignment)."""
        hs = sorted(holders, key=lambda h: (h.load_ewma + h.slot_load, h.iid))
        w = max(svc_frac, 1e-9)
        total = n
        # Find the water level L: sum(max(0, L - s_i)) / w = n.
        levels = [h.load_ewma + h.slot_load for h in hs]
        assigned = [0.0] * len(hs)
        k = len(hs)
        # Raise level band by band.
        need = total * w
        for i in range(1, k + 1):
            band_top = levels[i] if i < k else math.inf
            band_cap = (band_top - levels[i - 1]) * i
            if band_cap >= need or i == k:
                level = levels[i - 1] + need / i
                for j in range(i):
                    assigned[j] = (level - levels[j]) / w
                break
            need -= band_cap
        return list(zip(hs, assigned))

    def end_slot(self) -> None:
        """Fold this slot's accumulated load into the smoothed load_ewma
        estimate (the mm-load feedback the NEXT slot's routing sees) and
        reset the accumulator. The workload generator calls this once
        per slot after routing every model's flow."""
        for inst in self.instances:
            inst.load_ewma += 0.5 * (inst.slot_load - inst.load_ewma)
            inst.slot_load = 0.0

    # -- burn observation (called by the workload per slot) ----------------

    def observe_slot(self, cls: str, ts_ms: int, bad: int, total: int) -> None:
        """Distribute a slot's per-class (bad, total) aggregate across
        entry instances — each alive instance sees ~1/n of the traffic,
        so the leader's window carries a leader-local sample exactly as
        in production (the PR-15 blind spot is reproduced, not papered
        over: its sample COUNT gates min_burn_samples realistically)."""
        live = [i for i in self.instances if i.alive]
        if not live:
            return
        n = len(live)
        b_share, b_extra = divmod(bad, n)
        t_share, t_extra = divmod(total, n)
        for idx, inst in enumerate(live):
            inst.observe_class(
                cls, ts_ms,
                b_share + (1 if idx < b_extra else 0),
                t_share + (1 if idx < t_extra else 0),
            )

    def _leader(self) -> Optional[ModeledInstance]:
        for inst in self.instances:
            if inst.alive:
                return inst
        return None

    # -- authority: legacy rate task + janitor -----------------------------

    def _rate_tick(self) -> None:
        cfg = self.cfg
        live = sum(1 for i in self.instances if i.alive)
        for mid in sorted(self.models):
            ms = self.models[mid]
            copies = len(ms.holders)
            if copies == 0:
                continue
            if ms.rpm > cfg.scale_up_rpm * copies and copies < min(
                cfg.max_copies, live
            ):
                if self.add_copy(mid):
                    self.counters["scale_up"] += 1
        self.loop.schedule_in(cfg.rate_interval_s * 1000.0, self._rate_tick)

    def _janitor_tick(self) -> None:
        """Cluster-full surplus shedding + aged second copies — the
        legacy janitor's scale-down half."""
        cfg = self.cfg
        now = self.loop.now_ms
        used = sum(i.used_bytes for i in self.instances if i.alive)
        cap = sum(i.capacity_bytes for i in self.instances if i.alive)
        full = cap > 0 and used / cap > 0.9
        for mid in sorted(self.models):
            ms = self.models[mid]
            if len(ms.holders) < 2:
                continue
            surplus_ok = ms.rpm < cfg.scale_up_rpm * (len(ms.holders) - 1)
            newest_iid = max(ms.holders, key=lambda h: (ms.holders[h], h))
            aged = now - ms.holders[newest_iid] > cfg.second_copy_max_age_s * 1000
            if (full and surplus_ok) or (aged and surplus_ok):
                self._drop_copy(ms, newest_iid, to_host=True)
                self.counters["scale_down"] += 1
        self.loop.schedule_in(
            cfg.janitor_interval_s * 1000.0, self._janitor_tick
        )

    # -- authority: burn-rate controller -----------------------------------

    def _burn_tick(self) -> None:
        cfg = self.cfg
        now = self.loop.now_ms
        leader = self._leader()
        if leader is None:
            self.loop.schedule_in(
                cfg.autoscale_interval_s * 1000.0, self._burn_tick
            )
            return
        live = sum(1 for i in self.instances if i.alive)
        if self.forecaster is not None:
            for mid in sorted(self.models):
                ms = self.models[mid]
                if ms.rpm > 0:
                    self.forecaster.observe(mid, ms.rpm, now)
        for cls in sorted(leader.burn):
            obj = self.objectives(cls)
            if obj is None:
                continue
            burn = leader.burn_rate(
                cls, now, cfg.window_ms, obj.good_target, cfg.min_burn_samples
            )
            if burn is None:
                continue
            if burn >= cfg.burn_up:
                self._calm_ticks[cls] = 0
                flash = burn >= cfg.burn_flash
                ceiling = min(cfg.max_copies, live)
                # Hottest models that can still GAIN a copy: once the
                # top of the class saturates, pressure walks down the
                # popularity list instead of stalling on maxed models.
                hot = sorted(
                    (m for m in self.models.values()
                     if m.cls == cls and m.holders
                     and len(m.holders) < ceiling),
                    key=lambda m: (-m.rpm, m.mid),
                )[: cfg.max_models_per_tick]
                for ms in hot:
                    if now < ms.holddown_until_ms:
                        continue
                    copies = len(ms.holders)
                    want = min(copies * 2 if flash else copies + 1,
                               cfg.max_copies, live)
                    added = False
                    for _ in range(want - copies):
                        if self.add_copy(ms.mid):
                            added = True
                            self.counters["scale_up"] += 1
                    if added:
                        ms.holddown_until_ms = now + cfg.holddown_ms
            elif burn <= cfg.burn_down:
                calm = self._calm_ticks.get(cls, 0) + 1
                self._calm_ticks[cls] = calm
                if calm >= cfg.idle_ticks_down:
                    self._scale_down_class(cls, now)
                    self._calm_ticks[cls] = 0
            else:
                self._calm_ticks[cls] = 0
        if self.forecaster is not None:
            self._prewarm(now)
        self.loop.schedule_in(
            cfg.autoscale_interval_s * 1000.0, self._burn_tick
        )

    def _scale_down_class(self, cls: str, now: int) -> None:
        cfg = self.cfg
        for mid in sorted(self.models):
            ms = self.models[mid]
            if ms.cls != cls or len(ms.holders) < 2:
                continue
            if now < ms.holddown_until_ms:
                continue
            newest = max(ms.holders, key=lambda h: (ms.holders[h], h))
            self._drop_copy(ms, newest, to_host=True)
            self.counters["scale_down"] += 1
            ms.holddown_until_ms = now + cfg.holddown_ms

    def _prewarm(self, now: int) -> None:
        """Stage host snapshots for trending models on instances that
        do not hold them — the PR-15 predictive pre-warm: when demand
        arrives, the load is a cheap host re-warm instead of a cold
        store pull."""
        assert self.forecaster is not None
        for mid in self.forecaster.trending(now_ms=now):
            ms = self.models.get(mid)
            if ms is None:
                continue
            staged = 0
            for inst in self.instances:
                if staged >= 1:
                    break
                if not inst.routable or ms.mid in inst.copies:
                    continue
                if inst.host_used + ms.size > inst.host_budget:
                    continue
                inst.copies[ms.mid] = _Copy(
                    "host", now, ms.size, now, "host"
                )
                inst.host_used += ms.size
                self.counters["prewarms"] += 1
                staged += 1

    # -- admission ---------------------------------------------------------

    def _admission_tick(self) -> None:
        """Per-class throttle refresh: when any class at-or-above a
        class's priority burns >= 1x on the leader's window, classes
        below halve their admitted fraction (multiplicative recovery
        when pressure lifts); the first clause is never shed —
        routing/admission.py's bucket semantics on the slot grid."""
        cfg = self.cfg
        now = self.loop.now_ms
        leader = self._leader()
        if leader is not None:
            burning_at: Optional[int] = None
            for pri, cls in enumerate(self._slo_order):
                obj = self.objectives(cls)
                if obj is None:
                    continue
                burn = leader.burn_rate(
                    cls, now, cfg.window_ms, obj.good_target,
                    cfg.min_burn_samples,
                )
                if burn is not None and burn >= 1.0:
                    burning_at = pri
                    break  # highest burning priority wins
            for pri, cls in enumerate(self._slo_order):
                if pri == 0:
                    self.throttle[cls] = 1.0  # first clause never shed
                    continue
                if burning_at is not None and pri >= burning_at:
                    self.throttle[cls] = max(
                        self.throttle[cls] * 0.5, cfg.admission_floor
                    )
                else:
                    self.throttle[cls] = min(self.throttle[cls] * 2.0, 1.0)
        self.loop.schedule_in(1_000.0, self._admission_tick)

    # -- fault overlays ----------------------------------------------------

    def kill(self, iid: str) -> None:
        inst = self._inst(iid)
        inst.alive = False
        inst.load_ewma = 0.0
        inst.slot_load = 0.0
        for mid in list(inst.copies):
            ms = self.models.get(mid)
            if ms is not None:
                ms.holders.pop(iid, None)
        inst.copies.clear()
        inst.used_bytes = 0
        inst.host_used = 0

    def partition(self, iid: str) -> None:
        self._inst(iid).partitioned = True

    def heal(self, iid: str) -> None:
        self._inst(iid).partitioned = False

    # -- invariant-facing --------------------------------------------------

    def total_copies(self) -> int:
        return sum(len(m.holders) for m in self.models.values())

    def bytes_conservation_violations(self) -> list[str]:
        """used_bytes must equal the sum of active+loading copy sizes
        and never exceed capacity — the modeled twin of the cache
        accounting invariant."""
        out = []
        for inst in self.instances:
            acc = sum(
                c.size for c in inst.copies.values()
                if c.phase in ("active", "loading")
            )
            if acc != inst.used_bytes:
                out.append(
                    f"{inst.iid}: used_bytes={inst.used_bytes} != sum={acc}"
                )
            if inst.used_bytes > inst.capacity_bytes:
                out.append(
                    f"{inst.iid}: over capacity "
                    f"{inst.used_bytes}>{inst.capacity_bytes}"
                )
            host = sum(
                c.size for c in inst.copies.values() if c.phase == "host"
            )
            if host != inst.host_used:
                out.append(
                    f"{inst.iid}: host_used={inst.host_used} != sum={host}"
                )
        return out
