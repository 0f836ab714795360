"""The port's own copy of the JAX package's ``sim/workload.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Closed-loop macro workload: millions of synthetic users against a
``ModeledFleet`` on one ``EventLoop``.

The generator is slot-batched — the macro perf strategy. Instead of an
event per request (billions per simulated day), each virtual slot
(default 10 s) draws one Poisson arrival count from the closed-loop
rate, splits it across models with one seeded multinomial over the
Zipf popularity vector, and routes each model's count as a flow
(``ModeledFleet.route_slot``). Latencies come back as (latency, count)
aggregate pairs and land in per-window per-class histograms quantized
to 0.5 ms buckets — memory is O(windows x classes x distinct buckets),
not O(requests), and weighted nearest-rank percentiles over the merged
histogram match per-request percentiles to bucket width.

Closed loop: the offered rate is ``users x slot / (think + latency)``
— latency feedback throttles arrivals exactly like real users waiting
on responses, so overload self-limits the way production traffic does
(and sheds return fast, so admission INCREASES offered rate — the
retry-pressure effect the admission matrix cells exercise).

Traffic shapes compose declaratively on ``WorkloadSpec``:

* diurnal: a 24-bucket hourly profile (linear interpolation between
  buckets) — the PR-15 forecaster's native resolution, exercised over
  a full virtual day by the macro headline.
* flash crowds: a seeded band of mid-popularity models gets its weight
  multiplied for a window — the scale-up burst that separates burn
  doubling from legacy +1 stepping.
* mass churn: a seeded fraction of models is unregistered and replaced
  by fresh ids that INHERIT the old popularity — the "new model
  version goes instantly hot" cold-load storm.
* fault overlays: kill / partition / heal a seeded fraction of the
  fleet at a virtual time.

Determinism: every draw comes from one ``numpy.random.default_rng``
seeded at construction; time comes only from the EventLoop. The same
(spec, seed) replays bit-for-bit — ``MacroStats.digest()`` is the
witness (pinned in tier-1 by tests/test_bench_macro.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional

import numpy as np

from modelmesh_tpu_torch.sim.engine import EventLoop, FleetConfig, ModeledFleet

__all__ = [
    "FlashCrowd",
    "MassChurn",
    "FaultOverlay",
    "WorkloadSpec",
    "MacroStats",
    "WorkloadGenerator",
    "run_macro",
    "DEFAULT_DIURNAL",
]

# Hourly demand multipliers (fraction of peak), one per hour-of-day:
# overnight trough, morning ramp, lunch plateau, evening peak — the
# usual consumer-traffic shape, normalized to max 1.0.
DEFAULT_DIURNAL = (
    0.30, 0.25, 0.22, 0.20, 0.20, 0.24,
    0.32, 0.45, 0.60, 0.72, 0.80, 0.85,
    0.88, 0.86, 0.82, 0.80, 0.82, 0.88,
    0.95, 1.00, 0.98, 0.85, 0.60, 0.42,
)


@dataclasses.dataclass(frozen=True)
class FlashCrowd:
    at_ms: int
    duration_ms: int
    boost: float = 30.0   # weight multiplier on the target band
    n_models: int = 4     # seeded picks from the mid-popularity band


@dataclasses.dataclass(frozen=True)
class MassChurn:
    at_ms: int
    frac: float = 0.2     # fraction of models replaced by fresh ids


@dataclasses.dataclass(frozen=True)
class FaultOverlay:
    at_ms: int
    kind: str             # "kill" | "partition" | "heal_all"
    frac: float = 0.1     # fleet fraction targeted (kill/partition)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    users: int = 100_000
    models: int = 1024
    zipf_s: float = 1.1
    think_ms: float = 20_000.0
    day_s: int = 86_400
    slot_ms: int = 10_000
    window_ms: int = 60_000
    diurnal: tuple = DEFAULT_DIURNAL
    # (class_name, fraction of models) in SLO-priority order; fractions
    # are cumulative-assigned over the seeded model permutation.
    classes: tuple = (("default", 1.0),)
    flash: tuple = ()
    churn: tuple = ()
    faults: tuple = ()
    # Judge slo_attained only after this ramp (cold start + first
    # control cadences are not steady state).
    judge_after_ms: int = 300_000


class MacroStats:
    """Slot-aggregated outcome accounting: per-(window, class) latency
    histograms plus conservation counters. All integers — no request
    identity survives, only distributions (the macro memory contract).
    """

    BUCKET_PER_MS = 2  # 0.5 ms quantization

    def __init__(self, window_ms: int):
        self.window_ms = window_ms
        # (window_idx, cls) -> {"lat": {bucket: count}, "shed": n,
        #                       "failed": n, "served": n}
        self.windows: dict = {}
        self.offered = 0
        self.served = 0
        self.shed = 0
        self.failed = 0

    def observe(self, rel_ms: int, cls: str, res) -> None:
        """Fold one RouteResult into the window grid."""
        n = res.served + res.shed + res.failed
        self.offered += n
        self.served += res.served
        self.shed += res.shed
        self.failed += res.failed
        key = (rel_ms // self.window_ms, cls)
        w = self.windows.get(key)
        if w is None:
            w = self.windows[key] = {
                "lat": {}, "shed": 0, "failed": 0, "served": 0,
            }
        w["shed"] += res.shed
        w["failed"] += res.failed
        w["served"] += res.served
        lat = w["lat"]
        q = self.BUCKET_PER_MS
        for latency_ms, count in res.lat:
            b = int(latency_ms * q)
            lat[b] = lat.get(b, 0) + count

    # -- reductions --------------------------------------------------------

    def percentile(self, p: float, cls: Optional[str] = None) -> float:
        """Weighted nearest-rank percentile (ms) over served requests,
        merged across windows (optionally one class)."""
        merged: dict[int, int] = {}
        for (_, c), w in self.windows.items():
            if cls is not None and c != cls:
                continue
            for b, n in w["lat"].items():
                merged[b] = merged.get(b, 0) + n
        total = sum(merged.values())
        if total == 0:
            return 0.0
        rank = max(int(math.ceil(p / 100.0 * total)), 1)
        acc = 0
        for b in sorted(merged):
            acc += merged[b]
            if acc >= rank:
                return b / self.BUCKET_PER_MS
        return max(merged) / self.BUCKET_PER_MS

    def slo_attained(self, cls: str, bound_ms: Optional[float],
                     good_target: float, judge_after_ms: int) -> float:
        """Fraction of post-ramp windows whose good-event fraction
        (served under the latency bound, over ALL offered including
        sheds and failures) meets the class's implied target — the
        windowed twin of invariants.slo_attained."""
        judged = attained = 0
        first_win = judge_after_ms // self.window_ms
        q = self.BUCKET_PER_MS
        for (win, c), w in sorted(self.windows.items()):
            if c != cls or win < first_win:
                continue
            total = w["served"] + w["shed"] + w["failed"]
            if total == 0:
                continue
            if bound_ms is None:
                good = w["served"]
            else:
                cut = int(bound_ms * q)
                good = sum(n for b, n in w["lat"].items() if b <= cut)
            judged += 1
            if good / total >= good_target:
                attained += 1
        return attained / judged if judged else 0.0

    def digest(self) -> str:
        """Canonical sha256 over every window histogram + totals: the
        bit-for-bit replay witness."""
        canon = {
            "offered": self.offered, "served": self.served,
            "shed": self.shed, "failed": self.failed,
            "windows": [
                [win, c, sorted(w["lat"].items()),
                 w["shed"], w["failed"], w["served"]]
                for (win, c), w in sorted(self.windows.items())
            ],
        }
        return hashlib.sha256(
            json.dumps(canon, separators=(",", ":")).encode()
        ).hexdigest()


class WorkloadGenerator:
    """Drives one ``ModeledFleet`` through one ``WorkloadSpec`` on the
    fleet's EventLoop. Construct, ``start()``, then run the loop to
    ``t0 + day_s*1000``."""

    def __init__(self, loop: EventLoop, fleet: ModeledFleet,
                 spec: WorkloadSpec, seed: int = 0):
        self.loop = loop
        self.fleet = fleet
        self.spec = spec
        self.rng = np.random.default_rng(seed)
        self.t0 = loop.now_ms
        self.stats = MacroStats(spec.window_ms)
        self.requests_simulated = 0
        # -- popularity: Zipf over a seeded permutation ---------------------
        m = spec.models
        ranks = np.arange(1, m + 1, dtype=np.float64)
        w = 1.0 / ranks ** spec.zipf_s
        self.base_weights = w / w.sum()
        # model index -> current id (churn swaps ids in place, so the
        # replacement inherits the slot's popularity).
        self.ids = [f"mm-{seed}-{i:05d}" for i in range(m)]
        # class per index: spec fractions over a seeded permutation, so
        # class membership is popularity-independent.
        perm = self.rng.permutation(m)
        self.cls = [""] * m
        start = 0
        for cname, frac in spec.classes:
            end = m if (cname == spec.classes[-1][0]) else min(
                m, start + int(round(frac * m))
            )
            for j in perm[start:end]:
                self.cls[int(j)] = cname
            start = end
        for j in perm[start:]:
            self.cls[int(j)] = spec.classes[-1][0]
        for i, mid in enumerate(self.ids):
            fleet.register(mid, self.cls[i])
        # flash targets: seeded picks from the mid-popularity band
        # (ranks m//8 .. m//2): popular enough to matter, cold enough
        # that the burst forces real scale-up.
        self._flash_targets: list[np.ndarray] = [
            self.rng.choice(
                np.arange(m // 8, max(m // 2, m // 8 + 1)),
                size=min(f.n_models, m), replace=False,
            )
            for f in spec.flash
        ]
        self._lat_ewma = fleet.cfg.service_base_ms
        #: shared-ok: single-threaded EventLoop state — slot callbacks run on the loop thread
        self._slot_ev = None
        for f in spec.faults:
            loop.schedule_at(self.t0 + f.at_ms, self._fault, f)
        for c in spec.churn:
            loop.schedule_at(self.t0 + c.at_ms, self._churn, c)

    def warm_start(self) -> None:
        """Pre-place one copy per model, most popular first, until the
        fleet is ~60% full — the steady-state cache a real fleet would
        have at the start of a day."""
        cap = sum(
            i.capacity_bytes for i in self.fleet.instances if i.alive
        )
        order = np.argsort(-self.base_weights, kind="stable")
        for j in order:
            mid = self.ids[int(j)]
            used = sum(
                i.used_bytes for i in self.fleet.instances if i.alive
            )
            if cap and used / cap > 0.6:
                break
            self.fleet.add_copy(mid)

    def start(self) -> None:
        self._slot_ev = self.loop.schedule_at(
            self.t0 + self.spec.slot_ms, self._slot
        )

    # -- per-slot hot path -------------------------------------------------

    def _diurnal_factor(self, rel_ms: int) -> float:
        prof = self.spec.diurnal
        h = (rel_ms / 3_600_000.0) % 24.0
        i = int(h) % 24
        frac = h - int(h)
        return prof[i] * (1.0 - frac) + prof[(i + 1) % 24] * frac

    def _weights(self, rel_ms: int) -> np.ndarray:
        w = self.base_weights
        boosted = None
        for f, targets in zip(self.spec.flash, self._flash_targets):
            if f.at_ms <= rel_ms < f.at_ms + f.duration_ms:
                if boosted is None:
                    boosted = w.copy()
                boosted[targets] *= f.boost
        if boosted is None:
            return w
        return boosted / boosted.sum()

    def _slot(self) -> None:
        spec = self.spec
        now = self.loop.now_ms
        rel = now - self.t0
        # Closed loop: each user cycles think -> request -> response.
        rate_per_user = spec.slot_ms / (spec.think_ms + self._lat_ewma)
        mean = spec.users * rate_per_user * self._diurnal_factor(rel)
        arrivals = int(self.rng.poisson(mean)) if mean > 0 else 0
        if arrivals > 0:
            counts = self.rng.multinomial(arrivals, self._weights(rel))
            fleet = self.fleet
            stats = self.stats
            observe = stats.observe
            class_bad: dict[str, list] = {}
            lat_sum = 0.0
            lat_n = 0
            nz = np.nonzero(counts)[0]
            for j in nz:
                k = int(counts[j])
                res = fleet.route_slot(self.ids[j], k, spec.slot_ms)
                cls = self.cls[j]
                observe(rel, cls, res)
                bound = self._bound(cls)
                # Burn-window feed EXCLUDES sheds: admission rejects at
                # the door, before the real SloTracker ever records the
                # request — counting sheds as burn would make shedding
                # self-sustaining (shed -> burn >= 1 -> shed forever).
                # slo_attained still counts them (user-visible misses).
                bad = res.failed
                for latency_ms, c in res.lat:
                    lat_sum += latency_ms * c
                    lat_n += c
                    if bound is not None and latency_ms > bound:
                        bad += c
                agg = class_bad.get(cls)
                if agg is None:
                    class_bad[cls] = [bad, res.served + res.failed]
                else:
                    agg[0] += bad
                    agg[1] += res.served + res.failed
            self.requests_simulated += arrivals
            fleet.end_slot()
            for cls in sorted(class_bad):
                bad, total = class_bad[cls]
                fleet.observe_slot(cls, now, bad, total)
            if lat_n:
                # EWMA latency feedback, tau ~= 3 slots.
                alpha = 1.0 - math.exp(-1.0 / 3.0)
                self._lat_ewma += alpha * (lat_sum / lat_n - self._lat_ewma)
        if rel + spec.slot_ms <= spec.day_s * 1000:
            self._slot_ev = self.loop.schedule_at(
                now + spec.slot_ms, self._slot
            )

    def _bound(self, cls: str) -> Optional[float]:
        obj = self.fleet.objectives(cls)
        return obj.latency_bound_ms if obj is not None else None

    # -- overlays ----------------------------------------------------------

    def _fault(self, f: FaultOverlay) -> None:
        insts = self.fleet.instances
        if f.kind == "heal_all":
            for inst in insts:
                self.fleet.heal(inst.iid)
            return
        n = max(1, int(round(f.frac * len(insts))))
        # Never target pod-0: the modeled leader must survive (the
        # leader-loss case is a scripted full-fidelity scenario).
        pool = np.arange(1, len(insts))
        targets = self.rng.choice(pool, size=min(n, len(pool)), replace=False)
        for t in sorted(int(x) for x in targets):
            if f.kind == "kill":
                self.fleet.kill(insts[t].iid)
            elif f.kind == "partition":
                self.fleet.partition(insts[t].iid)
            else:
                raise ValueError(f"unknown fault overlay kind {f.kind!r}")

    def _churn(self, c: MassChurn) -> None:
        m = self.spec.models
        n = max(1, int(round(c.frac * m)))
        picks = self.rng.choice(np.arange(m), size=n, replace=False)
        for j in sorted(int(x) for x in picks):
            old = self.ids[j]
            self.fleet.unregister(old)
            new = old + "+"  # version bump; popularity slot unchanged
            self.ids[j] = new
            self.fleet.register(new, self.cls[j])

    # -- result ------------------------------------------------------------

    def summary(self) -> dict:
        spec = self.spec
        stats = self.stats
        out = {
            "users": spec.users,
            "models": spec.models,
            "virtual_day_s": spec.day_s,
            "offered": stats.offered,
            "served": stats.served,
            "shed": stats.shed,
            "failed": stats.failed,
            "p50_ms": stats.percentile(50.0),
            "p99_ms": stats.percentile(99.0),
            "digest": stats.digest(),
            "classes": {},
            "fleet": dict(self.fleet.counters),
        }
        for cname, _ in spec.classes:
            obj = self.fleet.objectives(cname)
            out["classes"][cname] = {
                "p99_ms": stats.percentile(99.0, cname),
                "slo_attained": stats.slo_attained(
                    cname,
                    obj.latency_bound_ms if obj else None,
                    obj.good_target if obj else 1.0,
                    spec.judge_after_ms,
                ),
            }
        return out


def run_macro(
    spec: WorkloadSpec,
    n_pods: int,
    fleet_config: Optional[FleetConfig] = None,
    seed: int = 0,
) -> dict:
    """One macro run, self-contained: build loop + fleet + generator,
    warm-start, run the virtual day, return the summary dict (with the
    engine's event count — callers add wall-clock around this)."""
    loop = EventLoop()
    fleet = ModeledFleet(loop, n_pods, fleet_config, seed=seed)
    gen = WorkloadGenerator(loop, fleet, spec, seed=seed)
    gen.warm_start()
    gen.start()
    loop.run(gen.t0 + spec.day_s * 1000)
    out = gen.summary()
    out["pods"] = n_pods
    out["engine_events"] = loop.events_processed
    out["requests_simulated"] = gen.requests_simulated
    out["conservation_violations"] = (
        fleet.bytes_conservation_violations()
    )
    offered = out["offered"]
    if offered != out["served"] + out["shed"] + out["failed"]:
        out["conservation_violations"].append(
            f"request conservation: offered={offered} != "
            f"served+shed+failed"
        )
    return out
