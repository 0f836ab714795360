"""The port's own copy of the JAX package's ``autoscale/controller.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

SLO-burn-rate-driven copy autoscaling: the signal→decision→actuation loop.

Before this module, every scaling signal the repo computes was ignored
by the scaling loop: PR-8's per-class burn-rate gauges, PR-14's
admission sheds, and the 9/114 ms fast weight paths (PR-6) all existed
while copy count still reacted only to the legacy 10 s rate tracker
(serving/tasks.py). The ``AutoscaleController`` closes the loop
(BLITZSCALE's live-autoscaling shape, PAPERS.md):

- **Reactive scale-up (leader only)**: each tick reads the per-class
  burn rates from the instance's ``SloTracker``. A class burning at or
  above ``burn_up`` *and not improving* (or past 1×) is pressured; the
  controller picks that class's hottest under-copied models and issues
  ``ensure_loaded(chain=adds-1)`` — one call materializes the whole
  step through the PR-3 chained fan-out, and the PR-6 wait-for-pending
  + peer-stream machinery makes the flash crowd pay ONE store load no
  matter how many copies land. Past ``burn_flash`` the step doubles the
  copy count (flash-crowd response) instead of adding one.
- **Reversible scale-down (every instance)**: a surplus local copy of a
  calm class (burn below ``burn_down`` for ``idle_ticks_down``
  consecutive ticks, local rate under the legacy threshold, older than
  the anti-thrash minimum) is DEMOTED to the host tier
  (``ModelMeshInstance.demote_surplus_copy``) rather than cold-dropped:
  a demand reversal re-warms in ~9 ms instead of re-paying the ~82 ms
  store load. The shedder election is the legacy janitor's (newest copy
  holder sheds) so exactly one instance acts per cycle.
- **Predictive pre-warming**: the leader feeds a ``DemandForecaster``
  from its per-model rates and publishes a small pre-warm plan into the
  KV (``<prefix>/autoscale/prewarm``); every instance's tick reads the
  plan and, when listed as a target, stages a host-tier snapshot
  streamed from a live holder (``WeightTransferManager.prewarm_host``)
  so the coming ramp is absorbed by the re-warm path.
- **Accountability**: every decision lands in the flight recorder
  (``autoscale-up`` / ``autoscale-down`` / ``autoscale-prewarm-plan`` /
  ``autoscale-prewarmed``), increments its counter metric, and is
  appended to the bounded ``decisions`` log (signal snapshot → action)
  that sim scenarios and tests assert against.

Composition with admission control (``MM_ADMISSION``): sheds are never
recorded into the SLO window (serving/admission.py), so the burn the
controller reads reflects *served* traffic only — sheds are not double
counted. The controller additionally treats classes the admission
controller is actively throttling as pressured at HALF the burn
threshold: a shed is demand the fleet dropped, and more copies may turn
it back into served traffic.

The controller is owned by ``BackgroundTasks`` (serving/tasks.py) and
ticked from one dedicated task thread; ``MM_AUTOSCALE`` selects exactly
one scaling authority — ``legacy`` (default: rate task + janitor
scale-down, this controller absent), ``burn`` (this controller; the
legacy scalers are suppressed), or ``off`` (no scaling at all).

KNOWN LIMITATION (ROADMAP item 4 follow-up): the burn signal is the
LEADER's local SLO window — completions recorded at the external entry
hop of the leader itself. Under an entry-traffic distribution that
bypasses the leader entirely (sticky affinity LBs), a fleet-wide breach
is invisible to scale-up until some of that traffic enters the leader.
Per-class fleet burn aggregation (piggybacked like the mm-load
feedback) is the designed successor; until then, front doors should
spread external entry across instances — which routing already wants
for load-balance reasons, and which every in-repo proof arranges.
"""

from __future__ import annotations

import json
import logging
from typing import TYPE_CHECKING, Optional

from modelmesh_tpu_torch.autoscale.forecast import DemandForecaster
from modelmesh_tpu_torch.observability.metrics import Metric as MX
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.lockdebug import mm_lock

if TYPE_CHECKING:  # pragma: no cover
    from modelmesh_tpu_torch.serving.instance import ModelMeshInstance

log = logging.getLogger(__name__)

MODES = ("legacy", "burn", "off")

# Surplus-copy anti-thrash bounds shared with the legacy janitor
# (serving/tasks.py) — imported lazily there to avoid a cycle, so the
# values are restated here with the same provenance (reference :249).
DEFAULT_SURPLUS_MIN_AGE_MS = 7 * 60_000
DEFAULT_MAX_DECISIONS = 256


class AutoscaleConfig:
    """Resolved controller knobs (utils/envs.py registry; every field
    overridable for tests/benches/scenarios)."""

    def __init__(
        self,
        burn_up: Optional[float] = None,
        burn_flash: float = 2.0,
        burn_down: Optional[float] = None,
        min_burn_samples: int = 5,
        idle_ticks_down: int = 3,
        max_models_per_tick: int = 4,
        holddown_ms: Optional[int] = None,
        max_copies: Optional[int] = None,
        scale_up_rpm: Optional[int] = None,
        surplus_min_age_ms: int = DEFAULT_SURPLUS_MIN_AGE_MS,
        prewarm: Optional[bool] = None,
        prewarm_targets: int = 2,
        prewarm_ratio: float = 1.5,
        prewarm_min_rate: float = 1.0,
        prewarm_horizon_s: float = 60.0,
        prewarm_per_tick: int = 2,
    ):
        from modelmesh_tpu_torch.utils import envs

        if burn_up is None:
            burn_up = envs.get_float("MM_AUTOSCALE_BURN_UP")
        if burn_down is None:
            burn_down = envs.get_float("MM_AUTOSCALE_BURN_DOWN")
        if holddown_ms is None:
            holddown_ms = envs.get_int("MM_AUTOSCALE_HOLDDOWN_MS")
        if prewarm is None:
            prewarm = envs.get_bool("MM_AUTOSCALE_PREWARM")
        self.burn_up = float(burn_up)
        self.burn_flash = float(burn_flash)
        self.burn_down = float(burn_down)
        self.min_burn_samples = int(min_burn_samples)
        self.idle_ticks_down = int(idle_ticks_down)
        self.max_models_per_tick = int(max_models_per_tick)
        self.holddown_ms = int(holddown_ms)
        # None = inherit the fleet's TaskConfig values (BackgroundTasks
        # resolves them before building the controller) so the per-model
        # ceiling the controller enforces and the one the copy_bounds
        # invariant checks cannot silently diverge; an explicit value is
        # a deliberate per-use pin. Standalone construction (tests,
        # direct controller drives) resolves the library defaults.
        self.max_copies = int(max_copies) if max_copies is not None else 8
        self.scale_up_rpm = (
            int(scale_up_rpm) if scale_up_rpm is not None else 2000
        )
        self._max_copies_pinned = max_copies is not None
        self._scale_up_rpm_pinned = scale_up_rpm is not None
        self.surplus_min_age_ms = int(surplus_min_age_ms)
        self.prewarm = bool(prewarm)
        self.prewarm_targets = int(prewarm_targets)
        self.prewarm_ratio = float(prewarm_ratio)
        self.prewarm_min_rate = float(prewarm_min_rate)
        self.prewarm_horizon_s = float(prewarm_horizon_s)
        self.prewarm_per_tick = int(prewarm_per_tick)


def prewarm_plan_key(kv_prefix: str) -> str:
    return f"{kv_prefix}/autoscale/prewarm"


class AutoscaleController:
    """One instance's autoscale participant. Decision state is mutated
    from the owning task thread (single-writer, like the rate-task
    bookkeeping), with two exceptions owned by the pre-warm worker on
    the cleanup pool: the ``_prewarming`` discard and the
    ``autoscale-prewarmed`` decision append. Those two fields are
    guarded by ``_mu`` — the decision-log trim is a len-then-del
    compound and the in-flight check is check-then-act, neither of
    which GIL atomicity covers across the two threads. Cross-thread
    readers (tests, dumps) still take GIL-atomic snapshots of the
    bounded ``decisions`` list without the lock."""

    def __init__(
        self,
        instance: "ModelMeshInstance",
        config: Optional[AutoscaleConfig] = None,
    ):
        self.instance = instance
        self.cfg = config or AutoscaleConfig()
        self.forecaster = DemandForecaster()
        # class -> burn rate at the previous tick (trend detection).
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._last_burn: dict[str, float] = {}
        # class -> consecutive calm ticks (burn <= burn_down).
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._calm: dict[str, int] = {}
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._ticks = 0
        # model -> (hold_until_ms, copies_at_decision): suppress re-adds
        # until the previous add either landed (copy count moved) or the
        # hold expired (the add failed / got stuck).
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._hold: dict[str, tuple[int, int]] = {}
        # Admission-shed pressure: served-traffic burn must not double
        # count sheds (they never enter the SLO window), but a non-zero
        # shed delta IS demand the fleet dropped — scale-up eligibility
        # for throttled classes halves its burn threshold.
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._last_shed_count = 0
        # Last published pre-warm plan JSON (leader); avoids a KV write
        # per tick when nothing changed. Reset on every leadership GAIN
        # (see tick): the KV may hold a previous leader's plan, and a
        # re-elected leader whose recomputed plan happens to equal its
        # own LAST published one would otherwise skip the write and
        # leave the interim leader's stale plan standing.
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._published_plan: Optional[str] = None
        #: shared-ok: single-writer task-thread state (tick cadence owns all writes)
        self._was_leader = False
        # Guards the two fields shared between the tick thread and the
        # pre-warm worker on the cleanup pool.
        self._mu = mm_lock("AutoscaleController._mu")
        # Models with a pre-warm fetch currently in flight on the
        # cleanup pool (added on the tick thread, discarded by the
        # worker in a finally).
        #: guarded-by: _mu
        self._prewarming: set[str] = set()
        # Bounded decision log: (ts_ms, kind, fields) — the signal
        # snapshot → action record tests and scenarios read. Appended
        # from the tick thread and (for autoscale-prewarmed) the
        # pre-warm worker.
        #: guarded-by: _mu
        self.decisions: list[dict] = []

    # ------------------------------------------------------------------ #
    # tick                                                               #
    # ------------------------------------------------------------------ #

    def tick(self) -> None:
        inst = self.instance
        if inst.shutting_down or inst.draining:
            return
        self._ticks += 1
        now = get_clock().now_ms()
        shed_pressure = self._shed_delta() > 0
        pressured = self._read_burn(now, shed_pressure)
        if inst.is_leader:
            if not self._was_leader:
                self._published_plan = None  # fresh mandate: re-publish
            self._was_leader = True
            self._feed_forecaster(now)
            if pressured:
                self._scale_up(now, pressured, shed_pressure)
            if self.cfg.prewarm:
                self._publish_prewarm_plan(now)
        else:
            self._was_leader = False
        self._scale_down(now)
        if self.cfg.prewarm:
            self._apply_prewarm_plan(now)

    # ------------------------------------------------------------------ #
    # signals                                                            #
    # ------------------------------------------------------------------ #

    def _shed_delta(self) -> int:
        ac = getattr(self.instance, "admission_controller", None)
        if ac is None:
            return 0
        count = ac.shed_count
        delta = count - self._last_shed_count
        self._last_shed_count = count
        return max(delta, 0)

    def _throttled_classes(self) -> set[str]:
        ac = getattr(self.instance, "admission_controller", None)
        if ac is None:
            return set()
        return set(ac.throttled_classes())

    def _read_burn(self, now: int, shed_pressure: bool) -> dict[str, float]:
        """Per-class burn snapshot; returns the PRESSURED classes
        (burning at/above threshold and not improving, or actively
        admission-throttled under shed pressure). Also maintains the
        per-class calm-tick counters the scale-down side reads."""
        slo = self.instance.slo
        throttled = self._throttled_classes() if shed_pressure else set()
        pressured: dict[str, float] = {}
        for cls in slo.classes():
            snap = slo.attainment(cls)
            prev = self._last_burn.get(cls)
            self._last_burn[cls] = snap.burn_rate
            if snap.burn_rate <= self.cfg.burn_down:
                self._calm[cls] = self._calm.get(cls, 0) + 1
            else:
                self._calm[cls] = 0
            if snap.requests < self.cfg.min_burn_samples:
                continue
            threshold = self.cfg.burn_up
            if cls in throttled:
                # Admission is already dropping this class's demand:
                # pressure at half the threshold (the shed signal feeds
                # scaling without double-counting into burn).
                threshold *= 0.5
            not_improving = prev is None or snap.burn_rate >= prev
            if snap.burn_rate >= threshold and (
                not_improving or snap.burn_rate >= 1.0
            ):
                pressured[cls] = snap.burn_rate
        return pressured

    def _feed_forecaster(self, now: int) -> None:
        """Feed leader-local rates — only for models with SOME demand
        history here (positive rate now, or already tracked, so their
        decay is observed too). Feeding every idle registry entry would
        churn the forecaster's bounded map at fleet scale (tens of
        thousands of zero-rate models evicting each other's history
        every tick) while contributing nothing a zero-history model
        doesn't already mean."""
        inst = self.instance
        fc = self.forecaster
        seen: set[str] = set()
        for model_id, mr in inst.registry_view.items():
            seen.add(model_id)
            rate = inst.model_rpm(model_id)
            if model_id in fc:
                fc.observe(model_id, rate, now_ms=now)
            elif rate > 0:
                # First sighting with traffic: seed a ZERO baseline at
                # this instant — the real rate lands next tick and
                # reads as the ramp-from-nothing it is (seeding with
                # the rate itself would set fast == slow and the ramp
                # could never trend).
                fc.observe(model_id, 0.0, now_ms=now)
        # Unregistered models leave the forecaster promptly: a deleted
        # hot model's frozen-high fast EWMA (it only decays on observe)
        # would otherwise sit in every trending() result — and one of
        # the bounded slots — until LRU eviction.
        for model_id in fc.tracked():
            if model_id not in seen:
                fc.drop(model_id)

    # ------------------------------------------------------------------ #
    # reactive scale-up (leader)                                         #
    # ------------------------------------------------------------------ #

    def _scale_up(
        self, now: int, pressured: dict[str, float], shed_pressure: bool,
    ) -> None:
        inst = self.instance
        cfg = self.cfg
        slo = inst.slo
        n_live = max(len(inst.cluster_view().instances), 1)
        copy_cap = min(cfg.max_copies, n_live)
        # Hottest members of the pressured classes first (leader-local
        # rate, then registry-persisted recency, then id — the id tie
        # break keeps iteration deterministic under replay).
        candidates = []
        for model_id, mr in inst.registry_view.items():
            cls = slo.resolve_class(mr.model_type or "")
            if cls not in pressured:
                continue
            if mr.copy_count >= copy_cap:
                continue
            if mr.loading_instances:
                continue  # an add is already materializing
            candidates.append(
                (-inst.model_rpm(model_id), -mr.last_used, model_id, mr, cls)
            )
        candidates.sort(key=lambda t: (t[0], t[1], t[2]))
        acted = 0
        for _rpm_neg, _lu_neg, model_id, mr, cls in candidates:
            if acted >= cfg.max_models_per_tick:
                break
            copies = mr.copy_count
            hold = self._hold.get(model_id)
            if hold is not None and now < hold[0] and copies <= hold[1]:
                continue  # previous add neither landed nor expired
            burn = pressured[cls]
            desired = copies * 2 if burn >= cfg.burn_flash else copies + 1
            desired = min(desired, copy_cap)
            adds = desired - copies
            if adds <= 0:
                continue
            try:
                inst.ensure_loaded(
                    model_id, sync=False,
                    exclude=set(mr.all_placements), chain=adds - 1,
                )
            except Exception as e:  # noqa: BLE001 — advisory, like legacy
                log.debug("autoscale add of %s skipped: %s", model_id, e)
                continue
            acted += 1
            self._hold[model_id] = (now + cfg.holddown_ms, copies)
            self._record(
                "autoscale-up", now, model=model_id, slo_class=cls,
                burn=round(burn, 3), copies=copies, adds=adds,
                shed_pressure=shed_pressure,
            )
            inst.metrics.inc(MX.AUTOSCALE_UP_COUNT, model_id=model_id)
            log.info(
                "autoscale: +%d cop%s of %s (class %s burn %.2f)",
                adds, "y" if adds == 1 else "ies", model_id, cls, burn,
            )
        # Expired holds are pruned so the map stays bounded by churn.
        for mid in [m for m, (t, _) in self._hold.items() if now >= t]:
            del self._hold[mid]

    # ------------------------------------------------------------------ #
    # reversible scale-down (every instance)                             #
    # ------------------------------------------------------------------ #

    def _calm_ticks(self, cls: str) -> int:
        """Calm streak for ``cls``; a class that never recorded a
        completion here has been calm for as long as we have ticked."""
        return self._calm.get(cls, self._ticks)

    def _scale_down(self, now: int) -> None:
        from modelmesh_tpu_torch.serving.tasks import (
            CLUSTER_FULL_FRACTION,
            cluster_fullness,
            elected_shedder,
            surplus_shed_eligible,
        )

        inst = self.instance
        cfg = self.cfg
        slo = inst.slo
        # Per-type subset fullness, memoized per pass (the legacy
        # janitor's capacity valve): a nearly-full candidate pool sheds
        # surplus even when the class never goes calm — demotion is
        # cheap and reversible, and without the valve a busy class
        # would pin the cluster full with no pressure release (the
        # behavior legacy's cluster-full scale-down provided).
        fullness: dict = {}

        def subset_full(model_type) -> bool:
            if inst.constraints is None:
                model_type = None
            f = fullness.get(model_type)
            if f is None:
                f = fullness[model_type] = cluster_fullness(inst, model_type)
            return f >= CLUSTER_FULL_FRACTION

        for model_id in inst.cache.keys():
            mr = inst.registry_view.get(model_id)
            # Shared eligibility + shedder election (serving/tasks.py):
            # ONE definition for both scaling authorities, so the
            # legacy janitor's rules and this controller's cannot fork.
            if not surplus_shed_eligible(
                inst, model_id, mr, now,
                cfg.surplus_min_age_ms, cfg.scale_up_rpm,
            ):
                continue
            if mr.loading_instances:
                # An add is materializing RIGHT NOW (most likely the
                # leader's own scale-up): demoting while copies are
                # still landing is the add/demote churn loop — every
                # cycle pays a transfer for nothing.
                continue
            cls = slo.resolve_class(mr.model_type or "")
            calm = self._calm_ticks(cls) >= cfg.idle_ticks_down
            if not calm and not subset_full(mr.model_type):
                continue  # neither calm nor capacity-pressured
            if elected_shedder(mr) != inst.instance_id:
                continue
            if not inst.demote_surplus_copy(model_id):
                continue
            rpm = inst.model_rpm(model_id)
            self._record(
                "autoscale-down", now, model=model_id, slo_class=cls,
                copies=len(mr.instance_ids), rpm=rpm,
                reason="calm" if calm else "full",
            )
            inst.metrics.inc(MX.AUTOSCALE_DOWN_COUNT, model_id=model_id)
            log.info(
                "autoscale: demoted surplus copy of %s to the host tier "
                "(%s, %d rpm)", model_id,
                "class calm" if calm else "capacity pressure", rpm,
            )

    # ------------------------------------------------------------------ #
    # predictive pre-warming                                             #
    # ------------------------------------------------------------------ #

    def _prewarm_plan(self, now: int) -> dict[str, list[str]]:
        """model -> target instance ids that should stage a host-tier
        snapshot ahead of forecast demand. Only models with at least one
        servable copy qualify (the snapshot streams from a holder), and
        targets are live non-holders without a host claim."""
        inst = self.instance
        cfg = self.cfg
        live = sorted(iid for iid, _ in inst.cluster_view().instances)
        plan: dict[str, list[str]] = {}
        for model_id in self.forecaster.trending(
            min_rate=cfg.prewarm_min_rate, ratio=cfg.prewarm_ratio,
            horizon_s=cfg.prewarm_horizon_s, now_ms=now,
        ):
            if len(plan) >= cfg.max_models_per_tick:
                break
            mr = inst.registry_view.get(model_id)
            if mr is None or not mr.instance_ids:
                continue
            covered = set(mr.all_placements) | set(mr.host_instances)
            targets = [iid for iid in live if iid not in covered]
            if targets:
                plan[model_id] = targets[: cfg.prewarm_targets]
        return plan

    def _publish_prewarm_plan(self, now: int) -> None:
        inst = self.instance
        plan = self._prewarm_plan(now)
        # A fresh leader (first tick: _published_plan is None) always
        # writes, even an empty plan: the KV may still hold a DEAD
        # leader's plan, and skipping the retraction would keep the
        # whole fleet pre-warming models nobody forecasts anymore.
        raw = json.dumps(plan, sort_keys=True)
        if raw == self._published_plan:
            return
        try:
            inst.store.put(
                prewarm_plan_key(inst.config.kv_prefix), raw.encode()
            )
        except Exception as e:  # noqa: BLE001 — advisory; next tick retries
            log.debug("prewarm plan publish failed: %s", e)
            return
        self._published_plan = raw
        if plan:
            self._record(
                "autoscale-prewarm-plan", now,
                models=len(plan),
                targets=sum(len(t) for t in plan.values()),
            )

    def _apply_prewarm_plan(self, now: int) -> None:
        """Every instance: stage host snapshots this tick's plan assigns
        to us (bounded per tick). The actual chunked fetch runs on the
        instance's cleanup pool, NOT the tick thread — a multi-GB
        transfer inline here would starve the reactive scale-up the
        controller exists to provide."""
        inst = self.instance
        try:
            kv = inst.store.get(prewarm_plan_key(inst.config.kv_prefix))
        except Exception:  # noqa: BLE001 — KV outage: next tick retries
            return
        if kv is None:
            return
        try:
            plan = json.loads(kv.value.decode())
        except ValueError:
            return
        done = 0
        for model_id in sorted(plan):
            if done >= self.cfg.prewarm_per_tick:
                break
            if inst.instance_id not in plan[model_id]:
                continue
            with self._mu:
                in_flight = model_id in self._prewarming
            if in_flight:
                continue  # a fetch is already in flight
            if inst.cache.get_quietly(model_id) is not None:
                continue  # a device copy landed meanwhile
            if inst.host_tier.peek(model_id) is not None:
                # Already staged — but re-claim if the advertisement is
                # missing (the claim CAS can lose against registry churn;
                # this IS the "next pre-warm pass re-claims" path).
                mr = inst.registry_view.get(model_id)
                if mr is not None and inst.instance_id not in (
                    mr.host_instances
                ):
                    inst._claim_host_copy(model_id)
                continue
            done += 1
            with self._mu:
                self._prewarming.add(model_id)
            inst._cleanup_pool.submit(self._prewarm_one, model_id)

    def _prewarm_one(self, model_id: str) -> None:
        """Pre-warm worker (cleanup pool): one fetch + claim + record."""
        inst = self.instance
        try:
            if inst.prewarm_host_copy(model_id):
                self._record(
                    "autoscale-prewarmed", get_clock().now_ms(),
                    model=model_id,
                )
                inst.metrics.inc(MX.AUTOSCALE_PREWARM_COUNT,
                                 model_id=model_id)
                log.info("autoscale: pre-warmed host tier for %s", model_id)
        except Exception as e:  # noqa: BLE001 — best-effort; next tick
            # re-plans (and the sender may simply be gone)
            log.debug("pre-warm of %s failed: %s", model_id, e)
        finally:
            with self._mu:
                self._prewarming.discard(model_id)

    # ------------------------------------------------------------------ #
    # accountability                                                     #
    # ------------------------------------------------------------------ #

    def _record(self, kind: str, now: int, **fields) -> None:
        self.instance.flightrec.record(kind, **fields)
        with self._mu:
            self.decisions.append({"ts_ms": now, "kind": kind, **fields})
            if len(self.decisions) > DEFAULT_MAX_DECISIONS:
                del self.decisions[
                    : len(self.decisions) - DEFAULT_MAX_DECISIONS
                ]
