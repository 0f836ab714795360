"""The port's own copy of the JAX package's ``serving/tasks.py``
(the port imports nothing of that package); names and behaviour
are the reference's. The leader reaper's plan work (the reference's
``_reaper_tick`` up to its gauges, ``tasks.py:480-502``) is the function
``reaper_plan_step``, which returns what it read as a ``PlanStep``;
``BackgroundTasks._reaper_tick`` calls it and runs the gauges, the
prune pass and proactive loading on the records and views it returns.

Background tasks: publisher, rate-tracking scaler, janitor, leader reaper.

The autonomous layer of every instance (reference scheduled tasks,
ModelMesh.java:1151-1172; behaviors in SURVEY.md section 3.5):

- publisher: refresh our InstanceRecord advertisement periodically (40 s in
  the reference; configurable here).
- rate task (10 s): per-model scale-up — the 1->2 "used again" pattern and
  the RPM-threshold N>2 rule (rateTrackingTask :5619-5806, default
  threshold 2000 RPM per copy, :240).
- janitor (6 min): local cache <-> registry reconciliation in both
  directions, failure-record expiry, lazy lastUsed persistence, and
  cluster-full scale-down of surplus copies (:5876-6379).
- reaper (7 min, leader only): prune registrations pointing at instances
  gone >10 min (:6524-6608), drop stale loading claims, and proactive
  loading of recently-used-but-unloaded models into free space
  (:6616-6747). The reaper consults the PlacementStrategy, so the
  global plan slots in here.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import weakref
from typing import NamedTuple, Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.kv.store import CasFailed
from modelmesh_tpu_torch.placement.plan_sync import publish_plan
from modelmesh_tpu_torch.records import ModelRecord
from modelmesh_tpu_torch.serving.entry import EntryState
from modelmesh_tpu_torch.serving.instance import ModelMeshInstance
from modelmesh_tpu_torch.utils.clock import get_clock

log = logging.getLogger(__name__)

DEFAULT_SCALE_UP_RPM = 2000          # per copy (reference :240)
SECOND_COPY_MIN_AGE_MS = 7 * 60_000  # "used again" window (reference :249)
SECOND_COPY_MAX_AGE_MS = 40 * 60_000
ASSUME_INSTANCE_GONE_MS = 10 * 60_000   # reaper prune grace (reference :270)
STALE_LOADING_CLAIM_MS = 20 * 60_000    # loading claim with no progress
CLUSTER_FULL_FRACTION = 0.95            # scale-down trigger (reference :6197)
# Surplus-copy lifetime bounds (reference :249-257): never shed a copy
# younger than the min (anti-thrash with the scale-up window); a low-traffic
# surplus copy older than the 10 h cap sheds even when the cluster isn't
# full.
SURPLUS_COPY_MIN_AGE_MS = 7 * 60_000
SURPLUS_COPY_MAX_AGE_MS = 10 * 3600_000
PROACTIVE_RESERVE_FRACTION = 0.125      # keep 12.5% free (reference :6616)


def cluster_fullness(inst, model_type: Optional[str] = None) -> float:
    """Fullness over the candidate subset for ``model_type`` (per-label
    subset stats, InstanceSetStatsTracker.java:17-40) — global fullness
    is wrong in heterogeneous clusters: a full GPU-labeled pool must
    trigger scale-down of GPU models even while CPU pools sit empty,
    and vice versa. Shared by the legacy janitor and the autoscale
    controller's capacity valve."""
    views = list(inst.instances_view.items())
    constraints = inst.constraints
    if model_type is not None and constraints is not None:
        subset = [
            (i, r) for i, r in views
            if constraints.is_candidate(model_type, r.labels)
        ]
        views = subset or views
    cap = sum(r.capacity_units for _, r in views) or 1
    used = sum(r.used_units for _, r in views)
    return used / cap


def surplus_shed_eligible(
    inst, model_id: str, mr: ModelRecord, now: int, min_age_ms: int,
    scale_up_rpm: int,
) -> bool:
    """The surplus-copy predicate BOTH scaling authorities share (the
    legacy janitor's cluster-full scale-down and the autoscale
    controller's calm-class demotion — one definition so their
    eligibility rules cannot fork): this instance holds one of >= 2
    READY copies (a copy still loading elsewhere must not license
    dropping the sole active one), the copy is past the anti-thrash
    minimum age, and OUR local traffic is well under the per-copy
    threshold (< 2/3 of it, reference :6197-6379 — symmetric with
    scale-up)."""
    if mr is None or len(mr.instance_ids) < 2:
        return False
    our_ts = mr.instance_ids.get(inst.instance_id)
    if our_ts is None:
        return False
    if now - our_ts < min_age_ms:
        return False
    return inst.model_rpm(model_id) < scale_up_rpm * 2 // 3


def elected_shedder(mr: ModelRecord) -> str:
    """Shedder election shared by both scaling authorities: the NEWEST
    copy's holder (tie-break id) sheds — keeps the established copy and
    rotates fairly as newest changes, unlike highest-id-always-sheds
    which skews one instance forever."""
    return max(mr.instance_ids.items(), key=lambda kv: (kv[1], kv[0]))[0]


class TaskConfig:
    def __init__(
        self,
        publish_interval_s: float = 40.0,
        rate_interval_s: float = 10.0,
        janitor_interval_s: float = 360.0,
        reaper_interval_s: float = 420.0,
        scale_up_rpm: int = DEFAULT_SCALE_UP_RPM,
        second_copy_min_age_ms: int = SECOND_COPY_MIN_AGE_MS,
        second_copy_max_age_ms: int = SECOND_COPY_MAX_AGE_MS,
        assume_gone_ms: int = ASSUME_INSTANCE_GONE_MS,
        max_copies: int = 8,
        jitter_frac: float = 0.1,
        autoscale_mode: Optional[str] = None,
        autoscale_interval_s: float = 10.0,
        autoscale=None,
    ):
        self.publish_interval_s = publish_interval_s
        self.rate_interval_s = rate_interval_s
        self.janitor_interval_s = janitor_interval_s
        self.reaper_interval_s = reaper_interval_s
        self.scale_up_rpm = scale_up_rpm
        self.second_copy_min_age_ms = second_copy_min_age_ms
        self.second_copy_max_age_ms = second_copy_max_age_ms
        self.assume_gone_ms = assume_gone_ms
        self.max_copies = max_copies
        # Cadence jitter (fraction of the interval, 0 disables): each tick
        # waits interval*(1 ± U[0,jitter]), and the FIRST tick is phase-
        # shifted by U[0,1)*interval — both drawn from a per-(instance,
        # task) seeded RNG, so a mass-restarted fleet spreads its
        # publisher/janitor KV load instead of thundering in lockstep.
        self.jitter_frac = jitter_frac
        # The ONE copy-scaling authority (MM_AUTOSCALE): "legacy" keeps
        # the rate-task scale-up + janitor cluster-full scale-down
        # exactly as before; "burn" replaces BOTH with the autoscale/
        # controller (its tick rides the same task machinery); "off"
        # disables scaling entirely. Exactly one authority ever runs.
        if autoscale_mode is None:
            from modelmesh_tpu_torch.utils import envs

            autoscale_mode = envs.get("MM_AUTOSCALE") or "legacy"
        from modelmesh_tpu_torch.autoscale.controller import MODES

        if autoscale_mode not in MODES:
            raise ValueError(
                f"MM_AUTOSCALE={autoscale_mode!r} — expected one of {MODES}"
            )
        self.autoscale_mode = autoscale_mode
        self.autoscale_interval_s = autoscale_interval_s
        # Optional AutoscaleConfig override (tests/benches/scenarios);
        # None builds the env-resolved defaults, sharing this config's
        # max_copies and per-copy rate threshold.
        self.autoscale = autoscale


class BackgroundTasks:
    def __init__(
        self, instance: ModelMeshInstance, config: Optional[TaskConfig] = None
    ):
        self.instance = instance
        self.config = config or TaskConfig()
        self._clock = get_clock()
        self._stop = self._clock.new_event()
        self._threads: list[threading.Thread] = []
        # Observability: per-task tick timestamps (clock ms; the FIRST
        # _TICK_LOG_CAP per task). The sim's jitter scenario reads these
        # to assert a mass-restarted fleet doesn't fire in lockstep; each
        # list is appended only by its own task thread.
        self.tick_times: dict[str, list[int]] = {}
        # model_id -> (previous-use timestamp at last rate tick, a
        # WEAK ref to the CacheEntry it was observed on). The entry
        # identity pins the prev-use sample to one model INCARNATION: a
        # delete→re-register inside a rate interval mints a fresh entry,
        # and comparing identities makes the stale timestamp read as "no
        # previous use" instead of fabricating a used-again age that
        # trips a spurious 1->2 scale-up (the serving/tasks.py:184
        # leak). Weak, not strong: a strong ref would pin the dead
        # incarnation's entry (and its loaded-weights handle) until the
        # model is next used; a dead ref simply reads as a fresh
        # incarnation, which is the correct answer anyway.
        self._prev_use: dict[str, tuple[int, object]] = {}
        self._last_rate_tick = now_ms()
        # leader state: instance_id -> first time we noticed it missing.
        self._missing_since: dict[str, int] = {}
        # Autoscale controller (autoscale/controller.py), present only in
        # burn mode — the single non-legacy scaling authority.
        self.autoscaler = None
        if self.config.autoscale_mode == "burn":
            from modelmesh_tpu_torch.autoscale.controller import (
                AutoscaleConfig,
                AutoscaleController,
            )

            import copy as _copy

            asc = self.config.autoscale
            if asc is None:
                asc = AutoscaleConfig()
            # Unpinned controller bounds inherit THIS task config's, so
            # the ceiling the controller enforces and the one the sim's
            # copy_bounds invariant checks are the same number even for
            # scenarios passing an explicit AutoscaleConfig. Resolved on
            # a COPY: the caller's config object may be shared across
            # fleets, and writing through it would make two clusters'
            # controllers last-writer-wins on each other's ceilings.
            asc = _copy.copy(asc)
            if not asc._max_copies_pinned:
                asc.max_copies = self.config.max_copies
            if not asc._scale_up_rpm_pinned:
                asc.scale_up_rpm = self.config.scale_up_rpm
            self.autoscaler = AutoscaleController(instance, asc)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        specs = [
            ("publisher", self.config.publish_interval_s, self._publish_tick),
            ("janitor", self.config.janitor_interval_s, self._janitor_tick),
            ("reaper", self.config.reaper_interval_s, self._reaper_tick),
        ]
        # Exactly one scaling authority: the legacy rate-task scaler OR
        # the burn-rate autoscale controller (or neither, mode "off").
        # The janitor's cluster-full scale-down is gated the same way in
        # _janitor_tick — reconciliation always runs, scale-down only
        # under the legacy authority.
        mode = self.config.autoscale_mode
        if mode == "legacy":
            specs.insert(
                1, ("rate", self.config.rate_interval_s, self._rate_tick)
            )
        elif mode == "burn":
            specs.insert(
                1,
                ("autoscale", self.config.autoscale_interval_s,
                 self._autoscale_tick),
            )
        for name, interval, fn in specs:
            t = threading.Thread(
                target=self._loop, args=(name, interval, fn),
                name=f"task-{name}-{self.instance.instance_id}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    _TICK_LOG_CAP = 64

    # Tasks that mutate the registry skip their cycle when the KV store is
    # unreachable (reference janitor/reaper guard, ModelMesh.java:5886,
    # 6449) — half-applied reconciliation against a flapping store does
    # more harm than a skipped cycle. The autoscale tick qualifies: its
    # decisions CAS the registry (copy adds/demotions) and read/write the
    # pre-warm plan key.
    _NEEDS_KV = frozenset({"janitor", "reaper", "autoscale"})

    def _kv_reachable(self) -> bool:
        try:
            self.instance.store.get(
                f"{self.instance.config.kv_prefix}/__health__"
            )
            return True
        except Exception:  # noqa: BLE001 — any store error counts
            return False

    def _loop(self, name: str, interval: float, fn) -> None:
        # Deterministic per-(instance, task) jitter stream: the seed is the
        # identity, not entropy, so a sim replay sees identical cadences.
        rng = random.Random(f"{self.instance.instance_id}:{name}")
        jitter = max(0.0, self.config.jitter_frac)
        # Initial phase offset — the anti-thundering-herd half: a fleet
        # restarted at the same instant must not fire its first publisher/
        # janitor cycle at the same instant too.
        wait_s = interval * rng.random() if jitter > 0 else interval
        ticks = self.tick_times.setdefault(name, [])
        while not self._clock.wait_event(self._stop, wait_s):
            wait_s = interval * (
                1.0 + jitter * (2.0 * rng.random() - 1.0)
            ) if jitter > 0 else interval
            if len(ticks) < self._TICK_LOG_CAP:
                # Bounded from the FRONT: consumers (the sim's jitter
                # spread check) read the first ticks; later ones are
                # droppable, the earliest never silently evicted.
                ticks.append(now_ms())
            if self.instance.shutting_down:
                return
            if name in self._NEEDS_KV and not self._kv_reachable():
                log.warning("task %s: kv unreachable; skipping cycle", name)
                continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — tasks must not die
                log.exception("task %s failed (cycle aborted)", name)

    # -- publisher ---------------------------------------------------------

    def _publish_tick(self) -> None:
        self.instance.publish_instance_record()

    # -- autoscale controller (burn mode) ----------------------------------

    def _autoscale_tick(self) -> None:
        self.autoscaler.tick()

    # -- rate task: scale UP ----------------------------------------------

    def _rate_tick(self) -> None:
        inst = self.instance
        cfg = self.config
        tick_start = now_ms()
        cutoff = self._last_rate_tick
        self._last_rate_tick = tick_start
        # Prune usage history for models no longer cached here (stale
        # entries leak). Pruning alone cannot catch a model deleted AND
        # re-registered between two ticks (the id is back in the cache by
        # the time we look), so each sample below also carries the
        # CacheEntry it was observed on — a fresh incarnation never
        # inherits the dead one's timestamp.
        cached = set(inst.cache.keys())
        for gone in [k for k in self._prev_use if k not in cached]:
            del self._prev_use[gone]
        for model_id, ce, last_used in inst.cache.items_used_since(cutoff):
            if ce.state is not EntryState.ACTIVE:
                continue
            mr = inst.registry_view.get(model_id)
            if mr is None:
                continue
            copies = mr.copy_count
            prev_sample = self._prev_use.get(model_id)
            prev = (
                prev_sample[0]
                if prev_sample is not None and prev_sample[1]() is ce
                else 0
            )
            self._prev_use[model_id] = (last_used, weakref.ref(ce))
            if copies >= cfg.max_copies:
                continue
            if copies <= 1:
                # 1 -> 2: the model was used a while ago AND is in use now —
                # recurring traffic deserves redundancy.
                age = last_used - prev
                if prev and cfg.second_copy_min_age_ms <= age <= cfg.second_copy_max_age_ms:
                    self._add_copy(model_id, mr)
                    continue
            # Local per-copy rate vs the per-copy threshold (applies at any
            # copy count — a saturated single copy must scale too): each
            # instance sees only its own copy's traffic, so if the copy it
            # serves is at threshold, the model needs another copy
            # (reference rateTrackingTask, ModelMesh.java:5762). In latency
            # mode (runtime declared a per-model concurrency limit) the
            # threshold is dynamic: 90% of this copy's measured bandwidth
            # (reference :719-732).
            rpm = inst.model_rpm(model_id)
            threshold = cfg.scale_up_rpm
            bandwidth = ce.bandwidth_rpm()
            if bandwidth > 0:
                threshold = max(1, int(bandwidth * 0.9))
            if rpm >= threshold:
                self._add_copy(model_id, mr)

    def _add_copy(self, model_id: str, mr: ModelRecord) -> None:
        try:
            self.instance.ensure_loaded(
                model_id, sync=False, exclude=set(mr.all_placements)
            )
            log.info("scale-up: requested extra copy of %s", model_id)
        except Exception as e:  # noqa: BLE001 — advisory
            log.debug("scale-up of %s skipped: %s", model_id, e)

    # -- janitor: reconcile + scale DOWN ----------------------------------

    def _janitor_tick(self) -> None:
        inst = self.instance
        now = now_ms()
        # (a) registry -> local: drop local copies of unregistered models;
        #     repair records that lost our placement entry.
        for model_id in inst.cache.keys():
            ce = inst.cache.get_quietly(model_id)
            if ce is None:
                continue
            mr = inst.registry.get(model_id)
            if mr is None:
                log.info("janitor: %s unregistered; removing local copy", model_id)
                inst._remove_local(model_id)
                continue
            changed = False
            if (
                ce.state is EntryState.ACTIVE
                and inst.instance_id not in mr.instance_ids
            ):
                mr.promote_loaded(inst.instance_id, ce.load_completed_ms or now)
                changed = True
            if mr.expire_load_failures(now):
                changed = True
            # Lazy lastUsed persistence (reference ModelRecord.java:96-105).
            local_last_used = inst.cache.last_used(model_id) or 0
            if mr.should_persist_last_used(local_last_used):
                mr.last_used = local_last_used
                changed = True
            if changed:
                try:
                    inst.registry.conditional_set(model_id, mr)
                except CasFailed:
                    pass
        # (b) local -> registry: records claiming we hold a copy we don't.
        for model_id, mr in inst.registry.items():
            if mr.placed_on(inst.instance_id) and model_id not in inst.cache:
                def fix(cur):
                    if cur is None:
                        return None
                    cur.remove_instance(inst.instance_id)
                    return cur
                try:
                    inst.registry.update_or_create(model_id, fix)
                except CasFailed:
                    pass
        # (c) scale-down when the cluster is nearly full — LEGACY scaling
        # authority only: in burn mode the autoscale controller owns
        # scale-down (demote-to-host); in off mode nothing scales.
        if self.config.autoscale_mode == "legacy":
            self._maybe_scale_down()

    def _cluster_fullness(self, model_type: Optional[str] = None) -> float:
        return cluster_fullness(self.instance, model_type)

    def _maybe_scale_down(self) -> None:
        inst = self.instance
        cfg = self.config
        # Memoize per-type subset fullness for this pass.
        fullness: dict[Optional[str], float] = {}

        def subset_full(model_type: Optional[str]) -> bool:
            if inst.constraints is None:
                model_type = None
            f = fullness.get(model_type)
            if f is None:
                f = fullness[model_type] = self._cluster_fullness(model_type)
            return f >= CLUSTER_FULL_FRACTION

        now = now_ms()
        for model_id in inst.cache.keys():
            mr = inst.registry_view.get(model_id)
            # Shared eligibility (surplus_shed_eligible): >= 2 READY
            # copies, ours past the anti-thrash minimum age, local rate
            # under 2/3 of the per-copy threshold.
            if not surplus_shed_eligible(
                inst, model_id, mr, now,
                SURPLUS_COPY_MIN_AGE_MS, cfg.scale_up_rpm,
            ):
                continue
            age = now - mr.instance_ids[inst.instance_id]
            # Fullness gates ordinary scale-down; a surplus copy past the
            # 10 h cap sheds regardless (reference :257).
            if not subset_full(mr.model_type) and age < SURPLUS_COPY_MAX_AGE_MS:
                continue
            if elected_shedder(mr) == inst.instance_id:
                log.info("scale-down: dropping surplus copy of %s", model_id)
                if inst._remove_local(model_id):
                    # mm_scale_down_count counts surplus copies removed
                    # by WHICHEVER scaling authority is active (the
                    # burn-mode demote path increments it too);
                    # mm_autoscale_down_count is the controller's
                    # decision counter on top.
                    from modelmesh_tpu_torch.observability.metrics import (
                        Metric as _MX,
                    )

                    inst.metrics.inc(_MX.SCALE_DOWN_COUNT,
                                     model_id=model_id)

    # -- reaper (leader only) ---------------------------------------------

    def _reaper_tick(self) -> None:
        inst = self.instance
        if not inst.is_leader:
            self._missing_since.clear()
            return
        # One registry scan + one view snapshot feed the plan refresh, the
        # gauges, the prune pass, and proactive loading below — items() is
        # a full KV range read, unaffordable to repeat per concern at 100k
        # models. When the instance runs the global strategy, the reaper
        # is its refresh cadence: solve one global plan from current state
        # and publish it, so EVERY instance's PlanFollower (instance.py)
        # serves this solve; the routing layer serves decisions from it
        # until the next pass.
        step = reaper_plan_step(
            inst.store, inst.config.kv_prefix, inst.strategy, inst.registry,
            inst.instances_view, inst.model_rpm,
        )
        views, records = step.views, step.records
        live = {iid for iid, _ in views}
        now = now_ms()
        from modelmesh_tpu_torch.observability.metrics import Metric as _MX

        if step.plan is not None:
            # The refresh's host time: snapshot, solve, readback and plan.
            inst.metrics.observe(_MX.PLACEMENT_SOLVE_TIME, step.refresh_ms)
        # Leader-published fleet gauges (reference cluster-scope metrics).
        inst.metrics.set_gauge(_MX.CLUSTER_INSTANCES, len(views))
        inst.metrics.set_gauge(_MX.CLUSTER_MODELS, len(records))
        inst.metrics.set_gauge(
            _MX.CLUSTER_COPIES,
            sum(len(mr.instance_ids) for _, mr in records),
        )
        inst.metrics.set_gauge(
            _MX.CLUSTER_CAPACITY_UNITS,
            sum(r.capacity_units for _, r in views),
        )
        inst.metrics.set_gauge(
            _MX.CLUSTER_USED_UNITS, sum(r.used_units for _, r in views)
        )
        # Track how long each referenced instance has been missing.
        referenced: set[str] = set()
        for _, mr in records:
            referenced |= mr.all_placements
            # Host-tier claims (transfer/ demotions) are peer-fetch
            # sources, not servable placements — but a dead holder's
            # claim must be pruned the same way or receivers keep
            # dialing a ghost before falling back.
            referenced |= set(mr.host_instances)
        for iid in referenced - live:
            self._missing_since.setdefault(iid, now)
        for iid in list(self._missing_since):
            if iid in live:
                del self._missing_since[iid]
        gone = {
            iid for iid, since in self._missing_since.items()
            if now - since >= self.config.assume_gone_ms
        }
        # (a) prune placements on gone instances + stale loading claims.
        # SUPPRESSED in KV-migration read-only mode: holders registered in
        # the OTHER kv store are invisible here and would all look "gone"
        # (reference skips pruning under readOnlyMode, ModelMesh.java:6543).
        if inst.config.read_only:
            self._proactive_load(records, visible_only=live)
            return
        for model_id, mr in records:
            stale_claims = [
                iid for iid, ts in mr.loading_instances.items()
                if iid in gone or (
                    iid not in live and now - ts > STALE_LOADING_CLAIM_MS
                )
            ]
            dead = [iid for iid in mr.instance_ids if iid in gone]
            dead_hosts = [iid for iid in mr.host_instances if iid in gone]
            if not stale_claims and not dead and not dead_hosts:
                continue

            def prune(cur):
                if cur is None:
                    return None
                for iid in stale_claims + dead + dead_hosts:
                    cur.remove_instance(iid)
                return cur

            try:
                inst.registry.update_or_create(model_id, prune)
                log.info(
                    "reaper: pruned %s from %s",
                    stale_claims + dead + dead_hosts, model_id,
                )
            except CasFailed:
                pass
        # (b) proactive loading: restore the most-recently-used unloaded
        #     models into free cluster space, above a reserve.
        self._proactive_load(records)

    def _proactive_load(self, records, visible_only=None) -> None:
        """``visible_only``: in KV-migration read-only mode, placements on
        instances outside OUR instance registry belong to the other store's
        fleet — for load decisions they count as not loaded here (reference
        filters insts to instanceInfo under readOnlyMode,
        ModelMesh.java:6547-6551)."""
        inst = self.instance
        views = inst.instances_view.items()
        cap = sum(r.capacity_units for _, r in views) or 1
        used = sum(r.used_units for _, r in views)
        budget_units = int((cap - used) - cap * PROACTIVE_RESERVE_FRACTION) // 2
        if budget_units <= 0:
            return

        def visible(ids):
            if visible_only is None:
                return ids
            return [i for i in ids if i in visible_only]

        # loading_instances gets the same filter: an other-store (or stale)
        # claim must not block the local load for the whole migration —
        # read-only mode suppresses the pruning that would clear it.
        unloaded = [
            (mr.last_used, model_id, mr)
            for model_id, mr in records
            if not visible(mr.instance_ids) and not visible(mr.loading_instances)
            and not mr.load_exhausted()
        ]
        unloaded.sort(reverse=True, key=lambda t: t[0])
        default_units = 128
        loads = 0
        for last_used, model_id, mr in unloaded:
            if loads >= 8:  # bounded per pass
                break
            cost = mr.size_units or default_units
            if cost > budget_units:
                continue  # next candidate might be smaller
            try:
                inst.ensure_loaded(model_id, last_used_ms=last_used, sync=False)
                budget_units -= cost
                loads += 1
                log.info("reaper: proactive load of %s (%du)", model_id, cost)
            except Exception as e:  # noqa: BLE001 — advisory
                log.debug("proactive load of %s skipped: %s", model_id, e)
                break


class PlanStep(NamedTuple):
    """What one reaper plan step read and did. ``plan`` is None when the
    strategy has no ``refresh`` or the refresh or publish failed
    (``error`` then holds the exception); ``nbytes`` is the published
    size (0 when nothing was published). The ``*_ms`` fields are host
    wall times of the stages."""

    records: list
    views: list
    plan: Optional[object]
    nbytes: int
    error: Optional[BaseException]
    views_ms: float
    scan_ms: float
    refresh_ms: float
    publish_ms: float


def reaper_plan_step(store, kv_prefix: str, strategy, registry,
                     instances_view, rpm_fn=None) -> PlanStep:
    """One reaper pass's plan work (the reference's ``_reaper_tick`` up to
    its gauges): ``instances_view.items()``, ``registry.items()`` (one
    paged scan of the bucketed registry), ``strategy.refresh(records,
    views, rpm_fn)`` and ``publish_plan(store, kv_prefix, plan)``. The
    caller checks that it is the leader."""
    t0 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    views = list(instances_view.items())
    t1 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    records = list(registry.items())
    t2 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    plan = None
    nbytes = 0
    error = None
    t3 = None
    refresh = getattr(strategy, "refresh", None)
    if refresh is not None:
        try:
            plan = refresh(records, views, rpm_fn)
            t3 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
            # Publish so EVERY instance's PlanFollower serves this solve,
            # not just the leader's own strategy.
            nbytes = publish_plan(store, kv_prefix, plan)
        except Exception as e:  # noqa: BLE001 — plan is advisory
            log.exception("global plan refresh/publish failed")
            plan, nbytes, error = None, 0, e
    t4 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    if t3 is None:  # no refresh, or the refresh itself failed
        t3 = t4
    return PlanStep(
        records=records, views=views, plan=plan, nbytes=nbytes, error=error,
        views_ms=(t1 - t0) * 1e3, scan_ms=(t2 - t1) * 1e3,
        refresh_ms=(t3 - t2) * 1e3, publish_ms=(t4 - t3) * 1e3,
    )
