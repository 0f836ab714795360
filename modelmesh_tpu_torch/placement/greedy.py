"""The port's own copy of the JAX package's ``placement/greedy.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Greedy placement: functional re-derivation of the reference heuristics.

Default strategy and the correctness oracle for the JAX strategy. Decision
rules re-derived from (not copied out of) the reference:

- Load placement (cache-miss LB, ModelMesh.java:4757-5004): rank live,
  non-excluded instances by PLACEMENT_ORDER — most free capacity first,
  then oldest cache LRU (cheapest eviction); shortlist everything "close"
  to the best (within a free-space ratio and an LRU window); among the
  shortlist prefer the least busy. If the requester itself is in the
  shortlist, it loads locally (saves a hop).
- Serve balancing (ForwardingLB, ModelMesh.java:4309-4393): among loaded,
  live, non-excluded copies prefer the least busy instance; copies loaded
  long ago are preferred to freshly-loading ones.
"""

from __future__ import annotations

from typing import Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.placement.strategy import (
    LOAD_HERE,
    ClusterView,
    PlacementRequest,
    PlacementStrategy,
)
from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch.reconfig.rolling import upversion_shortlist
from modelmesh_tpu_torch.serving.route_cache import ServeCandidate

# Shortlist thresholds (tunable analogs of the reference's proximity rules).
FREE_SPACE_SHORTLIST_RATIO = 0.75   # candidates with >= 75% of best free
LRU_SHORTLIST_WINDOW_MS = 5 * 60_000
# Warming fallback when no TimeStats is attached (per-type mean+3σ is the
# reference behavior, MM/TimeStats.java used at ModelMesh.java:4351).
# Single source of truth: timestats' no-evidence default.
from modelmesh_tpu_torch.serving.timestats import DEFAULT_EXPECT_MS as RECENT_LOAD_PENALTY_MS  # noqa: E501


class GreedyStrategy(PlacementStrategy):
    def __init__(self, time_stats=None, constraints=None):
        # serving/timestats.TimeStats — attached by the instance so warming
        # penalties and wait-vs-reroute decisions use per-type load times.
        self.time_stats = time_stats
        # serving/constraints.TypeConstraints — `preferred` labels shape the
        # shortlist (TypeConstraintManager.java:242-248): when any shortlist
        # member matches the type's preferred labels, only those compete;
        # otherwise preference is moot and the full shortlist stands.
        self.constraints = constraints

    def _expect_ms(self, model_type: str) -> float:
        if self.time_stats is not None:
            return self.time_stats.expect_ms(model_type)
        return float(RECENT_LOAD_PENALTY_MS)

    def choose_load_target(
        self, req: PlacementRequest, view: ClusterView
    ) -> Optional[str]:
        candidates: list[tuple[str, InstanceRecord]] = [
            (iid, rec)
            for iid, rec in view.placeable()
            if iid not in req.exclude and iid not in req.model.instance_ids
        ]
        if not candidates:
            return None
        with_room = [
            (iid, rec) for iid, rec in candidates
            if rec.free_units >= req.required_units
        ]
        pool = with_room or candidates  # full cluster: evict somewhere
        best_free = max(rec.free_units for _, rec in pool)
        oldest_lru = min(
            (rec.lru_ts or 0) for _, rec in pool
        )
        shortlist = [
            (iid, rec) for iid, rec in pool
            if rec.free_units >= best_free * FREE_SPACE_SHORTLIST_RATIO
            or (rec.lru_ts or 0) <= oldest_lru + LRU_SHORTLIST_WINDOW_MS
        ] or pool
        if self.constraints is not None:
            pref = [
                (iid, rec) for iid, rec in shortlist
                if self.constraints.is_preferred(
                    req.model.model_type, rec.labels
                )
            ]
            if pref:
                shortlist = pref
        # Rolling-upgrade bias (reconfig/rolling.py): while the fleet
        # spans versions, only newest-version instances compete — applied
        # BEFORE the load-here shortcut so a down-version requester can't
        # capture the load and migrate the model backward.
        shortlist = upversion_shortlist(shortlist)
        if any(iid == req.requesting_instance for iid, _ in shortlist):
            return LOAD_HERE
        # Least busy; stable tie-break on free space then id. min() over a
        # key is the single-pass form of sort()[0] (same winner: min is
        # leftmost among key-ties, exactly what a stable sort put first).
        return min(
            shortlist,
            key=lambda p: (p[1].req_per_minute, -p[1].free_units, p[0]),
        )[0]

    def choose_group_targets(
        self, req: PlacementRequest, view: ClusterView,
        shard_count: int, shard_units: int,
    ) -> Optional[dict[str, int]]:
        """Group planning with the same candidate filters as
        ``choose_load_target``: type-constraint preferred labels and the
        rolling-upgrade upversion bias shape the pool before the
        capacity-greedy pick; existing same-index members stay sticky
        (a top-up re-plan must not shuffle landed shards). Atomic: all
        ``shard_count`` distinct members or None."""
        keep: dict[str, int] = {}
        taken: set[int] = set()
        for iid, idx in req.model.shard_instances.items():
            if (
                0 <= idx < shard_count
                and idx not in taken
                and iid not in req.exclude
                and iid in view.live_map
                and not view.live_map[iid].draining
            ):
                keep[iid] = idx
                taken.add(idx)
        pool = [
            (iid, rec) for iid, rec in view.placeable()
            if iid not in req.exclude and iid not in keep
            and rec.free_units >= shard_units
        ]
        if self.constraints is not None:
            pref = [
                (iid, rec) for iid, rec in pool
                if self.constraints.is_preferred(
                    req.model.model_type, rec.labels
                )
            ]
            missing_n = shard_count - len(taken)
            if len(pref) >= missing_n:
                pool = pref
        pool = upversion_shortlist(pool)
        pool.sort(key=lambda p: (-p[1].free_units, p[0]))
        missing = [i for i in range(shard_count) if i not in taken]
        if len(pool) < len(missing):
            return None
        assignments = dict(keep)
        for idx, (iid, _) in zip(missing, pool):
            assignments[iid] = idx
        return assignments

    def choose_serve_target(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ) -> Optional[str]:
        # Shared per-snapshot id->record map (ClusterView caches it across
        # requests); single-pass running-minimum selection — the per-request
        # cost is O(copies), with no dict build and no candidate sort.
        live = view.live_map
        now = now_ms()
        expect = self._expect_ms(model.model_type)
        best_key: Optional[tuple] = None
        best: Optional[str] = None
        for iid, load_ts in model.instance_ids.items():
            if iid in exclude:
                continue
            rec = live.get(iid)
            if rec is None:
                continue
            # DRAINING copies rank behind every healthy one (reconfig/:
            # traffic shifts to survivors the moment their copies are
            # servable) but stay eligible — during the pre-copy window
            # the draining instance may hold the ONLY copy, and serving
            # it is exactly what makes the drain zero-gap. Per-type
            # warming penalty: a slow-loading type stays deprioritized
            # longer after activation than a fast one.
            key = (
                rec.draining, now - load_ts < expect,
                rec.req_per_minute, iid,
            )
            if best_key is None or key < best_key:
                best_key, best = key, iid
        if best is not None:
            return best
        # No READY copy: wait-vs-go-elsewhere on LOADING copies (reference
        # ModelMesh.java:4351). A copy loading for less than the type's
        # mean+3σ is healthy — forward to it and ride its load (a second
        # cold load elsewhere would cost the full load time again). One
        # loading beyond the bound is probably stuck: return None so the
        # cache-miss loop places a fresh copy elsewhere. With no per-type
        # evidence yet, ride unconditionally — the 10s default would call
        # every healthy slow FIRST load stuck and duplicate copies across
        # the fleet on cold start; the target's own flat wait bound
        # still catches genuinely dead loads.
        no_evidence = (
            self.time_stats is not None
            and self.time_stats.samples(model.model_type)
            < self.time_stats.min_samples
        )
        # Longest-elapsed healthy copy: closest to completion, so the
        # forwarded request waits the least. Running max, no list build.
        best_load: Optional[tuple[int, str]] = None
        for iid, claim_ts in model.loading_instances.items():
            if iid in exclude or iid not in live:
                continue
            elapsed = now - claim_ts
            if elapsed <= expect or no_evidence:
                cand = (elapsed, iid)
                if best_load is None or cand > best_load:
                    best_load = cand
        return best_load[1] if best_load is not None else None

    def rank_serve_candidates(
        self, model: ModelRecord, view: ClusterView, exclude: frozenset[str]
    ) -> list[ServeCandidate]:
        """The serve-target ranking as a SET: every eligible ready copy
        in exactly ``choose_serve_target``'s preference order (draining
        behind healthy, warming behind settled, then least busy), with a
        capability weight per candidate — advertised capacity normalized
        against the set's mean, so mixed hardware generations draw
        proportional traffic from the d-choices pick. When no ready copy
        exists, the wait-vs-reroute loading pick (if any) is returned as
        a single ``loading=True`` candidate: the route cache memoizes it
        like the old single-winner cache did but never load-balances it.
        ``rank[0]`` always equals ``choose_serve_target`` on the same
        inputs (parity-pinned in tests/test_route_cache.py) — the two
        must not fork."""
        live = view.live_map
        now = now_ms()
        expect = self._expect_ms(model.model_type)
        ranked: list[tuple[tuple, str, InstanceRecord]] = []
        for iid, load_ts in model.instance_ids.items():
            if iid in exclude:
                continue
            rec = live.get(iid)
            if rec is None:
                continue
            key = (
                rec.draining, now - load_ts < expect,
                rec.req_per_minute, iid,
            )
            ranked.append((key, iid, rec))
        if ranked:
            ranked.sort(key=lambda t: t[0])
            caps = [max(rec.capacity_units, 1) for _, _, rec in ranked]
            mean_cap = sum(caps) / len(caps)
            return [
                ServeCandidate(
                    iid, draining=rec.draining,
                    weight=max(rec.capacity_units, 1) / mean_cap,
                )
                for _, iid, rec in ranked
            ]
        loading = self.choose_serve_target(model, view, exclude)
        if loading is None:
            return []
        return [ServeCandidate(loading, loading=True)]
