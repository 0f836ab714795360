"""The port's own copy of the JAX package's ``serving/route_cache.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Load-aware fused routing: candidate-set memo + power-of-d choices.

The PR-2 route cache memoized a *single* greedy winner per model. Under
skewed (Zipf) traffic that herds every request at the cached target
while sibling copies idle — the winner only changes when the registry
record version, instances epoch, or warming bucket moves, none of which
react to load on the sub-second timescale queues build at. RouteBalance
(PAPERS.md) is the fix this module implements: routing and load
balancing fused at the per-request decision, still amortized off the
request path.

Structure:

- ``RouteCache`` now caches the ranked candidate *set* (greedy order,
  as exported by ``GreedyStrategy.rank_serve_candidates``) under the
  same validity keys as before: registry record version × instances
  epoch × warming-clock bucket. A hit costs two dict lookups plus the
  d-choices pick below.
- ``LoadView`` holds per-instance load feedback piggybacked on Forward
  responses (the responder's in-flight count, its batch-queue depth,
  and a drain flag — serving/instance.py captures it in ``_forward``).
  Scores DECAY with staleness (``MM_FEEDBACK_DECAY_MS``): an instance
  we haven't heard from recently scores toward 0, so the pick degrades
  gracefully toward the greedy prior instead of acting on stale load.
- The pick is **anchored power-of-d choices** (``MM_ROUTE_D``): the
  greedy winner (rank 0) is always a candidate, plus d-1 distinct
  uniformly sampled others; the request goes to the sampled candidate
  with the lowest capability-weighted load score, ties broken by greedy
  rank. Consequences that matter:
    * MM_ROUTE_D=1 → always rank 0 → bit-identical to the old
      single-winner cache (the regression-pinned parity mode).
    * No feedback yet (or all decayed) → every score is 0 → rank 0
      wins → identical to the greedy prior. d-choices only *deviates*
      from greedy when live load evidence says the winner is busier.
    * DRAINING candidates keep their rank-behind-healthy semantics
      (reconfig/): the pick key orders (draining, score, rank), so a
      draining copy wins only when every sampled candidate drains.
- **Capability weights** normalize load scores by the instance's
  advertised capacity (InstanceRecord.capacity_units — the PR-7
  record): at equal queue depth a 2× capacity hardware generation
  scores half as loaded, so mixed fleets get proportional traffic.
- **Failed-forward demotion**: a forward failure demotes the failed
  candidate WITHIN the cached set (moved behind the survivors, plus a
  decaying LoadView penalty) instead of dropping the whole entry —
  dropping would make every concurrent retry recompute the same
  greedy ranking and re-herd the thundering retry at one survivor.
  With MM_ROUTE_D=1 the old invalidate behavior is kept (parity).

Concurrency: the hit path stays lock-free — candidate entries and
LoadView slots are whole-tuple dict reads/writes (GIL-atomic), so a
racing store can never expose a half-updated record; the striped locks
only serialize read-modify-write merges of feedback slots, and the
cache-level lock only the rare wholesale reset.

Knobs (utils/envs.py): ``MM_ROUTE_CACHE``, ``MM_ROUTE_CACHE_TTL_MS``,
``MM_ROUTE_D``, ``MM_FEEDBACK_DECAY_MS``.
"""

from __future__ import annotations

import random
import zlib
from typing import Optional, Sequence

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.utils.lockdebug import mm_lock
from modelmesh_tpu_torch.utils import racedebug

DEFAULT_TTL_MS = 1_000
# Distinct model ids cached before a wholesale reset; a cache, not a
# registry mirror — resets only cost the next request per model one
# recompute.
DEFAULT_MAX_MODELS = 8_192

# Load-score units: one in-flight request == 1.0. The demotion penalty
# dwarfs any plausible queue so a freshly-failed candidate loses every
# pick until the penalty decays (or the entry is rebuilt on the epoch
# bump its failure usually causes).
FAIL_PENALTY = 1_000.0
# A peer reporting drain/PARTIAL in its feedback is biased against
# modestly — the candidate set's own draining flag (epoch-fed) is the
# authoritative rank-behind-healthy ordering; this just reacts a watch
# round-trip earlier.
DRAIN_BIAS = 4.0

_N_STRIPES = 8


class LoadFeedback:
    """One piggybacked load report from a peer (Forward response trailer
    on the wire, a direct attribute on the sim/bench transports)."""

    __slots__ = ("instance_id", "in_flight", "queue_depth", "draining")

    def __init__(self, instance_id: str, in_flight: int, queue_depth: int,
                 draining: bool = False):
        self.instance_id = instance_id
        self.in_flight = in_flight
        self.queue_depth = queue_depth
        self.draining = draining

    def encode(self) -> str:
        """Wire form for the mm-load response trailer."""
        return (
            f"{self.in_flight},{self.queue_depth},"
            f"{1 if self.draining else 0}"
        )

    @classmethod
    def decode(cls, instance_id: str, raw: str) -> Optional["LoadFeedback"]:
        try:
            inflight_s, depth_s, drain_s = raw.split(",")
            return cls(
                instance_id, int(inflight_s), int(depth_s),
                drain_s.strip() == "1",
            )
        except (ValueError, AttributeError):
            return None  # malformed trailer: feedback is advisory


class LoadView:
    """Per-instance load scores: piggybacked feedback + own outstanding.

    Two signals compose the score:

    - **Piggybacked feedback** (the responder's in-flight/queue-depth
      report): authoritative but stale by one round trip, so it decays
      linearly to 0 over ``decay_ms`` — silence means "no evidence",
      not "still as loaded as last reported".
    - **Own outstanding forwards** (``begin``/``end`` around every
      Forward dispatch): the sender's zero-staleness view of the load
      IT is creating. Without it, every thread that just read the same
      feedback herds at the same 'least loaded' peer until the next
      response returns (the classic stale-feedback oscillation the
      power-of-d literature warns about); with it, concurrent picks
      from one sender spread immediately.

    The hot-path read is two dict probes (an immutable slot tuple
    ``(ts_ms, load, fail_ts_ms)`` plus the pending counter) — no lock.
    Writers merge under a striped lock (note() must not clobber a
    concurrent demote's fail stamp and vice versa) and publish by
    rebinding whole values.
    """

    __slots__ = (
        "decay_ms", "_slots", "_pending", "_locks", "notes", "demotions",
    )

    def __init__(self, decay_ms: Optional[int] = None):
        if decay_ms is None:
            from modelmesh_tpu_torch.utils import envs

            decay_ms = envs.get_int("MM_FEEDBACK_DECAY_MS")
        self.decay_ms = max(int(decay_ms), 1)
        # iid -> (ts_ms, load, fail_ts_ms); whole-tuple rebinds only.
        # [rebind]: slot reads/installs are deliberately lock-free
        # (GIL-atomic dict ops on immutable tuples); the striped locks
        # below serialize only the read-modify-write merges.
        #: guarded-by: _locks [rebind]
        self._slots: dict[str, tuple[int, float, int]] = {}
        # iid -> count of OUR forwards currently in flight to the peer.
        # [rebind]: same convention — int rebinds under the stripe lock,
        # lock-free reads.
        #: guarded-by: _locks [rebind]
        self._pending: dict[str, int] = {}
        self._locks = [
            mm_lock("LoadView._locks") for _ in range(_N_STRIPES)
        ]
        # Racy plain-int stats (diagnostics, not accounting).
        self.notes = 0
        self.demotions = 0

    def _lock_for(self, iid: str):
        return self._locks[zlib.crc32(iid.encode()) & (_N_STRIPES - 1)]

    def begin(self, iid: str) -> None:
        """A forward to ``iid`` is being dispatched."""
        with self._lock_for(iid):
            self._pending[iid] = self._pending.get(iid, 0) + 1

    def end(self, iid: str) -> None:
        """The forward completed (any outcome)."""
        with self._lock_for(iid):
            cur = self._pending.get(iid, 0)
            if cur > 1:
                self._pending[iid] = cur - 1
            else:
                self._pending.pop(iid, None)

    def note(self, fb: LoadFeedback, now: Optional[int] = None) -> None:
        """Record one piggybacked report (the Forward return path)."""
        now = now if now is not None else now_ms()
        load = float(fb.in_flight + fb.queue_depth)
        if fb.draining:
            load += DRAIN_BIAS
        with self._lock_for(fb.instance_id):
            prev = self._slots.get(fb.instance_id)
            fail_ts = prev[2] if prev is not None else 0
            self._slots[fb.instance_id] = (now, load, fail_ts)
        self.notes += 1

    def demote(self, iid: str, now: Optional[int] = None) -> None:
        """Stamp a forward failure: a decaying penalty that makes the
        candidate lose every d-choices pick while fresh."""
        now = now if now is not None else now_ms()
        with self._lock_for(iid):
            prev = self._slots.get(iid)
            ts, load = (prev[0], prev[1]) if prev is not None else (0, 0.0)
            self._slots[iid] = (ts, load, now)
        self.demotions += 1

    def score(self, iid: str, now: Optional[int] = None) -> float:
        """Decayed load score; 0.0 = no (fresh) evidence — the greedy
        prior. Single dict probe on the hot path."""
        score = float(self._pending.get(iid, 0))
        slot = self._slots.get(iid)
        if slot is None:
            return score
        now = now if now is not None else now_ms()
        ts, load, fail_ts = slot
        if load > 0.0:
            age = now - ts
            if age < self.decay_ms:
                score += load * (1.0 - age / self.decay_ms)
        if fail_ts:
            fail_age = now - fail_ts
            if fail_age < self.decay_ms:
                score += FAIL_PENALTY * (1.0 - fail_age / self.decay_ms)
        return score

    def staleness_ms(self, now: Optional[int] = None) -> Optional[int]:
        """Age of the OLDEST tracked feedback slot (diagnostics/gauge);
        None when nothing has been heard at all."""
        now = now if now is not None else now_ms()
        ages = [now - ts for ts, _load, _f in self._slots.values() if ts]
        return max(ages) if ages else None

    # Fully-decayed slots linger this many decay windows before pruning
    # (kept briefly for diagnostics; pruned so churned/replaced peers —
    # fresh uuid ids every rolling restart — can't grow the map and the
    # per-instance gauge series without bound).
    PRUNE_AFTER_DECAYS = 3

    def prune(self, now: Optional[int] = None) -> list[str]:
        """Drop slots whose every signal has fully decayed and that have
        no outstanding forwards — called on the publisher cadence, never
        from the request path. Returns the pruned instance ids so the
        caller can retire their per-instance gauge series too."""
        now = now if now is not None else now_ms()
        horizon = self.decay_ms * self.PRUNE_AFTER_DECAYS
        dead = [
            iid for iid, (ts, _load, fail_ts) in list(self._slots.items())
            if now - ts >= horizon and now - fail_ts >= horizon
        ]
        pruned: list[str] = []
        for iid in dead:
            with self._lock_for(iid):
                slot = self._slots.get(iid)
                if (
                    slot is not None
                    and now - slot[0] >= horizon
                    and now - slot[2] >= horizon
                    and iid not in self._pending
                ):
                    del self._slots[iid]
                    pruned.append(iid)
        return pruned

    def clear(self) -> None:
        for lock in self._locks:
            lock.acquire()
        try:
            self._clear_locked()
        finally:
            for lock in self._locks:
                lock.release()

    def _clear_locked(self) -> None:
        """Caller holds every stripe lock."""
        self._slots = {}
        self._pending = {}

    def __len__(self) -> int:
        return len(self._slots)


class ServeCandidate:
    """One ranked serve candidate exported by the placement strategy.

    ``weight`` is the capability weight (normalized advertised capacity;
    1.0 = fleet-typical) and ``loading`` marks the ride-a-loading-copy
    fallback pick, which never participates in d-choices (there is
    nothing to balance — the ranked set is that single copy)."""

    __slots__ = ("iid", "draining", "weight", "loading")

    def __init__(self, iid: str, draining: bool = False,
                 weight: float = 1.0, loading: bool = False):
        self.iid = iid
        self.draining = draining
        self.weight = weight if weight > 0 else 1.0
        self.loading = loading

    def __repr__(self) -> str:  # tests/diagnostics
        flags = "".join(
            f for f, on in (("d", self.draining), ("l", self.loading)) if on
        )
        return f"<{self.iid}{':' + flags if flags else ''} w={self.weight:g}>"


@racedebug.tracked("_by_model")
class RouteCache:
    """Candidate-set memo + anchored power-of-d pick.

    Lock-free on the hit path: entry reads/installs are single dict
    operations on immutable tuples (GIL-atomic); the lock only guards
    the rare size-cap reset. Validity is carried in the entry and
    checked against caller-supplied inputs, so a racing store can never
    make a lookup return candidates whose inputs don't match."""

    __slots__ = (
        "enabled", "ttl_ms", "max_models", "route_d", "load_view", "_rng",
        "_by_model", "_lock", "hits", "misses", "invalidations",
    )

    def __init__(
        self,
        enabled: Optional[bool] = None,
        ttl_ms: Optional[int] = None,
        max_models: int = DEFAULT_MAX_MODELS,
        route_d: Optional[int] = None,
        feedback_decay_ms: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        if enabled is None or ttl_ms is None or route_d is None:
            from modelmesh_tpu_torch.utils import envs

            if enabled is None:
                enabled = envs.get_bool("MM_ROUTE_CACHE")
            if ttl_ms is None:
                ttl_ms = envs.get_int("MM_ROUTE_CACHE_TTL_MS")
            if route_d is None:
                route_d = envs.get_int("MM_ROUTE_D")
        self.enabled = enabled
        self.ttl_ms = max(int(ttl_ms), 1)
        self.max_models = max_models
        self.route_d = max(int(route_d), 1)
        self.load_view = LoadView(decay_ms=feedback_decay_ms)
        # Seeded sampler (det-entropy rule): the d-choices draw is load
        # balancing, not security — a fixed default seed keeps
        # single-threaded tests reproducible; owners wanting per-process
        # spread pass a seed derived from the instance id.
        self._rng = random.Random(seed if seed is not None else 0xD0)
        # model_id -> {exclusion_sig: (candidates, record_version,
        #                              view_epoch, clock_bucket)}
        # [rebind]: inner-map writes are deliberately lock-free (GIL-
        # atomic dict ops; validity is carried in the entry) — only the
        # wholesale resets rebind the dict, and those are guarded.
        #: guarded-by: _lock [rebind]
        self._by_model: dict[str, dict[frozenset, tuple]] = {}
        self._lock = mm_lock("RouteCache._lock")
        # Plain-int stats (racy under contention, monotone enough for
        # bench/diagnostics — not billing).
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def _bucket(self, now: Optional[int]) -> int:
        return (now if now is not None else now_ms()) // self.ttl_ms

    # -- candidate-set entries ------------------------------------------- #

    def lookup(
        self,
        model_id: str,
        sig: frozenset,
        record_version: int,
        view_epoch: int,
        now: Optional[int] = None,
    ) -> Optional[tuple[ServeCandidate, ...]]:
        """Cached candidate set, or None when absent/any validity input
        moved. The caller picks with :meth:`pick`."""
        sigs = self._by_model.get(model_id)
        entry = sigs.get(sig) if sigs is not None else None
        if (
            entry is not None
            and entry[1] == record_version
            and entry[2] == view_epoch
            and entry[3] == self._bucket(now)
        ):
            self.hits += 1
            return entry[0]
        self.misses += 1
        return None

    def store(
        self,
        model_id: str,
        sig: frozenset,
        record_version: int,
        view_epoch: int,
        candidates: Sequence[ServeCandidate],
        now: Optional[int] = None,
    ) -> None:
        if len(self._by_model) >= self.max_models:
            with self._lock:
                if len(self._by_model) >= self.max_models:
                    self._by_model = {}
        entry = (
            tuple(candidates), record_version, view_epoch, self._bucket(now),
        )
        sigs = self._by_model.setdefault(model_id, {})
        # Signatures per model stay tiny (the trivial external signature
        # plus a handful of multi-hop variants); cap defensively so a
        # pathological exclusion churn can't grow one model's map.
        if len(sigs) >= 16:
            sigs.clear()
        sigs[sig] = entry

    # -- the pick --------------------------------------------------------- #

    def pick(
        self,
        candidates: Sequence[ServeCandidate],
        now: Optional[int] = None,
    ) -> Optional[str]:
        """Anchored power-of-d choice over a ranked candidate set.

        Rank 0 (the greedy winner) is always sampled; d-1 distinct
        others join uniformly. The winner minimizes (draining,
        weighted-load-score, rank): zero/decayed scores reduce to the
        greedy prior, MM_ROUTE_D=1 reduces to exactly the old
        single-winner behavior, and a DRAINING candidate only wins when
        the whole sample drains."""
        n = len(candidates)
        if n == 0:
            return None
        first = candidates[0]
        if n == 1 or self.route_d == 1 or first.loading:
            return first.iid
        lv = self.load_view
        if not lv._slots and not lv._pending:
            # No load evidence anywhere: every sample would tie at 0 and
            # the anchor would win by rank — skip the draw entirely. The
            # uncontended hit path costs what the single-winner cache
            # cost.
            return first.iid
        d = min(self.route_d, n)
        if d == 2:
            # The common case, kept cheap: anchor + ONE uniform draw
            # (random.sample's set machinery costs more than the whole
            # ranking walk it replaces).
            r = self._rng.randrange(1, n)
            sample = ((0, first), (r, candidates[r]))
        elif d >= n:
            sample = tuple(enumerate(candidates))
        else:
            sample = ((0, first),) + tuple(
                (i, candidates[i])
                for i in self._rng.sample(range(1, n), d - 1)
            )
        now = now if now is not None else now_ms()
        best = None
        best_key = None
        for rank, cand in sample:
            key = (cand.draining, lv.score(cand.iid, now) / cand.weight, rank)
            if best_key is None or key < best_key:
                best_key, best = key, cand
        return best.iid

    # -- invalidation / demotion ------------------------------------------ #

    def invalidate(self, model_id: str) -> None:
        if self._by_model.pop(model_id, None) is not None:
            self.invalidations += 1

    def demote(self, model_id: str, iid: str) -> None:
        """A forward to ``iid`` just failed. Demote it WITHIN every
        cached candidate set for the model — surviving candidates keep
        their relative ranking, so concurrent retries spread over them
        instead of re-herding at one recomputed winner — and stamp the
        decaying LoadView penalty so d-choices avoids it everywhere.
        With MM_ROUTE_D=1 the pick always takes rank 0, so parity with
        the old cache requires the old behavior: drop the entry."""
        self.load_view.demote(iid)
        if self.route_d == 1:
            self.invalidate(model_id)
            return
        sigs = self._by_model.get(model_id)
        if not sigs:
            return
        for sig, entry in list(sigs.items()):
            cands = entry[0]
            if not any(c.iid == iid for c in cands):
                continue
            keep = [c for c in cands if c.iid != iid]
            failed = [c for c in cands if c.iid == iid]
            sigs[sig] = (tuple(keep + failed),) + entry[1:]

    def clear(self) -> None:
        with self._lock:
            self._by_model = {}
        self.load_view.clear()

    def __len__(self) -> int:
        return len(self._by_model)
