"""The port's own copy of the JAX package's ``serving/entry.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Model-copy lifecycle: cache entries, the loading pool, unload accounting.

Parity targets in the reference core:
- CacheEntry state machine NEW -> QUEUED -> WAITING -> LOADING -> SIZING ->
  ACTIVE | FAILED | REMOVED (ModelMesh.java:1838-1848, CacheEntry :1632)
- priority loading queue with limited concurrency (loadingPool :504,
  CacheEntry.run :2145)
- load timeout with diagnostic capture (scheduleTimeoutForLoad :2308-2336)
- unload-buffer accounting: space freed by eviction is unusable until the
  runtime confirms the unload, and loads block (bounded) waiting for it
  (ModelCacheUnloadBufManager.java; waitForSpaceToLoad :2271-2305)
- per-entry invocation gating for latency-based autoscaling
  (MaxConcCacheEntry :2641-2797)
"""

from __future__ import annotations

import enum
import heapq
import logging
import threading
import traceback
from typing import Callable, Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.runtime.spi import (
    CACHE_UNIT_BYTES,
    LoadedModel,
    ModelInfo,
    ModelLoader,
    ModelLoadException,
)
from modelmesh_tpu_torch.utils.lockdebug import mm_condition, mm_lock
from modelmesh_tpu_torch.utils import racedebug

log = logging.getLogger(__name__)

# Initial nominal weight before prediction/sizing (units).
INSERTION_WEIGHT_UNITS = 8
# Max time a queued load waits for unloads to free space (reference: 3 min).
DEFAULT_SPACE_WAIT_S = 180.0


class EntryState(enum.Enum):
    NEW = "new"
    QUEUED = "queued"
    WAITING = "waiting"      # waiting for unload space
    LOADING = "loading"
    SIZING = "sizing"
    # Serve-before-fully-loaded (layer-streamable families only): enough
    # layers of a streamed transfer have landed to admit requests, while
    # the tail of the stream is still arriving. Servable AND still
    # loading; finalizes to ACTIVE when the stream completes (or FAILED/
    # REMOVED like any in-flight load).
    PARTIAL = "partial"
    # One shard of a multi-instance placement GROUP (sharded execution):
    # this copy holds 1/shard_count of the model's weights and is
    # servable — but only as a member of a COMPLETE group, a condition
    # the ROUTING layer enforces from the registry record (the entry
    # cannot see its peers). Terminal like ACTIVE: the shard is fully
    # materialized; group membership changes arrive as registry events
    # that REMOVE the entry, never as state regressions.
    SHARDED = "sharded"
    ACTIVE = "active"
    FAILED = "failed"
    REMOVED = "removed"

    @property
    def is_terminal(self) -> bool:
        return self in (
            EntryState.ACTIVE, EntryState.SHARDED,
            EntryState.FAILED, EntryState.REMOVED,
        )

    @property
    def is_loading(self) -> bool:
        return self in (
            EntryState.QUEUED, EntryState.WAITING,
            EntryState.LOADING, EntryState.SIZING, EntryState.PARTIAL,
        )

    @property
    def is_servable(self) -> bool:
        """Requests may execute against this copy (fully loaded, a
        partial streamed copy past its serve threshold, or a shard of a
        complete group — group completeness is the router's check)."""
        return self in (
            EntryState.ACTIVE, EntryState.PARTIAL, EntryState.SHARDED,
        )


@racedebug.tracked("state")
class CacheEntry:
    """One local copy of a model. Thread-safe via its own lock; completion
    is observed through ``wait_active``. Under MM_RACE_DEBUG=1 every
    ``state`` write is epoch-checked against the happens-before clocks —
    a transition that bypasses ``_lock`` raises ``DataRaceViolation``."""

    def __init__(
        self,
        model_id: str,
        info: ModelInfo,
        weight_units: int = INSERTION_WEIGHT_UNITS,
        last_used: Optional[int] = None,
    ):
        self.model_id = model_id
        self.info = info
        self.weight_units = weight_units
        self.last_used = last_used if last_used is not None else now_ms()
        # Every transition goes through the ONE funnel (PR-8): bare
        # writes would skip the terminal-state check, the cv broadcast,
        # and the flight-recorder event — the state-funnel rule flags
        # them.
        #: state-funnel: _transition_locked
        self.state = EntryState.NEW  #: guarded-by: _lock [rebind]
        self.error: Optional[str] = None  #: guarded-by: _lock
        self.loaded: Optional[LoadedModel] = None
        self.queued_ms: Optional[int] = None
        self.load_started_ms: Optional[int] = None
        self.load_completed_ms: Optional[int] = None
        self._lock = mm_lock("CacheEntry._lock")
        self._done = threading.Event()
        # Broadcast on EVERY state transition (not just terminal ones):
        # load waiters sleep on this instead of polling, waking exactly
        # when the entry moves — activation, failure, removal, or an
        # intermediate phase change that re-bases their timeout budget
        # (QUEUED -> LOADING starts the per-type load clock).
        self._state_cv = mm_condition("CacheEntry._state_cv", self._lock)
        self._sem: Optional[threading.Semaphore] = None  #: guarded-by: _lock
        # True once begin_partial installed a provisional runtime copy
        # (sticky — survives later state transitions; see _load_failed).
        self.partial_started = False
        # Sharded-execution shard metadata (set at insert time by
        # _load_local when the registry assigns this instance a shard;
        # immutable for the entry's lifetime — a re-plan REPLACES the
        # entry rather than mutating it). shard_index < 0 = unsharded.
        self.shard_index = -1
        self.shard_count = 0
        self.group_epoch = 0
        # Observability linkage, attached by the owning instance at
        # insert time: every state transition is recorded into the
        # flight recorder, and a load inherits the initiating request's
        # trace context (observability/tracing.py).
        self.recorder = None  # FlightRecorder | None
        self.trace_id = ""
        self.trace_parent = ""
        self.max_concurrency = 0
        self.inflight = 0  #: guarded-by: _lock
        self.total_invocations = 0  #: guarded-by: _lock
        # EWMA of invocation latency (ms); drives the latency-based
        # autoscaling threshold (reference MaxConcCacheEntry bandwidth
        # estimate, ModelMesh.java:2641-2797).
        self.avg_latency_ms = 0.0
        self._latency_samples = 0

    @property
    def is_shard(self) -> bool:
        return self.shard_index >= 0

    # bandwidth_rpm() stays 0 until this many samples — the first call often
    # includes cold-start/compile time and must not collapse the threshold.
    MIN_LATENCY_SAMPLES = 20

    def record_latency(self, ms: float, alpha: float = 0.1) -> None:
        self._latency_samples += 1
        if self._latency_samples == 1:
            # Discard the very first sample entirely (cold start/compile).
            return
        prev = self.avg_latency_ms
        self.avg_latency_ms = ms if prev == 0 else (1 - alpha) * prev + alpha * ms

    def bandwidth_rpm(self) -> int:
        """Estimated sustainable requests/min of this copy: concurrency
        slots / average service time. 0 = unknown (insufficient latency
        data or no concurrency limit)."""
        if (
            self.avg_latency_ms <= 0
            or self.max_concurrency <= 0
            or self._latency_samples < self.MIN_LATENCY_SAMPLES
        ):
            return 0
        return int(60_000.0 / self.avg_latency_ms * self.max_concurrency)

    # -- state ------------------------------------------------------------

    def _transition_locked(self, new: EntryState) -> None:
        prev = self.state
        self.state = new
        if new.is_terminal:
            self._done.set()
        self._state_cv.notify_all()
        # Flight-recorder hook (the single funnel every transition takes):
        # the stripe lock nests INSIDE CacheEntry._lock and the recorder
        # never takes entry locks, so the edge is acyclic.
        rec = self.recorder
        if rec is not None:
            rec.record("state", model=self.model_id, frm=prev.value,
                       to=new.value)

    def try_transition(self, new: EntryState) -> bool:
        """Advance to a non-terminal loading state unless already terminal
        (e.g. REMOVED by a concurrent eviction). Loader threads must use this
        so eviction-during-load is never clobbered."""
        with self._lock:
            if self.state.is_terminal:
                return False
            self._transition_locked(new)
            return True

    def claim_chain_fire(self) -> bool:
        """Atomically claim the one-shot chained-fan-out trigger: True for
        exactly ONE caller across every path that can fire the chain
        (claim-time, ride-a-loading-entry, servable hit, completion) —
        a plain check-then-set raced when two async requests rode the
        same in-flight load."""
        with self._lock:
            if getattr(self, "_chain_fired", False):
                return False
            self._chain_fired = True
            return True

    def begin_partial(self, loaded: LoadedModel) -> bool:
        """Admit requests on a partially-streamed copy: install the
        (already-servable) provisional handle and move to PARTIAL. Returns
        False when the entry is already terminal (evicted/failed mid-
        stream) — the caller abandons the early-serve and lets the stream
        outcome decide. Idempotent-ish: a second call just refreshes the
        handle."""
        with self._lock:
            if self.state.is_terminal:
                return False
            self.loaded = loaded
            # Sticky: a provisional runtime copy is resident from here on,
            # even if a later eviction moves the STATE off PARTIAL — the
            # failure path keys its unload on this, not on the state.
            self.partial_started = True
            if loaded.max_concurrency and self._sem is None:
                self.max_concurrency = loaded.max_concurrency
                self._sem = threading.Semaphore(loaded.max_concurrency)
            self._transition_locked(EntryState.PARTIAL)
            return True

    def complete_load(self, loaded: LoadedModel) -> bool:
        """Finalize to ACTIVE unless removed meanwhile. Returns False if the
        entry was removed — caller must release the runtime copy."""
        return self._complete(loaded, EntryState.ACTIVE)

    def complete_shard(self, loaded: LoadedModel) -> bool:
        """Finalize a shard load to SHARDED (the sharded-execution analog
        of ``complete_load``). Returns False if the entry was removed —
        caller must release the runtime shard."""
        return self._complete(loaded, EntryState.SHARDED)

    def _complete(self, loaded: LoadedModel, final: EntryState) -> bool:
        with self._lock:
            if self.state.is_terminal:
                return False
            self.loaded = loaded
            self.load_completed_ms = now_ms()
            if loaded.max_concurrency and self._sem is None:
                # Keep a semaphore installed at PARTIAL time: requests may
                # already hold slots on it — swapping would leak permits.
                self.max_concurrency = loaded.max_concurrency
                self._sem = threading.Semaphore(loaded.max_concurrency)
            self._transition_locked(final)
            return True

    def fail(self, message: str) -> None:
        with self._lock:
            if self.state.is_terminal:
                return
            self.error = message
            self._transition_locked(EntryState.FAILED)

    def remove(self) -> None:
        with self._lock:
            self._transition_locked(EntryState.REMOVED)

    def wait_active(self, timeout_s: float) -> bool:
        """True if ACTIVE (or SHARDED) within the timeout; False on
        timeout. Raises ModelLoadException if the entry FAILED."""
        if not self._done.wait(timeout_s):
            return False
        if self.state is EntryState.FAILED:
            raise ModelLoadException(self.error or "load failed")
        return self.state in (EntryState.ACTIVE, EntryState.SHARDED)

    def await_transition(
        self, known: EntryState, timeout_s: float
    ) -> EntryState:
        """Event-driven wait: block until the state is no longer ``known``
        (any transition wakes us — the condition broadcasts on every
        advance) or the timeout elapses; returns the state seen on wake.
        Load waiters use this instead of a fixed-cadence poll, so wakeup
        latency is notification latency, not poll-interval slack."""
        with self._state_cv:
            if self.state is known and timeout_s > 0:
                get_clock().cond_wait(self._state_cv, timeout_s)
            return self.state

    # -- invocation gating ---------------------------------------------------

    def before_invoke(
        self, timeout_s: Optional[float] = None, cancel_event=None,
    ) -> bool:
        with self._lock:
            sem = self._sem
        if sem is not None:
            if cancel_event is None:
                if not sem.acquire(timeout=timeout_s or 30.0):
                    return False
            else:
                # Interruptible acquire: a cancelled client must stop
                # queueing for the slot immediately.
                import time as _t

                deadline = _t.monotonic() + (timeout_s or 30.0)  #: wall-clock: slices a REAL semaphore acquire at cancel-check cadence; the waker is a real thread's release, not virtual time
                acquired = False
                while not acquired:
                    if cancel_event.is_set():
                        return False
                    remaining = deadline - _t.monotonic()  #: wall-clock: same wall bound as above
                    if remaining <= 0:
                        return False
                    acquired = sem.acquire(timeout=min(0.05, remaining))
        with self._lock:
            self.inflight += 1
            self.total_invocations += 1
        return True

    def after_invoke(self) -> None:
        with self._lock:
            self.inflight -= 1
            sem = self._sem
        if sem is not None:
            sem.release()


class PrioritizedLoadingPool:
    """Fixed-thread pool draining a priority queue of load tasks.

    Priority: loads with a waiting request run before preemptive/chained
    loads; ties broken by most-recently-used (reference priority queue at
    ModelMesh.java:504, 2108-2116).
    """

    def __init__(self, concurrency: int = 8, name: str = "loader"):
        #: guarded-by: _cv
        self._heap: list[tuple[tuple, int, Callable[[], None]]] = []
        self._cv = mm_condition("PrioritizedLoadingPool._cv")
        self._seq = 0  #: guarded-by: _cv
        self._shutdown = False  #: guarded-by: _cv
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(concurrency)
        ]
        for t in self._threads:
            t.start()

    def submit(
        self, task: Callable[[], None], *, urgent: bool, last_used: int
    ) -> None:
        key = (0 if urgent else 1, -last_used)
        with self._cv:
            if self._shutdown:
                raise RuntimeError("loading pool is shut down")
            self._seq += 1
            heapq.heappush(self._heap, (key, self._seq, task))
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, task = heapq.heappop(self._heap)
            try:
                task()
            except Exception:
                log.error("load task crashed:\n%s", traceback.format_exc())

    def shutdown(self, drain: bool = False) -> None:
        with self._cv:
            self._shutdown = True
            if not drain:
                self._heap.clear()
            self._cv.notify_all()


class UnloadTracker:
    """Accounting for in-flight unloads: evicted space isn't reusable until
    the runtime confirms release. Loads block on ``wait_for_space``.

    The reference implements this as a buffer entry inside the cache sharing
    the eviction lock; here the cache reports its own weight and we track
    the pending-unload units beside it — same invariant:
        cache_weight + pending_unload_units <= capacity_units.

    The reference's borrow/repay weight adjustment
    (ModelCacheUnloadBufManager.adjustNewEntrySpaceRequest:152 — revising a
    loading entry's space claim when sizing changes the estimate) has no
    separate mechanism here because the decomposition covers it: a mid-load
    grow goes through WeightedLRUCache.update_weight, which evicts others to
    keep cache_weight <= capacity; those evictions enter pending-unload
    accounting; and every later load re-checks ``wait_for_space`` at its own
    WAITING stage, so new work blocks until the displaced space is actually
    released. The transient accounting catch-up after an
    underestimated-then-loaded model is unavoidable in ANY design — the
    runtime has already physically allocated the real size by the time it is
    known — and the runtime's own capacity enforcement backstops it.
    """

    def __init__(self, capacity_units: int):
        self.capacity_units = capacity_units
        self._pending_units = 0  #: guarded-by: _cv
        self._cv = mm_condition("UnloadTracker._cv")

    @property
    def pending_units(self) -> int:
        return self._pending_units

    def unload_started(self, units: int) -> None:
        with self._cv:
            self._pending_units += units

    def unload_finished(self, units: int) -> None:
        with self._cv:
            self._pending_units = max(0, self._pending_units - units)
            self._cv.notify_all()

    def wait_for_space(
        self, cache_weight_fn: Callable[[], int], need_units: int,
        timeout_s: float = DEFAULT_SPACE_WAIT_S,
    ) -> bool:
        """Block until need_units fit beside cache weight + pending unloads."""
        clock = get_clock()
        deadline = clock.monotonic() + timeout_s
        with self._cv:
            while (
                cache_weight_fn() + self._pending_units + need_units
                > self.capacity_units
            ):
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    return False
                clock.cond_wait(self._cv, min(remaining, 1.0))
            return True


def bytes_to_units(size_bytes: int) -> int:
    return max(1, (size_bytes + CACHE_UNIT_BYTES - 1) // CACHE_UNIT_BYTES)
