"""The port's own copy of the JAX package's ``serving/batching.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Continuous micro-batching in front of the runtime call (the batched
multi-model data plane, ROADMAP item 5).

Everything before this sat AROUND the model call — routing, load
lifecycle, the placement solve — while the runtime SPI executed one
request against one model at a time. This module is the execution layer
between ``ModelMeshInstance._invoke_local`` and the loader:

- **Per-group micro-batch queues.** A request arriving at an idle group
  executes immediately as a zero-copy passthrough (the single-call
  runtime path, byte-identical to the unbatched data plane — no added
  p50 at low load). Requests arriving while a dispatch is in flight park
  in the group's queue; when the in-flight dispatch completes, the head
  of the queue is promoted to batch leader, collects up to
  ``MM_BATCH_MAX`` parked requests (optionally waiting
  ``MM_BATCH_WINDOW_US`` for the batch to fill), and executes the whole
  micro-batch as ONE batched runtime dispatch. That is continuous
  batching: batch size adapts to instantaneous concurrency with no
  timer on the uncontended path.

- **Groups, not just models.** The queue key comes from the loader's
  ``batch_group_key`` — by default the model id (per-model batching);
  a fused-dispatch-capable loader (models/server.py) maps co-located
  same-architecture models of one family onto a shared key, so a
  micro-batch can span MODELS and execute as one stacked
  expert-parallel-style kernel with a per-request model-index route.

- **Exotic entry states.** A PARTIAL (serve-before-fully-loaded) copy is
  batchable only solo: its request never shares a dispatch with
  batch-mates (`solo_only`), mirroring how the rest of the stack treats
  partial copies as not-yet-first-class. Drain (reconfig/drain.py)
  flushes a model's queue before the copy drops so parked requests
  never execute against a released runtime handle.

The queue state machine is deliberately event-driven and leader-based:
the completing dispatcher never executes strangers' requests (its own
caller is waiting on it); it only designates the next leader. Every
parked request is therefore executed by exactly one thread that is
already inside ``submit`` for a request of the same group, and every
dispatch path signals completion in a ``finally`` — a request can wait
only on a live leader chain, never on nothing.

Instrumentation: batch occupancy and fused-group-size histograms, flush
reason counters (full / window / drain + solo passthroughs), and a
flight-recorder event per dispatched batch.
"""

from __future__ import annotations

import logging
import threading
import time as _time
from typing import Callable, Optional

from modelmesh_tpu_torch.observability.metrics import Metric as MX
from modelmesh_tpu_torch.runtime.spi import BatchItem
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.lockdebug import mm_condition, mm_lock

log = logging.getLogger(__name__)

# Cancellation poll slice while parked (same cadence as the load-wait
# slicing in _wait_entry_active): a foreign cancel Event cannot notify
# our per-request Event.
_CANCEL_SLICE_S = 0.25


class BatchCancelled(Exception):
    """The parked request's client disconnected before a leader claimed
    it into a batch. Mapped to RequestCancelledError by the caller."""


class _BatchRequest:
    __slots__ = (
        "model_id", "method", "payload", "headers", "cancel_event",
        "solo_only", "ctx", "event", "result", "err", "lead", "done",
    )

    def __init__(self, model_id, method, payload, headers, cancel_event,
                 solo_only, ctx=None):
        self.ctx = ctx  # opaque caller context (the serving CacheEntry)
        self.model_id = model_id
        self.method = method
        self.payload = payload
        self.headers = headers
        self.cancel_event = cancel_event
        self.solo_only = solo_only
        self.event = threading.Event()
        self.result: Optional[bytes] = None
        self.err: Optional[Exception] = None
        self.lead = False   # guarded by the owning _GroupQueue.lock
        self.done = False

    def to_item(self) -> BatchItem:
        return BatchItem(
            model_id=self.model_id, method=self.method or "",
            payload=self.payload, headers=self.headers,
        )


class _GroupQueue:
    """One micro-batch queue (one model, or one fused family group)."""

    __slots__ = ("key", "lock", "idle_cv", "pending", "in_flight",
                 "in_flight_ids", "drain_flush", "dead")

    def __init__(self, key: str):
        self.key = key
        self.lock = mm_lock("_GroupQueue.lock")
        # Broadcast on every dispatch completion — the drain flush waits
        # on this instead of polling: queue drain progresses in real
        # thread time, so a virtual-clock poll would deadlock
        # direct-tick sims.
        self.idle_cv = mm_condition("_GroupQueue.idle_cv", self.lock)
        self.pending: list[_BatchRequest] = []  #: guarded-by: lock
        self.in_flight = False  #: guarded-by: lock
        # Model ids riding the current dispatch (a fused group serves
        # several models; a flush must wait only for ITS model, not for
        # sibling traffic to stop).
        self.in_flight_ids: list[str] = []  #: guarded-by: lock
        # Count of drain flushes in progress (a drain can flush several
        # fused-sibling models concurrently): while non-zero, leaders
        # skip the fill window so the queue empties as fast as
        # dispatches complete.
        self.drain_flush = 0  #: guarded-by: lock
        # Set when the idle prune removed this queue from the registry.
        # A submit that fetched the queue just before the prune must
        # NOT run on the orphan — a drain flush looks queues up by key
        # and would miss the orphan's traffic, reporting the model
        # quiesced while a request is still in flight.
        self.dead = False  #: guarded-by: lock

    def await_drained(self, model_id: str, timeout_s: float) -> bool:
        """Drain flush: wait until no parked or in-flight request for
        ``model_id`` remains. Bounded by actual dispatch progress, NOT
        whole-queue idleness — a fused group's sibling models may keep
        the queue busy forever. The deadline is REAL time — queue drain
        is driven by live threads, not the (possibly virtual)
        injectable clock; a virtual wait here would deadlock
        direct-tick sims whose queues drain in wall microseconds."""
        deadline = _time.monotonic() + timeout_s  #: wall-clock: real-thread queue drain; a virtual wait would deadlock direct-tick sims
        with self.idle_cv:
            self.drain_flush += 1
            try:
                while (
                    model_id in self.in_flight_ids
                    or any(r.model_id == model_id for r in self.pending)
                ):
                    remaining = deadline - _time.monotonic()  #: wall-clock: real-thread queue drain deadline
                    if remaining <= 0:
                        return False
                    self.idle_cv.wait(remaining)
                return True
            finally:
                self.drain_flush -= 1


class RequestBatcher:
    """The continuous-batching execution layer.

    ``call_one(req) -> bytes`` is the zero-copy passthrough (the
    original single-request runtime call, cancel-capable); ``call_many
    (list[BatchItem], cancel_event) -> list[bytes | Exception]`` is the
    batched dispatch. ``group_key(model_id) -> str`` maps a model onto
    its queue (identity = per-model batching).
    """

    def __init__(
        self,
        call_one: Callable[[_BatchRequest], bytes],
        call_many: Callable[..., list],
        group_key: Optional[Callable[[str], str]] = None,
        batch_max: int = 8,
        window_us: int = 0,
        metrics=None,
        flightrec=None,
    ):
        self._call_one = call_one
        self._call_many = call_many
        self._group_key = group_key or (lambda mid: mid)
        self.batch_max = max(int(batch_max), 1)
        self.window_s = max(int(window_us), 0) / 1e6
        self.metrics = metrics
        self.flightrec = flightrec
        self._queues: dict[str, _GroupQueue] = {}  #: guarded-by: _qlock
        self._qlock = mm_lock("RequestBatcher._qlock")
        # Idle queues are RETAINED up to this bound so steady
        # non-overlapping traffic reuses its queue object instead of
        # paying an allocation plus two global-lock acquisitions per
        # request; past the bound, each completion prunes its own idle
        # queue (the JaxModelStore bounded-cache pattern).
        self.max_idle_queues = 256
        # Counters exposed for tests/benches (monotonic, approximate
        # under concurrency is fine — they feed assertions about "did a
        # batch form", not accounting).
        self.solo_count = 0
        self.batch_count = 0
        self.batched_requests = 0
        # Requests currently parked behind an in-flight dispatch across
        # ALL groups — the queue-depth surface the load-feedback trailer
        # (serving/route_cache.LoadFeedback) reports to routing peers.
        # Parks/claims/withdrawals run under different GROUP locks, so a
        # plain += would drift permanently; the dedicated lock costs one
        # acquire per parked (already-contended-path) request. Read
        # lock-free — it is a point-in-time load signal, not accounting.
        self._depth_lock = mm_lock("RequestBatcher._depth_lock")
        self.parked_total = 0  #: guarded-by: _depth_lock

    # ------------------------------------------------------------------ #
    # submission                                                         #
    # ------------------------------------------------------------------ #

    def submit(
        self, model_id: str, method: Optional[str], payload: bytes,
        headers, cancel_event=None, solo_only: bool = False, ctx=None,
    ) -> bytes:
        """Execute one request through the batch queue. Blocks until the
        request's (possibly shared) dispatch completes; raises whatever
        the dispatch raised for this request."""
        req = _BatchRequest(
            model_id, method, payload, headers, cancel_event, solo_only,
            ctx=ctx,
        )
        key = self._group_key(model_id)
        while True:
            q = self._queue_for(key)
            with q.lock:
                if q.dead:
                    # Lost the race with the idle prune: this object is
                    # no longer reachable by key (flush would miss it) —
                    # fetch the live replacement.
                    continue
                if not q.in_flight and not q.pending:
                    # Idle group: zero-copy passthrough, no queueing, no
                    # window — the uncontended path is byte-identical to
                    # the unbatched data plane.
                    q.in_flight = True
                    q.in_flight_ids = [model_id]
                    passthrough = True
                else:
                    q.pending.append(req)
                    passthrough = False
                    # Nested inside q.lock by convention (every
                    # parked_total adjustment is) so the acquisition
                    # order can never invert.
                    with self._depth_lock:
                        self.parked_total += 1
            break
        if passthrough:
            self.solo_count += 1
            try:
                return self._call_one(req)
            finally:
                self._complete(q)
        return self._park(q, req)

    # ------------------------------------------------------------------ #
    # queue state machine                                                #
    # ------------------------------------------------------------------ #

    def _queue_for(self, key: str) -> _GroupQueue:
        with self._qlock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _GroupQueue(key)
            return q

    def _complete(self, q: _GroupQueue) -> None:
        """A dispatch finished: hand leadership to the queue head (its
        thread wakes inside _park and runs the next micro-batch), or
        prune the now-idle queue so model churn can't grow the dict
        without bound."""
        head = None
        with q.lock:
            q.in_flight = False
            q.in_flight_ids = []
            if q.pending:
                head = q.pending[0]
                head.lead = True
            # Every completion moves per-model membership — wake drain
            # flushes so they can re-check THEIR model, not just full
            # idleness.
            q.idle_cv.notify_all()
        if head is not None:
            head.event.set()
            return
        # Idle queues are retained below the bound (steady low-QPS
        # traffic reuses its queue with no global-lock churn); only
        # under model-churn pressure does the completion prune its own
        # idle entry. The unlocked len() read is a benign race — worst
        # case one slightly early/late prune. Lock order is _qlock ->
        # q.lock (same as flush). The dead flag closes the submit race:
        # a submit that fetched this q before the prune re-checks under
        # q.lock and retries on the live replacement, so flush's by-key
        # lookup always sees every in-flight request.
        if len(self._queues) <= self.max_idle_queues:
            return
        with self._qlock:
            with q.lock:
                if (
                    not q.pending and not q.in_flight
                    and self._queues.get(q.key) is q
                ):
                    q.dead = True
                    del self._queues[q.key]

    def _park(self, q: _GroupQueue, req: _BatchRequest) -> bytes:
        """Follower path: wait to be batched by a leader, or to be
        promoted to leader ourselves."""
        while True:
            if req.cancel_event is not None:
                req.event.wait(_CANCEL_SLICE_S)
            else:
                req.event.wait()
            with q.lock:
                if req.lead:
                    break  # promoted: run the next batch (below)
                if req.done:
                    return self._finish(req)
                if (
                    req.cancel_event is not None
                    and req.cancel_event.is_set()
                    and req in q.pending
                ):
                    # Not yet claimed by any leader: withdraw cleanly.
                    # The withdrawal moves per-model membership, so a
                    # drain flush waiting on this model must re-check —
                    # without the notify it would sleep out its full
                    # timeout.
                    q.pending.remove(req)
                    q.idle_cv.notify_all()
                    with self._depth_lock:
                        self.parked_total -= 1
                    raise BatchCancelled(req.model_id)
            if req.done:
                return self._finish(req)
        return self._lead(q, req)

    def _lead(self, q: _GroupQueue, req: _BatchRequest) -> bytes:
        """Leader path: optionally wait out the fill window, collect a
        micro-batch (self at the head), dispatch it, distribute results,
        then hand off to the next leader."""
        if self.window_s > 0 and not req.solo_only:
            with q.lock:
                need_fill = (
                    not q.drain_flush and len(q.pending) < self.batch_max
                )
            if need_fill:
                # Injectable clock: the sim's virtual window is what the
                # queue/flush scenarios exercise deterministically.
                get_clock().sleep(self.window_s)
        with q.lock:
            assert q.pending and q.pending[0] is req
            q.pending.pop(0)
            batch = [req]
            if not req.solo_only:
                while q.pending and len(batch) < self.batch_max:
                    nxt = q.pending[0]
                    if nxt.solo_only:
                        break  # PARTIAL copies batch only solo
                    batch.append(q.pending.pop(0))
            q.in_flight = True
            q.in_flight_ids = [r.model_id for r in batch]
            with self._depth_lock:
                self.parked_total -= len(batch)
            if len(batch) >= self.batch_max:
                reason = "full"
            elif q.drain_flush:
                reason = "drain"
            else:
                reason = "window"
        try:
            self._dispatch(batch, reason)
        finally:
            for r in batch[1:]:
                r.event.set()
            self._complete(q)
        return self._finish(req)

    def _dispatch(self, batch: list[_BatchRequest], reason: str) -> None:
        """Execute one micro-batch and ALWAYS mark every member done
        (result or error) — an exception escaping with members undone
        would leave their threads spinning on already-set events,
        breaking the completion-in-finally invariant."""
        try:
            self._dispatch_inner(batch, reason)
        except Exception as e:  # noqa: BLE001 — e.g. a raising sink
            for r in batch:
                if not r.done:
                    r.err = e
                    r.done = True

    def _dispatch_inner(self, batch: list[_BatchRequest], reason: str) -> None:
        self.batch_count += 1
        self.batched_requests += len(batch)
        if self.metrics is not None:
            self.metrics.observe(MX.BATCH_OCCUPANCY, float(len(batch)))
            counter = {
                "full": MX.BATCH_FLUSH_FULL_COUNT,
                "window": MX.BATCH_FLUSH_WINDOW_COUNT,
                "drain": MX.BATCH_FLUSH_DRAIN_COUNT,
            }[reason]
            self.metrics.inc(counter)
            models = len({r.model_id for r in batch})
            if models > 1:
                self.metrics.observe(MX.FUSED_GROUP_SIZE, float(models))
        if self.flightrec is not None:
            self.flightrec.record(
                "batch-flush", model=batch[0].model_id, reason=reason,
                size=len(batch),
                models=len({r.model_id for r in batch}),
            )
        # A batch member's cancel event can no longer withdraw it, and a
        # collective dispatch must never be aborted by ONE member's
        # disconnect (it would fail every innocent batch-mate) — so a
        # cancel event reaches the runtime only for a singleton batch,
        # where cancellation can't hurt anyone else.
        cancel = batch[0].cancel_event if len(batch) == 1 else None
        try:
            outs = self._call_many(
                [r.to_item() for r in batch],
                cancel_event=cancel,
            )
            if len(outs) != len(batch):
                raise RuntimeError(
                    f"batched dispatch returned {len(outs)} results "
                    f"for {len(batch)} requests"
                )
        except Exception as e:  # noqa: BLE001 — collective failure
            for r in batch:
                r.err = e
                r.done = True
            return
        for r, out in zip(batch, outs):
            if isinstance(out, Exception):
                r.err = out
            else:
                r.result = out
            r.done = True

    @staticmethod
    def _finish(req: _BatchRequest) -> bytes:
        if req.err is not None:
            raise req.err
        return req.result

    # ------------------------------------------------------------------ #
    # drain integration                                                  #
    # ------------------------------------------------------------------ #

    def flush(self, model_id: str, timeout_s: float = 5.0) -> bool:
        """Quiesce THIS model's requests before its copy drops (the
        drain / deliberate-removal hook): mark the group draining so
        leaders skip the fill window, then wait until no parked or
        in-flight request for the model remains — sibling models of a
        fused group may keep the queue busy throughout. Returns False
        on timeout (the removal proceeds anyway — parked requests then
        fail like any request racing an unload)."""
        key = self._group_key(model_id)
        with self._qlock:
            q = self._queues.get(key)
        if q is None:
            return True
        return q.await_drained(model_id, timeout_s)

    def queue_depth(self) -> int:
        """Parked requests across ALL groups right now — the batch-queue
        component of the piggybacked load feedback. Lock-free read of a
        lock-maintained counter: a point-in-time signal for routing
        peers, momentarily stale by design."""
        return self.parked_total

    def depth(self, model_id: str) -> int:
        """Parked requests for the model's group (tests/diagnostics)."""
        with self._qlock:
            q = self._queues.get(self._group_key(model_id))
        if q is None:
            return 0
        with q.lock:
            return len(q.pending) + (1 if q.in_flight else 0)
