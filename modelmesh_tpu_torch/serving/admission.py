"""The port's own copy of the JAX package's ``serving/admission.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

SLO-burn-rate admission control at the external-API edge.

Routing (route_cache.py d-choices) spreads load the fleet CAN absorb;
this module is the overload story for load it can't: per-model-class
token buckets at the edge whose refill is modulated by the PR-8 SLO
burn-rate gauges, shedding (fail-fast with a typed ``OverloadShedError``)
or briefly queueing lower-priority classes when a class trends toward
breach — the explicit-overload-penalty model ("Load Balanced Demand
Distribution under Overload Penalties", PAPERS.md): a deliberate shed at
the edge costs one request; letting queues build collapses tails
fleet-wide.

Mechanics:

- **Priority** is the class's position in ``MM_SLO_SPEC`` (first clause
  = highest priority). The spec is already the operator's statement of
  which traffic matters; no second priority vocabulary.
- **Pressure**: every ``BURN_REFRESH_MS`` (amortized onto the admit
  path, never per-request) the controller reads each active class's
  windowed burn rate from the instance's SloTracker. The
  highest-priority class burning at or above ``BURN_SHED_THRESHOLD``
  sets the pressure level: every class of equal or lower priority is
  throttled — EXCEPT the highest-priority class, which is never
  admission-shed (it is exactly the traffic the shedding protects).
  Throttling a burning low-priority class is deliberate fail-fast:
  shedding its own excess beats queueing it into collapse.
- **Buckets**: a throttled class gets a token bucket seeded from its
  observed admit rate cut by ``BACKOFF``; sustained pressure keeps
  multiplying the refill down (floored), calm multiplies it back up
  until the bucket uncaps entirely. An empty bucket briefly queues the
  request (``MM_ADMISSION_QUEUE_MS``, through the injectable clock so
  the sim exercises it under virtual time) before shedding.
- Shed decisions are recorded in the flight recorder
  (``admission-shed``) and counted (``mm_admission_shed_count``); the
  caller must NOT feed a shed into the SLO window — the control loop
  judges the health of *served* traffic, and counting its own sheds as
  breach would latch the throttle on forever.

``MM_ADMISSION`` (default off) gates the whole controller: off, the
``admit`` call is a single attribute check — the regression-pinned
"behaviorally identical to today" mode.
"""

from __future__ import annotations

import threading
from typing import Optional

from modelmesh_tpu_torch.serving.errors import OverloadShedError
from modelmesh_tpu_torch.utils.clock import get_clock
from modelmesh_tpu_torch.utils.lockdebug import mm_lock

BURN_REFRESH_MS = 250
BURN_SHED_THRESHOLD = 1.0
# Burn evidence below this many windowed completions is cold-start
# noise, not pressure.
MIN_BURN_SAMPLES = 8
RATE_FLOOR_PER_S = 0.5
BACKOFF = 0.5
RECOVER = 1.5
# A recovered bucket whose refill clears its observed demand by this
# factor uncaps (no bucket at all — the common healthy fast path).
UNCAP_HEADROOM = 4.0
# Token burst ceiling as seconds of refill: bounds how big a backlog an
# idle throttled class can dump at once.
BURST_S = 1.0
_QUEUE_POLL_S = 0.005


class _Bucket:
    __slots__ = ("lock", "rate_per_s", "tokens", "last_ms")

    def __init__(self, rate_per_s: float, now_ms: int):
        self.lock = mm_lock("_Bucket.lock")
        self.rate_per_s = rate_per_s  #: guarded-by: lock
        self.tokens = max(rate_per_s * BURST_S, 1.0)  #: guarded-by: lock
        self.last_ms = now_ms  #: guarded-by: lock

    def try_take(self, now_ms: int) -> bool:
        with self.lock:
            elapsed = max(now_ms - self.last_ms, 0)
            self.last_ms = now_ms
            burst = max(self.rate_per_s * BURST_S, 1.0)
            self.tokens = min(
                self.tokens + elapsed * self.rate_per_s / 1000.0, burst
            )
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class AdmissionController:
    """Per-model-class admission gate for ONE serving instance.

    ``slo`` is the instance's SloTracker (burn-rate source and the class
    vocabulary — priority is spec order). ``admit`` either returns (the
    request proceeds) or raises ``OverloadShedError``.
    """

    def __init__(
        self,
        slo,
        enabled: Optional[bool] = None,
        queue_ms: Optional[int] = None,
        metrics=None,
        flightrec=None,
    ):
        from modelmesh_tpu_torch.utils import envs

        if enabled is None:
            enabled = envs.get_bool("MM_ADMISSION")
        if queue_ms is None:
            queue_ms = envs.get_int("MM_ADMISSION_QUEUE_MS")
        self.enabled = bool(enabled)
        self.queue_ms = max(int(queue_ms), 0)
        self.slo = slo
        self.metrics = metrics
        self.flightrec = flightrec
        # Spec order IS the priority order (dict preserves insertion).
        self._priority: dict[str, int] = {
            cls: i for i, cls in enumerate(slo.objectives)
        }
        # class -> _Bucket; present only while throttled ([rebind]:
        # installs/removals are GIL-atomic dict ops — readers see either
        # no bucket (uncapped) or a fully-built one).
        #: guarded-by: _refresh_lock [rebind]
        self._buckets: dict[str, _Bucket] = {}
        self._refresh_lock = mm_lock("AdmissionController._refresh_lock")
        self._last_refresh_ms = 0  #: guarded-by: _refresh_lock
        # Per-class admit counts since the last refresh — the observed-
        # rate estimate a fresh bucket seeds from. Plain-int increments
        # (racy, a load estimate not accounting).
        self._admits: dict[str, int] = {}
        # Diagnostics / test handles.
        self.shed_count = 0
        self.queued_count = 0

    # -- hot path ---------------------------------------------------------- #

    def admit(self, model_class: str, cancel_event=None) -> None:
        """Admit or shed one external request of ``model_class``.
        Raises OverloadShedError on shed; returns on admit."""
        if not self.enabled:
            return
        cls = self.slo.resolve_class(model_class)
        clock = get_clock()
        now = clock.now_ms()
        if now - self._last_refresh_ms >= BURN_REFRESH_MS:
            self._refresh(now)
        self._admits[cls] = self._admits.get(cls, 0) + 1
        bucket = self._buckets.get(cls)
        if bucket is None or bucket.try_take(now):
            return
        # Empty bucket: brief bounded queue before the shed — absorbs a
        # burst without letting a sustained overload build a real queue.
        if self.queue_ms > 0:
            deadline = now + self.queue_ms
            while True:
                if cancel_event is not None and cancel_event.is_set():
                    # A disconnect while queued is a CANCELLATION, not a
                    # shed: it must not inflate the shed metrics
                    # operators alert on, and must map to CANCELLED at
                    # the edge like every other cancellation path.
                    from modelmesh_tpu_torch.serving.errors import (
                        RequestCancelledError,
                    )

                    raise RequestCancelledError(
                        f"client cancelled while queued for admission "
                        f"({cls})"
                    )
                clock.sleep(_QUEUE_POLL_S)
                now = clock.now_ms()
                if now >= deadline:
                    break
                bucket = self._buckets.get(cls)
                if bucket is None or bucket.try_take(now):
                    self.queued_count += 1
                    return
        self.shed_count += 1
        if self.metrics is not None:
            from modelmesh_tpu_torch.observability.metrics import Metric as MX

            self.metrics.inc(MX.ADMISSION_SHED_COUNT, model_id=cls)
        if self.flightrec is not None:
            self.flightrec.record("admission-shed", slo_class=cls)
        raise OverloadShedError(cls)

    # -- burn-driven bucket management ------------------------------------- #

    def _refresh(self, now: int) -> None:
        """Re-read burn rates and adjust buckets. One caller per cycle;
        latecomers skip (the gate is advisory on a 250 ms cadence)."""
        if not self._refresh_lock.acquire(blocking=False):
            return
        try:
            self._refresh_locked(now)
        finally:
            self._refresh_lock.release()

    def _refresh_locked(self, now: int) -> None:
        """Caller holds _refresh_lock."""
        if now - self._last_refresh_ms < BURN_REFRESH_MS:
            return
        elapsed_ms = max(now - self._last_refresh_ms, 1)
        self._last_refresh_ms = now
        admits, self._admits = self._admits, {}
        pressure_idx: Optional[int] = None
        for cls in self.slo.classes():
            snap = self.slo.attainment(cls)
            if (
                snap.requests >= MIN_BURN_SAMPLES
                and snap.burn_rate >= BURN_SHED_THRESHOLD
            ):
                idx = self._priority.get(cls, len(self._priority))
                if pressure_idx is None or idx < pressure_idx:
                    pressure_idx = idx
        for cls, idx in self._priority.items():
            throttle = (
                pressure_idx is not None
                and idx >= pressure_idx
                and idx != 0
            )
            bucket = self._buckets.get(cls)
            observed_per_s = admits.get(cls, 0) * 1000.0 / elapsed_ms
            if throttle:
                if bucket is None:
                    seed = max(observed_per_s * BACKOFF, RATE_FLOOR_PER_S)
                    self._buckets[cls] = _Bucket(seed, now)
                    self._record_throttle(cls, seed)
                else:
                    with bucket.lock:
                        bucket.rate_per_s = max(
                            bucket.rate_per_s * BACKOFF, RATE_FLOOR_PER_S
                        )
            elif bucket is not None:
                with bucket.lock:
                    bucket.rate_per_s *= RECOVER
                    rate = bucket.rate_per_s
                if rate >= max(observed_per_s, 1.0) * UNCAP_HEADROOM:
                    self._buckets.pop(cls, None)
                    self._record_throttle(cls, None)

    def _record_throttle(self, cls: str, rate: Optional[float]) -> None:
        if self.flightrec is not None:
            if rate is None:
                self.flightrec.record("admission-uncap", slo_class=cls)
            else:
                self.flightrec.record(
                    "admission-throttle", slo_class=cls,
                    rate_per_s=round(rate, 3),
                )

    # -- introspection ----------------------------------------------------- #

    def throttled_classes(self) -> list[str]:
        return list(self._buckets)
