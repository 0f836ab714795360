"""The port's own copy of the JAX package's ``serving/rate.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Request-rate tracking: per-instance and per-model RPM over a ring buffer.

Equivalent of the reference's RateTracker (RateTracker.java:26-115): 30
one-minute buckets; busyness = extrapolated requests/min over the recent
window. Also used per-model by the scale-up logic (rateTrackingTask,
ModelMesh.java:5619-5806).
"""

from __future__ import annotations

import threading

from modelmesh_tpu_torch.utils import clock as _clock

BUCKETS = 30
BUCKET_MS = 60_000


class RateTracker:
    def __init__(self, clock_ms=None):
        self._clock = clock_ms or _clock.now_ms
        self._counts = [0] * BUCKETS
        self._bucket_start = self._clock()
        self._bucket_idx = 0
        self._lock = threading.Lock()

    def _advance(self, now: int) -> None:
        elapsed = now - self._bucket_start
        steps = int(elapsed // BUCKET_MS)
        if steps <= 0:
            return
        for _ in range(min(steps, BUCKETS)):
            self._bucket_idx = (self._bucket_idx + 1) % BUCKETS
            self._counts[self._bucket_idx] = 0
        self._bucket_start += steps * BUCKET_MS

    def record(self, n: int = 1) -> None:
        with self._lock:
            self._advance(self._clock())
            self._counts[self._bucket_idx] += n

    def rpm(self, window_minutes: int = 5) -> int:
        """Requests/min over the last ``window_minutes`` full+current buckets,
        extrapolating the in-progress bucket."""
        with self._lock:
            now = self._clock()
            self._advance(now)
            w = max(1, min(window_minutes, BUCKETS - 1))
            total = 0
            for k in range(w):
                total += self._counts[(self._bucket_idx - k) % BUCKETS]
            frac = (now - self._bucket_start) / BUCKET_MS
            minutes = (w - 1) + max(frac, 1.0 / 60)
            return int(total / minutes)
