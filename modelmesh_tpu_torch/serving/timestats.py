"""The port's own copy of the JAX package's ``serving/timestats.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Per-model-type load-time statistics: streaming mean + 3σ.

Re-derivation of the reference's TimeStats (MM/TimeStats.java:17-45, used
in routing at ModelMesh.java:4351): every successful load records its
duration under the model's type; consumers ask for ``expect_ms`` —
mean + 3σ, the "a healthy load of this type should be done by now" bound.

Uses:
- wait-vs-go-elsewhere on loading copies (serving/instance.py,
  placement/greedy.py): a copy that has been loading LONGER than
  expect_ms is probably stuck — route a fresh load elsewhere; one still
  within the bound is worth forwarding to and waiting on (a second cold
  load elsewhere would take the full load time again).
- serve-side warming penalty (placement/greedy.py): replaces the flat
  10 s floor — a slow-type copy is deprioritized for longer after load.

Welford's algorithm per key; bounded key count (types are few, but ids
are caller-controlled).
"""

from __future__ import annotations

import math
import threading

DEFAULT_EXPECT_MS = 10_000.0  # until min_samples: the old flat floor
MIN_SAMPLES = 3


class TimeStats:
    def __init__(
        self,
        default_ms: float = DEFAULT_EXPECT_MS,
        min_samples: int = MIN_SAMPLES,
        max_keys: int = 4096,
    ):
        self.default_ms = default_ms
        self.min_samples = max(1, min_samples)
        self.max_keys = max_keys
        self._lock = threading.Lock()
        # key -> [n, mean, M2]
        self._stats: dict[str, list[float]] = {}

    def record(self, key: str, duration_ms: float) -> None:
        if duration_ms < 0:
            return
        with self._lock:
            s = self._stats.get(key)
            if s is None:
                if len(self._stats) >= self.max_keys:
                    # Safety valve for caller-controlled keyspaces: drop an
                    # arbitrary half. Types are few in practice.
                    for k in list(self._stats)[: self.max_keys // 2]:
                        del self._stats[k]
                s = self._stats[key] = [0.0, 0.0, 0.0]
            s[0] += 1
            delta = duration_ms - s[1]
            s[1] += delta / s[0]
            s[2] += delta * (duration_ms - s[1])

    def mean_ms(self, key: str) -> float:
        with self._lock:
            s = self._stats.get(key)
            return s[1] if s and s[0] >= self.min_samples else self.default_ms

    def expect_ms(self, key: str) -> float:
        """mean + 3σ; ``default_ms`` until enough samples exist."""
        with self._lock:
            s = self._stats.get(key)
            if s is None or s[0] < self.min_samples:
                return self.default_ms
            n, mean, m2 = s
            std = math.sqrt(m2 / (n - 1)) if n > 1 else 0.0
            return mean + 3.0 * std

    def samples(self, key: str) -> int:
        with self._lock:
            s = self._stats.get(key)
            return int(s[0]) if s else 0
