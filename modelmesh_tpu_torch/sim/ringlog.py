"""The port's own copy of the JAX package's ``sim/ringlog.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Bounded append-only ring for sim observation logs.

``SimCluster.request_log`` and ``batch_dispatches`` were plain lists:
one row per probe request / runtime dispatch, kept for the whole run.
Fine at scripted-scenario scale (hundreds of probes); a memory blowup
at macro scale, where a closed-loop day of a million synthetic users
offers hundreds of millions of requests (sim/workload.py aggregates
those — but the full-fidelity pods bridged into the same loop still
log per-request here, and a long exploration sweep accumulates too).

``RingLog`` is the same convention as ``observability/flightrec.py``
scaled down to one stripe: a bounded ring with a monotonically
increasing total-order sequence. Consumers (sim/invariants.py,
scenario ``extra_checks``, tests) only iterate / ``len()`` / truth-test
the log, so the ring is a drop-in replacement for the list; ``total``
and ``dropped`` expose whether the window is complete — the SLO
invariant's "observed-traffic witness" is explicit about truncation
instead of silently unbounded.

Capacity comes from ``MM_SIM_LOG_EVENTS`` (0 = unbounded, the
pre-ring behavior, for tests that assert over a whole run's traffic).
A single lock suffices: appenders are scenario worker threads at
human-scale rates, not the macro hot loop (which never touches this).
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator, Optional


class RingLog:
    """Bounded, thread-safe, append-only event ring.

    Iteration yields the retained tail in append (= total) order as a
    point-in-time snapshot; ``seq`` of the i-th yielded item is
    ``total - len(self) + i``.
    """

    __slots__ = ("_lock", "_buf", "_total", "capacity")

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            from modelmesh_tpu_torch.utils import envs

            capacity = envs.get_int("MM_SIM_LOG_EVENTS")
        self.capacity = max(int(capacity), 0)
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity or None
        )  #: guarded-by: _lock
        self._total = 0  #: guarded-by: _lock

    def append(self, item) -> int:
        """Record one event; returns its total-order sequence number."""
        with self._lock:
            seq = self._total
            self._total += 1
            self._buf.append(item)
            return seq

    @property
    def total(self) -> int:
        """Events ever appended (retained + dropped)."""
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        """Events the bound evicted (0 means the window is complete)."""
        with self._lock:
            return self._total - len(self._buf)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def __iter__(self) -> Iterator:
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def __bool__(self) -> bool:
        return len(self) > 0
