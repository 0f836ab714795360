"""The port's own copy of the JAX package's ``observability/flightrec.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Flight recorder: a bounded, lock-striped structured-event ring.

"Replay the seed and stare" is how sim invariant failures were diagnosed
until now. The flight recorder turns that into "read the last 2k events
before the violation": hot paths record tiny structured events — entry
state transitions, placement decisions, KV CAS outcomes, transfer
faults, drain phases — into a per-instance ring at near-zero cost
(one counter increment, one striped lock, one tuple append; no
formatting, no I/O). The ring is dumped automatically when a sim
scenario's invariant suite fails (sim/scenario.py attaches every pod's
tail to the ScenarioResult) and is retrievable in production through the
``***FLIGHTREC***`` diagnostic id on GetModelStatus — the same secret-id
channel as the state dump and ``***TRACES***``.

Timestamps go through ``utils/clock`` so sim dumps carry virtual time
(directly comparable to the scenario's event schedule and trace spans).

Striping mirrors PrometheusMetrics: events hash onto ``_N_STRIPES``
independently-locked rings by sequence number, so concurrent hot-path
recorders don't serialize on one lock; a monotonically increasing global
sequence (GIL-atomic ``itertools.count``) restores total order at dump
time. Capacity is ``MM_FLIGHTREC_EVENTS`` (0 disables recording
entirely — ``record`` returns before touching any lock).
"""

from __future__ import annotations

import itertools
import threading
from typing import Optional

from modelmesh_tpu_torch.utils.clock import get_clock

FLIGHTREC_DUMP_ID = "***FLIGHTREC***"

_N_STRIPES = 8


class _EventStripe:
    __slots__ = ("lock", "events", "cap")

    def __init__(self, cap: int):
        self.lock = threading.Lock()
        self.cap = cap
        # (seq, ts_ms, kind, fields)
        self.events: list[tuple] = []  #: guarded-by: lock


class FlightRecorder:
    def __init__(self, capacity: Optional[int] = None, instance_id: str = ""):
        if capacity is None:
            from modelmesh_tpu_torch.utils import envs

            capacity = envs.get_int("MM_FLIGHTREC_EVENTS")
        self.instance_id = instance_id
        self.capacity = max(int(capacity), 0)
        self.enabled = self.capacity > 0
        per = max(self.capacity // _N_STRIPES, 1)
        self._stripes = [_EventStripe(per) for _ in range(_N_STRIPES)]
        self._seq = itertools.count(1)

    def record(self, kind: str, **fields) -> None:
        """Hot-path event append. ``fields`` must be cheap scalars —
        anything needing formatting belongs in a log line, not here."""
        if not self.enabled:
            return
        seq = next(self._seq)
        stripe = self._stripes[seq & (_N_STRIPES - 1)]
        ev = (seq, get_clock().now_ms(), kind, fields)
        with stripe.lock:
            ring = stripe.events
            ring.append(ev)
            if len(ring) > stripe.cap:
                del ring[: len(ring) - stripe.cap]

    def dump(self, n: int = 2000) -> list[dict]:
        """The last ``n`` events across all stripes, oldest first, as
        JSON-able dicts."""
        merged: list[tuple] = []
        for stripe in self._stripes:
            with stripe.lock:
                merged.extend(stripe.events)
        merged.sort()
        out = []
        for seq, ts_ms, kind, fields in merged[-n:]:
            ev = {"seq": seq, "ts_ms": ts_ms, "kind": kind,
                  "instance": self.instance_id}
            ev.update(fields)
            out.append(ev)
        return out

    def __len__(self) -> int:
        total = 0
        for stripe in self._stripes:
            with stripe.lock:
                total += len(stripe.events)
        return total
