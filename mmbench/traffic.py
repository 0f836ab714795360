"""The fleet and its traffic, drawn from the seed.

One general generator: a configuration file gives the fleet (models,
pods, runtime types, size range, preloading, zones, utilization), a
traffic file the events of each tick (how many models get a fresh rpm
and ``last_used = now``, how many pods a new ``used_units``). The fleet
is the JAX bench's steady fleet (``steady_records`` there and in
``chip_smoke.py``: ``synthetic_records`` at 85% utilization with rpm in
0-49) and the model events its ``churn``, with every draw taken from
``--seed``; the pod events are this benchmark's own.

The generator keeps the fleet's state as numpy arrays, the benchmark's
truth, and writes each change into the records it hands the system
under test (``records`` gives their classes; without them only the
arrays are kept, as the stand-ins need).
"""

from __future__ import annotations

from collections import deque

import numpy as np

# The JAX bench's last_used for a model never used since the fleet was
# made (synthetic_records: 1,000,000 + row), and its pods' lru_ts.
ANCIENT_MS = 1_000_000
POD_LRU_TS = 1_000


class Fleet:
    """The fleet at the current tick: ``state`` (numpy arrays), the ids,
    and, given the record classes, the ``models``/``instances`` lists
    and the ``rpm`` map that the system under test reads."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, records=None):
        rng = np.random.default_rng([int(seed), 0])
        self.events = np.random.default_rng([int(seed), 1])
        self.ahead: deque = deque()
        self.traffic = traffic
        n, m = int(cfg["models"]), int(cfg["pods"])
        lo, hi = cfg["size_units"]
        sizes = rng.integers(lo, hi, n)
        loaded_on = rng.integers(0, m, n)
        every = int(cfg["loaded_every"])
        rows = np.arange(n)
        loaded_on = np.where(rows % every == 0, loaded_on, -1) if every else (
            np.full(n, -1))
        rpm_lo, rpm_hi = cfg["model_rpm"]
        rpm = rng.integers(rpm_lo, rpm_hi, n)
        capacity = max(1, round(int(sizes.sum()) / (cfg["utilization"] * m)))
        self.managed = np.bincount(loaded_on[loaded_on >= 0],
                                   weights=sizes[loaded_on >= 0],
                                   minlength=m).astype(np.int64)
        self.state = {
            "sizes": sizes.astype(np.int64),
            "copies": (loaded_on >= 0).astype(np.int64),
            "loaded_on": loaded_on.astype(np.int64),
            "type": rows % int(cfg["model_types"]),
            "rpm": rpm.astype(np.int64),
            "last_used": ANCIENT_MS + rows.astype(np.int64),
            "capacity": np.full(m, capacity, np.int64),
            "used": np.zeros(m, np.int64),
            "lru_ts": np.full(m, POD_LRU_TS, np.int64),
            "busy": np.arange(m, dtype=np.int64) % int(cfg["pod_rpm_mod"]),
            "zone": np.arange(m, dtype=np.int64) % int(cfg["zones"]),
        }
        self.state["used"] = self._used(np.arange(m), rng)
        self.model_ids = [f"m{i}" for i in range(n)]
        self.pod_ids = [f"i{j}" for j in range(m)]
        self.models = self.instances = self.rpm = None
        if records is not None:
            self._build_records(*records)

    @property
    def n(self) -> int:
        return len(self.model_ids)

    @property
    def m(self) -> int:
        return len(self.pod_ids)

    @property
    def entries(self) -> int:
        """The (model, pod) entries a plan holds: each model's wanted
        copies, at least one and at most eight."""
        return int(np.clip(self.state["copies"], 1, 8).sum())

    def _used(self, pods: np.ndarray, rng) -> np.ndarray:
        """A pod's advertised use: the models loaded on it plus an
        unmanaged share of its capacity drawn from ``pod_unmanaged``."""
        lo, hi = self.traffic["pod_unmanaged"]
        extra = rng.uniform(lo, hi, len(pods)) * self.state["capacity"][pods]
        return self.managed[pods] + np.floor(extra).astype(np.int64)

    def _build_records(self, model_cls, instance_cls) -> None:
        st = self.state
        self.models = []
        for i, mid in enumerate(self.model_ids):
            mr = model_cls(model_type=f"t{int(st['type'][i])}",
                           size_units=int(st["sizes"][i]),
                           last_used=int(st["last_used"][i]))
            if st["loaded_on"][i] >= 0:
                mr.instance_ids[self.pod_ids[int(st["loaded_on"][i])]] = 1
            self.models.append((mid, mr))
        self.instances = [
            (pid, instance_cls(
                capacity_units=int(st["capacity"][j]),
                used_units=int(st["used"][j]),
                zone=f"z{int(st['zone'][j])}", lru_ts=int(st["lru_ts"][j]),
                req_per_minute=int(st["busy"][j])))
            for j, pid in enumerate(self.pod_ids)
        ]
        self.rpm = dict(zip(self.model_ids, st["rpm"].tolist()))

    def _draw(self) -> tuple:
        t, rng = self.traffic, self.events
        k = max(1, int(self.n * t["model_events"]))
        rows = rng.integers(0, self.n, k)
        lo, hi = t["model_rpm"]
        new_rpm = rng.integers(lo, hi, k)
        pods = np.sort(rng.choice(self.m, int(t["pod_events"]), replace=False))
        return rows, new_rpm, pods, self._used(pods, rng)

    def predraw(self, ticks: int) -> None:
        """Draw the next ``ticks`` ticks' events now (set-up), in the order
        ``tick`` would draw them: the events are the seed's either way."""
        for _ in range(ticks):
            self.ahead.append(self._draw())

    def tick(self, now_ms: int) -> tuple[list, list]:
        """One tick's events at ``now_ms``: ``model_events`` models (per
        model of the fleet, drawn uniformly with repeats, as the JAX
        bench's churn) get a fresh rpm and ``last_used = now``;
        ``pod_events`` distinct pods get a new ``used_units``. Returns the
        changed model and pod ids, for ``mark_dirty``."""
        st = self.state
        rows, new_rpm, pods, used = (self.ahead.popleft() if self.ahead
                                     else self._draw())
        st["last_used"][rows] = now_ms
        st["rpm"][rows] = new_rpm       # a repeated row keeps its last draw
        st["used"][pods] = used
        changed = np.unique(rows)
        mids = [self.model_ids[i] for i in changed.tolist()]
        pids = [self.pod_ids[j] for j in pods.tolist()]
        if self.models is not None:
            for i, mid in zip(changed.tolist(), mids):
                self.models[i][1].last_used = now_ms
                self.rpm[mid] = int(st["rpm"][i])
            for j, u in zip(pods.tolist(), used.tolist()):
                self.instances[j][1].used_units = u
        return mids, pids

    def snapshot(self) -> dict:
        """The state now, with the arrays that ticks change copied."""
        snap = dict(self.state)
        for key in ("rpm", "last_used", "used"):
            snap[key] = self.state[key].copy()
        return snap

    def records_agree(self) -> bool:
        """Whether the records hold what the arrays say (the mirror the
        reference relies on)."""
        if self.models is None:
            return True
        st = self.state
        return (
            all(mr.last_used == st["last_used"][i]
                and self.rpm[mid] == st["rpm"][i]
                and mr.size_units == st["sizes"][i]
                and mr.copy_count == st["copies"][i]
                for i, (mid, mr) in enumerate(self.models))
            and all(rec.used_units == st["used"][j]
                    for j, (_, rec) in enumerate(self.instances))
        )
