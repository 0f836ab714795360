"""Cluster-state records: the fields the placement snapshot reads.

A copy of the registry schema's solver-facing part (the reference's
ModelRecord.java / InstanceRecord.java, as the JAX package's
``records.py`` holds them): everything ``snapshot_columns`` and the
placement strategy read (the KV ``version`` that versioned dirty marks
compare against, the group and drain fields of the strategy SPI), and
nothing of the KV persistence or the serving lifecycle.
"""

from __future__ import annotations

import dataclasses
import time


def now_ms() -> int:
    """Epoch milliseconds."""
    return int(time.time() * 1000)


@dataclasses.dataclass
class ModelRecord:
    model_type: str = ""
    size_units: int = 0      # measured size (cache units); 0 = unknown
    last_used: int = 0       # epoch ms
    # instance_id -> load-completion timestamp (ms): loaded, servable copies.
    instance_ids: dict[str, int] = dataclasses.field(default_factory=dict)
    # instance_id -> claim timestamp (ms): copies being loaded right now.
    loading_instances: dict[str, int] = dataclasses.field(default_factory=dict)
    # Placement groups: instance_id -> shard index of a sharded model.
    shard_instances: dict[str, int] = dataclasses.field(default_factory=dict)
    version: int = 0             # KV record version

    @property
    def copy_count(self) -> int:
        return len(self.instance_ids) + len(self.loading_instances)


@dataclasses.dataclass
class InstanceRecord:
    capacity_units: int = 0
    used_units: int = 0
    lru_ts: int = 0              # oldest cache-entry timestamp (0 = empty)
    req_per_minute: int = 0
    zone: str = ""
    labels: list[str] = dataclasses.field(default_factory=list)
    shutting_down: bool = False
    disabled: bool = False       # excluded from new placements
    draining: bool = False       # graceful drain: no new placements
    version: int = 0             # KV record version

    @property
    def free_units(self) -> int:
        return max(self.capacity_units - self.used_units, 0)
