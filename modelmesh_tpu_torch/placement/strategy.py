"""PlacementStrategy SPI: every placement decision behind one interface.

The port's own copy of the JAX package's ``placement/strategy.py`` (the
port imports nothing of that package): ``LOAD_HERE``, ``PlacementRequest``,
``ClusterView`` and the ``PlacementStrategy`` base class, with the same
method signatures. ``TorchPlacementStrategy``
(``placement/torch_engine.py``) implements it; records are duck-typed,
so the JAX package's records and the port's both fit.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
from typing import Optional, Sequence

from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

# Sentinel: "load on the requesting instance itself" (the reference's
# ABORT_REQUEST path meaning 'you take it', ModelMesh.java:4987-5004).
LOAD_HERE = "<here>"


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    model_id: str
    model: ModelRecord
    required_units: int
    requesting_instance: str
    exclude: frozenset[str] = frozenset()
    last_used_ms: int = 0


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """Immutable snapshot of live instances (from the instances TableView).

    ``epoch`` is the TableView version the snapshot was taken at (-1 for
    ad-hoc views built outside the watch-fed path). Views are shared
    across requests until the epoch moves, so the derived collections are
    computed once per snapshot, not per request (cached_property writes
    straight into __dict__, which the frozen dataclass permits)."""

    instances: Sequence[tuple[str, InstanceRecord]]
    epoch: int = -1

    @functools.cached_property
    def _live(self) -> list[tuple[str, InstanceRecord]]:
        return [(i, r) for i, r in self.instances if not r.shutting_down]

    @functools.cached_property
    def live_map(self) -> dict[str, InstanceRecord]:
        """id -> record of live instances; the O(1) lookup the per-request
        serve-target selection reads instead of rebuilding a dict."""
        return dict(self._live)

    @functools.cached_property
    def _placeable(self) -> list[tuple[str, InstanceRecord]]:
        return [
            (i, r) for i, r in self._live
            if not r.disabled and not r.draining
        ]

    def live(self) -> list[tuple[str, InstanceRecord]]:
        return self._live

    def placeable(self) -> list[tuple[str, InstanceRecord]]:
        """Candidates for NEW placements: live, not admin-drained, and not
        DRAINING (reconfig/drain.py). Serve routing keeps using live() —
        a disabled or draining instance's already-loaded copies continue
        serving (drain, not eviction)."""
        return self._placeable


class PlacementStrategy(abc.ABC):
    @abc.abstractmethod
    def choose_load_target(
        self, req: PlacementRequest, view: ClusterView
    ) -> Optional[str]:
        """Pick the instance that should load a new copy.

        Returns an instance id, LOAD_HERE (requester loads it), or None
        (nowhere to place — caller surfaces NoCapacityError).
        """

    @abc.abstractmethod
    def choose_serve_target(
        self, model: ModelRecord, view: ClusterView,
        exclude: frozenset[str],
    ) -> Optional[str]:
        """Pick a loaded copy to serve a request (cache-hit balancing)."""

    def choose_group_targets(
        self, req: PlacementRequest, view: ClusterView,
        shard_count: int, shard_units: int,
    ) -> Optional[dict[str, int]]:
        """Plan a PLACEMENT GROUP for a sharded model: assign each shard
        index 0..shard_count-1 to a DISTINCT instance, each with room for
        one shard (``shard_units``). Returns {instance_id: shard_index}
        or None when the fleet cannot host the whole group — group
        placement is atomic: all K members or nothing (a partial group
        can never serve, so partially placing one only wastes capacity).

        Existing same-index members in ``req.model.shard_instances``
        should be kept sticky so a re-plan tops up the missing shards
        instead of shuffling weights that already landed.

        Default: capacity-greedy — live placeable non-excluded instances
        ranked by free capacity, sticky members first. Strategies with a
        global plan override this (the solver co-plans the group as
        co-location columns in its cost surface).
        """
        keep: dict[str, int] = {}
        taken: set[int] = set()
        for iid, idx in req.model.shard_instances.items():
            if (
                0 <= idx < shard_count
                and idx not in taken
                and iid not in req.exclude
                and iid in view.live_map
                and not view.live_map[iid].draining
            ):
                keep[iid] = idx
                taken.add(idx)
        candidates = sorted(
            (
                (iid, rec) for iid, rec in view.placeable()
                if iid not in req.exclude and iid not in keep
                and rec.free_units >= shard_units
            ),
            key=lambda p: (-p[1].free_units, p[0]),
        )
        missing = [i for i in range(shard_count) if i not in taken]
        if len(candidates) < len(missing):
            return None
        assignments = dict(keep)
        for idx, (iid, _) in zip(missing, candidates):
            assignments[iid] = idx
        return assignments
