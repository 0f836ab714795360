"""The port's own copy of the JAX package's ``records.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Cluster-state records: the shared-registry schema.

Capability parity with the reference's KV-persisted records:
- ModelRecord    (MM/ModelRecord.java:61-126): per-model registry entry —
  type/path/key, instance placements with load timestamps, load failures
  with expiry, refCount/autoDelete for vmodel-managed models, lazily
  persisted lastUsed.
- InstanceRecord (MM/InstanceRecord.java:37-108): per-instance
  advertisement — LRU age, capacity/used, loading threads, request rate,
  shutdown flag, location/zone/labels.
- VModelRecord   (MM/VModelRecord.java:17-45): virtual-model alias state —
  owner, active/target concrete models, transition failure flag.

All are JSON dataclasses with KV-version CAS via kv.table.Record. Time is
epoch millis throughout (matching the cache timestamps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from modelmesh_tpu_torch.kv.table import Record
# Injectable time source (utils/clock.py): record timestamps follow the
# installed clock so the simulation harness controls them.
from modelmesh_tpu_torch.utils.clock import now_ms  # noqa: F401 — re-export


# Load-failure bookkeeping windows (reference: ModelMesh.java:219-224).
# Overridable via MM_LOAD_FAILURE_EXPIRY_MS (the reference exposes its
# time heuristics as system properties the same way — SURVEY.md section 4);
# read through failure_expiry_ms() (utils/envs registry accessor, live per
# call) so tests/operators can adjust at runtime.
LOAD_FAILURE_EXPIRY_MS = 15 * 60 * 1000


def failure_expiry_ms() -> int:
    from modelmesh_tpu_torch.utils import envs

    # No falsy fallback: an explicit 0 means "failures expire immediately"
    # (re-load exclusion disabled), which must be honored.
    return envs.get_int("MM_LOAD_FAILURE_EXPIRY_MS")


MAX_LOAD_FAILURES = 3
MAX_LOAD_LOCATIONS = 5


@dataclasses.dataclass
class ModelRecord(Record):
    model_type: str = ""
    model_path: str = ""
    model_key: str = ""          # opaque runtime credential/config blob
    # instance_id -> load-completion timestamp (ms): copies that are LOADED
    # and servable. (The reference keeps one map with load-start timestamps
    # and estimates completion via TimeStats, ModelMesh.java:4351; splitting
    # the claim from the completion makes status reporting exact.)
    instance_ids: dict[str, int] = dataclasses.field(default_factory=dict)
    # instance_id -> claim timestamp (ms): copies being loaded right now.
    # Acts as the placement claim so concurrent placements don't double-load.
    loading_instances: dict[str, int] = dataclasses.field(default_factory=dict)
    # instance_id -> demotion timestamp (ms): instances holding a HOST-RAM
    # snapshot of the weights (transfer/ tier) but NO device copy. Not
    # servable — never part of all_placements/copy_count — but valid
    # peer-fetch sources, so a re-scale-up streams from host RAM instead
    # of the model store. Cleared with the instance by remove_instance
    # (reaper pruning of dead instances covers host claims for free).
    host_instances: dict[str, int] = dataclasses.field(default_factory=dict)
    # instance_id -> [failure_ts_ms, message]
    load_failures: dict[str, list] = dataclasses.field(default_factory=dict)
    ref_count: int = 0           # vmodel references
    auto_delete: bool = False    # delete when ref_count drops to 0
    size_units: int = 0          # measured size (cache units); 0 = unknown.
                                 # Piggybacked on load completion; feeds the
                                 # global solver's cost matrix.
    last_used: int = 0           # lazily persisted (see should_persist_last_used)
    last_unload_ms: int = 0
    # Sharded multi-device execution (placement GROUPS): a model too big
    # for one instance is split into shard_count weight shards, each held
    # by a different instance. shard_instances maps instance_id -> shard
    # index (two instances MAY hold the same index transiently — that is
    # exactly the drain pre-copy overlap). The group is routable only
    # while COMPLETE (every index has a servable holder); group_epoch
    # increments on every re-plan / membership change so observers can
    # order group generations. shard_count == 0 means unsharded.
    shard_count: int = 0
    shard_instances: dict[str, int] = dataclasses.field(default_factory=dict)
    group_epoch: int = 0
    version: int = 0

    # -- placements ---------------------------------------------------------

    def claim_loading(self, instance_id: str, ts: Optional[int] = None) -> None:
        self.loading_instances[instance_id] = ts if ts is not None else now_ms()

    def promote_loaded(self, instance_id: str, ts: Optional[int] = None) -> None:
        self.loading_instances.pop(instance_id, None)
        # A device copy supersedes any stale host claim for the same
        # instance (re-warm promoted the host snapshot back to device).
        self.host_instances.pop(instance_id, None)
        self.instance_ids[instance_id] = ts if ts is not None else now_ms()

    def promote_partial(self, instance_id: str, ts: Optional[int] = None) -> None:
        """Mid-transfer (PARTIAL) promotion: the copy becomes routable
        (listed in ``instance_ids``) while the ORIGINAL loading claim is
        kept — the claim tells peers the copy is not yet a valid
        weight-transfer source and preserves the strict claim ordering
        receivers wait on. ``promote_loaded`` at stream completion (or
        ``remove_instance`` on failure) clears it."""
        self.host_instances.pop(instance_id, None)
        if instance_id not in self.loading_instances:
            self.loading_instances[instance_id] = (
                ts if ts is not None else now_ms()
            )
        self.instance_ids[instance_id] = ts if ts is not None else now_ms()

    def remove_instance(self, instance_id: str) -> bool:
        a = self.instance_ids.pop(instance_id, None) is not None
        b = self.loading_instances.pop(instance_id, None) is not None
        c = self.host_instances.pop(instance_id, None) is not None
        idx = self.shard_instances.pop(instance_id, None)
        if idx is not None:
            self.group_epoch += 1
            # Atomic group eviction: losing a shard whose index has no
            # surviving SERVABLE twin (a drain pre-copy leaves one) makes
            # every other shard dead weight — drop the whole group so
            # members observe their vanished claims and tear down,
            # freeing K-1 shards' capacity instead of stranding it. With
            # a twin present (drain), only the leaver is popped.
            twin = any(
                i == idx and other in self.instance_ids
                for other, i in self.shard_instances.items()
            )
            if not twin:
                for other in list(self.shard_instances):
                    self.shard_instances.pop(other, None)
                    self.instance_ids.pop(other, None)
                    self.loading_instances.pop(other, None)
                self.shard_count = 0
        if not self.shard_instances:
            # Last member gone: the group is absent, not half-present.
            self.shard_count = 0
        return a or b or c

    # -- shard groups (sharded multi-device execution) -----------------------

    def begin_shard_group(
        self, assignments: dict[str, int], shard_count: int,
        ts: Optional[int] = None,
    ) -> None:
        """Install (or re-plan) the FULL group atomically inside one CAS:
        shard assignments, loading claims for every member that is not
        already servable, and an epoch bump. ``assignments`` for members
        already holding the right shard are kept as-is (their claims and
        completion timestamps survive a top-up re-plan)."""
        ts = ts if ts is not None else now_ms()
        self.shard_count = int(shard_count)
        self.group_epoch += 1
        for iid, idx in assignments.items():
            prev = self.shard_instances.get(iid)
            self.shard_instances[iid] = int(idx)
            if prev == int(idx) and iid in self.instance_ids:
                continue  # already a servable holder of this very shard
            self.claim_loading(iid, ts)
        # Members no longer assigned any shard lose their claims — their
        # pods observe the vanished claim and tear the local shard down.
        for iid in [i for i in self.shard_instances if i not in assignments]:
            self.shard_instances.pop(iid, None)
            self.instance_ids.pop(iid, None)
            self.loading_instances.pop(iid, None)

    def shard_index_of(self, instance_id: str) -> Optional[int]:
        return self.shard_instances.get(instance_id)

    @property
    def group_complete(self) -> bool:
        """True when every shard index 0..shard_count-1 has at least one
        SERVABLE holder (listed in instance_ids). Unsharded models are
        vacuously complete."""
        if not self.shard_count:
            return True
        held = {
            idx for iid, idx in self.shard_instances.items()
            if iid in self.instance_ids
        }
        return held >= set(range(self.shard_count))

    def missing_shards(self) -> list[int]:
        """Shard indices with no holder AT ALL (neither servable nor
        loading) — the top-up re-plan's work list."""
        if not self.shard_count:
            return []
        held = set(self.shard_instances.values())
        return [i for i in range(self.shard_count) if i not in held]

    def claim_host_copy(self, instance_id: str, ts: Optional[int] = None) -> None:
        """Advertise a host-tier (demoted) snapshot on this instance."""
        self.host_instances[instance_id] = ts if ts is not None else now_ms()

    def drop_host_copy(self, instance_id: str) -> bool:
        return self.host_instances.pop(instance_id, None) is not None

    def placed_on(self, instance_id: str) -> bool:
        return (
            instance_id in self.instance_ids
            or instance_id in self.loading_instances
        )

    @property
    def all_placements(self) -> set[str]:
        return set(self.instance_ids) | set(self.loading_instances)

    @property
    def copy_count(self) -> int:
        return len(self.instance_ids) + len(self.loading_instances)

    # -- failures -------------------------------------------------------------

    def add_load_failure(self, instance_id: str, message: str,
                         ts: Optional[int] = None) -> None:
        self.load_failures[instance_id] = [
            ts if ts is not None else now_ms(), message[:512]
        ]

    def expire_load_failures(
        self, now: Optional[int] = None,
        expiry_ms: Optional[int] = None,
    ) -> bool:
        """Drop stale failure entries; returns True if anything changed."""
        now = now if now is not None else now_ms()
        expiry_ms = expiry_ms if expiry_ms is not None else failure_expiry_ms()
        stale = [
            iid for iid, (ts, _msg) in self.load_failures.items()
            if now - ts > expiry_ms
        ]
        for iid in stale:
            del self.load_failures[iid]
        return bool(stale)

    def active_failures(self, now: Optional[int] = None) -> set[str]:
        """Instance ids with a NON-expired load failure (one expiry read
        for the whole set — the routing hot path calls this per miss)."""
        now = now if now is not None else now_ms()
        expiry = failure_expiry_ms()
        return {
            iid for iid, (ts, _msg) in self.load_failures.items()
            if now - ts <= expiry
        }

    def active_failure_count(self, now: Optional[int] = None) -> int:
        return len(self.active_failures(now))

    def failed_on(self, instance_id: str, now: Optional[int] = None) -> bool:
        entry = self.load_failures.get(instance_id)
        if entry is None:
            return False
        now = now if now is not None else now_ms()
        return now - entry[0] <= failure_expiry_ms()

    def load_exhausted(self, now: Optional[int] = None) -> bool:
        """Too many failures or too many attempted locations
        (reference checkLoadFailureCount/checkLoadLocationCount,
        ModelMesh.java:4590-4607)."""
        return (
            self.active_failure_count(now) >= MAX_LOAD_FAILURES
            or len(self.load_failures) >= MAX_LOAD_LOCATIONS
        )

    # -- lastUsed laziness ---------------------------------------------------

    # The reference persists lastUsed only when >6-7h stale or piggybacked on
    # other updates (ModelRecord.java:96-105) to avoid write storms.
    LAST_USED_PERSIST_STALENESS_MS = 6 * 3600 * 1000

    def should_persist_last_used(self, observed_last_used: int) -> bool:
        return (
            observed_last_used - self.last_used
            > self.LAST_USED_PERSIST_STALENESS_MS
        )


@dataclasses.dataclass
class InstanceRecord(Record):
    start_ts: int = 0
    lru_ts: int = 0              # oldest cache-entry timestamp (0 = empty)
    model_count: int = 0
    capacity_units: int = 0
    used_units: int = 0
    loading_threads: int = 0
    loading_in_progress: int = 0
    req_per_minute: int = 0
    shutting_down: bool = False
    # Admin drain (dynamic config `disable`): excluded from new placements
    # but NOT migrating and NOT holding peers' readiness (unlike
    # shutting_down).
    disabled: bool = False
    # Graceful drain in progress (reconfig/drain.py): excluded from new
    # placements and deprioritized as a serve target (survivor copies are
    # preferred once servable), but still LIVE — already-loaded copies
    # keep serving while the drain pre-copies them to survivors. Unlike
    # shutting_down, a draining instance is still a routable member of
    # the fleet; unlike disabled, it IS migrating and will deregister.
    draining: bool = False
    endpoint: str = ""           # host:port of the instance's internal RPC
    location: str = ""           # node/host for anti-affinity
    zone: str = ""
    labels: list[str] = dataclasses.field(default_factory=list)
    instance_version: str = ""   # deployment version for upgrade tracking
    version: int = 0

    @property
    def free_units(self) -> int:
        return max(self.capacity_units - self.used_units, 0)

    @property
    def full_fraction(self) -> float:
        return self.used_units / self.capacity_units if self.capacity_units else 1.0

    def placement_sort_key(self) -> tuple:
        """The reference's PLACEMENT_ORDER (ModelMesh.java:4646): prefer most
        free space, break ties by oldest LRU (cheapest eviction)."""
        return (-self.free_units, self.lru_ts if self.lru_ts else 0)


@dataclasses.dataclass
class VModelRecord(Record):
    owner: str = ""
    active_model: str = ""
    target_model: str = ""
    target_load_failed: bool = False
    version: int = 0

    @property
    def in_transition(self) -> bool:
        return bool(self.target_model) and self.target_model != self.active_model
