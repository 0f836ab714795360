"""The port's own copy of the JAX package's ``reconfig/drain.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Instance drain: migrate-then-deregister with no serving gap.

The legacy pre-shutdown (reference preShutdown, ModelMesh.java:6959-7143)
flips ``shutting_down`` FIRST — the instance vanishes from every peer's
live view while its copies are still the only ones, so requests herd
onto survivors that haven't loaded yet and ride cold loads (or fail).
The drain controller inverts the order:

1. Mark DRAINING (``InstanceRecord.draining``) and force-publish: the
   instance stops receiving NEW placements (``ClusterView.placeable``)
   and ranks behind healthy copies as a serve target, but stays fully
   live — its loaded copies keep serving.
2. Pre-copy hot models (used within the recency window) to survivors:
   ``ensure_loaded(sync=True, exclude={self})`` places a copy elsewhere
   and blocks until it is ACTIVE/PARTIAL-servable. Because this instance
   still holds a loaded copy, the survivor's load resolves it as a peer
   weight source (transfer/) — the pre-copy streams over the mesh
   instead of hitting the model store; with the transfer path disabled
   it degrades to a store load (bounded drain time, still no gap: the
   local copy serves until the survivor is up).
3. Only then drop the local copy and deregister. Cold models skip the
   pre-copy and demote into the host tier instead (the snapshot stays a
   peer-fetch source for the rest of the drain window, and a re-warm is
   a host copy if the drain is aborted).
4. At the deadline (``MM_DRAIN_TIMEOUT_MS``) or when the cache is empty,
   flip ``shutting_down`` and deregister whatever remains — the bounded
   degradation the legacy path had throughout.

``ModelMeshInstance.pre_shutdown`` delegates here (gated on
``MM_DRAIN_ON_SIGTERM``), so SIGTERM triggers the drain in production;
``SimCluster.drain`` drives the identical path under virtual time.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.utils.clock import get_clock

if TYPE_CHECKING:  # pragma: no cover
    from modelmesh_tpu_torch.serving.instance import ModelMeshInstance

log = logging.getLogger(__name__)

# Models used within this window are "hot": they get a survivor pre-copy;
# everything colder demotes to the host tier (reference migrates only the
# recently-used set too, ModelMesh.java:7010).
DEFAULT_HOT_WINDOW_MS = 3_600_000


@dataclasses.dataclass
class DrainReport:
    started_ms: int = 0
    finished_ms: int = 0
    migrated: list[str] = dataclasses.field(default_factory=list)
    demoted: list[str] = dataclasses.field(default_factory=list)
    dropped: list[str] = dataclasses.field(default_factory=list)
    # model_id -> why the pre-copy failed (the copy kept serving until
    # the final sweep — bounded gap, not silent loss).
    failed: dict[str, str] = dataclasses.field(default_factory=dict)
    deadline_hit: bool = False

    @property
    def clean(self) -> bool:
        return not self.failed and not self.deadline_hit


class DrainController:
    """One-shot graceful drain of the owning instance."""

    def __init__(
        self,
        instance: "ModelMeshInstance",
        deadline_s: Optional[float] = None,
        hot_window_ms: int = DEFAULT_HOT_WINDOW_MS,
    ):
        self.instance = instance
        if deadline_s is None:
            deadline_s = instance.config.drain_timeout_ms / 1000.0
        self.deadline_s = deadline_s
        self.hot_window_ms = hot_window_ms

    def drain(self) -> DrainReport:
        inst = self.instance
        clock = get_clock()
        report = DrainReport(started_ms=now_ms())
        # Phase 1: advertise DRAINING. The publish bumps the instances
        # view epoch on every peer, so memoized serve routes recompute
        # and new placements exclude us from here on.
        inst.flightrec.record("drain", phase="advertise")
        inst.set_draining(True)
        inst.publish_instance_record(force=True)
        deadline = clock.monotonic() + self.deadline_s
        recent_cutoff = now_ms() - self.hot_window_ms
        skip_migration = getattr(inst, "shutdown_skip_migration", False)

        # Phase 2: MRU -> LRU so the hottest copies migrate first — if
        # the deadline cuts the pass short, what's lost is the coldest
        # tail, not the traffic-bearing head.
        for model_id, ce, last_used in list(inst.cache.descending_items()):
            if deadline - clock.monotonic() <= 0:
                report.deadline_hit = True
                break
            if not ce.state.is_servable:
                # A copy still loading (or failed) has nothing to hand
                # off; the final sweep deregisters it.
                continue
            if ce.is_shard:
                # Placement-group member: the generic pre-copy would lie
                # (ensure_loaded on a complete group just forwards to an
                # existing member and reports LOADED without moving OUR
                # shard), and dropping the shard un-replaced tears down
                # the WHOLE group (records.remove_instance is group-
                # atomic). Re-plan our index onto a survivor — pre-copy
                # the shard, wait until the survivor holds it — then
                # drop the local member; recency is irrelevant because
                # there is no demote path for shards.
                inst.flightrec.record("drain", phase="shard-replan",
                                      model=model_id)
                if not skip_migration and inst.replan_shard_for_drain(
                    model_id, deadline
                ):
                    report.migrated.append(model_id)
                    inst._remove_local(model_id)
                else:
                    report.failed[model_id] = (
                        "no survivor took shard "
                        f"{ce.shard_index}/{ce.shard_count}"
                    )
                    log.warning(
                        "drain: shard re-plan of %s[%d/%d] failed; copy "
                        "kept until final sweep", model_id,
                        ce.shard_index, ce.shard_count,
                    )
                continue
            if last_used >= recent_cutoff and not skip_migration:
                inst.flightrec.record("drain", phase="pre-copy",
                                      model=model_id)
                err = self._migrate(model_id, last_used)
                if err is None:
                    report.migrated.append(model_id)
                    # The survivor is servable and registered before our
                    # copy goes — this ordering is the zero-gap property.
                    inst._remove_local(model_id)
                else:
                    # Keep serving the local copy until the final sweep:
                    # a failed pre-copy must degrade to a bounded gap at
                    # shutdown, never an early one.
                    report.failed[model_id] = err
                    log.warning(
                        "drain: pre-copy of %s failed (%s); copy kept "
                        "until final sweep", model_id, err,
                    )
            else:
                if inst._remove_local(model_id, demote=True):
                    # "Demoted" means a host snapshot really survives as
                    # a peer-fetch source — not merely that the cold
                    # copy was removed (the demote is best-effort: tier
                    # disabled, non-streaming loader, or a PARTIAL copy
                    # all skip it).
                    if inst.host_tier.peek(model_id) is not None:
                        report.demoted.append(model_id)
                    else:
                        report.dropped.append(model_id)

        # Phase 3: final sweep — deregister everything left (pre-copy
        # failures, loading entries, post-deadline tail), then advertise
        # shutting_down so peers drop us from their live views.
        inst.flightrec.record("drain", phase="final-sweep",
                              deadline_hit=report.deadline_hit)
        inst.shutting_down = True
        for model_id, _ce, _lu in list(inst.cache.descending_items()):
            if inst._remove_local(model_id):
                report.dropped.append(model_id)
        inst.publish_instance_record(force=True)
        report.finished_ms = now_ms()
        inst.flightrec.record(
            "drain", phase="done", migrated=len(report.migrated),
            demoted=len(report.demoted), dropped=len(report.dropped),
            failed=len(report.failed),
        )
        log.info(
            "drain of %s complete in %dms: %d migrated, %d demoted, "
            "%d dropped, %d failed%s",
            inst.instance_id, report.finished_ms - report.started_ms,
            len(report.migrated), len(report.demoted),
            len(report.dropped), len(report.failed),
            " (deadline hit)" if report.deadline_hit else "",
        )
        return report

    def _migrate(self, model_id: str, last_used: int) -> Optional[str]:
        """Place a servable copy on a survivor; returns an error string
        (None = a survivor copy is ACTIVE/PARTIAL and registered). Each
        pre-copy runs under its own trace: the placement forwards over
        the normal internal hop, so the survivor's load (and its peer
        stream back from us) assembles into one drain-visible tree."""
        inst = self.instance
        try:
            with inst.tracer.trace("", model_id, "drain-precopy"):
                status = inst.ensure_loaded(
                    model_id, last_used_ms=last_used, sync=True,
                    exclude={inst.instance_id},
                )
        except Exception as e:  # noqa: BLE001 — per-model, drain continues
            return f"{type(e).__name__}: {e}"
        # sync=True blocks until the survivor copy is ACTIVE (a PARTIAL
        # streamed copy also reports LOADED — it is admitting requests).
        if status != "LOADED":
            return f"survivor copy not servable (status {status})"
        return None
