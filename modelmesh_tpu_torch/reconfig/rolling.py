"""The port's own copy of the JAX package's ``reconfig/rolling.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Rolling-upgrade orchestration: version-aware wave planning.

The reference tracks rolling updates indirectly — ``UpgradeTracker``
infers outgoing replica sets from instance-id structure. This module is
the direct form the registry already carries the data for:
``InstanceRecord.instance_version`` (published by every instance,
previously write-only) names each pod's deployment version, so the
planner can compute exactly which instances are outdated, drain them in
bounded waves (``MM_UPGRADE_MAX_UNAVAILABLE`` per wave), and bias
placement toward up-version targets while a rollout is in flight —
models migrate forward with the upgrade, never backward onto pods about
to be replaced.

The coordinator is deliberately hook-driven (drain / replace / readiness
are callables): in production those map onto the platform's pod
lifecycle; in the deterministic sim they map onto
``SimCluster.drain``/``add_instance`` so the whole orchestration is
replayable under virtual time (sim/scenarios.py rolling-restart
scenario).
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
from typing import Callable, Optional, Sequence

from modelmesh_tpu_torch.records import InstanceRecord

log = logging.getLogger(__name__)

_SEGMENT = re.compile(r"[.\-_]")


def max_unavailable_default() -> int:
    from modelmesh_tpu_torch.utils import envs

    return max(1, envs.get_int("MM_UPGRADE_MAX_UNAVAILABLE"))


def version_key(version: str) -> tuple:
    """Total order over ``instance_version`` strings.

    Dotted/dashed segments compare numerically when numeric ("v1.10" >
    "v1.9"), with a "v"/"V" prefix normalized away so "v1.2" == "1.2"
    (mixed labeling conventions across a deployment tool change must
    not read as a permanent rollout); non-numeric segments compare
    lexicographically; an empty version sorts oldest, so unlabeled
    legacy pods are always upgrade candidates. Each element is a
    (kind, int, str) triple so mixed numeric/text segments never raise
    on comparison.
    """
    if not version:
        return ()
    key = []
    for part in _SEGMENT.split(version):
        bare = part.lstrip("vV")
        if bare.isdigit():
            key.append((0, int(bare), ""))
        else:
            key.append((1, 0, part))
    return tuple(key)


def rollout_active(
    instances: Sequence[tuple[str, InstanceRecord]]
) -> bool:
    """A rollout is in flight when live instances advertise 2+ distinct
    versions (by ORDER, not raw string — "v1.2" and "1.2" are one
    version) — the only signal placement needs (no coordinator state)."""
    return len({
        version_key(rec.instance_version) for _, rec in instances
    }) >= 2


def upversion_shortlist(
    candidates: Sequence[tuple[str, InstanceRecord]]
) -> list[tuple[str, InstanceRecord]]:
    """Placement bias during an active rollout: when the candidate set
    spans versions, only the newest-version instances compete — a model
    displaced by a draining old-version pod lands up-version and never
    migrates backward onto a pod the next wave will drain. With a single
    version present (no rollout) this is the identity."""
    pairs = list(candidates)
    if not rollout_active(pairs):
        return pairs
    best = max(version_key(rec.instance_version) for _, rec in pairs)
    # Never empty: best is drawn from the versions present in pairs.
    return [
        (iid, rec) for iid, rec in pairs
        if version_key(rec.instance_version) == best
    ]


def plan_waves(
    instances: Sequence[tuple[str, InstanceRecord]],
    target_version: str,
    max_unavailable: Optional[int] = None,
) -> list[list[str]]:
    """Partition outdated instances into drain waves.

    An instance is outdated when its version orders strictly below the
    target (at-or-above-target instances are never touched — "never
    backward" applies to the orchestrator too). Oldest versions drain
    first (they are the likeliest to be the reason for the upgrade);
    ties break on instance id so the plan is deterministic.
    """
    mu = (
        max_unavailable if max_unavailable is not None
        else max_unavailable_default()
    )
    if mu < 1:
        # An explicit 0 is a caller error, not "use the default" — it
        # would read as a request for zero concurrent unavailability.
        raise ValueError(f"max_unavailable must be >= 1, got {mu}")
    target = version_key(target_version)
    outdated = sorted(
        (version_key(rec.instance_version), iid)
        for iid, rec in instances
        if version_key(rec.instance_version) < target
    )
    ids = [iid for _, iid in outdated]
    return [ids[i:i + mu] for i in range(0, len(ids), mu)]


@dataclasses.dataclass
class UpgradeReport:
    target_version: str
    waves: list[list[str]] = dataclasses.field(default_factory=list)
    replaced: list[str] = dataclasses.field(default_factory=list)
    failures: list[str] = dataclasses.field(default_factory=list)

    @property
    def complete(self) -> bool:
        return not self.failures


class RollingUpgradeCoordinator:
    """Drive a fleet to ``target_version`` in bounded waves.

    Hooks:
    - ``list_instances() -> [(iid, InstanceRecord)]`` — current live fleet.
    - ``drain_instance(iid)`` — gracefully drain AND terminate the pod
      (DrainController semantics: pre-copy, deregister, then die).
    - ``replace_instance(iid, target_version)`` — start the replacement
      pod at the new version (platform-specific; the sim adds a fresh
      SimPod).
    - ``wait_ready(expect_n)`` — block until the fleet again has
      ``expect_n`` live members (clock-aware at the call site).

    Each wave drains at most ``max_unavailable`` instances CONCURRENTLY,
    replaces them, waits for readiness, then re-plans from the live
    fleet — a pod that upgraded out-of-band (or died) between waves is
    simply no longer in the plan.
    """

    def __init__(
        self,
        target_version: str,
        *,
        list_instances: Callable[[], Sequence[tuple[str, InstanceRecord]]],
        drain_instance: Callable[[str], None],
        replace_instance: Callable[[str, str], Optional[str]],
        wait_ready: Optional[Callable[[int], None]] = None,
        max_unavailable: Optional[int] = None,
        max_waves: int = 256,
    ):
        self.target_version = target_version
        if max_unavailable is None:
            max_unavailable = max_unavailable_default()
        if max_unavailable < 1:
            raise ValueError(
                f"max_unavailable must be >= 1, got {max_unavailable}"
            )
        self.max_unavailable = max_unavailable
        self.max_waves = max_waves
        self._list = list_instances
        self._drain = drain_instance
        self._replace = replace_instance
        self._wait_ready = wait_ready

    def run(self) -> UpgradeReport:
        report = UpgradeReport(self.target_version)
        for _ in range(self.max_waves):
            fleet = list(self._list())
            waves = plan_waves(
                fleet, self.target_version, self.max_unavailable
            )
            if not waves:
                return report
            wave = waves[0]
            report.waves.append(wave)
            log.info(
                "rolling upgrade to %s: draining wave %s (%d left)",
                self.target_version, wave,
                sum(len(w) for w in waves),
            )
            drains = [
                threading.Thread(
                    target=self._drain_one, args=(iid, report),
                    name=f"upgrade-drain-{iid}", daemon=True,
                )
                for iid in wave
            ]
            for t in drains:
                t.start()
            for t in drains:
                t.join()
            for iid in wave:
                try:
                    self._replace(iid, self.target_version)
                    report.replaced.append(iid)
                except Exception as e:  # noqa: BLE001 — surface, don't wedge
                    report.failures.append(f"replace {iid}: {e}")
            if self._wait_ready is not None:
                try:
                    self._wait_ready(len(fleet))
                except Exception as e:  # noqa: BLE001
                    report.failures.append(f"wait_ready: {e}")
                    return report
        report.failures.append("max_waves exceeded (fleet churning?)")
        return report

    def _drain_one(self, iid: str, report: UpgradeReport) -> None:
        try:
            self._drain(iid)
        except Exception as e:  # noqa: BLE001 — a failed drain is reported,
            # not fatal: the pod still gets replaced (bounded-gap path).
            log.warning("drain of %s failed: %s", iid, e)
            report.failures.append(f"drain {iid}: {e}")
