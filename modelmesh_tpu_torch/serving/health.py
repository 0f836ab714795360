"""The port's own copy of the JAX package's ``serving/health.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Readiness gating + bootstrap fail-fast probation.

Reference behaviors re-derived (not transcribed):

- Readiness (ModelMesh.java:1310-1331): an instance that has NEVER yet
  reported ready holds while any peer in the fleet advertises
  shutting-down; once an instance reports ready the state LATCHES
  (reference reportReady) and only a local shutdown un-readies it. A
  rolling update's readiness probe then holds the rollout at the new pod —
  the next pod isn't torn down until migrations off the draining pod
  finish (its record disappears when its session lease is revoked) —
  without flipping established pods out of the Service.
- Bootstrap probation (ModelMesh.java:1335-1419): during a startup window,
  repeated early load failures with zero successful loads mean the runtime
  or image is poisoned; the process aborts non-zero so the rollout FAILS at
  pod 1 instead of the bad image absorbing the whole fleet model-by-model
  as each migration lands on it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Optional

from modelmesh_tpu_torch.utils.clock import get_clock

log = logging.getLogger(__name__)

DEFAULT_PROBATION_WINDOW_S = 360.0
DEFAULT_PROBATION_MAX_FAILURES = 3


class ReadinessGate:
    """Answers the /ready probe from live cluster state.

    Readiness LATCHES after the first successful report, mirroring the
    reference's one-way ``reportReady`` flag (ModelMesh.java:1310-1331):
    only pods that have never been ready are held back by a draining
    peer. Without the latch, one draining pod would flip every
    established pod to 503 and Kubernetes would empty the Service's
    endpoints — a fleet-wide outage on every rolling-update step.
    A local shutdown still un-readies this pod regardless of the latch.
    """

    def __init__(self, instance) -> None:
        self.instance = instance
        self._latched = False

    def is_ready(self) -> tuple[bool, str]:
        inst = self.instance
        if inst.shutting_down:
            return False, "shutting down"
        if self._latched:
            return True, "ok (latched)"
        # Don't latch off an UNSYNCED view: at bootstrap the kubelet can
        # probe before the KV watch has populated instances_view — an
        # empty view shows no draining peer and would latch ready while a
        # migration off a draining pod is still in flight. Our own record
        # appearing proves the view has caught up to at least our own
        # registration, which pre_start publishes before serving.
        if inst.instance_id not in inst.instances_view:
            return False, "cluster view not yet synced"
        for iid, rec in inst.instances_view.items():
            if iid != inst.instance_id and rec.shutting_down:
                return False, f"peer {iid} draining (rolling update in flight)"
        self._latched = True
        return True, "ok"


def _default_abort(reason: str) -> None:
    log.critical("bootstrap probation abort: %s", reason)
    # Raw exit: the process is declared unfit; supervisors (k8s) see a
    # non-zero exit and halt the rollout.
    os._exit(3)


class BootstrapProbation:
    """Counts early load outcomes; aborts a poisoned bootstrap.

    Armed for ``window_s`` after construction. Any successful load disarms
    it (the runtime demonstrably works); ``max_failures`` failures with no
    success abort via ``abort_fn``. Thread-safe — loads complete on pool
    threads.
    """

    def __init__(
        self,
        window_s: float = DEFAULT_PROBATION_WINDOW_S,
        max_failures: int = DEFAULT_PROBATION_MAX_FAILURES,
        abort_fn: Callable[[str], None] = _default_abort,
    ) -> None:
        self.window_s = window_s
        self.max_failures = max(1, max_failures)
        self.abort_fn = abort_fn
        self._started = get_clock().monotonic()
        self._lock = threading.Lock()
        self._failures = 0
        self._disarmed = False

    @classmethod
    def from_env(cls) -> Optional["BootstrapProbation"]:
        """MM_PROBATION_S (0 disables) / MM_PROBATION_FAILURES."""
        from modelmesh_tpu_torch.utils.envs import get_float, get_int

        window = get_float("MM_PROBATION_S")
        if window <= 0:
            return None
        return cls(
            window_s=window, max_failures=get_int("MM_PROBATION_FAILURES")
        )

    def reset_window(self) -> None:
        """Re-stamp the window start. Called after slow runtime/accelerator
        initialization so probation guards the load-serving period, not the
        (potentially minutes-long) device claim that precedes it."""
        with self._lock:
            self._started = get_clock().monotonic()

    def record_success(self) -> None:
        with self._lock:
            self._disarmed = True

    def record_failure(self, model_id: str, message: str) -> None:
        with self._lock:
            if self._disarmed:
                return
            if get_clock().monotonic() - self._started > self.window_s:
                self._disarmed = True
                return
            self._failures += 1
            n = self._failures
        if n >= self.max_failures:
            self.abort_fn(
                f"{n} load failures with no success within {self.window_s:.0f}s "
                f"of startup (last: {model_id}: {message}) — runtime looks "
                f"poisoned; failing the rollout"
            )
