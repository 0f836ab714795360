"""The port's own copy of the JAX package's ``serving/tasks.py``, so far
only the leader reaper's plan step (``tasks.py:480-502``).

The elected leader's reaper scans the registry and the instances view
once, hands both to the strategy's ``refresh`` (a full warm refresh, as
the reference calls it) and publishes the plan into the KV, where every
instance's ``PlanFollower`` (``placement/plan_sync.py``) installs it. A
failed refresh or publish is logged and swallowed: the plan is advisory,
and greedy answers until the next pass.

The port's ``ModelMeshInstance`` (``serving/instance.py``) is the
caller's side: the step takes an instance's ``store``, ``registry``,
``instances_view`` and ``model_rpm`` with the instance's own strategy.
``BackgroundTasks`` (publisher, rate task, janitor, reaper, with
``autoscale/``) is not ported yet; its ``_reaper_tick`` will call
``reaper_plan_step`` and go on to the gauges, the prune pass and
proactive loading with the records and views the step returns.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple, Optional

from modelmesh_tpu_torch.placement.plan_sync import publish_plan

log = logging.getLogger(__name__)


class PlanStep(NamedTuple):
    """What one reaper plan step read and did. ``plan`` is None when the
    strategy has no ``refresh`` or the refresh or publish failed
    (``error`` then holds the exception); ``nbytes`` is the published
    size (0 when nothing was published). The ``*_ms`` fields are host
    wall times of the stages."""

    records: list
    views: list
    plan: Optional[object]
    nbytes: int
    error: Optional[BaseException]
    views_ms: float
    scan_ms: float
    refresh_ms: float
    publish_ms: float


def reaper_plan_step(store, kv_prefix: str, strategy, registry,
                     instances_view, rpm_fn=None) -> PlanStep:
    """One reaper pass's plan work (the reference's ``_reaper_tick`` up to
    its gauges): ``instances_view.items()``, ``registry.items()`` (one
    paged scan of the bucketed registry), ``strategy.refresh(records,
    views, rpm_fn)`` and ``publish_plan(store, kv_prefix, plan)``. The
    caller checks that it is the leader."""
    t0 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    views = list(instances_view.items())
    t1 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    records = list(registry.items())
    t2 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    plan = None
    nbytes = 0
    error = None
    t3 = None
    refresh = getattr(strategy, "refresh", None)
    if refresh is not None:
        try:
            plan = refresh(records, views, rpm_fn)
            t3 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
            # Publish so EVERY instance's PlanFollower serves this solve,
            # not just the leader's own strategy.
            nbytes = publish_plan(store, kv_prefix, plan)
        except Exception as e:  # noqa: BLE001 — plan is advisory
            log.exception("global plan refresh/publish failed")
            plan, nbytes, error = None, 0, e
    t4 = time.perf_counter()  #: wall-clock: perf_counter stage-timing metric
    if t3 is None:  # no refresh, or the refresh itself failed
        t3 = t4
    return PlanStep(
        records=records, views=views, plan=plan, nbytes=nbytes, error=error,
        views_ms=(t1 - t0) * 1e3, scan_ms=(t2 - t1) * 1e3,
        refresh_ms=(t3 - t2) * 1e3, publish_ms=(t4 - t3) * 1e3,
    )
