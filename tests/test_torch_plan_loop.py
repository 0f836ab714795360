"""The registry and the leader/follower plan loop on the port, end to end
on ``device="cpu"``: the port's ``InMemoryKV``, tables, sessions and
election, the reaper's plan step (``serving/tasks.py``),
``publish_plan``/``PlanFollower`` and ``TorchPlacementStrategy``.

- A leader's reaper step publishes into the port's store under a byte
  budget that forces truncation; a follower adopts exactly the kept
  models, answers ``choose_load_target`` from the plan for a kept model
  and through greedy for a cut one.
- The same registry (``test_torch_strategy.py``'s 600 x 200 churn fleet,
  f32 solves, where that file holds the two strategies' placements
  equal) through the reference's store, ``JaxPlacementStrategy`` and
  ``publish_plan``: equal decoded placements and equal ``g``/``n``/``w``
  header fields. The time fields may differ; the solve's ``ms`` is
  pinned on both sides, because its printed length moves the byte
  budget's cut.
- Across packages: the reference's ``PlanFollower`` adopts the port's
  bytes, the port's adopts the reference's.
- The step's failure handling (logged and swallowed; nothing published),
  a strategy without ``refresh``, a leader handover, and a shadow
  strategy as the leader's.
"""

import logging
import time
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import modelmesh_tpu.kv as ref_kv
import modelmesh_tpu.kv.table as ref_table
import modelmesh_tpu.placement.plan_sync as ref_sync
import modelmesh_tpu.records as ref_records
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.placement.synthetic import synthetic_records
from modelmesh_tpu_torch import kv as port_kv
from modelmesh_tpu_torch import records as port_records
from modelmesh_tpu_torch.kv import table as port_table
from modelmesh_tpu_torch.ops.solve import SolveConfig
from modelmesh_tpu_torch.placement import plan_sync as port_sync
from modelmesh_tpu_torch.placement import torch_engine as te
from modelmesh_tpu_torch.placement.greedy import GreedyStrategy
from modelmesh_tpu_torch.placement.shadow import ShadowStrategy
from modelmesh_tpu_torch.placement.strategy import (
    LOAD_HERE, ClusterView, PlacementRequest,
)
from modelmesh_tpu_torch.serving.tasks import PlanStep, reaper_plan_step

NOW = 42_000_000
PREFIX = "mm"
WAIT_S = 10.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """Both engines read one clock: snapshot recency and the plans'
    timestamps (the followers' orphan guard compares them)."""
    monkeypatch.setattr(je, "now_ms", lambda: NOW)
    monkeypatch.setattr(te, "now_ms", lambda: NOW)


class FixedMsTorch(te.TorchPlacementStrategy):
    def refresh(self, *args, **kw):
        plan = super().refresh(*args, **kw)
        plan.solve_ms = 12.5
        return plan


class FixedMsJax(je.JaxPlacementStrategy):
    def refresh(self, *args, **kw):
        plan = super().refresh(*args, **kw)
        plan.solve_ms = 12.5
        return plan


def _torch_strategy(**kw):
    return FixedMsTorch(solve_config=SolveConfig(dtype=torch.float32),
                        device="cpu", **kw)


def _fleet(n=600, m=200, seed=3):
    """``test_torch_strategy.py::_churn_sequence``'s fleet as field
    dicts: 200 instances pad to 256 (the sparse path), 85% utilization,
    seeded rpm."""
    models, instances = synthetic_records(n, m)
    demand = sum(mr.size_units for _, mr in models)
    for _, rec in instances:
        rec.capacity_units = max(1, round(demand / (0.85 * m)))
    rng = np.random.default_rng(seed)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, n))}
    return models, instances, rpm


def _wait(pred, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.005)


def _registry(kv_mod, table_mod, records_mod, fleet, skip_instances=()):
    """A store holding the fleet: models through a BucketedKVTable under
    mm/registry, instances (except ``skip_instances``) through a KVTable
    under mm/instances. Instances go in in key order: a TableView lists
    them in the order it admitted them, from its watch's replay (put
    order) or from its seed scan (key order), whichever lands first, and
    the solve's columns follow that order."""
    models, instances, _ = fleet
    kv = kv_mod.InMemoryKV()
    registry = table_mod.BucketedKVTable(kv, f"{PREFIX}/registry",
                                         records_mod.ModelRecord)
    for mid, mr in models:
        registry.put(mid, records_mod.ModelRecord.from_bytes(
            mr.to_bytes(), 0))
    table = table_mod.KVTable(kv, f"{PREFIX}/instances",
                              records_mod.InstanceRecord)
    for iid, rec in sorted(instances, key=lambda p: p[0]):
        if iid not in skip_instances:
            table.put(iid, records_mod.InstanceRecord.from_bytes(
                rec.to_bytes(), 0))
    return kv, registry, table


class Pod:
    """An instance's cluster-layer wiring on the port (as the reference's
    ModelMeshInstance wires it)."""

    def __init__(self, kv, iid, rec, strategy, ttl_s=5.0):
        self.iid, self.strategy = iid, strategy
        self.view = port_table.TableView(port_table.KVTable(
            kv, f"{PREFIX}/instances", port_records.InstanceRecord))
        self.session = port_kv.SessionNode(
            kv, f"{PREFIX}/instances/{iid}", rec.to_bytes(), ttl_s=ttl_s)
        self.session.start()
        self.election = port_kv.LeaderElection(
            kv, f"{PREFIX}/leader", iid, lambda _: None, ttl_s=ttl_s)
        self.election.start()
        self.follower = port_sync.PlanFollower(kv, PREFIX, strategy)

    def close(self):
        self.follower.close()
        self.view.close()
        self.election.close()
        self.session.close()


def _header(data: bytes) -> dict:
    import json

    raw = zlib.decompress(data)
    assert raw.startswith(b"MMP2")
    n = int.from_bytes(raw[4:8], "big")
    return json.loads(raw[8:8 + n])


def test_leader_publishes_truncated_plan_and_follower_adopts(monkeypatch):
    fleet = _fleet()
    models, instances, rpm = fleet
    pods_at = [instances[0], instances[1]]
    kv, registry, _ = _registry(port_kv, port_table, port_records, fleet,
                                skip_instances={i for i, _ in pods_at})
    pods = []
    try:
        for iid, rec in pods_at:
            pods.append(Pod(kv, iid, rec, _torch_strategy()))
        leader, follower = pods
        _wait(lambda: leader.election.is_leader, "a leader")
        assert not follower.election.is_leader
        _wait(lambda: all(len(p.view) == len(instances) for p in pods),
              "the views")
        # An untruncated step first: its size sets the budget below.
        full = reaper_plan_step(kv, PREFIX, leader.strategy, registry,
                                leader.view, rpm)
        assert full.error is None and full.plan.num_models() == len(models)
        assert full.nbytes == len(kv.get(port_sync.plan_key(PREFIX)).value)
        monkeypatch.setenv("MM_MAX_PLAN_BYTES", str(full.nbytes // 3))
        step = reaper_plan_step(kv, PREFIX, leader.strategy, registry,
                                leader.view, rpm)
        assert isinstance(step, PlanStep) and step.error is None
        assert step.plan.generation == 2
        assert len(step.records) == len(models)
        assert len(step.views) == len(instances)
        published = kv.get(port_sync.plan_key(PREFIX)).value
        assert step.nbytes == len(published) <= full.nbytes // 3
        kept = te.GlobalPlan.from_bytes(published).num_models()
        assert 0 < kept < len(models)
        _wait(lambda: all(p.strategy.plan is not None
                          and p.strategy.plan.generation == 2
                          and p.strategy.plan.num_models() == kept
                          for p in pods), "adoption")
        for p in pods:
            assert p.strategy.plan.to_bytes() == published
        # Kept models answer from the plan, cut ones through greedy.
        plan = follower.strategy.plan
        view = ClusterView(follower.view.items())
        live = {iid for iid, _ in view.placeable()}
        records = dict(step.records)
        order = step.plan._columnar[0]
        from_plan = 0
        for mid in order[:kept:7]:
            mr = records[mid]
            req = PlacementRequest(model_id=mid, model=mr,
                                   required_units=mr.size_units,
                                   requesting_instance=follower.iid)
            want = next((i for i in plan.lookup(mid)
                         if i in live and i not in mr.instance_ids), None)
            got = follower.strategy.choose_load_target(req, view)
            if want is not None:
                from_plan += 1
                assert got == (LOAD_HERE if want == follower.iid else want)
        assert from_plan > 0
        for mid in order[kept::37]:
            mr = records[mid]
            assert plan.lookup(mid) is None
            req = PlacementRequest(model_id=mid, model=mr,
                                   required_units=mr.size_units,
                                   requesting_instance=follower.iid)
            assert follower.strategy.choose_load_target(req, view) == (
                GreedyStrategy().choose_load_target(req, view))
    finally:
        for p in pods:
            p.close()
        kv.close()


def _port_loop(fleet):
    kv, registry, table = _registry(port_kv, port_table, port_records,
                                    fleet)
    view = port_table.TableView(table)
    try:
        step = reaper_plan_step(kv, PREFIX, _torch_strategy(), registry,
                                view, fleet[2])
        assert step.error is None
        return kv.get(port_sync.plan_key(PREFIX)).value
    finally:
        view.close()
        kv.close()


def _reference_loop(fleet):
    """The reference reaper's lines (``tasks.py:480-502``) on the
    reference's store, tables and strategy."""
    kv, registry, table = _registry(ref_kv, ref_table, ref_records, fleet)
    view = ref_table.TableView(table)
    try:
        strat = FixedMsJax(solve_config=JaxConfig(dtype=jnp.float32))
        views = list(view.items())
        records = list(registry.items())
        plan = strat.refresh(records, views, fleet[2])
        ref_sync.publish_plan(kv, PREFIX, plan)
        return kv.get(ref_sync.plan_key(PREFIX)).value
    finally:
        view.close()
        kv.close()


@pytest.mark.parametrize("budget_frac", [None, 0.3])
def test_plan_loop_matches_reference_loop(monkeypatch, budget_frac):
    fleet = _fleet()
    if budget_frac is not None:
        full = _reference_loop(fleet)
        monkeypatch.setenv("MM_MAX_PLAN_BYTES",
                           str(int(len(full) * budget_frac)))
    ours = _port_loop(fleet)
    theirs = _reference_loop(fleet)
    ha, hb = _header(ours), _header(theirs)
    assert {k: ha[k] for k in "gnw"} == {k: hb[k] for k in "gnw"}
    a, b = te.GlobalPlan.from_bytes(ours), je.GlobalPlan.from_bytes(theirs)
    assert a.placements == b.placements
    assert list(a.placements) == list(b.placements)   # hottest first
    if budget_frac is not None:
        assert a.num_models() < len(fleet[0])


def _plan_pair():
    fleet = _fleet(n=300, m=60)
    models, instances, rpm = fleet
    port_plan = _torch_strategy().refresh(models, instances, rpm)
    ref_plan = FixedMsJax(solve_config=JaxConfig(dtype=jnp.float32)).refresh(
        models, instances, rpm)
    return port_plan, ref_plan


@pytest.mark.parametrize("path", ["initial_read", "watch"])
def test_followers_adopt_across_packages(path):
    port_plan, ref_plan = _plan_pair()
    # The reference's follower, the port's bytes.
    kv = ref_kv.InMemoryKV()
    strat = je.JaxPlacementStrategy()
    try:
        if path == "initial_read":
            kv.put(ref_sync.plan_key(PREFIX), port_plan.to_bytes())
        follower = ref_sync.PlanFollower(kv, PREFIX, strat)
        if path == "watch":
            kv.put(ref_sync.plan_key(PREFIX), port_plan.to_bytes())
        _wait(lambda: strat.plan is not None, "reference adoption")
        assert strat.plan.placements == port_plan.placements
        assert strat.plan.to_bytes() == port_plan.to_bytes()
        follower.close()
    finally:
        kv.close()
    # The port's follower, the reference's bytes.
    kv = port_kv.InMemoryKV()
    tstrat = te.TorchPlacementStrategy(device="cpu")
    try:
        if path == "initial_read":
            kv.put(port_sync.plan_key(PREFIX), ref_plan.to_bytes())
        follower = port_sync.PlanFollower(kv, PREFIX, tstrat)
        if path == "watch":
            kv.put(port_sync.plan_key(PREFIX), ref_plan.to_bytes())
        _wait(lambda: tstrat.plan is not None, "port adoption")
        assert tstrat.plan.placements == ref_plan.placements
        assert tstrat.plan.to_bytes() == ref_plan.to_bytes()
        assert tstrat.plan._index is not None      # indexed on the watch
        # A deleted plan clears the follower's; an older revision never
        # replaces a newer one.
        kv.delete(port_sync.plan_key(PREFIX))
        _wait(lambda: tstrat.plan is None, "the plan cleared")
        follower._decode_and_adopt(ref_plan.to_bytes(), 1)
        assert tstrat.plan is None
        follower.close()
    finally:
        kv.close()


def test_follower_ignores_orphaned_plans():
    plan = te.GlobalPlan({"m0": ["i0"]}, NOW - port_sync.MAX_PLAN_WALL_AGE_MS
                         - 1, 1.0, 4)
    kv = port_kv.InMemoryKV()
    tstrat = te.TorchPlacementStrategy(device="cpu")
    try:
        kv.put(port_sync.plan_key(PREFIX), plan.to_bytes())
        port_sync.PlanFollower(kv, PREFIX, tstrat).close()
        assert tstrat.plan is None
    finally:
        kv.close()


class Failing(GreedyStrategy):
    def refresh(self, models, instances, rpm_fn=None):
        raise RuntimeError("solver down")


def test_step_swallows_failure_and_needs_refresh(caplog):
    fleet = _fleet(n=40, m=8)
    kv, registry, table = _registry(port_kv, port_table, port_records,
                                    fleet)
    view = port_table.TableView(table)
    try:
        with caplog.at_level(logging.ERROR):
            step = reaper_plan_step(kv, PREFIX, Failing(), registry, view)
        assert step.plan is None and step.nbytes == 0
        assert isinstance(step.error, RuntimeError)
        assert "refresh/publish failed" in caplog.text
        assert len(step.records) == 40 and len(step.views) == 8
        assert kv.get(port_sync.plan_key(PREFIX)) is None
        # Greedy has no refresh: nothing to publish, no error.
        step = reaper_plan_step(kv, PREFIX, GreedyStrategy(), registry, view)
        assert (step.plan, step.error, step.nbytes) == (None, None, 0)
        assert kv.get(port_sync.plan_key(PREFIX)) is None
        assert min(step.scan_ms, step.views_ms, step.refresh_ms,
                   step.publish_ms) >= 0
    finally:
        view.close()
        kv.close()


def test_handover_and_shadow_leader():
    """The leader leaves; the next candidate leads and its step
    publishes a later revision that the remaining pods adopt. A shadow
    strategy as the leader's publishes its solver's plan."""
    fleet = _fleet(n=120, m=16)
    models, instances, rpm = fleet
    pods_at = instances[:3]
    kv, registry, _ = _registry(port_kv, port_table, port_records, fleet,
                                skip_instances={i for i, _ in pods_at})
    pods = []
    try:
        for k, (iid, rec) in enumerate(pods_at):
            strat = (ShadowStrategy(GreedyStrategy(), _torch_strategy())
                     if k == 1 else _torch_strategy())
            pods.append(Pod(kv, iid, rec, strat, ttl_s=0.5))
        first = reaper_plan_step(kv, PREFIX, pods[0].strategy, registry,
                                 pods[0].view, rpm)
        rev = kv.get(port_sync.plan_key(PREFIX)).mod_rev
        pods[0].election.close()
        pods[0].session.close()
        _wait(lambda: pods[1].election.is_leader, "the handover", 2.0)
        assert not pods[2].election.is_leader
        _wait(lambda: pods[0].iid not in pods[1].view, "the view")
        step = reaper_plan_step(kv, PREFIX, pods[1].strategy, registry,
                                pods[1].view, rpm)
        assert step.error is None and first.error is None
        kvp = kv.get(port_sync.plan_key(PREFIX))
        assert kvp.mod_rev > rev
        # The new leader's generation is its own refresh count.
        assert step.plan.generation == 1
        holder = pods[2].strategy
        _wait(lambda: holder.plan is not None
              and holder.plan.to_bytes() == kvp.value, "adoption")
        _wait(lambda: pods[1].strategy.shadow.plan is not None
              and pods[1].strategy.shadow.plan.to_bytes() == kvp.value,
              "the shadow's adoption")
        assert len(step.views) == len(instances) - 1
    finally:
        for p in pods:
            p.close()
        kv.close()
