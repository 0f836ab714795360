"""The port's GlobalPlan through the reference's plan distribution
(modelmesh_tpu/placement/plan_sync.py), on the CPU.

- ``truncate(keep)`` gives the reference's bytes: the same columnar plan,
  or the same dict plan, truncated on both sides serializes to identical
  ``to_bytes()`` at several ``keep`` values, the kept rows re-indexed
  against only the instances they use.
- ``publish_plan`` trims a port plan that is over its byte budget (it
  calls ``truncate``), and a ``PlanFollower`` hands the published plan,
  indexed (``ensure_index``), to a port strategy that answers placement
  decisions from it.
"""

import time

import numpy as np
import pytest
import torch

from modelmesh_tpu.kv import InMemoryKV
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.placement.greedy import GreedyStrategy
from modelmesh_tpu.placement.plan_sync import (
    PlanFollower,
    plan_key,
    publish_plan,
)
from modelmesh_tpu.placement.strategy import ClusterView, PlacementRequest
from modelmesh_tpu.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch.placement import torch_engine as te
from modelmesh_tpu_torch.records import now_ms

SOLVED_AT = 1_700_000_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _columnar(n=3000, m=700, seed=0):
    """A plan in the columnar form ``finalize_plan`` builds: 0-8 targets a
    model, flat indices into the instance table."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.uint8)
    flat = rng.integers(0, m, int(counts.sum())).astype(np.int32)
    model_ids = [f"model-{i:05d}" for i in range(n)]
    inst_ids = [f"inst-{j:04d}" for j in range(m)]
    return model_ids, counts, flat, inst_ids


def _pair(args):
    ref = je.GlobalPlan.from_columnar(*args, SOLVED_AT, 12.5, generation=3)
    port = te.GlobalPlan.from_columnar(*args, SOLVED_AT, 12.5, generation=3)
    return ref, port


@pytest.mark.parametrize("keep", [0, 1, 7, 1000, 2999, 3000, 5000])
def test_columnar_truncate_bytes_equal_reference(keep):
    ref, port = _pair(_columnar())
    ref.adopted_at_ms = port.adopted_at_ms = SOLVED_AT + 5
    rcut, pcut = ref.truncate(keep), port.truncate(keep)
    assert pcut.to_bytes() == rcut.to_bytes()
    assert pcut.num_models() == rcut.num_models() == min(keep, 3000)
    assert pcut.adopted_at_ms == SOLVED_AT + 5
    assert pcut.generation == 3
    # The kept rows keep their targets, and only the instances they use.
    for mid in list(port.placements)[: min(keep, 3000)]:
        assert pcut.lookup(mid) == port.lookup(mid)
    used = {t for mid in pcut.placements for t in pcut.placements[mid]}
    assert pcut._columnar[3] == sorted(used)


@pytest.mark.parametrize("keep", [0, 2, 50])
def test_dict_truncate_bytes_equal_reference(keep):
    placements = {f"m{i}": [f"i{(i * 7 + k) % 13}" for k in range(i % 4)]
                  for i in range(60)}
    ref = je.GlobalPlan(dict(placements), SOLVED_AT, 1.0, generation=2)
    port = te.GlobalPlan(dict(placements), SOLVED_AT, 1.0, generation=2)
    rcut, pcut = ref.truncate(keep), port.truncate(keep)
    assert pcut.to_bytes() == rcut.to_bytes()
    assert list(pcut.placements) == list(placements)[:keep]


def test_ensure_index_is_public():
    _, port = _pair(_columnar(n=40, m=9))
    back = te.GlobalPlan.from_bytes(port.to_bytes())
    assert back._index is None
    back.ensure_index()
    assert back._index is not None and len(back._index) == 40
    for mid in port._columnar[0]:
        assert back.lookup(mid) == port.lookup(mid)


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _fleet(n=400, m=6):
    models = [(f"m{i}", ModelRecord(model_type="t", size_units=64,
                                    last_used=1000)) for i in range(n)]
    instances = [
        (f"i{j}", InstanceRecord(capacity_units=10_000, used_units=1000,
                                 zone="ab"[j % 2], lru_ts=1000))
        for j in range(m)
    ]
    return models, instances


def test_publish_trims_a_port_plan_and_a_follower_adopts_it():
    """A leader on the port's strategy publishes over a budget small
    enough to force truncation; a follower on the port's strategy adopts
    the trimmed plan and answers from it."""
    models, instances = _fleet()
    leader = te.TorchPlacementStrategy(fallback=GreedyStrategy(),
                                       device="cpu")
    plan = leader.refresh(models, instances)
    full = len(plan.to_bytes())
    kv = InMemoryKV(sweep_interval_s=0.05)
    follower_strat = te.TorchPlacementStrategy(fallback=GreedyStrategy(),
                                               device="cpu")
    try:
        n = publish_plan(kv, "mm", plan, max_bytes=full // 2)
        assert n <= full // 2
        stored = kv.get(plan_key("mm")).value
        kept = te.GlobalPlan.from_bytes(stored).num_models()
        assert 0 < kept < len(models)
        follower = PlanFollower(kv, "mm", follower_strat)
        assert _wait(lambda: follower_strat.plan is not None)
        adopted = follower_strat.plan
        assert adopted._index is not None  # indexed in the watch thread
        assert adopted.num_models() == kept
        # The follower's decisions come from the published (hottest-first)
        # rows: the first kept model's plan target, not the fallback's.
        mid, rec = models[int(list(adopted.placements)[0][1:])]
        want = adopted.lookup(mid)
        req = PlacementRequest(model_id=mid, model=rec, required_units=64,
                               requesting_instance="i-other")
        got = follower_strat.choose_load_target(
            req, ClusterView(instances=instances))
        assert got == want[0]
        follower.close()
    finally:
        kv.close()


def test_publish_under_budget_is_untrimmed():
    models, instances = _fleet(n=50)
    plan = te.TorchPlacementStrategy(
        fallback=GreedyStrategy(), device="cpu").refresh(models, instances)
    kv = InMemoryKV()
    try:
        n = publish_plan(kv, "mm", plan, max_bytes=1 << 20)
        assert n == len(plan.to_bytes())
        back = je.GlobalPlan.from_bytes(kv.get(plan_key("mm")).value)
        assert back.num_models() == 50
        assert back.adopted_at_ms <= now_ms()
    finally:
        kv.close()
