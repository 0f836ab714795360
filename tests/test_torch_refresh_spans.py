"""The placement refresh's spans and counters (``observability/tracing.py``
``RefreshSpans``) on the CPU: the ``mm.refresh.*`` ranges a profiler
records, the keys ``finalize_plan`` writes into ``plan.stats``, and what
stays off while no profiler records."""

import time

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.observability import tracing
from modelmesh_tpu_torch.ops.solve import SolveConfig
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.placement import torch_engine as te
from modelmesh_tpu_torch.placement.refresh_loop import PipelinedRefresher
from modelmesh_tpu_torch.placement.synthetic import synthetic_records

# Gated dense solves: the Sinkhorn probe and the auction's warm probe
# read their gates on the host. The sparse tier gates by its defaults.
GATED = SolveConfig(sinkhorn_tol=1e-3, auction_stall_tol=1e-3)
DEVICE_KEYS = ("cost_device_ms", "transport_device_ms", "auction_device_ms")
SPAN_KEYS = ("rpm_read_ms", "dirty_models", "dirty_instances",
             "gate_wait_ms", "solve_device_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pinned_clock(monkeypatch):
    """The snapshot's rates age with the wall clock: pinned, two runs of
    one script see the same columns."""
    monkeypatch.setattr(te, "now_ms", lambda: 42_000_000)


def _fleet(m):
    return synthetic_records(600, m, capacity_units=20_000)


def _dirty(models, instances, k=3):
    """Mark ``k`` models (each twice) and, for a full solve, one pod."""
    mids = [models[i][0] for i in range(k)]
    return mids + mids, [instances[0][0]] if instances else []


def _refresh(tier):
    """A strategy on the CPU and the fleet of ``tier`` after one cold
    refresh, with the next refresh's marks made: "dense" and "sparse"
    refresh a full solve next (a pod is dirty), "incremental" re-solves
    the dirty rows."""
    m = 256 if tier == "sparse" else 64
    models, instances = _fleet(m)
    strat = te.TorchPlacementStrategy(
        device="cpu", solve_config=None if tier == "sparse" else GATED)
    strat.refresh(models, instances, incremental=True)
    dm, di = _dirty(models, instances)
    strat.mark_dirty(dm, [] if tier == "incremental" else di)
    return strat, models, instances


def _ranges(prof):
    """The profiler's ``mm.refresh*`` ranges, (name, start, end) by start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(tracing.REFRESH_SPAN)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(ranges, parent):
    """Names of the ranges directly inside ``parent``, in order."""
    inner = [r for r in ranges if r is not parent and _inside(r, parent)]
    return [r[0] for r in inner
            if not any(o is not r and _inside(r, o) for o in inner)]


@pytest.mark.parametrize("tier,path", [("dense", "dense"),
                                       ("sparse", "sparse"),
                                       ("incremental", "incremental")])
def test_ranges_nest_in_the_refresh_order(tier, path):
    strat, models, instances = _refresh(tier)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = strat.refresh(models, instances, incremental=True)
    assert plan.stats["solver_path"] == path
    ranges = _ranges(prof)
    roots = [r for r in ranges if r[0] == "mm.refresh"]
    assert len(roots) == 1
    root = roots[0]
    assert all(_inside(r, root) for r in ranges)
    assert _children(ranges, root) == [
        "mm.refresh.snapshot", "mm.refresh.dispatch",
        "mm.refresh.readback_wait", "mm.refresh.extract"]
    snapshot = next(r for r in ranges if r[0] == "mm.refresh.snapshot")
    assert _children(ranges, snapshot) == ["mm.refresh.rpm"]
    dispatch = next(r for r in ranges if r[0] == "mm.refresh.dispatch")
    layers = [n for n in _children(ranges, dispatch)
              if n != "mm.refresh.gate"]
    want = {
        "dense": ["cost", "cost", "transport", "auction"],
        "sparse": ["cost", "cost", "select", "transport", "auction"],
        "incremental": ["cost", "cost", "transport", "auction"],
    }[tier]
    assert layers == [f"mm.refresh.{n}" for n in want]
    gates = [r for r in ranges if r[0] == "mm.refresh.gate"]
    assert len(gates) == plan.stats["host_syncs"] - 1
    assert all(_inside(g, dispatch) for g in gates)
    if tier != "incremental":
        assert gates


class _Counted(autograd_profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


@pytest.mark.parametrize("tier", ["dense", "sparse", "incremental"])
def test_no_range_without_a_profiler(tier, monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _Counted)
    monkeypatch.setattr(_Counted, "entered", 0)
    strat, models, instances = _refresh(tier)
    plan = strat.refresh(models, instances, incremental=True)
    assert _Counted.entered == 0
    assert all(k in plan.stats for k in SPAN_KEYS)
    # The counting stand-in does see the ranges of a profiled refresh.
    strat.mark_dirty(*_dirty(models, instances))
    with profile(activities=[ProfilerActivity.CPU]):
        strat.refresh(models, instances, incremental=True)
    assert _Counted.entered > 0


def test_gate_wait_holds_the_slowed_gates(monkeypatch):
    strat, models, instances = _refresh("dense")
    sleep_s = 0.02
    item = torch.Tensor.item

    def slow_item(self):
        time.sleep(sleep_s)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", slow_item)
    plan = strat.refresh(models, instances, incremental=True)
    gates = plan.stats["host_syncs"] - 1
    assert gates >= 2
    assert plan.stats["gate_wait_ms"] >= gates * sleep_s * 1e3
    assert plan.stats["gate_wait_ms"] <= plan.stats["dispatch_ms"]


@pytest.mark.parametrize("tier", ["dense", "sparse", "incremental"])
def test_span_keys_are_consistent(tier):
    strat, models, instances = _refresh(tier)
    plan = strat.refresh(models, instances, incremental=True)
    st = plan.stats
    assert 0 <= st["rpm_read_ms"] <= st["snapshot_ms"]
    assert 0 <= st["gate_wait_ms"] <= st["dispatch_ms"]
    layers = [st[k] for k in DEVICE_KEYS]
    assert all(v >= 0 for v in layers)
    assert sum(layers) <= st["solve_device_ms"]
    # On the CPU the solve is synchronous: its device time lies inside
    # the dispatch.
    assert st["solve_device_ms"] <= st["dispatch_ms"]


def test_dirty_counts_are_the_marks_consumed():
    models, instances = _fleet(64)
    strat = te.TorchPlacementStrategy(device="cpu")
    plan = strat.refresh(models, instances, incremental=True)
    assert plan.stats["dirty_models"] == plan.stats["dirty_instances"] == 0
    strat.mark_dirty(["m1", "m2", "m2", ("m3", 0)], ["i1", "i2", "i1"])
    plan = strat.refresh(models, instances, incremental=True)
    assert plan.stats["solver_path"] == "dense"
    assert (plan.stats["dirty_models"], plan.stats["dirty_instances"]) == (
        3, 2)
    strat.mark_dirty(["m5"])
    plan = strat.refresh(models, instances, incremental=True)
    assert plan.stats["solver_path"] == "incremental"
    assert (plan.stats["dirty_models"], plan.stats["dirty_instances"]) == (
        1, 0)
    # A blocking full refresh consumes the marks too.
    strat.mark_dirty(["m6", "m7"])
    plan = strat.refresh(models, instances)
    assert plan.stats["dirty_models"] == 2


@pytest.mark.parametrize("tier", ["dense", "sparse", "incremental"])
def test_plans_and_stats_the_same_with_the_profiler_on(tier):
    plans = []
    for profiled in (False, True):
        strat, models, instances = _refresh(tier)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                plans.append(strat.refresh(models, instances,
                                           incremental=True))
        else:
            plans.append(strat.refresh(models, instances, incremental=True))
    off, on = plans
    # (The wire bytes carry the solve's time and wall clock.)
    assert off.placements == on.placements
    assert off.generation == on.generation
    assert off.warm_g == on.warm_g and off.warm_price == on.warm_price
    assert set(off.stats) == set(on.stats)
    for k, v in off.stats.items():
        if not k.endswith("_ms"):
            assert on.stats[k] == v, k


def test_ops_called_directly_keep_no_record():
    models, instances = _fleet(64)
    cols = te.snapshot_columns(models, instances)
    assert tracing.current_refresh() is None
    plan = te.finalize_plan(te.dispatch_solve(cols, device="cpu"))
    assert not any(k in plan.stats for k in SPAN_KEYS + DEVICE_KEYS)
    assert "dispatch_ms" in plan.stats


def test_solve_plan_keeps_a_record():
    models, instances = _fleet(64)
    plan = te.solve_plan(models, instances, device="cpu")
    assert all(k in plan.stats for k in ("rpm_read_ms", "gate_wait_ms",
                                         "solve_device_ms"))
    assert tracing.current_refresh() is None


def test_pipelined_plans_resolve_their_own_records():
    models, instances = _fleet(64)
    strat = te.TorchPlacementStrategy(device="cpu")
    ref = PipelinedRefresher(strat)
    assert ref.submit(models, instances) is None
    strat.mark_dirty(["m1", "m2"])
    first = ref.submit(models, instances)
    strat.mark_dirty(["m3"], ["i4"])
    second = ref.submit(models, instances)
    last = ref.drain()
    assert first.stats["dirty_models"] == 0
    assert second.stats["dirty_models"] == 2
    assert (last.stats["dirty_models"], last.stats["dirty_instances"]) == (
        1, 1)
    for plan in (first, second, last):
        assert all(k in plan.stats for k in SPAN_KEYS)
    assert tracing.current_refresh() is None


def test_a_mesh_leaves_the_device_keys_out():
    mesh = mesh_mod.make_mesh((2, 1), ["cpu"] * 2)
    try:
        models, instances = _fleet(64)
        strat = te.TorchPlacementStrategy(device="cpu", mesh=mesh)
        plan = strat.refresh(models, instances)
        assert plan.stats["solver_path"] == "sharded"
        assert not any(k in plan.stats
                       for k in DEVICE_KEYS + ("solve_device_ms",))
        assert {"rpm_read_ms", "gate_wait_ms", "dirty_models"} <= set(
            plan.stats)
    finally:
        mesh.close()


def test_host_sync_time_grows_with_the_waits(monkeypatch):
    item = torch.Tensor.item

    def slow_item(self):
        time.sleep(0.01)
        return item(self)

    monkeypatch.setattr(torch.Tensor, "item", slow_item)
    syncs0, waited0 = device_mod.host_syncs, device_mod.host_sync_s
    assert device_mod.item(torch.tensor(True)) is True
    assert device_mod.host_syncs - syncs0 >= 1
    assert device_mod.host_sync_s - waited0 >= 0.01
