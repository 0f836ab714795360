"""The port's placement strategy (``TorchPlacementStrategy``,
``placement/torch_engine.py``) and its copy of the strategy SPI
(``placement/strategy.py``) against the JAX package's, on the CPU.

- The reference's own strategy gates, case for case on the port with the
  reference's ``GreedyStrategy`` as the fallback: the incremental
  dispatch cases of ``tests/test_jax_engine.py::TestIncrementalDispatch``,
  and from ``tests/test_steady_refresh.py`` the versioned-mark requeue,
  the delta refresh equal to a full one, and the empty view that keeps the
  carries (through ``refresh``: the pipelined refresher is not ported).
- One churn sequence through both strategies: the path and the dirty row
  count equal at every step; placements equal at f32, agreement >= 0.97
  at bf16.
- The SPI's signatures pinned against the reference's with
  ``inspect.signature``; the plan-serving decisions and their fallback.

Records are the JAX package's (the port's code reads them duck-typed);
every port strategy runs with ``device="cpu"``.
"""

import copy
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.placement import strategy as jax_spi
from modelmesh_tpu.placement.greedy import GreedyStrategy
from modelmesh_tpu.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch import records as torch_records
from modelmesh_tpu_torch.ops.solve import SolveConfig
from modelmesh_tpu_torch.placement import strategy as spi
from modelmesh_tpu_torch.placement import torch_engine as te

NOW = 42_000_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strategy(**kw):
    return te.TorchPlacementStrategy(fallback=GreedyStrategy(),
                                     device="cpu", **kw)


def _models(n, loaded_on=None, size=64):
    """``tests/test_jax_engine.py``'s fleet helper."""
    out = []
    for i in range(n):
        mr = ModelRecord(model_type="t", size_units=size, last_used=1000)
        if loaded_on:
            mr.promote_loaded(loaded_on[i % len(loaded_on)], 1000)
        out.append((f"m{i}", mr))
    return out


def _instances(m, cap=10_000, zone_cycle=("a", "b")):
    return [
        (
            f"i{j}",
            InstanceRecord(
                capacity_units=cap, used_units=cap // 10,
                zone=zone_cycle[j % len(zone_cycle)], lru_ts=1_000,
            ),
        )
        for j in range(m)
    ]


def _steady_models(n, loaded_on=None, size=64):
    """``tests/test_steady_refresh.py``'s fleet helper."""
    out = []
    for i in range(n):
        mr = ModelRecord(model_type=f"t{i % 3}", size_units=size + i % 7,
                         last_used=1000 + i)
        if loaded_on:
            mr.promote_loaded(loaded_on[i % len(loaded_on)], 1000)
        out.append((f"m{i}", mr))
    return out


def _steady_instances(m, cap=10_000):
    return [
        (f"i{j}", InstanceRecord(
            capacity_units=cap, used_units=cap // 10 + j,
            zone=("a", "b")[j % 2], lru_ts=1_000 + j, req_per_minute=j,
        ))
        for j in range(m)
    ]


# -- tests/test_jax_engine.py::TestIncrementalDispatch ----------------------

class TestIncrementalDispatch:
    def _fleet(self, n=128, m=4):
        return _models(n, loaded_on=["i0", "i1"]), _instances(m)

    def test_model_only_churn_takes_incremental_path(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.refresh(models, instances)
        assert strat._base is not None
        models[3][1].last_used = 2_000
        strat.mark_dirty(models=["m3", "m7"])
        syncs0 = device_mod.host_syncs
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] == "incremental"
        assert plan.stats["dirty_rows"] == 2
        assert plan.stats["delta_snapshot"] is True
        assert device_mod.host_syncs - syncs0 == plan.stats["host_syncs"] == 1
        assert strat._base is not None
        assert strat._base.seed == strat._seed

    def test_instance_churn_takes_full_path(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.refresh(models, instances)
        strat.mark_dirty(models=["m3"], instances=["i1"])
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] != "incremental"
        assert "dirty_rows" not in plan.stats

    def test_zero_frac_disables_incremental(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.incr_max_dirty_frac = 0.0
        strat.refresh(models, instances)
        strat.mark_dirty(models=["m3"])
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] != "incremental"

    def test_dirty_fraction_ceiling(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.incr_max_dirty_frac = 0.05  # 128 models -> ceiling 6
        strat.refresh(models, instances)
        strat.mark_dirty(models=[f"m{i}" for i in range(10)])
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] != "incremental"

    def test_overflow_drift_gate_falls_back_to_full(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.refresh(models, instances)
        strat._base = strat._base._replace(overflow=-1e9)
        strat.mark_dirty(models=["m3"])
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] != "incremental"
        assert strat._base is not None
        assert strat._base.overflow >= 0.0

    def test_traffic_drift_on_clean_row_joins_dirty_set(self):
        models, instances = self._fleet()
        rpm = {f"m{i}": 10 for i in range(len(models))}
        strat = _strategy()
        strat.refresh(models, instances, rpm)
        assert strat._base is not None and strat._base.rates is not None
        rpm["m9"] = 300  # 30x spike, never marked dirty
        strat.mark_dirty(models=["m3"])
        plan = strat.refresh(models, instances, rpm, incremental=True)
        assert plan.stats["solver_path"] == "incremental"
        assert plan.stats["dirty_rows"] == 2  # marked m3 + drifted m9

    def test_fleet_wide_traffic_shift_takes_full_path(self):
        models, instances = self._fleet()
        n = len(models)
        rpm = {f"m{i}": 10 for i in range(n)}
        strat = _strategy()
        strat.refresh(models, instances, rpm)
        for i in range(0, n, 2):
            rpm[f"m{i}"] = 300
        strat.mark_dirty(models=["m3"])
        plan = strat.refresh(models, instances, rpm, incremental=True)
        assert plan.stats["solver_path"] != "incremental"

    def test_incremental_plan_routes_requests(self):
        models, instances = self._fleet()
        strat = _strategy()
        strat.refresh(models, instances)
        strat.mark_dirty(models=["m0"])
        plan = strat.refresh(models, instances, incremental=True)
        assert plan.stats["solver_path"] == "incremental"
        assert plan.num_models() == len(models)
        for mid, _ in models[:8]:
            targets = plan.lookup(mid)
            assert targets, mid
            assert all(t.startswith("i") for t in targets)


def test_seed_rotates_and_price_carry_drops_on_full_rebuild():
    models, instances = _models(128, ["i0", "i1"]), _instances(4)
    strat = _strategy()
    strat.refresh(models, instances)
    assert strat._seed == 1 and strat._warm_price is not None
    strat.mark_dirty(models=["m3"])
    strat.refresh(models, instances, incremental=True)
    assert strat._seed == 1                  # a delta keeps the epoch
    assert strat._epoch_carries_locked(False)[1] is None
    assert strat._seed == 2


def test_threefry_strategy_takes_full_path():
    """A threefry pin at tau > 0 never routes incremental (its draw cannot
    be replayed at scattered rows, the reference's gate): the refresh goes
    full and dense, where the threefry draw runs, on the port as on the
    reference's strategy fed the same records."""
    models, instances = _models(128, ["i0", "i1"]), _instances(4)
    strat = _strategy()
    jstrat = je.JaxPlacementStrategy()
    for s in (strat, jstrat):
        s.refresh(models, instances)
    strat.solve_config = SolveConfig(noise_impl="threefry")
    jstrat.solve_config = JaxConfig(noise_impl="threefry")
    for s in (strat, jstrat):
        s.mark_dirty(models=["m3"])
    plan = strat.refresh(models, instances, incremental=True)
    jplan = jstrat.refresh(models, instances, incremental=True)
    assert plan.stats["solver_path"] == jplan.stats["solver_path"] == "dense"
    agree = np.mean([jplan.lookup(m) == plan.lookup(m)
                     for m in jplan.placements])
    assert agree >= 0.97


# -- tests/test_steady_refresh.py ---------------------------------------------

def test_watch_race_requeues_versioned_mark():
    models = _steady_models(32)
    instances = _steady_instances(4)
    for _, mr in models:
        mr.version = 1
    strat = _strategy()
    strat.refresh(models, instances)
    stale = [(mid, copy.copy(mr)) for mid, mr in models]
    fresh = copy.copy(models[5][1])
    fresh.size_units = 999
    fresh.version = 2
    models[5] = (models[5][0], fresh)
    strat.mark_dirty(models=[("m5", 2)])
    plan = strat.refresh(stale, instances, incremental=True)
    assert plan.stats["delta_snapshot"] is True
    assert strat._snap_cache.cols.sizes[5] != 999
    assert strat._dirty_models.get("m5") == 2
    plan2 = strat.refresh(models, instances, incremental=True)
    assert plan2.stats["delta_snapshot"] is True
    assert strat._snap_cache.cols.sizes[5] == 999
    assert "m5" not in strat._dirty_models


def test_unversioned_marks_keep_legacy_semantics():
    models = _steady_models(16)
    instances = _steady_instances(4)
    strat = _strategy()
    strat.refresh(models, instances)
    models[3][1].size_units = 555
    strat.mark_dirty(models=["m3"], instances=["i1"])
    plan = strat.refresh(models, instances, incremental=True)
    assert plan.stats["delta_snapshot"] is True
    assert strat._snap_cache.cols.sizes[3] == 555
    assert not strat._dirty_models and not strat._dirty_instances


def test_strategy_delta_refresh_matches_full():
    models = _steady_models(64, loaded_on=["i0"])
    instances = _steady_instances(4)
    strat = _strategy()
    strat.refresh(models, instances)
    models[7][1].last_used = 10_000
    strat.mark_dirty(models=["m7"])
    p_delta = strat.refresh(models, instances, incremental=True)
    assert p_delta.stats["delta_snapshot"] is True
    assert p_delta.generation == 2
    p_full = _strategy().refresh(models, instances)
    assert p_delta.placements == p_full.placements


def test_empty_view_keeps_carries_and_epoch():
    strat = _strategy()
    models = _steady_models(16)
    instances = _steady_instances(4)
    strat.refresh(models, instances)
    seed, warm_g, warm_price = strat._seed, strat._warm_g, strat._warm_price
    empty = strat.refresh([], [])    # a transient empty registry view
    assert empty.num_models() == 0 and empty.generation == 2
    assert strat._seed == seed
    assert strat._warm_g is warm_g and strat._warm_price is warm_price
    assert strat.refresh(models, instances).generation == 3


def test_delta_streak_forces_a_rebuild(monkeypatch):
    monkeypatch.setattr(te, "MAX_DELTA_STREAK", 2)
    models, instances = _steady_models(16), _steady_instances(4)
    strat = _strategy()
    strat.refresh(models, instances)
    deltas = []
    for _ in range(3):
        strat.mark_dirty(models=["m1"])
        deltas.append(strat.refresh(models, instances,
                                    incremental=True).stats["delta_snapshot"])
    assert deltas == [True, True, False]


# -- one churn sequence through both strategies -----------------------------

def _pinned(monkeypatch):
    monkeypatch.setattr(je, "now_ms", lambda: NOW)
    monkeypatch.setattr(te, "now_ms", lambda: NOW)


def _churn_sequence(jstrat, tstrat, n=600, m=200, steps=4, seed=3):
    """A fleet routed sparse (200 instances pad to 256), then model-only
    churn of ~2% of models a step (last_used and a fresh rpm), one
    instance change at step 2 (the full path), both strategies fed the
    same records. Returns the (jax, torch) plans of every step."""
    from modelmesh_tpu.placement.synthetic import synthetic_records

    models, instances = synthetic_records(n, m)
    demand = sum(mr.size_units for _, mr in models)
    for _, rec in instances:
        rec.capacity_units = max(1, round(demand / (0.85 * m)))
    rng = np.random.default_rng(seed)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, n))}
    plans = [(jstrat.refresh(models, instances, rpm),
              tstrat.refresh(models, instances, rpm))]
    for step in range(steps):
        dirty = []
        for i in rng.integers(0, n, n // 50):
            mid, mr = models[int(i)]
            mr.last_used = NOW - 1000
            rpm[mid] = int(rng.integers(0, 50))
            dirty.append(mid)
        dirty_inst = []
        if step == 2:
            instances[5][1].used_units += 100
            dirty_inst = ["i5"]
        for strat in (jstrat, tstrat):
            strat.mark_dirty(dirty, dirty_inst)
        plans.append((jstrat.refresh(models, instances, rpm, incremental=True),
                      tstrat.refresh(models, instances, rpm, incremental=True)))
    return plans


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_churn_sequence_matches_reference(monkeypatch, dtype):
    _pinned(monkeypatch)
    jcfg = JaxConfig(dtype=jnp.float32) if dtype == "f32" else JaxConfig()
    tcfg = (SolveConfig(dtype=torch.float32) if dtype == "f32"
            else SolveConfig())
    jstrat = je.JaxPlacementStrategy(solve_config=jcfg)
    tstrat = _strategy(solve_config=tcfg)
    plans = _churn_sequence(jstrat, tstrat)
    paths = []
    for jplan, tplan in plans:
        assert tplan.stats["solver_path"] == jplan.stats["solver_path"]
        assert tplan.stats.get("dirty_rows") == jplan.stats.get("dirty_rows")
        paths.append(tplan.stats["solver_path"])
        mids = list(jplan.placements)
        agree = np.mean([jplan.lookup(mid) == tplan.lookup(mid)
                         for mid in mids])
        if dtype == "f32":
            assert agree == 1.0, (paths, agree)
        else:
            assert agree >= 0.97, (paths, agree)
    assert paths.count("incremental") >= 2, paths
    assert "sparse" in paths[1:], paths        # the instance change


# -- the SPI and the plan-serving decisions ---------------------------------

@pytest.mark.parametrize("name", [
    "choose_load_target", "choose_serve_target", "choose_group_targets",
])
def test_spi_signatures_match_reference(name):
    ours = inspect.signature(getattr(spi.PlacementStrategy, name))
    theirs = inspect.signature(getattr(jax_spi.PlacementStrategy, name))
    assert str(ours) == str(theirs)
    abstract = [getattr(getattr(mod.PlacementStrategy, name),
                        "__isabstractmethod__", False)
                for mod in (spi, jax_spi)]
    assert abstract[0] == abstract[1]


@pytest.mark.parametrize("name", [
    "refresh", "mark_dirty", "adopt", "choose_load_target",
    "choose_serve_target", "choose_group_targets", "rank_serve_candidates",
])
def test_strategy_method_signatures_match_reference(name):
    ours = inspect.signature(getattr(te.TorchPlacementStrategy, name))
    theirs = inspect.signature(getattr(je.JaxPlacementStrategy, name))
    assert str(ours) == str(theirs)


def test_spi_dataclasses_match_reference():
    assert spi.LOAD_HERE == jax_spi.LOAD_HERE
    for cls in ("PlacementRequest", "ClusterView"):
        ours = [(f.name, f.default) for f in
                dataclasses.fields(getattr(spi, cls))]
        theirs = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(jax_spi, cls))]
        assert ours == theirs, cls
    insts = _instances(4)
    insts[1][1].disabled = True
    insts[2][1].draining = True
    insts[3][1].shutting_down = True
    for mod in (spi, jax_spi):
        view = mod.ClusterView(insts)
        assert [i for i, _ in view.placeable()] == ["i0"]
        assert [i for i, _ in view.live()] == ["i0", "i1", "i2"]


def test_port_records_carry_the_strategy_fields():
    """The port's records hold what the strategy and its SPI read, with
    the reference's defaults."""
    for cls in ("ModelRecord", "InstanceRecord"):
        ours = {f.name: f for f in
                dataclasses.fields(getattr(torch_records, cls))}
        theirs = {f.name: f for f in
                  dataclasses.fields(getattr(__import__(
                      "modelmesh_tpu.records", fromlist=[cls]), cls))}
        for name, f in ours.items():
            assert name in theirs, (cls, name)
            assert f.default == theirs[name].default, (cls, name)
    rec = torch_records.InstanceRecord(capacity_units=10, used_units=25)
    assert rec.free_units == 0 and rec.version == 0


def test_default_fallback_is_the_port_greedy_and_mesh_type_checked():
    """No fallback handed in: the port's own GreedyStrategy, as the
    reference defaults to its greedy (``jax_engine.py:1370``). A mesh of
    another type still raises."""
    from modelmesh_tpu_torch.placement.greedy import (
        GreedyStrategy as PortGreedy,
    )

    strat = te.TorchPlacementStrategy(device="cpu")
    assert type(strat.fallback) is PortGreedy
    handed = GreedyStrategy()
    assert te.TorchPlacementStrategy(
        fallback=handed, device="cpu").fallback is handed
    with pytest.raises(NotImplementedError):
        te.TorchPlacementStrategy(fallback=GreedyStrategy(), mesh=object(),
                                  device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.TorchPlacementStrategy(fallback=GreedyStrategy())


def test_incremental_frac_knob(monkeypatch):
    assert _strategy().incr_max_dirty_frac == 0.05
    monkeypatch.setenv("MM_SOLVER_INCREMENTAL_MAX_DIRTY_FRAC", "0")
    assert _strategy().incr_max_dirty_frac == 0.0


def _request(mid, model, requester="i0", exclude=frozenset()):
    return spi.PlacementRequest(model_id=mid, model=model, required_units=64,
                                requesting_instance=requester,
                                exclude=exclude)


def test_choose_load_target_reads_the_plan_then_falls_back():
    models, instances = _models(32), _instances(4)
    strat = _strategy()
    plan = strat.refresh(models, instances)
    view = spi.ClusterView(instances)
    mid, model = models[3]
    planned = plan.lookup(mid)
    got = strat.choose_load_target(_request(mid, model, "ix"), view)
    assert got == planned[0]
    # The requester itself is the planned instance: LOAD_HERE.
    got = strat.choose_load_target(_request(mid, model, planned[0]), view)
    assert got == spi.LOAD_HERE
    # Every planned instance excluded: the fallback decides.
    req = _request(mid, model, "ix", frozenset(planned))
    assert strat.choose_load_target(req, view) == (
        GreedyStrategy().choose_load_target(req, view))
    # A plan past its TTL is not read.
    strat.plan_ttl_ms = -1
    req = _request(mid, model, "ix")
    assert strat.choose_load_target(req, view) == (
        GreedyStrategy().choose_load_target(req, view))
    strat.adopt(None)
    assert strat.plan is None


def test_choose_group_targets_and_serve_delegate():
    models, instances = _models(32), _instances(6)
    strat = _strategy()
    plan = strat.refresh(models, instances)
    view = spi.ClusterView(instances)
    mid, model = models[4]
    group = strat.choose_group_targets(_request(mid, model), view, 3, 64)
    assert sorted(group.values()) == [0, 1, 2]
    assert plan.lookup(mid)[0] in group
    jstrat = je.JaxPlacementStrategy()
    jstrat.adopt(plan)
    assert group == jstrat.choose_group_targets(_request(mid, model), view,
                                                3, 64)
    model.promote_loaded("i1", 5)
    for fn in ("choose_serve_target", "rank_serve_candidates"):
        assert repr(getattr(strat, fn)(model, view, frozenset())) == repr(
            getattr(GreedyStrategy(), fn)(model, view, frozenset()))
