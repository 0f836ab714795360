"""The port's pipelined refresher (``placement/refresh_loop.py``) and the
readback ticket under it, against the JAX package's, on the CPU.

- The reference's own cases of
  ``tests/test_steady_refresh.py::TestPipelinedRefresh`` and
  ``TestDeviceResidency``, case for case on the port: no plan tearing
  under two reader threads, every generation emitted once, a blocking
  refresh never rolled back by a stale flight, the empty view that
  flushes and keeps the carries, and at most one host sync
  (``device.host_syncs``) per steady incremental cycle. The reference's
  donated-entry case becomes the port's refusal of donation.
- One churn sequence (a sparse fleet, model churn, an instance change and
  an interleaved blocking ``refresh()``) through the reference's
  ``PipelinedRefresher(JaxPlacementStrategy)`` and the port's: ``None``
  at the same steps; generation, path, dirty rows and the delta flag
  equal; placements equal at f32, agreement >= 0.97 at bf16.
- The blocking ``refresh`` path with the readback enqueued at dispatch
  against the same path with the readback taken at finalize (as before
  the ticket): plans and sync counts equal.

Records are the JAX package's; every port strategy runs with
``device="cpu"``.
"""

import inspect
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.placement import refresh_loop as jax_rl
from modelmesh_tpu.placement.greedy import GreedyStrategy
from modelmesh_tpu.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops.solve import SolveConfig
from modelmesh_tpu_torch.placement import refresh_loop as rl
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


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(je, "now_ms", lambda: NOW)
    monkeypatch.setattr(te, "now_ms", lambda: NOW)


def _strategy(**kw):
    return te.TorchPlacementStrategy(fallback=GreedyStrategy(),
                                     device="cpu", **kw)


def _models(n, loaded_on=None, size=64):
    """``tests/test_steady_refresh.py``'s fleet helper."""
    out = []
    for i in range(n):
        mr = ModelRecord(model_type=f"t{i % 3}", size_units=size + i % 7,
                         last_used=1000 + i)
        if loaded_on:
            mr.promote_loaded(loaded_on[i % len(loaded_on)], 1000)
        out.append((f"m{i}", mr))
    return out


def _instances(m, cap=10_000):
    return [
        (f"i{j}", InstanceRecord(
            capacity_units=cap, used_units=cap // 10 + j,
            zone=("a", "b")[j % 2], lru_ts=1_000 + j, req_per_minute=j,
        ))
        for j in range(m)
    ]


# -- tests/test_steady_refresh.py::TestPipelinedRefresh ---------------------

def test_no_plan_tearing_under_overlap():
    """Readers racing the pipelined install see only whole plans with
    generations that never go back."""
    models = _models(128, loaded_on=["i0", "i2"])
    instances = _instances(4)
    strat = _strategy()
    refresher = rl.PipelinedRefresher(strat)
    stop = threading.Event()
    errors: list = []
    gens: list[int] = []

    def reader():
        last_gen = -1
        # One more read after stop: drain() installs the last plan before
        # stop is set, so the final read sees the last generation.
        final_pass = False
        while not final_pass:
            final_pass = stop.is_set()
            plan = strat.plan
            if plan is None:
                continue
            try:
                assert plan.generation >= last_gen
                last_gen = plan.generation
                targets = plan.lookup("m0")
                assert targets is not None and len(targets) >= 1
                assert all(t.startswith("i") for t in targets)
            except AssertionError as e:  # pragma: no cover
                errors.append(e)
                return
        gens.append(last_gen)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for step in range(4):
            models[step][1].last_used = 20_000 + step
            strat.mark_dirty(models=[f"m{step}"])
            refresher.submit(models, instances, incremental=True)
        refresher.drain()
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors
    assert gens and max(gens) == strat.plan.generation


def test_pipeline_emits_every_generation_once():
    strat = _strategy()
    refresher = rl.PipelinedRefresher(strat)
    models = _models(32)
    instances = _instances(4)
    seen = []
    assert refresher.submit(models, instances) is None  # priming
    for _ in range(3):
        plan = refresher.submit(models, instances)
        seen.append(plan.generation)
    tail = refresher.drain()
    seen.append(tail.generation)
    assert seen == sorted(set(seen)), seen
    assert len(seen) == 4
    # Steady-state refreshes ride the warm carries.
    assert tail.stats["warm"] is True and tail.stats["pipelined"] is True


def test_blocking_refresh_never_rolled_back_by_stale_flight():
    strat = _strategy()
    refresher = rl.PipelinedRefresher(strat)
    models = _models(32)
    instances = _instances(4)
    refresher.submit(models, instances)           # flight gen N in the air
    newer = strat.refresh(models, instances)      # installs gen N+1
    # The stale flight is neither installed nor handed back: drain returns
    # the freshest installed plan.
    out = refresher.drain()
    assert out.generation == newer.generation
    assert strat.plan.generation == newer.generation


def test_donation_is_refused():
    """The reference's donated entry (``dispatch_solve(donate=True)``)
    has no PyTorch analog: the port refuses it at dispatch and at the
    refresher, and ``donate="auto"`` resolves to no donation."""
    cols = te.snapshot_columns(_models(16), _instances(4))
    m_pad = te._bucket(len(cols.instance_ids), 64)
    carry = (torch.zeros(m_pad), torch.zeros(m_pad))
    with pytest.raises(NotImplementedError, match="donation"):
        te.dispatch_solve(cols, carry=carry, donate=True, device="cpu")
    with pytest.raises(NotImplementedError, match="donation"):
        rl.PipelinedRefresher(_strategy(), donate=True)
    assert rl.PipelinedRefresher(_strategy())._donate is False
    plan = te.finalize_plan(te.dispatch_solve(cols, carry=carry,
                                              device="cpu"))
    assert plan.num_models() == 16


def test_empty_view_flushes_and_keeps_carries():
    strat = _strategy()
    refresher = rl.PipelinedRefresher(strat)
    models = _models(16)
    instances = _instances(4)
    refresher.submit(models, instances)
    out = refresher.submit([], [])  # a transient empty registry view
    assert out is not None          # flushed the in-flight refresh
    assert strat._warm_g is not None  # the carry survived the blip
    plan = refresher.submit(models, instances)
    assert plan is None or plan.generation >= out.generation


# -- tests/test_steady_refresh.py::TestDeviceResidency ----------------------

def test_steady_cycle_single_host_sync():
    """A steady pipelined cycle (the incremental dirty-row path) makes at
    most one host sync, the wait on the previous flight's readback; the
    frozen base never goes to the host."""
    strat = _strategy()
    refresher = rl.PipelinedRefresher(strat)
    models = _models(64, loaded_on=["i0"])
    instances = _instances(4)
    # Cycle 1 (cold full) and cycle 2 (warm full, which freezes the base
    # at its finalize) are the background cadence, not the steady state.
    refresher.submit(models, instances)
    models[0][1].last_used = 50_000
    strat.mark_dirty(models=["m0"])
    refresher.submit(models, instances, incremental=True)
    syncs = []
    for step in range(1, 4):
        models[step][1].last_used = 50_000 + step
        strat.mark_dirty(models=[f"m{step}"])
        before = device_mod.host_syncs
        refresher.submit(models, instances, incremental=True)
        syncs.append(device_mod.host_syncs - before)
        assert syncs[-1] <= 1, (
            f"steady cycle {step} made {syncs[-1]} host syncs (budget: "
            "the one readback wait)")
    tail = refresher.drain()
    # Non-vacuity: the cycles rode the dirty-row path on a device base,
    # and the readback waits did happen.
    assert tail.stats["solver_path"] == "incremental"
    assert tail.stats["host_syncs"] == 1
    assert strat._base is not None
    assert sum(syncs) >= 1


# -- the ticket and the blocking path ---------------------------------------

def test_readback_waits_for_its_own_copy_only():
    """On the CPU the ticket is the tensor itself, with no event; waiting
    on it counts one host sync."""
    t = torch.arange(6, dtype=torch.int32)
    rb = device_mod.start_readback(t)
    assert rb.done is None and rb.host is t
    before = device_mod.host_syncs
    assert torch.equal(device_mod.finish_readback(rb), t)
    assert device_mod.host_syncs - before == 1


def _blocking_sequence(strat, steps=4, seed=5):
    from modelmesh_tpu.placement.synthetic import synthetic_records

    models, instances = synthetic_records(600, 200)
    rng = np.random.default_rng(seed)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, 600))}
    out = []
    for step in range(steps + 1):
        if step:
            dirty = []
            for i in rng.integers(0, 600, 12):
                mid, mr = models[int(i)]
                mr.last_used = NOW - 1000
                rpm[mid] = int(rng.integers(0, 50))
                dirty.append(mid)
            strat.mark_dirty(dirty, ["i5"] if step == 3 else [])
            if step == 3:
                instances[5][1].used_units += 100
        before = device_mod.host_syncs
        plan = strat.refresh(models, instances, rpm, incremental=True)
        out.append((plan, device_mod.host_syncs - before))
    return out


def test_blocking_refresh_unchanged_by_the_ticket(pinned_clock, monkeypatch):
    """The blocking path with the readback enqueued at dispatch against
    the same path with it taken at finalize: the same placements,
    scalars, warm dicts and sync counts, one sync per incremental
    refresh."""
    ticket = _blocking_sequence(_strategy())
    finalize = te.finalize_plan
    monkeypatch.setattr(
        te, "finalize_plan",
        lambda p, fetch_carries=True: finalize(p._replace(readback=None),
                                               fetch_carries))
    late = _blocking_sequence(_strategy())
    paths = []
    for (a, sa), (b, sb) in zip(ticket, late):
        assert a.placements == b.placements
        for k in ("overflow", "row_err", "solver_path", "host_syncs",
                  "dirty_rows", "delta_snapshot"):
            assert a.stats.get(k) == b.stats.get(k), k
        assert a.warm_g == b.warm_g and a.warm_price == b.warm_price
        assert sa == sb == a.stats["host_syncs"]
        if a.stats["solver_path"] == "incremental":
            assert sa == 1
        paths.append(a.stats["solver_path"])
    assert paths.count("incremental") >= 2, paths


# -- one churn sequence through both refreshers -----------------------------

def _pipelined_sequence(jstrat, tstrat, n=600, m=200, steps=5, seed=3):
    """A fleet routed sparse (200 instances pad to 256), then model-only
    churn of ~2% of models a step, one instance change at step 2, and a
    blocking full ``refresh()`` after step 3's submit; both refreshers fed
    the same records. Returns the (jax, torch) plans emitted, in order."""
    from modelmesh_tpu.placement.synthetic import synthetic_records

    models, instances = synthetic_records(n, m)
    demand = sum(mr.size_units for _, mr in models)
    for _, rec in instances:
        rec.capacity_units = max(1, round(demand / (0.85 * m)))
    rng = np.random.default_rng(seed)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, n))}
    jref = jax_rl.PipelinedRefresher(jstrat)
    tref = rl.PipelinedRefresher(tstrat)
    plans = [(jref.submit(models, instances, rpm),
              tref.submit(models, instances, rpm))]
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
        plans.append((jref.submit(models, instances, rpm),
                      tref.submit(models, instances, rpm)))
        if step == 3:
            plans.append((jstrat.refresh(models, instances, rpm),
                          tstrat.refresh(models, instances, rpm)))
    plans.append((jref.drain(), tref.drain()))
    return plans


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pipelined_sequence_matches_reference(pinned_clock, dtype):
    jcfg = JaxConfig(dtype=jnp.float32) if dtype == "f32" else JaxConfig()
    tcfg = (SolveConfig(dtype=torch.float32) if dtype == "f32"
            else SolveConfig())
    jstrat = je.JaxPlacementStrategy(solve_config=jcfg)
    tstrat = _strategy(solve_config=tcfg)
    plans = _pipelined_sequence(jstrat, tstrat)
    paths, nones = [], []
    for step, (jplan, tplan) in enumerate(plans):
        assert (jplan is None) == (tplan is None), step
        if jplan is None:
            nones.append(step)
            continue
        assert tplan.generation == jplan.generation, step
        for k in ("solver_path", "dirty_rows", "delta_snapshot",
                  "pipelined"):
            assert tplan.stats.get(k) == jplan.stats.get(k), (step, k)
        paths.append(tplan.stats["solver_path"])
        mids = list(jplan.placements)
        agree = np.mean([jplan.lookup(mid) == tplan.lookup(mid)
                         for mid in mids])
        if dtype == "f32":
            assert agree == 1.0, (step, paths, agree)
        else:
            assert agree >= 0.97, (step, paths, agree)
    assert nones[0] == 0, nones              # priming
    assert len(nones) >= 2, nones            # the superseded flight
    assert paths.count("incremental") >= 2, paths
    assert "sparse" in paths, paths
    assert tstrat.plan.generation == jstrat.plan.generation


@pytest.mark.parametrize("name", ["submit", "drain"])
def test_refresher_signatures_match_reference(name):
    ours = inspect.signature(getattr(rl.PipelinedRefresher, name))
    theirs = inspect.signature(getattr(jax_rl.PipelinedRefresher, name))
    assert list(ours.parameters) == list(theirs.parameters)
    assert ([p.default for p in ours.parameters.values()]
            == [p.default for p in theirs.parameters.values()])
