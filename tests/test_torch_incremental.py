"""The port's incremental path against the JAX package's, on the CPU.

- ``ops/costs.py::assemble_cost_rows``: equal to the port's own
  ``assemble_cost(...)[rows]`` exactly at f32 and bf16; against the
  reference's ``assemble_cost_rows``, f32 within atol 1e-5 and bf16 equal
  or one bf16 ulp (``test_torch_costs.py``'s rule: ``sizes @ loaded``
  sums in another order than XLA's).
- ``ops/sparse.py::resolve_dirty_rows`` through
  ``solve_placement_incremental``: the reference's own four gates
  (``tests/test_sparse_solver.py::TestIncrementalResolve``) run on the
  port, and the port against the reference from one base at f32 (indices
  and valid equal, load within atol 1e-3).
- ``dispatch_solve(base=, dirty_rows=)`` + ``finalize_plan``: the
  incremental branch, its shape check, one host sync, and the device
  ``carry`` branch.
- The delta snapshot (``patch_columns``): equal to a full rebuild after
  churn, falling back where the reference does, leaving handed-out
  columns frozen, and equal column by column to the reference's patch.

Problems come from the reference's ``random_problem`` and reach the port
through ``carry.problem_from_numpy``; every port call passes
``device="cpu"`` or CPU tensors, so the kernels' plain versions run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.costs import assemble_cost_rows as jax_cost_rows
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.ops.solve import solve_placement as jax_solve
from modelmesh_tpu.ops.solve import (
    solve_placement_incremental as jax_incremental,
)
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.carry import problem_from_numpy
from modelmesh_tpu_torch.ops import _build, costs, cuda_lse, cuda_sparse
from modelmesh_tpu_torch.ops.auction import MAX_COPIES
from modelmesh_tpu_torch.ops.solve import (
    SolveConfig,
    solve_placement,
    solve_placement_incremental,
)
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


def _leaves(p) -> dict:
    return {f.name: np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def _pair(p):
    """(reference problem, the port's copy on the CPU)."""
    return p, problem_from_numpy(_leaves(p), device="cpu")


def _fixture(n=512, m=64, slack=1.3, key=8):
    """The reference gates' fixture: random_problem(PRNGKey(8), 512, 64)."""
    return _pair(ops.random_problem(
        jax.random.PRNGKey(key), n, m, capacity_slack=slack
    ))


def _loaded_problem(n, m, seed, zones=None):
    """A problem with a random loaded placement (the generator leaves it
    empty, which would zero the move and zone terms) and optionally
    explicit zone ids."""
    p = ops.random_problem(jax.random.PRNGKey(seed), n, m, capacity_slack=1.5,
                           feasible_frac=0.7)
    rng = np.random.default_rng(seed)
    loaded = rng.random((n, m)) < 0.05
    zone = np.asarray(p.zone) if zones is None else np.asarray(zones, np.int32)
    return _pair(dataclasses.replace(p, loaded=jnp.asarray(loaded),
                                     zone=jnp.asarray(zone)))


def _demand(tp) -> float:
    return float((tp.sizes * torch.clamp_max(tp.copies, MAX_COPIES)).sum())


# -- assemble_cost_rows -----------------------------------------------------

ROW_CASES = [
    (256, 96, 0, None),
    (300, 200, 1, None),
    (130, 1100, 2, None),
    (64, 96, 4, np.arange(96) % 11 - 1),   # zone ids outside [0, 8)
]


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=max(1, n // 7), replace=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,seed,zones", ROW_CASES)
def test_cost_rows_equal_full_assembly_rows(n, m, seed, zones, dtype):
    """Exactly the rows of the port's own full assembly."""
    _, tp = _loaded_problem(n, m, seed, zones)
    rows = torch.from_numpy(_rows(n, seed))
    want = costs.assemble_cost(tp, dtype=dtype)[rows]
    got = costs.assemble_cost_rows(tp, rows, dtype=dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,m,seed,zones", ROW_CASES)
def test_cost_rows_f32_match_reference(n, m, seed, zones):
    jp, tp = _loaded_problem(n, m, seed, zones)
    rows = _rows(n, seed)
    want = np.asarray(jax_cost_rows(jp, jnp.asarray(rows),
                                    dtype=jnp.float32))
    got = costs.assemble_cost_rows(tp, torch.from_numpy(rows),
                                   dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,m,seed,zones", ROW_CASES)
def test_cost_rows_bf16_equal_or_one_ulp(n, m, seed, zones):
    jp, tp = _loaded_problem(n, m, seed, zones)
    rows = _rows(n, seed)
    want = np.asarray(
        jax_cost_rows(jp, jnp.asarray(rows)).astype(jnp.float32))
    got = costs.assemble_cost_rows(
        tp, torch.from_numpy(rows)).to(torch.float32).numpy()
    equal = got == want
    assert equal.mean() >= 0.999, equal.mean()
    # One bf16 ulp at the value's binade: 2**(exponent - 7).
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want)[~equal] <= ulp[~equal])


# -- resolve_dirty_rows: the reference's gates, on the port ----------------

def _resolve(problem, base, rows, cfg=SolveConfig(), seed=11, n_pad=None):
    """The reference test's helper: dirty rows padded to at least 4 with
    the sentinel n (or ``n_pad``)."""
    n = problem.num_models
    rows = np.asarray(rows, np.int64)
    padded = np.full(max(len(rows), 4), n if n_pad is None else n_pad,
                     np.int64)
    padded[: len(rows)] = rows
    return solve_placement_incremental(
        problem, cfg, seed, torch.from_numpy(padded),
        base.indices, base.valid, base.g, base.prices, base.row_err,
    )


F32 = SolveConfig(dtype=torch.float32)


class TestReferenceGates:
    """``tests/test_sparse_solver.py::TestIncrementalResolve``, case for
    case, on the port's base solve and re-solve."""

    def test_unchanged_problem_is_bitwise_noop_at_f32(self):
        _, tp = _fixture()
        base = solve_placement(tp, F32, seed=11)
        merged = _resolve(tp, base, np.arange(0, 512, 7), F32)
        assert torch.equal(merged.indices, base.indices)
        assert torch.equal(merged.valid, base.valid)
        np.testing.assert_allclose(merged.load.numpy(), base.load.numpy(),
                                   atol=1e-3)
        np.testing.assert_allclose(float(merged.overflow),
                                   float(base.overflow), atol=1e-2)

    def test_unchanged_problem_near_noop_at_bf16(self):
        _, tp = _fixture()
        base = solve_placement(tp, SolveConfig(), seed=11)
        rows = np.arange(0, 512, 7)
        merged = _resolve(tp, base, rows)
        clean = np.ones(512, bool)
        clean[rows] = False
        assert torch.equal(merged.indices[clean], base.indices[clean])
        changed = int(((merged.indices != base.indices).any(1)
                       | (merged.valid != base.valid).any(1)).sum())
        assert changed <= max(2, len(rows) // 10), changed
        assert float(merged.overflow) <= (float(base.overflow)
                                          + 0.005 * _demand(tp))

    def test_perturbation_moves_only_dirty_rows(self):
        _, tp = _fixture()
        base = solve_placement(tp, F32, seed=11)
        rows = np.asarray([3, 17, 100, 101, 400])
        copies = tp.copies.clone()
        copies[rows] = torch.clamp_max(copies[rows] + 1, MAX_COPIES)
        perturbed = dataclasses.replace(tp, copies=copies)
        merged = _resolve(perturbed, base, rows, F32)
        clean = np.ones(512, bool)
        clean[rows] = False
        assert torch.equal(merged.indices[clean], base.indices[clean])
        assert torch.equal(merged.valid[clean], base.valid[clean])
        v = merged.valid.numpy()
        assert (v[rows].sum(axis=1) == copies.numpy()[rows]).all()
        # The merged load is an exact recount of the merged plan.
        idx = merged.indices.numpy()
        sizes = tp.sizes.numpy()
        load = np.zeros(64, np.float64)
        for r in range(512):
            for j in idx[r][v[r]]:
                load[j] += sizes[r]
        np.testing.assert_allclose(load, merged.load.numpy(), rtol=1e-4)

    def test_padded_sentinel_rows_are_inert(self):
        _, tp = _fixture(128, 32, 1.5)
        base = solve_placement(tp, F32, seed=11)
        merged = _resolve(tp, base, [5], F32, n_pad=128)
        assert torch.equal(merged.indices, base.indices)
        assert torch.equal(merged.valid, base.valid)


def _jax_base(jp, cfg, seed=11):
    return jax_solve(jp, cfg, seed=seed)


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_resolve_matches_reference_from_one_base(tau):
    """One reference base (indices, valid, g, prices, row_err) carried
    across; both packages re-solve rows 0:512:7 of a perturbed problem at
    f32. Indices and valid equal; load within atol 1e-3."""
    jp, tp = _fixture()
    jcfg = JaxConfig(dtype=jnp.float32, tau=tau)
    base = _jax_base(jp, jcfg)
    rows = np.arange(0, 512, 7)
    # Perturb the dirty rows' copies so the re-selection has work to do.
    copies = np.asarray(jp.copies).copy()
    copies[rows[::3]] = np.minimum(copies[rows[::3]] + 1, MAX_COPIES)
    jp = dataclasses.replace(jp, copies=jnp.asarray(copies))
    tp = dataclasses.replace(tp, copies=torch.from_numpy(copies))
    padded = np.full(80, 512, np.int64)
    padded[: len(rows)] = rows
    want = jax_incremental(
        jp, jcfg, jnp.uint32(11), jnp.asarray(padded, jnp.int32),
        base.indices, base.valid, base.g, base.prices, base.row_err,
    )
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = solve_placement_incremental(
        tp, SolveConfig(dtype=torch.float32, tau=tau), 11,
        torch.from_numpy(padded), t(base.indices).long(), t(base.valid),
        t(base.g), t(base.prices), t(base.row_err),
    )
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.load.numpy(), np.asarray(want.load),
                               atol=1e-3)
    np.testing.assert_allclose(float(got.overflow), float(want.overflow),
                               atol=1e-2)
    assert got.f is None and got.sinkhorn_iters_run == 0
    assert got.auction_iters_run == 0
    assert torch.equal(got.g, t(base.g)) and torch.equal(got.prices,
                                                         t(base.prices))


def test_row_potential_takes_kernel_4_route(monkeypatch):
    """The exact row potential goes through ``cuda_lse.row_lse`` (kernel
    4's wrapper), once per re-solve, over [D_pad, M] in the config's
    dtype; ``torch.logsumexp`` is not on the path."""
    _, tp = _fixture(128, 32, 1.5)
    base = solve_placement(tp, SolveConfig(), seed=11)
    seen = []
    real = cuda_lse.row_lse_partial

    def spy(C, g, eps):
        seen.append((tuple(C.shape), C.dtype))
        return real(C, g, eps)

    def refuse(*a, **k):
        raise AssertionError("torch.logsumexp on the incremental path")

    monkeypatch.setattr(cuda_lse, "row_lse_partial", spy)
    monkeypatch.setattr(torch, "logsumexp", refuse)
    _resolve(tp, base, [1, 2, 3, 9, 40])
    assert seen == [((5, 32), torch.bfloat16)]


def test_resolve_validates_config():
    _, tp = _fixture(128, 32, 1.5)
    base = solve_placement(tp, F32, seed=11)
    with pytest.raises(ValueError, match="hash"):
        _resolve(tp, base, [1], SolveConfig(noise_impl="threefry"))
    with pytest.raises(ValueError, match="lse_impl"):
        _resolve(tp, base, [1], F32._replace(lse_impl="cuda"))


# -- dispatch_solve's incremental branch ------------------------------------

def _models(n, loaded_on=None, size=64):
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


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(je, "now_ms", lambda: NOW)
    monkeypatch.setattr(te, "now_ms", lambda: NOW)


def _full_base(cols, seed=3):
    pending = te.dispatch_solve(cols, seed=seed, device="cpu")
    plan = te.finalize_plan(pending)
    sol = pending.sol
    return te.SolveBase(
        indices=sol.indices, valid=sol.valid, g=sol.g, prices=sol.prices,
        row_err=sol.row_err, seed=seed, overflow=plan.stats["overflow"],
        rates=cols.rates.copy(),
    ), plan


@pytest.mark.parametrize("m", [4, 300])   # dense-tier and sparse-tier fleets
def test_dispatch_incremental_branch(pinned_clock, m):
    cols = te.snapshot_columns(_models(200, ["i0", "i1"]), _instances(m))
    base, full = _full_base(cols)
    syncs0 = device_mod.host_syncs
    pending = te.dispatch_solve(cols, seed=3, base=base,
                                dirty_rows=[9, 2, 40], device="cpu")
    plan = te.finalize_plan(pending)
    assert device_mod.host_syncs - syncs0 == 1    # the one readback
    assert plan.stats["host_syncs"] == 1
    assert pending.path == plan.stats["solver_path"] == "incremental"
    assert plan.stats["dirty_rows"] == 3 and plan.stats["warm"] is True
    assert plan.stats["lse_impl"] == "plain"
    assert plan.stats["sinkhorn_iters_run"] == 0
    assert plan.stats.get("topk", 0) == (24 if m == 300 else 0)
    # Dirty ids are host-padded to a bucket of 64 with the sentinel n_pad.
    assert pending.sol.indices.shape == base.indices.shape
    # An unchanged problem at the base's own seed: the plan is the base's.
    assert plan.num_models() == 200
    agree = np.mean([plan.lookup(mid) == full.lookup(mid)
                     for mid in cols.model_ids])
    assert agree >= 0.98, agree


def test_dispatch_incremental_rejects_stale_base(pinned_clock):
    cols = te.snapshot_columns(_models(200), _instances(4))
    base, _ = _full_base(cols)
    grown = te.snapshot_columns(_models(300), _instances(4))
    with pytest.raises(ValueError, match="SolveBase shapes"):
        te.dispatch_solve(grown, base=base, dirty_rows=[0], device="cpu")
    with pytest.raises(NotImplementedError):
        te.dispatch_solve(cols, base=base, dirty_rows=[0], mesh=object(),
                          device="cpu")


def test_dispatch_incremental_without_cuda_raises(pinned_clock, monkeypatch):
    cols = te.snapshot_columns(_models(64), _instances(4))
    base, _ = _full_base(cols)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.dispatch_solve(cols, base=base, dirty_rows=[0])


def test_incremental_cpu_path_calls_no_cuda_code(pinned_clock, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CUDA code reached on a CPU solve")

    cols = te.snapshot_columns(_models(200), _instances(300))
    base, _ = _full_base(cols)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    cuda_sparse.reset_launches()
    cuda_lse.reset_launches()
    te.finalize_plan(te.dispatch_solve(cols, base=base, dirty_rows=[1, 5],
                                       device="cpu"))
    assert all(v == 0 for v in cuda_sparse.launches.values())
    assert all(v == 0 for v in cuda_lse.launches.values())


def test_dispatch_device_carry(pinned_clock):
    """``carry=(g0, price0)`` padded device tensors warm-start like the
    id-keyed dicts they came from."""
    cols = te.snapshot_columns(_models(200, ["i0"]), _instances(300))
    cold = te.finalize_plan(te.dispatch_solve(cols, seed=1, device="cpu"))
    m_pad = te._bucket(300, 64)
    g0 = torch.zeros(m_pad)
    p0 = torch.zeros(m_pad)
    g0[:300] = torch.tensor([cold.warm_g[i] for i in cols.instance_ids])
    p0[:300] = torch.tensor([cold.warm_price[i] for i in cols.instance_ids])
    by_carry = te.dispatch_solve(cols, seed=2, carry=(g0, p0), device="cpu")
    by_dict = te.dispatch_solve(cols, seed=2, warm_g=cold.warm_g,
                                warm_price=cold.warm_price, device="cpu")
    assert by_carry.warm is True
    assert torch.equal(by_carry.sol.indices, by_dict.sol.indices)
    assert torch.equal(by_carry.sol.g, by_dict.sol.g)
    with pytest.raises(ValueError, match="device carry shape"):
        te.dispatch_solve(cols, carry=(g0[:64], p0[:64]), device="cpu")


# -- the delta snapshot -------------------------------------------------------

def _assert_cols_equal(a, b):
    for field in a._fields:
        va, vb = getattr(a, field), getattr(b, field)
        if field in ("loaded_rows", "loaded_cols"):
            continue  # order-insensitive; compared as pair sets below
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, field
            np.testing.assert_array_equal(va, vb, err_msg=field)
        else:
            assert va == vb, field
    pa = set(zip(a.loaded_rows.tolist(), a.loaded_cols.tolist()))
    pb = set(zip(b.loaded_rows.tolist(), b.loaded_cols.tolist()))
    assert pa == pb


def _churn(models, instances, rpm):
    """The reference test's churn: size, loaded set and recency on 3
    models, used units and a shutdown on 2 instances."""
    models[5][1].size_units = 300
    models[9][1].promote_loaded("i2", 2000)
    models[12][1].last_used = 41_999_000
    rpm["m12"] = 50
    instances[2][1].used_units = 5_000
    instances[4][1].shutting_down = True
    return {"m5", "m9", "m12"}, {"i2", "i4"}


class _Constraints:
    def is_candidate(self, mtype, labels):
        return not (mtype == "t1" and "small" in labels)

    def is_preferred(self, mtype, labels):
        return "fast" in labels


@pytest.mark.parametrize("constrained", [False, True])
def test_patched_equals_full_rebuild(pinned_clock, constrained):
    models = _models(64, loaded_on=["i1", "i3"])
    instances = _instances(6)
    for j, (_, rec) in enumerate(instances):
        rec.labels = ["small"] if j % 2 else ["fast"]
    rpm = {mid: i % 11 for i, (mid, _) in enumerate(models)}
    c = _Constraints() if constrained else None
    _, cache = te.snapshot_columns(models, instances, rpm, constraints=c,
                                   return_cache=True)
    dm, di = _churn(models, instances, rpm)
    instances[2][1].labels = ["small", "fast"]
    patched = te.patch_columns(cache, models, instances, rpm,
                               dirty_models=dm, dirty_instances=di,
                               constraints=c)
    assert patched is not None and cache.cols is patched
    _assert_cols_equal(patched, te.snapshot_columns(models, instances, rpm,
                                                    constraints=c))


def test_patch_matches_reference_patch(pinned_clock):
    """The same records through both packages' snapshot and patch: equal
    column by column (the COO pairs in the same order)."""
    models = _models(64, loaded_on=["i1", "i3"])
    instances = _instances(6)
    rpm = {mid: i % 11 for i, (mid, _) in enumerate(models)}
    _, tcache = te.snapshot_columns(models, instances, rpm,
                                    return_cache=True)
    _, jcache = je.snapshot_columns(models, instances, rpm,
                                    return_cache=True)
    dm, di = _churn(models, instances, rpm)
    tcols = te.patch_columns(tcache, models, instances, rpm, dm, di)
    jcols = je.patch_columns(jcache, models, instances, rpm, dm, di)
    for field in je.ProblemColumns._fields:
        a, b = getattr(jcols, field), getattr(tcols, field)
        if isinstance(a, list):
            assert a == b, field
        else:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(b, a, err_msg=field)
    for name in ("last_used", "used", "lru_ts"):
        np.testing.assert_array_equal(getattr(tcache, name),
                                      getattr(jcache, name), err_msg=name)


def test_patch_falls_back_on_structure_change(pinned_clock):
    models = _models(16)
    instances = _instances(4)
    _, cache = te.snapshot_columns(models, instances, return_cache=True)
    # A joining instance changes the column count.
    assert te.patch_columns(cache, models, instances + _instances(5)[4:],
                            None) is None
    # An unknown dirty id.
    assert te.patch_columns(cache, models, instances, None,
                            dirty_models={"nope"}) is None
    # A dirty fraction above the threshold.
    assert te.patch_columns(cache, models, instances, None,
                            dirty_models={mid for mid, _ in models}) is None
    # A new model type, a new zone, another constraints object.
    models[2][1].model_type = "t-new"
    assert te.patch_columns(cache, models, instances, None,
                            dirty_models={"m2"}) is None
    models[2][1].model_type = "t2"
    instances[1][1].zone = "z-new"
    assert te.patch_columns(cache, models, instances, None,
                            dirty_instances={"i1"}) is None
    assert te.patch_columns(cache, models, instances, None,
                            constraints=_Constraints()) is None


def test_patch_does_not_mutate_handed_out_columns(pinned_clock):
    models = _models(16)
    instances = _instances(4)
    cols0, cache = te.snapshot_columns(models, instances, return_cache=True)
    before = {f: np.array(getattr(cols0, f)) for f in cols0._fields
              if isinstance(getattr(cols0, f), np.ndarray)}
    models[3][1].size_units = 999
    models[3][1].promote_loaded("i2", 5)
    instances[1][1].capacity_units = 1
    patched = te.patch_columns(cache, models, instances, None,
                               dirty_models={"m3"}, dirty_instances={"i1"})
    assert patched is not None and patched.sizes[3] == 999
    for f, v in before.items():
        np.testing.assert_array_equal(getattr(cols0, f), v, err_msg=f)
