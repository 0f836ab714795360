"""The port's sparse solve (modelmesh_tpu_torch/ops/sparse.py, solve.py)
against the JAX package's ``solve_placement`` with ``sparse_impl="xla"``
on the same problem, on the CPU (the port's kernels run as their plain
versions there).

Gates: in f32, ``valid`` equal, indices equal on every valid slot (1.0
measured) and g within atol 1e-3; in bf16, placement agreement >= 0.97
and |overflow difference| <= 0.5% of demand (the reference's own drift
gates between its two sparse backends). The gated configurations also
pin the iteration counts the convergence gates stop at.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.auction import MAX_COPIES
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.ops.solve import SolveInit as JaxInit
from modelmesh_tpu.ops.solve import solve_placement as jax_solve
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.carry import init_from_numpy, problem_from_numpy
from modelmesh_tpu_torch.ops import cuda_sparse, sparse
from modelmesh_tpu_torch.ops.solve import SolveConfig, solve_placement

N, M, K, SEED = 512, 96, 24, 9
GATED = dict(sinkhorn_tol=0.02, auction_stall_tol=1e-3, auction_iters=8)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    jp = ops.random_problem(jax.random.PRNGKey(0), N, M, capacity_slack=1.6)
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    return jp, problem_from_numpy(leaves, device="cpu")


def _pair(problems, dtype, init=None, **knobs):
    jp, tp = problems
    jd, td = DTYPES[dtype]
    base = dict(topk=K, sel_width=MAX_COPIES, **knobs)
    jax_sol = jax_solve(
        jp, JaxConfig(sparse_impl="xla", dtype=jd, **base), seed=SEED,
        init=None if init is None else JaxInit(
            jnp.asarray(init[0]), jnp.asarray(init[1])),
    )
    torch_sol = solve_placement(
        tp, SolveConfig(dtype=td, **base), seed=SEED,
        init=None if init is None else init_from_numpy(*init, device="cpu"),
    )
    return jax_sol, torch_sol


def _agreement(jax_sol, torch_sol) -> float:
    jv, tv = np.asarray(jax_sol.valid), torch_sol.valid.numpy()
    ji, ti = np.asarray(jax_sol.indices), torch_sol.indices.numpy()
    same = jv == tv
    return float(((same & (ji == ti)) | (same & ~jv)).mean())


def _demand(jp) -> float:
    return float(jnp.sum(jp.sizes * jnp.minimum(jp.copies, MAX_COPIES)))


@pytest.mark.parametrize("knobs", [{}, GATED], ids=["fixed", "gated"])
def test_f32_placements_match(problems, knobs):
    jax_sol, torch_sol = _pair(problems, "f32", **knobs)
    jv = np.asarray(jax_sol.valid)
    np.testing.assert_array_equal(torch_sol.valid.numpy(), jv)
    idx_eq = np.asarray(jax_sol.indices)[jv] == torch_sol.indices.numpy()[jv]
    assert idx_eq.mean() == 1.0
    np.testing.assert_allclose(
        torch_sol.g.numpy(), np.asarray(jax_sol.g), rtol=0, atol=1e-3
    )
    assert torch_sol.sinkhorn_iters_run == int(jax_sol.sinkhorn_iters_run)
    assert torch_sol.auction_iters_run == int(jax_sol.auction_iters_run)


@pytest.mark.parametrize("knobs", [{}, GATED], ids=["fixed", "gated"])
def test_bf16_drift_gate(problems, knobs):
    jax_sol, torch_sol = _pair(problems, "bf16", **knobs)
    assert _agreement(jax_sol, torch_sol) >= 0.97
    d_over = abs(float(torch_sol.overflow) - float(jax_sol.overflow))
    assert d_over <= 0.005 * _demand(problems[0])


def test_warm_start_matches(problems):
    """A warm solve from carried (g0, price0) follows the reference."""
    cold, _ = _pair(problems, "f32", **GATED)
    init = (np.asarray(cold.g), np.asarray(cold.prices))
    jax_sol, torch_sol = _pair(problems, "f32", init=init, **GATED)
    assert _agreement(jax_sol, torch_sol) == 1.0
    assert torch_sol.sinkhorn_iters_run == int(jax_sol.sinkhorn_iters_run)
    assert torch_sol.auction_iters_run == int(jax_sol.auction_iters_run)


def test_final_select_none_matches(problems):
    jax_sol, torch_sol = _pair(problems, "f32", final_select="none", **GATED)
    assert _agreement(jax_sol, torch_sol) == 1.0
    np.testing.assert_allclose(
        float(torch_sol.overflow), float(jax_sol.overflow), rtol=1e-5
    )


def test_host_syncs_per_gated_solve(problems):
    """Each gate decision is one counted host sync: the Sinkhorn probe
    plus one per chunk but the last, the auction probe plus one per round
    but the last. This cold solve runs the whole Sinkhorn budget (probe +
    3 chunks of 4: the probe and two chunk gates, 3 syncs) and one
    auction round after a failed probe (1 sync)."""
    _, tp = problems
    before = device_mod.host_syncs
    sol = solve_placement(
        tp, SolveConfig(topk=K, sel_width=MAX_COPIES, **GATED), seed=SEED
    )
    assert (sol.sinkhorn_iters_run, sol.auction_iters_run) == (13, 9)
    assert device_mod.host_syncs - before == 3 + 1


def test_cpu_solve_never_loads_kernels(problems, monkeypatch):
    from modelmesh_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    cuda_sparse.reset_launches()
    solve_placement(problems[1], SolveConfig(topk=K), seed=SEED)
    assert all(v == 0 for v in cuda_sparse.launches.values())


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the sparse wrappers' calls (on the CPU they run their plain
    versions; ``launches`` counts only kernel launches)."""
    calls = dict.fromkeys(cuda_sparse.launches, 0)
    for name in calls:
        fn = getattr(cuda_sparse, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(cuda_sparse, name, counted)
    return calls


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sinkhorn_shape_rule(kernel_calls, wide):
    """Up to FUSED_MAX_COLS instances an iteration is one fused step;
    wider, the row and column products run back to back. Both routes
    follow the reference: f32 placements and iteration counts equal."""
    m = cuda_sparse.FUSED_MAX_COLS + 76 if wide else M
    jp = ops.random_problem(jax.random.PRNGKey(1), 128, m,
                            capacity_slack=1.6)
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    pair = (jp, problem_from_numpy(leaves, device="cpu"))
    jax_sol, torch_sol = _pair(pair, "f32", **GATED)
    assert _agreement(jax_sol, torch_sol) == 1.0
    assert torch_sol.sinkhorn_iters_run == int(jax_sol.sinkhorn_iters_run)
    # The whole budget: the probe and 3 chunks of 4, 3 marginal gates.
    iters, gates = torch_sol.sinkhorn_iters_run, 3
    assert iters == 13
    # The gather packs the mask (one selection pass); the Sinkhorn takes it.
    assert kernel_calls["select_candidates"] == 1
    assert kernel_calls["masked_row_min"] == 0
    if wide:
        assert kernel_calls["masked_sinkhorn_step"] == 0
        assert kernel_calls["masked_col_matvec"] == iters
        assert kernel_calls["masked_row_matvec"] == iters + gates
    else:
        assert kernel_calls["masked_sinkhorn_step"] == iters
        assert kernel_calls["masked_col_matvec"] == 0
        assert kernel_calls["masked_row_matvec"] == gates


def test_dense_route_raises(problems):
    """topk = 0 or >= M routes dense (tests/test_torch_dense_solve.py holds
    that tier against the reference); there the sparse-only knob checks
    do not apply: the threefry pin that the sparse tier refuses solves
    dense and holds the dense parity gates, and a dense-tier knob that
    does not apply to CPU tensors raises."""
    jp, tp = problems
    ref = jax_solve(jp, JaxConfig(topk=0, noise_impl="threefry"), seed=3)
    got = solve_placement(tp, SolveConfig(topk=0, noise_impl="threefry"),
                          seed=3)
    assert _agreement(ref, got) >= 0.97
    assert abs(float(got.overflow) - float(ref.overflow)) <= (
        0.005 * _demand(jp))
    with pytest.raises(ValueError, match="lse_impl"):
        solve_placement(problems[1], SolveConfig(topk=M, lse_impl="cuda"))


@pytest.mark.parametrize("bad,match", [
    (dict(noise_impl="threefry"), "noise_impl='hash'"),
    (dict(noise_impl="philox"), "noise_impl"),
    (dict(load_impl="onehot"), "load_impl"),
    (dict(sel_width=MAX_COPIES + 1), "sel_width"),
    (dict(final_select="none", auction_iters=0), "iters >= 1"),
    (dict(sparse_impl="xla"), "sparse_impl"),
    (dict(sparse_impl="cuda"), "CUDA device"),
])
def test_config_validation(problems, bad, match):
    with pytest.raises(ValueError, match=match):
        solve_placement(problems[1], SolveConfig(topk=K, **bad))


def test_resolve_sparse_impl():
    assert sparse.resolve_sparse_impl("auto", torch.device("cpu")) == "plain"
    assert sparse.resolve_sparse_impl("auto", torch.device("cuda")) == "cuda"
    assert sparse.resolve_sparse_impl("cuda", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        sparse.resolve_sparse_impl("pallas", torch.device("cuda"))


@pytest.mark.parametrize("seed", [None, 7], ids=["exact_ties", "noised"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_topk_candidates_tie_order(seed, dtype):
    """The top-K gather against the reference's ``jax.lax.top_k`` order:
    a row with fewer than K feasible columns, rows of feasible costs on a
    coarse grid (exact ties without noise, near-ties with it). Gathered
    ids equal on every valid slot; the K-th keys equal, or with noise
    within the hash-Gumbel draw's pinned atol 2e-4 (XLA-CPU's and
    torch-CPU's f32 log differ by an ulp on some inputs)."""
    from modelmesh_tpu.ops import sparse as ref_sparse

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    n, m = 6, 96
    cost = np.round(rng.random((n, m)) * 4) / 4
    feasible = np.ones((n, m), bool)
    feasible[0, 5:] = False
    feasible[1, ::3] = False
    cost = (cost + 1e4 * ~feasible).astype(np.float32)
    Cj = jnp.asarray(cost).astype(jd)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(td)
    ref = ref_sparse.topk_candidates(
        Cj, jnp.asarray(feasible), K,
        seed=None if seed is None else jnp.uint32(seed), return_thresh=True)
    _, idx_k, feas_k, fused = sparse.topk_candidates(
        Ct, torch.from_numpy(feasible), K, seed=seed)
    ref_idx, ref_feas = np.asarray(ref[1]), np.asarray(ref[2])
    np.testing.assert_array_equal(feas_k.numpy(), ref_feas)
    np.testing.assert_array_equal(idx_k.numpy()[ref_feas], ref_idx[ref_feas])
    assert int(ref_feas[0].sum()) == 5          # the short row
    np.testing.assert_allclose(fused.thresh.numpy(), np.asarray(ref[4]),
                               rtol=0, atol=0 if seed is None else 2e-4)
