"""The port's dense tier (modelmesh_tpu_torch/ops/sinkhorn.py, auction.py,
solve.py) against the JAX package on the CPU, stage by stage and whole.

Same inputs on both sides (JAX problems carried across through numpy;
auction inputs are the reference's own bf16 plan logits). Gates: f and g
within atol 1e-3 (tests/test_pallas_lse.py's Sinkhorn gate) with equal
iteration counts; plan logits within one bf16 ulp; at tau = 0 the auction
is deterministic, so valid slots, their indices and the load must be
equal, including rows whose columns tie; with noise on, placement
agreement >= 0.97 and |overflow difference| <= 0.5% of demand (the
reference's own drift gates), since XLA-CPU and torch-CPU round the
Gumbel draw's double log apart (ROADMAP queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.auction import auction as jax_auction
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.ops.solve import SolveInit as JaxInit
from modelmesh_tpu.ops.solve import solve_placement as jax_solve
from modelmesh_tpu.ops.sinkhorn import plan_logits as jax_plan_logits
from modelmesh_tpu.ops.sinkhorn import sinkhorn as jax_sinkhorn
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.carry import init_from_numpy, problem_from_numpy
from modelmesh_tpu_torch.ops import auction, cuda_lse
from modelmesh_tpu_torch.ops.sinkhorn import plan_logits, sinkhorn
from modelmesh_tpu_torch.ops.solve import SolveConfig, solve_placement

MAX_COPIES = auction.MAX_COPIES
GATED = dict(sinkhorn_tol=0.02, auction_stall_tol=1e-3, auction_iters=8)
EPS = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x) -> torch.Tensor:
    """A JAX array as a torch CPU tensor (bf16 through exact f32)."""
    a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _carry(jp):
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    return problem_from_numpy(leaves, device="cpu")


def _marginals(p):
    copies = jnp.minimum(p.copies, MAX_COPIES)
    return (p.sizes * copies.astype(jnp.float32),
            jnp.maximum(p.capacity - p.reserved, 0.0))


def _agreement(jv, ji, tv, ti) -> float:
    same = jv == tv
    return float(((same & (ji == ti)) | (same & ~jv)).mean())


def _demand(p) -> float:
    return float(jnp.sum(p.sizes * jnp.minimum(p.copies, MAX_COPIES)))


@pytest.fixture(scope="module")
def sk_inputs():
    """The reference test's Sinkhorn problem (random_problem(5), 96 x 48)."""
    p = ops.random_problem(jax.random.PRNGKey(5), 96, 48)
    C = ops.assemble_cost(p)
    rm, cm = _marginals(p)
    return (C, rm, cm), (_t(C), _t(rm), _t(cm))


@pytest.mark.parametrize("knobs", [dict(iters=6), dict(iters=10, tol=0.02)],
                         ids=["fixed", "gated"])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_sinkhorn_matches_reference(sk_inputs, jax_impl, knobs):
    (C, rm, cm), (Ct, rmt, cmt) = sk_inputs
    ref = jax_sinkhorn(C, rm, cm, eps=EPS, lse_impl=jax_impl, **knobs)
    got = sinkhorn(Ct, rmt, cmt, eps=EPS, **knobs)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), atol=1e-3)
    np.testing.assert_allclose(got.g.numpy(), np.asarray(ref.g), atol=1e-3)
    assert got.iters_run == int(ref.iters_run)
    np.testing.assert_allclose(float(got.row_err), float(ref.row_err),
                               rtol=1e-3, atol=1e-6)


def test_warm_sinkhorn_probe_exit(sk_inputs):
    """A converged g0 passes the one-iteration probe on both sides."""
    (C, rm, cm), (Ct, rmt, cmt) = sk_inputs
    g0 = jax_sinkhorn(C, rm, cm, eps=EPS, iters=40).g
    ref = jax_sinkhorn(C, rm, cm, eps=EPS, iters=10, tol=0.05, g0=g0)
    got = sinkhorn(Ct, rmt, cmt, eps=EPS, iters=10, tol=0.05, g0=_t(g0))
    assert got.iters_run == int(ref.iters_run) == 1
    np.testing.assert_allclose(got.g.numpy(), np.asarray(ref.g), atol=1e-3)


def test_plan_logits_within_one_bf16_ulp(sk_inputs):
    (C, rm, cm), (Ct, _, _) = sk_inputs
    sk = jax_sinkhorn(C, rm, cm, eps=EPS, iters=6)
    ref = np.asarray(jax_plan_logits(C, sk.f, sk.g, EPS).astype(jnp.float32))
    got = plan_logits(Ct, _t(sk.f), _t(sk.g), EPS)
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    # One bf16 ulp at |x|: 2**(floor(log2 |x|) - 7).
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(got - ref) <= ulp).all()
    assert (got == ref).mean() > 0.99


@pytest.fixture(scope="module")
def au_inputs():
    """The reference's own bf16 plan logits of a 512 x 96 problem."""
    p = ops.random_problem(jax.random.PRNGKey(0), 512, 96, capacity_slack=1.6)
    C = ops.assemble_cost(p)
    rm, cm = _marginals(p)
    sk = jax_sinkhorn(C, rm, cm, eps=EPS, iters=10)
    logits = jax_plan_logits(C, sk.f, sk.g, EPS)
    return p, logits


def _auctions(p, logits, seed=3, price0=None, **kw):
    copies = jnp.minimum(p.copies, MAX_COPIES)
    cap = jnp.maximum(p.capacity - p.reserved, 0.0)
    ref = jax_auction(
        logits, p.sizes, copies, cap, p.feasible, seed,
        price0=None if price0 is None else jnp.asarray(price0), **kw)
    got = auction.auction(
        _t(logits), _t(p.sizes), _t(copies), _t(cap), _t(p.feasible), seed,
        price0=None if price0 is None else torch.tensor(price0), **kw)
    return ref, got


def _assert_same_assignment(ref, got):
    jv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_array_equal(got.indices.numpy()[jv],
                                  np.asarray(ref.indices)[jv])
    np.testing.assert_array_equal(got.load.numpy(), np.asarray(ref.load))


@pytest.mark.parametrize("knobs", [{}, dict(iters=8, stall_tol=1e-3)],
                         ids=["fixed", "gated"])
def test_auction_deterministic_matches(au_inputs, knobs):
    ref, got = _auctions(*au_inputs, tau=0.0, **knobs)
    _assert_same_assignment(ref, got)
    assert got.iters_run == int(ref.iters_run)


def test_auction_tied_columns(au_inputs):
    """Every instance column twice (identical logits, feasibility and
    capacity): at tau = 0 each tie must break toward the lower column, as
    jax.lax.top_k breaks it."""
    p, logits = au_inputs
    m = 48
    cols = np.repeat(np.arange(m // 2), 2)
    tied = dataclasses.replace(
        p, feasible=p.feasible[:, cols], capacity=p.capacity[cols],
        reserved=p.reserved[cols],
    )
    ref, got = _auctions(tied, logits[:, cols], tau=0.0, iters=16)
    _assert_same_assignment(ref, got)


def test_auction_noised_drift_gate(au_inputs):
    p, logits = au_inputs
    ref, got = _auctions(p, logits, tau=1.0)
    agree = _agreement(np.asarray(ref.valid), np.asarray(ref.indices),
                       got.valid.numpy(), got.indices.numpy())
    assert agree >= 0.97, agree
    assert abs(float(got.overflow) - float(ref.overflow)) <= (
        0.005 * _demand(p))


@pytest.mark.parametrize("mode", ["exact", "approx", "none"])
def test_final_select_modes_match(au_inputs, mode):
    ref, got = _auctions(*au_inputs, tau=0.0, iters=16, final_select=mode)
    _assert_same_assignment(ref, got)
    np.testing.assert_array_equal(got.prices.numpy(), np.asarray(ref.prices))


def test_warm_price_probe_matches(au_inputs):
    """Warm prices from a cold run: the stall-gated warm probe takes the
    same branch and returns the same assignment."""
    p, logits = au_inputs
    cold, _ = _auctions(p, logits, tau=0.0, iters=16, stall_tol=1e-3)
    price0 = np.asarray(cold.prices)
    ref, got = _auctions(p, logits, tau=0.0, iters=16, stall_tol=1e-3,
                         price0=price0)
    _assert_same_assignment(ref, got)
    assert got.iters_run == int(ref.iters_run)


@pytest.fixture(scope="module")
def solve_problems():
    jp = ops.random_problem(jax.random.PRNGKey(0), 512, 96, capacity_slack=1.6)
    return jp, _carry(jp)


def _solve_pair(problems, dtype, init=None, **knobs):
    jp, tp = problems
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jax_solve(jp, JaxConfig(dtype=jd, **knobs), seed=9,
                    init=None if init is None else JaxInit(
                        jnp.asarray(init[0]), jnp.asarray(init[1])))
    got = solve_placement(tp, SolveConfig(dtype=td, **knobs), seed=9,
                          init=None if init is None else init_from_numpy(
                              *init, device="cpu"))
    return ref, got


@pytest.mark.parametrize("knobs", [{}, GATED], ids=["fixed", "gated"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_solve_placement_dense_matches(solve_problems, dtype, knobs):
    ref, got = _solve_pair(solve_problems, dtype, **knobs)
    agree = _agreement(np.asarray(ref.valid), np.asarray(ref.indices),
                       got.valid.numpy(), got.indices.numpy())
    assert agree >= 0.97, agree
    assert abs(float(got.overflow) - float(ref.overflow)) <= (
        0.005 * _demand(solve_problems[0]))
    np.testing.assert_allclose(got.g.numpy(), np.asarray(ref.g), atol=1e-3)
    assert got.sinkhorn_iters_run == int(ref.sinkhorn_iters_run)
    assert got.auction_iters_run == int(ref.auction_iters_run)


def test_warm_dense_solve_matches(solve_problems):
    cold, _ = _solve_pair(solve_problems, "f32", **GATED)
    init = (np.asarray(cold.g), np.asarray(cold.prices))
    ref, got = _solve_pair(solve_problems, "f32", init=init, **GATED)
    agree = _agreement(np.asarray(ref.valid), np.asarray(ref.indices),
                       got.valid.numpy(), got.indices.numpy())
    assert agree >= 0.97, agree
    assert got.sinkhorn_iters_run == int(ref.sinkhorn_iters_run)
    assert got.auction_iters_run == int(ref.auction_iters_run)


def test_prefers_existing_placement_same_count():
    """The reference's xfail case (tests/test_placement_ops.py,
    prefers_existing_placement, on the dense tier): the port keeps exactly
    as many models where they are loaded as the reference does."""
    p = ops.random_problem(jax.random.PRNGKey(17), 64, 8, capacity_slack=4.0)
    target = np.arange(64) % 8
    loaded = jnp.zeros((64, 8), bool).at[jnp.arange(64),
                                         jnp.asarray(target)].set(True)
    p = type(p)(**{**vars(p), "loaded": loaded})
    ref = jax_solve(p)
    got = solve_placement(_carry(p))

    def stays(idx, valid):
        return sum(target[i] in idx[i][valid[i]].tolist() for i in range(64))

    assert stays(got.indices.numpy(), got.valid.numpy()) == stays(
        np.asarray(ref.indices), np.asarray(ref.valid))


def test_host_syncs_per_dense_solve(solve_problems):
    """The default dense config reads no gate; the gated one reads the
    Sinkhorn probe and each chunk gate but the last (probe + 3 chunks of
    4: 3 reads) and the auction probe (the round budget of 8 is one
    round, whose gate is not read)."""
    _, tp = solve_problems
    before = device_mod.host_syncs
    solve_placement(tp, SolveConfig(), seed=9)
    assert device_mod.host_syncs == before
    sol = solve_placement(tp, SolveConfig(**GATED), seed=9)
    assert (sol.sinkhorn_iters_run, sol.auction_iters_run) == (13, 9)
    assert device_mod.host_syncs - before == 3 + 1


def test_cpu_dense_solve_launches_no_kernel(solve_problems, monkeypatch):
    from modelmesh_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"kernel library {name} loaded")

    monkeypatch.setattr(_build, "load_library", refuse)
    cuda_lse.reset_launches()
    solve_placement(solve_problems[1], SolveConfig(), seed=9)
    assert all(v == 0 for v in cuda_lse.launches.values())


@pytest.mark.parametrize("bad,err,match", [
    (dict(noise_impl="philox"), ValueError, "noise_impl"),
    (dict(load_impl="onehot"), ValueError, "load_impl"),
    (dict(lse_impl="cuda"), ValueError, "CUDA device"),
    (dict(lse_impl="pallas"), ValueError, "lse_impl"),
    (dict(final_select="none", auction_iters=0), ValueError, "iters >= 1"),
])
def test_dense_config_validation(solve_problems, bad, err, match):
    with pytest.raises(err, match=match):
        solve_placement(solve_problems[1], SolveConfig(**bad))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_threefry_dense_solve_matches(solve_problems, dtype):
    """noise_impl="threefry" at tau 1: the draw is JAX's PRNG
    (``jax.random.gumbel(PRNGKey(seed), shape)``, its uniforms bit for bit,
    its double log PyTorch's), held by the dense parity gates: agreement
    >= 0.97, overflow within 0.5% of demand, equal iteration counts."""
    ref, got = _solve_pair(solve_problems, dtype, noise_impl="threefry",
                           tau=1.0)
    agree = _agreement(np.asarray(ref.valid), np.asarray(ref.indices),
                       got.valid.numpy(), got.indices.numpy())
    assert agree >= 0.97, agree
    assert abs(float(got.overflow) - float(ref.overflow)) <= (
        0.005 * _demand(solve_problems[0]))
    assert got.sinkhorn_iters_run == int(ref.sinkhorn_iters_run)
    assert got.auction_iters_run == int(ref.auction_iters_run)


def test_threefry_without_noise_runs(solve_problems):
    """tau = 0 draws no noise, so the threefry pin has nothing to draw."""
    sol = solve_placement(solve_problems[1],
                          SolveConfig(noise_impl="threefry", tau=0.0))
    assert sol.valid.any()


def test_top_k_breaks_ties_toward_lower_index():
    """The trap: a row [1, 2, 3, -1e9 x 37]; jax.lax.top_k gives
    [2 1 0 3 4 5 6 7]."""
    row = np.array([[1.0, 2.0, 3.0] + [-1e9] * 37], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(row), 8)
    vals, idx = auction.top_k(torch.from_numpy(row), 8)
    assert idx.tolist() == np.asarray(want).tolist() == [[2, 1, 0, 3, 4, 5,
                                                          6, 7]]
    assert vals[0, :3].tolist() == [3.0, 2.0, 1.0]


def test_hash_gumbel_rows_offset():
    full = auction.hash_gumbel((16, 8), 3)
    block = auction.hash_gumbel((4, 8), 3, row_offset=4)
    assert torch.equal(block, full[4:8])



def _small_cluster(case):
    if case == "one_instance":
        return ops.random_problem(jax.random.PRNGKey(2), 16, 1)
    if case == "copies_over_max":
        p = ops.random_problem(jax.random.PRNGKey(1), 32, 16)
        return dataclasses.replace(p, copies=jnp.full((32,), 20, jnp.int32))
    p = ops.random_problem(jax.random.PRNGKey(1), 32, 8)
    return dataclasses.replace(
        p, feasible=jnp.ones((32, 8), bool).at[5, :].set(False))


@pytest.mark.parametrize(
    "case", ["one_instance", "copies_over_max", "infeasible_row"])
def test_small_cluster_edge_cases_match(case):
    """The reference's TestSmallClusters problems: M < MAX_COPIES, copies
    clamped to MAX_COPIES, a model with no feasible instance."""
    p = _small_cluster(case)
    ref, got = jax_solve(p), solve_placement(_carry(p))
    jv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    np.testing.assert_array_equal(got.indices.numpy()[jv],
                                  np.asarray(ref.indices)[jv])
