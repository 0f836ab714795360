"""The port's implied load (modelmesh_tpu_torch/ops/cuda_load.py) against
the JAX package's ``_implied_load_fused`` and ``_implied_load(...,
"scatter")`` on the CPU, and the ``load_impl`` routing.

Inputs come from a seed through numpy. The plain one-hot version equals
the reference's fused histogram bit for bit wherever the sums are exact
(integer sizes below 2^24, as the fleets have), and matches it within rtol
1e-6 at random f32 sizes (the two frameworks sum a chunk in another
order). On the CPU ``load_impl="auto"`` resolves to the scatter, so the
solves there are bit for bit what they were; ``"fused"`` runs the plain
one-hot version. The kernel itself needs a card (``chip_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.auction import _implied_load as jax_implied_load
from modelmesh_tpu.ops.auction import _implied_load_fused as jax_fused
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.ops.solve import solve_placement as jax_solve
from modelmesh_tpu_torch.carry import problem_from_numpy
from modelmesh_tpu_torch.ops import _build, auction, cuda_load
from modelmesh_tpu_torch.ops.solve import SolveConfig, solve_placement

MAX_COPIES = auction.MAX_COPIES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assignment(seed, n, s, m, integer=True):
    """idx i64[n, s] in [0, m), valid bool[n, s], sizes f32[n]: integer
    sizes 16-255 (the fleets'), or lognormal f32."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(m, 1), (n, s)).astype(np.int64)
    valid = rng.random((n, s)) < 0.7
    if integer:
        sizes = rng.integers(16, 256, n).astype(np.float32)
    else:
        sizes = np.exp(rng.standard_normal(n) * 0.8 + 3.0).astype(np.float32)
    return idx, valid, sizes


def _both(idx, valid, sizes, m):
    """(port plain one-hot, reference fused, reference scatter)."""
    got = cuda_load.implied_load(torch.from_numpy(idx),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(sizes), m)
    j = (jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(sizes))
    return (got.numpy(), np.asarray(jax_fused(*j, m)),
            np.asarray(jax_implied_load(*j, m, "scatter")))


# Ragged N (not a multiple of the 8192-entry chunk), fewer slots than
# MAX_COPIES, more entries than one chunk, one instance, one model.
SHAPES = [(1000, 8, 96), (333, 3, 64), (2500, 8, 1100), (40, 1, 1),
          (1, 8, 16)]


@pytest.mark.parametrize("n,s,m", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_reference_bitwise_at_integer_sizes(n, s, m, seed):
    got, fused, scatter = _both(*_assignment(seed, n, s, m), m)
    assert got.dtype == np.float32 and got.shape == (m,)
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, scatter)


@pytest.mark.parametrize("n,s,m", SHAPES)
def test_plain_close_to_reference_at_f32_sizes(n, s, m):
    got, fused, scatter = _both(*_assignment(5, n, s, m, integer=False), m)
    np.testing.assert_allclose(got, fused, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, scatter, rtol=1e-6, atol=0)


def test_zero_models():
    idx = np.zeros((0, 8), np.int64)
    got, fused, scatter = _both(idx, np.zeros((0, 8), bool),
                                np.zeros(0, np.float32), 32)
    assert got.shape == (32,) and not got.any()
    np.testing.assert_array_equal(got, fused)
    np.testing.assert_array_equal(got, scatter)


def test_nsel_slice():
    """The sparse auction's first ``nsel`` slots, passed as a view of the
    [N, MAX_COPIES] selection (row stride MAX_COPIES)."""
    idx, valid, sizes = _assignment(3, 700, MAX_COPIES, 200)
    nsel = 5
    view_i = torch.from_numpy(idx)[:, :nsel]
    view_v = torch.from_numpy(valid)[:, :nsel]
    assert view_i.stride() == (MAX_COPIES, 1)
    got = cuda_load.implied_load(view_i, view_v, torch.from_numpy(sizes), 200)
    want = jax_fused(jnp.asarray(idx[:, :nsel]), jnp.asarray(valid[:, :nsel]),
                     jnp.asarray(sizes), 200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_invalid_slots_contribute_nothing():
    """Every valid slot off: a zero load even where ids point somewhere
    (the selection pads invalid slots with real ids)."""
    idx, valid, sizes = _assignment(4, 50, 8, 16)
    got, fused, _ = _both(idx, np.zeros_like(valid), sizes, 16)
    assert not got.any()
    np.testing.assert_array_equal(got, fused)


class TestRouting:
    def test_resolve_load_impl(self):
        cpu, cuda = torch.device("cpu"), torch.device("cuda")
        assert auction.resolve_load_impl("auto", cpu) == "scatter"
        assert auction.resolve_load_impl("auto") == "scatter"
        assert auction.resolve_load_impl("auto", cuda) == "fused"
        assert auction.resolve_load_impl("fused", cpu) == "fused"
        assert auction.resolve_load_impl("scatter", cuda) == "scatter"
        for bad in ("onehot", "pallas", ""):
            with pytest.raises(ValueError, match="load_impl"):
                auction.resolve_load_impl(bad, cpu)

    def test_unresolved_impl_rejected(self):
        idx, valid, sizes = (torch.from_numpy(a)
                             for a in _assignment(0, 4, 2, 8))
        with pytest.raises(ValueError, match="unresolved"):
            auction._implied_load(idx, valid, sizes, 8, "auto")

    def test_fused_routes_to_the_wrapper(self):
        idx, valid, sizes = (torch.from_numpy(a)
                             for a in _assignment(2, 300, 8, 40))
        fused = auction._implied_load(idx, valid, sizes, 40, "fused")
        assert torch.equal(fused,
                           cuda_load.implied_load_ref(idx, valid, sizes, 40))
        assert torch.equal(fused,
                           auction._implied_load(idx, valid, sizes, 40))

    def test_cpu_takes_plain_version(self, monkeypatch):
        def refuse(name):
            raise AssertionError(f"kernel library {name} loaded")

        monkeypatch.setattr(_build, "load_library", refuse)
        cuda_load.reset_launches()
        idx, valid, sizes = (torch.from_numpy(a)
                             for a in _assignment(1, 64, 8, 32))
        cuda_load.implied_load(idx, valid, sizes, 32)
        assert cuda_load.launches == {"implied_load": 0}

    def test_other_devices_raise_without_plain_fallback(self):
        meta = dict(device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            cuda_load.implied_load(
                torch.zeros((4, 8), dtype=torch.int64, **meta),
                torch.zeros((4, 8), dtype=torch.bool, **meta),
                torch.zeros(4, **meta), 16)

    @pytest.mark.parametrize("bad", ["idx_dtype", "valid_shape",
                                     "sizes_dtype", "device"])
    def test_operand_checks(self, bad):
        idx = torch.zeros((4, 8), dtype=torch.int64)
        valid = torch.zeros((4, 8), dtype=torch.bool)
        sizes = torch.zeros(4)
        if bad == "idx_dtype":
            idx = idx.to(torch.int32)
        elif bad == "valid_shape":
            valid = valid[:, :7]
        elif bad == "sizes_dtype":
            sizes = sizes.to(torch.float64)
        else:
            valid = valid.to("meta")
        with pytest.raises((TypeError, ValueError)):
            cuda_load.implied_load(idx, valid, sizes, 16)


def _problems(n, m, seed=0):
    """One random problem on both sides, its sizes rounded to integers so
    every load is exact in f32 whatever the summation order."""
    jp = ops.random_problem(jax.random.PRNGKey(seed), n, m,
                            capacity_slack=1.6)
    jp = dataclasses.replace(jp, sizes=jnp.round(jp.sizes) + 1.0)
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    return jp, problem_from_numpy(leaves, device="cpu")


SOLVES = {
    "sparse": dict(topk=24, sel_width=MAX_COPIES, dtype=torch.float32,
                   sinkhorn_tol=0.02, auction_stall_tol=1e-3,
                   auction_iters=8),
    "dense": dict(tau=0.0, auction_iters=16, dtype=torch.float32),
}
PLACEMENT = ("indices", "valid", "load", "prices", "overflow", "f", "g")


@pytest.fixture(scope="module")
def problems():
    return _problems(256, 96)


@pytest.mark.parametrize("tier", sorted(SOLVES))
def test_cpu_solves_unchanged(problems, tier):
    """``auto`` on the CPU is the scatter, bit for bit; ``fused`` (the
    one-hot plain version) gives the same placement where the loads are
    exact."""
    _, tp = problems
    sols = {impl: solve_placement(tp, SolveConfig(load_impl=impl,
                                                  **SOLVES[tier]), seed=3)
            for impl in ("auto", "scatter", "fused")}
    for impl in ("auto", "fused"):
        for field in PLACEMENT:
            a = getattr(sols[impl], field)
            b = getattr(sols["scatter"], field)
            assert torch.equal(a, b), (impl, field)
        assert (sols[impl].sinkhorn_iters_run, sols[impl].auction_iters_run) \
            == (sols["scatter"].sinkhorn_iters_run,
                sols["scatter"].auction_iters_run)


@pytest.mark.parametrize("tier", sorted(SOLVES))
def test_fused_solve_matches_reference_fused(problems, tier):
    """``load_impl="fused"`` on both sides: f32 placements equal (the
    reference's sparse solve on its XLA path)."""
    jp, tp = problems
    knobs = dict(SOLVES[tier], load_impl="fused")
    sol = solve_placement(tp, SolveConfig(**knobs), seed=3)
    knobs["dtype"] = jnp.float32
    if tier == "sparse":
        knobs["sparse_impl"] = "xla"
    ref = jax_solve(jp, JaxConfig(**knobs), seed=3)
    np.testing.assert_array_equal(sol.valid.numpy(), np.asarray(ref.valid))
    valid = sol.valid.numpy()
    np.testing.assert_array_equal(sol.indices.numpy()[valid],
                                  np.asarray(ref.indices)[valid])
    np.testing.assert_array_equal(sol.load.numpy(), np.asarray(ref.load))
