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
          (1, 8, 16), (3000, 8, 1536)]


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


def test_nsel_view_at_the_wide_width():
    """The sparse auction's 5-slot view onto the wide fleets' 1,536
    instances: the plain version and the kernel's order equal the
    reference's fused histogram bit for bit."""
    idx, valid, sizes = _assignment(6, 2000, MAX_COPIES, 1536)
    view_i = torch.from_numpy(idx)[:, :5]
    view_v = torch.from_numpy(valid)[:, :5]
    want = np.asarray(jax_fused(jnp.asarray(idx[:, :5]),
                                jnp.asarray(valid[:, :5]),
                                jnp.asarray(sizes), 1536))
    sizes_t = torch.from_numpy(sizes)
    got = cuda_load.implied_load(view_i, view_v, sizes_t, 1536)
    tree = cuda_load.implied_load_tree(view_i, view_v, sizes_t, 1536)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tree.numpy(), want)


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


# -- the kernel's grid, its workspace and its summation order ----------------


def test_layout_matches_the_kernel_source():
    """The wrapper's grid constants are the kernel's."""
    import re
    from pathlib import Path

    src = (Path(cuda_load.__file__).parent.parent / "csrc"
           / "implied_load.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == cuda_load.THREADS
    assert int(consts["kRows"]) == cuda_load.ROWS
    assert int(consts["kGroup"]) == cuda_load.GROUP
    # A block's entries split into whole steps of its warps at any S.
    for s in range(1, 20):
        assert cuda_load.ROWS * s % cuda_load.THREADS == 0


# (n, s, m) -> (parts, groups, ld): the tier, the sparse auction's view of
# it, the wide fleets, the ragged check, one group and one past it, M past
# a warp histogram's 2,048 bins.
GRIDS = {
    (131072, 8, 1024): (128, 8, 1024),
    (131072, 5, 1024): (128, 8, 1024),
    (12288, 8, 1536): (12, 1, 1536),
    (1000, 3, 1001): (1, 1, 1004),
    (16384, 8, 1024): (16, 1, 1024),
    (16385, 8, 1024): (17, 2, 1024),
    (5000, 8, 4097): (5, 1, 4100),
    (1, 1, 1): (1, 1, 4),
}


@pytest.mark.parametrize("shape", sorted(GRIDS))
def test_grid_follows_from_the_shape_alone(shape):
    g = cuda_load.grid(*shape)
    assert (g.parts, g.groups, g.ld) == GRIDS[shape]
    n, s, m = shape
    assert g.parts * cuda_load.ROWS >= n > (g.parts - 1) * cuda_load.ROWS
    assert g.ld % 4 == 0 and m <= g.ld < m + 4
    assert g.workspace() == ((g.parts + g.groups) * g.ld, g.groups + 1)
    # The summation tree: every partial once, in index order.
    groups = cuda_load.combine_groups(g.parts)
    assert len(groups) == g.groups
    assert [i for grp in groups for i in grp] == list(range(g.parts))
    assert all(len(grp) == cuda_load.GROUP for grp in groups[:-1])


def test_grid_refuses_empty_shapes():
    for shape in ((0, 8, 16), (4, 0, 16), (4, 8, 0)):
        with pytest.raises(ValueError, match="empty"):
            cuda_load.grid(*shape)


@pytest.mark.parametrize("n,s,m", [(3000, 8, 96), (20000, 8, 1024),
                                   (2500, 5, 1536), (1000, 3, 1001),
                                   (5000, 8, 2100)])
def test_tree_order_equals_reference_at_integer_sizes(n, s, m):
    """The kernel's summation order in PyTorch: every sum exact, so the
    reference's fused histogram bit for bit (M > 1,024 and past one slab
    included)."""
    idx, valid, sizes = _assignment(7, n, s, m)
    got = cuda_load.implied_load_tree(torch.from_numpy(idx),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(sizes), m)
    want = jax_fused(jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(sizes),
                     m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,s,m", [(20000, 8, 1024), (3000, 5, 1536)])
def test_tree_order_close_to_reference_at_f32_sizes(n, s, m):
    idx, valid, sizes = _assignment(8, n, s, m, integer=False)
    got = cuda_load.implied_load_tree(torch.from_numpy(idx),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(sizes), m)
    want = jax_fused(jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(sizes),
                     m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def _shard_partials(idx, valid, sizes, m, shards):
    rows = idx.shape[0] // shards
    return [cuda_load.block_partials_tree(idx[i * rows:(i + 1) * rows],
                                          valid[i * rows:(i + 1) * rows],
                                          sizes[i * rows:(i + 1) * rows], m)
            for i in range(shards)]


@pytest.mark.parametrize("s,shards", [(8, 2), (8, 4), (8, 8), (4, 4),
                                      (5, 2)])
def test_shard_partials_combine_to_the_whole_bitwise(s, shards):
    """Shards of a multiple of ROWS rows: their block partials,
    concatenated in rank order and combined, are the whole assignment's
    load bit for bit at f32 sizes (the sharded route)."""
    rows = shards * cuda_load.ROWS * (3 if shards == 2 else 1)
    idx, valid, sizes = (torch.from_numpy(a) for a in
                         _assignment(9, rows, s, 700, integer=False))
    assert rows // shards % cuda_load.ROWS == 0
    parts = _shard_partials(idx, valid, sizes, 700, shards)
    assert sum(p.shape[0] for p in parts) == cuda_load.grid(rows, s, 700).parts
    whole = cuda_load.implied_load_tree(idx, valid, sizes, 700)
    combined = cuda_load.combine_tree(torch.cat(parts))
    assert torch.equal(combined.view(torch.int32), whole.view(torch.int32))


def test_unaligned_shards_leave_more_partials():
    """Shards of 700 rows (not a multiple of ROWS) leave more partials
    than the whole has: their combine is another sum than the single
    device's."""
    shard = cuda_load.grid(700, 8, 16).parts
    assert 4 * shard > cuda_load.grid(4 * 700, 8, 16).parts


def test_view_is_read_by_its_row_stride():
    """The sparse auction's ``idx[:, :nsel]`` is passed as it is (no
    copy), by its row stride, as is any view of rows; a layout without
    unit column stride is copied; a single row's stride is taken as S."""
    base = torch.arange(64, dtype=torch.int64).view(8, 8)
    view = base[:, :5]
    assert cuda_load._rows(view).data_ptr() == base.data_ptr()
    assert cuda_load.row_stride(cuda_load._rows(view)) == 8
    shifted = base[:, 1:6]
    assert cuda_load._rows(shifted).data_ptr() == shifted.data_ptr()
    wide = torch.arange(160, dtype=torch.int64).view(10, 16)[:, :5]
    assert cuda_load.row_stride(cuda_load._rows(wide)) == 16
    flipped = base.t()[:, :5]
    rows = cuda_load._rows(flipped)
    assert rows.stride() == (5, 1) and torch.equal(rows, flipped)
    one = base[:1, :3].expand(1, 3)
    assert cuda_load.row_stride(one) == 3
    assert cuda_load.row_stride(base[2:3, 1:4]) == 3


def test_tree_block_partials_cover_their_entries():
    """Each block partial sums exactly its ROWS rows: weights of 1 in one
    block show up in that partial only."""
    n, s, m = 3 * cuda_load.ROWS + 17, 8, 40
    idx = torch.arange(n * s, dtype=torch.int64).view(n, s) % m
    valid = torch.zeros((n, s), dtype=torch.bool)
    valid[cuda_load.ROWS:2 * cuda_load.ROWS] = True
    parts = cuda_load.block_partials_tree(idx, valid, torch.ones(n), m)
    assert parts.shape == (4, m)
    assert parts[1].sum().item() == cuda_load.ROWS * s
    assert not parts[0].any() and not parts[2:].any()


def test_more_slots_than_one_round():
    """Rows of 12 slots: the block's 12,000 entries take a thread two
    rounds of loads. The kernel's order and the plain version both equal
    the reference's fused histogram at integer sizes."""
    idx, valid, sizes = _assignment(3, 1000, 12, 30)
    plain, want, _ = _both(idx, valid, sizes, 30)
    tree = cuda_load.implied_load_tree(torch.from_numpy(idx),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(sizes), 30)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(tree.numpy(), want)
