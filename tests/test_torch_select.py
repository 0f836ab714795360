"""The top-K candidate selection (``cuda_sparse.select_candidates``)
against the JAX package on the CPU, and a CPU model of its kernel's guard
band.

1. The plain version (the PyTorch-op key, the tie-stable top-K, the K-th
   key, ``masked_row_min_ref``) against the reference's
   ``topk_candidates(..., return_thresh=True)`` followed by its Pallas
   ``masked_row_min`` in interpret mode, on the same bf16 costs and seed:
   gathered ids, mask and rowmin bitwise; the K-th key bitwise without
   noise, and with it within the hash-Gumbel draw's pinned atol 2e-4
   (XLA-CPU's and torch-CPU's f32 log differ by an ulp on some inputs,
   ROADMAP queue 3).
2. The guard band's decision rules (csrc/masked_sparse.cu, select_kernel),
   modelled with PyTorch ops: the fast draw is the exact one moved by up
   to the kernel's bound E either way (from a seed, and at exactly +-E);
   each lane's two smallest key', the band, the members and the exact
   selection among them give bitwise the idx, thresh, rowmin and bits of
   the exact route, and the mask-only mode's three-way decision the exact
   mask. The kernel itself needs a card (``chip_smoke.py`` holds it
   against the plain version there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops.pallas_sparse import masked_row_min as jax_row_min
from modelmesh_tpu.ops.pallas_sparse import (
    noise_row_state as jax_noise_row_state,
)
from modelmesh_tpu.ops.sparse import GATHER_TAU, _GATHER_SALT
from modelmesh_tpu.ops.sparse import topk_candidates as jax_topk
from modelmesh_tpu_torch.ops import _build, auction, cuda_sparse
from modelmesh_tpu_torch.ops import sparse as torch_sparse

# The kernel's constants: the draw bound kGumbelErr and the rounding slack
# kRoundRel (2^-20) of its band.
GUMBEL_ERR = 1e-4
ROUND_REL = 2.0 ** -20
INFEASIBLE = 1e4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _costs(kind: str, n: int, m: int, seed: int) -> np.ndarray:
    """f32 costs: ~3 N(0, 1); ties in {0, 1, 2}; or the INFEASIBLE plateau
    (a third of each row feasible, the first row with 5 feasible columns)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 3, (n, m)).astype(np.float32)
    c = (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
    if kind == "plateau":
        feasible = rng.random((n, m)) < 0.33
        feasible[0] = False
        feasible[0, :5] = True
        c = np.where(feasible, np.abs(c), c + INFEASIBLE).astype(np.float32)
    return c


# (kind, n, m, k, noised): the tier's K at a multiple of 8 (vector lanes)
# and at an odd width (scalar lanes), K >= M, K above 32 (more than 32
# members) and above 64 (no lane bound), tie-heavy rows, the INFEASIBLE
# plateau.
CASES = [
    pytest.param("normal", 96, 1024, 24, True, id="k24_1024"),
    pytest.param("normal", 64, 1001, 24, True, id="k24_odd"),
    pytest.param("normal", 128, 96, 24, False, id="k24_unnoised"),
    pytest.param("normal", 40, 20, 24, True, id="k_ge_m"),
    pytest.param("normal", 40, 200, 48, True, id="k48"),
    pytest.param("normal", 40, 200, 80, True, id="k80"),
    pytest.param("ties", 64, 512, 24, False, id="ties"),
    pytest.param("ties", 64, 200, 16, True, id="ties_noised"),
    pytest.param("plateau", 64, 256, 24, True, id="plateau"),
]


def _torch_costs(c32: np.ndarray):
    """bf16 costs on both sides (through exact f32)."""
    Cj = jnp.asarray(c32).astype(jnp.bfloat16)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(torch.bfloat16)
    return Cj, Ct


def _x_row(n: int, seed: int, noised: bool) -> torch.Tensor:
    salted = (seed ^ _GATHER_SALT) & 0xFFFFFFFF if noised else 0
    return cuda_sparse.noise_row_state(n, salted, "cpu")


@pytest.mark.parametrize("kind,n,m,k,noised", CASES)
def test_plain_matches_reference(kind, n, m, k, noised):
    seed = 7
    Cj, Ct = _torch_costs(_costs(kind, n, m, seed))
    s = jnp.asarray(seed, jnp.uint32) if noised else None
    _, jidx, _, jmask, jkth = jax_topk(
        Cj, jnp.ones((n, m), bool), k, seed=s, return_thresh=True)
    jxr = jax_noise_row_state(
        n, s ^ jnp.uint32(_GATHER_SALT) if noised else jnp.uint32(0))
    tau = GATHER_TAU if noised else 0.0
    jrowmin = jax_row_min(Cj, jkth, jxr, tau=tau, noised=noised,
                          interpret=True)
    got = cuda_sparse.select_candidates(Ct, _x_row(n, seed, noised), k,
                                        tau=GATHER_TAU, noised=noised)
    kk = min(k, m)
    assert got.idx.shape == (n, kk) and got.idx.dtype == torch.int64
    np.testing.assert_array_equal(got.idx.numpy(),
                                  np.asarray(jidx).astype(np.int64))
    np.testing.assert_array_equal(
        cuda_sparse.unpack_mask(got.bits, m).numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(got.rowmin.numpy(), np.asarray(jrowmin))
    np.testing.assert_allclose(got.thresh.numpy(), np.asarray(jkth), rtol=0,
                               atol=2e-4 if noised else 0)


@pytest.mark.parametrize("kind,n,m,k,noised", CASES[:3])
def test_plain_is_the_unfused_route(kind, n, m, k, noised):
    """The plain version is today's CPU route op for op: the gather's K-th
    key, then ``masked_row_min`` on it."""
    seed = 9
    _, Ct = _torch_costs(_costs(kind, n, m, seed))
    xr = _x_row(n, seed, noised)
    got = cuda_sparse.select_candidates(Ct, xr, k, tau=GATHER_TAU,
                                        noised=noised)
    key = cuda_sparse.selection_key(Ct, xr, tau=GATHER_TAU, noised=noised)
    neg, idx = auction.top_k(-key, k)
    assert torch.equal(got.idx, idx)
    assert torch.equal(got.thresh, -neg.amin(dim=1))
    rowmin, bits = cuda_sparse.masked_row_min(Ct, got.thresh, xr,
                                              tau=GATHER_TAU, noised=noised)
    assert torch.equal(got.rowmin, rowmin) and torch.equal(got.bits, bits)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _band(cabs: torch.Tensor, atau: float) -> torch.Tensor:
    """select_kernel's band(): |tau| E + 2^-20 (|c| + 35 |tau|), in f32."""
    a = _f32(atau)
    return a * _f32(GUMBEL_ERR) + _f32(ROUND_REL) * (cabs + _f32(35.0) * a)


def _fast_keys(C, x_row, tau, noised, g_err):
    """key' = c - tau g' with g' = g + g_err (|g_err| <= E): what the
    kernel's fast draw may give, at its worst (the kernel rounds c - tau g'
    once, this model twice: both inside the band's rounding slack)."""
    c = C.to(torch.float32)
    if not noised:
        return c
    cols = torch.arange(C.shape[1], dtype=torch.int64)
    g = auction.gumbel_from_bits(
        auction.hash_bits(cuda_sparse._as_u32(x_row)[:, None], cols[None]))
    return c - _f32(tau) * (g + g_err)


def _g_err(shape, seed: int, extreme: bool) -> torch.Tensor:
    """Draw errors within +-E: at exactly +-E, or anywhere inside."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    mag = np.ones(shape) if extreme else rng.random(shape)
    return torch.from_numpy((sign * mag * GUMBEL_ERR).astype(np.float32))


def _band_select(C, x_row, k, tau, noised, g_err):
    """select_kernel<true>'s decisions with PyTorch ops: the bound from
    each lane's two smallest key', the band, the members, the exact
    selection among them. Returns the selection and the members (entries
    whose exact key was computed)."""
    n, m = C.shape
    c = C.to(torch.float32)
    kf = _fast_keys(C, x_row, tau, noised, g_err)
    cols = torch.arange(m)
    lane = (cols // 8) % 32 if m % 8 == 0 else cols % 32
    # Each lane's two smallest key' (+inf where it has fewer entries).
    two = torch.full((n, 64), torch.inf)
    for ln in range(32):
        own = kf[:, lane == ln]
        if own.shape[1]:
            low = torch.topk(own, min(2, own.shape[1]), dim=1,
                             largest=False).values
            two[:, 2 * ln:2 * ln + low.shape[1]] = low
    upper = (torch.sort(two, dim=1).values[:, k - 1] if k <= 64
             else torch.full((n,), torch.inf))
    d = (_band(c.abs().amax(dim=1), abs(tau)) if noised
         else torch.zeros(n))
    members = kf <= (upper + _f32(3.0) * d)[:, None]
    assert bool((members.sum(dim=1) >= k).all())
    key = cuda_sparse.selection_key(C, x_row, tau=tau, noised=noised)
    # Ranks by (exact key, column) among the members.
    vals, order = torch.sort(torch.where(members, key, torch.inf), dim=1,
                             stable=True)
    thresh = vals[:, k - 1]
    mask = members & (key <= thresh[:, None])
    rowmin = torch.where(mask, c, torch.inf).amin(dim=1)
    sel = cuda_sparse.SelectedCandidates(
        order[:, :k].contiguous(), thresh, rowmin, cuda_sparse.pack_mask(mask))
    return sel, members


def _band_mask(C, x_row, thresh, tau, noised, g_err):
    """select_kernel<false>'s three-way decision per entry."""
    c = C.to(torch.float32)
    kf = _fast_keys(C, x_row, tau, noised, g_err)
    key = cuda_sparse.selection_key(C, x_row, tau=tau, noised=noised)
    if not noised:
        return key <= thresh[:, None], torch.zeros_like(key, dtype=torch.bool)
    d = _band(c.abs(), abs(tau))
    diff = kf - thresh[:, None]
    th = thresh[:, None]
    sure_in, sure_out = diff <= -d, diff > d
    exact = ~sure_in & ~sure_out
    return sure_in | (exact & (key <= th)), exact


@pytest.mark.parametrize("extreme", [False, True], ids=["inside", "at_E"])
@pytest.mark.parametrize("kind,n,m,k,noised", CASES)
def test_band_model_equals_exact_route(kind, n, m, k, noised, extreme):
    seed = 11
    _, Ct = _torch_costs(_costs(kind, n, m, seed))
    xr = _x_row(n, seed, noised)
    kk = min(k, m)
    want = cuda_sparse.select_candidates(Ct, xr, kk, tau=GATHER_TAU,
                                         noised=noised)
    g_err = _g_err((n, m), seed, extreme)
    got, members = _band_select(Ct, xr, kk, GATHER_TAU, noised, g_err)
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a,
                           b.view(torch.int32) if b.is_floating_point()
                           else b), field
    mask, exact = _band_mask(Ct, xr, want.thresh, GATHER_TAU, noised, g_err)
    assert torch.equal(cuda_sparse.pack_mask(mask), want.bits)
    if kind == "normal" and noised and kk == 24 and m >= 1000:
        # The band is narrow: the exact keys are a small share of a row.
        assert members.sum().item() < 0.1 * n * m
        assert exact.sum().item() < 0.01 * n * m


def test_band_catches_a_wrong_bound():
    """The model is sharp enough to fail: with draws off by 100 E and the
    band still at E, some row's selection or mask differs."""
    n, m, k, seed = 96, 1024, 24, 13
    _, Ct = _torch_costs(_costs("normal", n, m, seed))
    xr = _x_row(n, seed, True)
    want = cuda_sparse.select_candidates(Ct, xr, k, tau=GATHER_TAU,
                                         noised=True)
    g_err = _g_err((n, m), seed, True) * 100
    mask, _ = _band_mask(Ct, xr, want.thresh, GATHER_TAU, True, g_err)
    assert not torch.equal(cuda_sparse.pack_mask(mask), want.bits)


def test_topk_candidates_carries_the_packed_mask():
    """The gather hands the Sinkhorn its mask: rowmin and bits are
    ``masked_row_min``'s on the gather's thresholds."""
    n, m, k = 64, 96, 24
    _, Ct = _torch_costs(_costs("normal", n, m, 3))
    _, idx, _, fz = torch_sparse.topk_candidates(
        Ct, torch.ones((n, m), dtype=torch.bool), k, seed=3)
    rowmin, bits = cuda_sparse.masked_row_min(Ct, fz.thresh, fz.x_row,
                                              tau=fz.tau, noised=fz.noised)
    assert torch.equal(fz.rowmin, rowmin) and torch.equal(fz.bits, bits)
    assert idx.shape == (n, k)


class TestWrapper:
    @pytest.fixture
    def no_build(self, monkeypatch):
        def refuse(name):
            raise AssertionError(f"kernel library {name} loaded")

        monkeypatch.setattr(_build, "load_library", refuse)
        cuda_sparse.reset_launches()

    def test_cpu_takes_plain_version(self, no_build):
        _, Ct = _torch_costs(_costs("normal", 16, 64, 0))
        cuda_sparse.select_candidates(Ct, _x_row(16, 0, True), 8,
                                      tau=GATHER_TAU, noised=True)
        assert cuda_sparse.launches["select_candidates"] == 0

    def test_other_devices_raise(self, no_build):
        with pytest.raises(ValueError, match="no kernel"):
            cuda_sparse.select_candidates(
                torch.zeros((8, 16), dtype=torch.bfloat16, device="meta"),
                torch.zeros(8, dtype=torch.int32, device="meta"), 4,
                tau=GATHER_TAU, noised=True)

    def test_rejects_empty_selection_and_cpu_diagnostic(self, no_build):
        C = torch.zeros((8, 16), dtype=torch.bfloat16)
        xr = torch.zeros(8, dtype=torch.int32)
        with pytest.raises(ValueError, match="at least one"):
            cuda_sparse.select_candidates(C, xr, 0, tau=0.5, noised=True)
        with pytest.raises(ValueError, match="diagnostic"):
            cuda_sparse.select_candidates(
                C, xr, 4, tau=0.5, noised=True,
                exact_counts=torch.zeros(8, dtype=torch.int32))
