"""The port's fused sparse kernels (modelmesh_tpu_torch/ops/cuda_sparse.py)
held against the JAX package's Pallas kernels (ops/pallas_sparse.py, in
interpret mode) on the CPU.

Each side derives its own row thresholds through its own top-K gather from
the same cost matrix and seed, so the whole chain is compared: the hash
bits, the selection key, the candidate mask and gathered ids (exact), the
masked row minimum (bitwise — an f32 min carries no rounding), the
flat-integrand candidate counts (exact integers) and the matvec pair
(rtol 1e-5 / atol 1e-6: XLA-CPU and torch-CPU round exp/log differently
and sum in another order). The CUDA kernels themselves need a card; the
wrappers take their plain versions only for CPU tensors, which the last
tests pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops.auction import hash_gumbel_at as jax_hash_gumbel_at
from modelmesh_tpu.ops.pallas_sparse import _fmix32 as jax_fmix32
from modelmesh_tpu.ops.pallas_sparse import (
    masked_col_matvec as jax_col_matvec,
    masked_row_matvec as jax_row_matvec,
    masked_row_min as jax_row_min,
    noise_row_state as jax_noise_row_state,
)
from modelmesh_tpu.ops.sparse import GATHER_TAU, _GATHER_SALT
from modelmesh_tpu.ops.sparse import topk_candidates as jax_topk
from modelmesh_tpu_torch.ops import _build, auction, cuda_sparse
from modelmesh_tpu_torch.ops import sparse as torch_sparse

# The reference tests' shapes (tile-aligned, sub-tile, ragged, wide) plus
# the end-to-end parity shape.
SHAPES = [(256, 512), (64, 96), (300, 200), (130, 1100), (512, 96)]
K = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(shape, seed=7, k=K):
    """One cost matrix on both sides (bf16 through exact f32) and each
    side's own top-K gather from it."""
    n, m = shape
    rng = np.random.default_rng(seed)
    c32 = (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
    Cj = jnp.asarray(c32).astype(jnp.bfloat16)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(
        torch.bfloat16
    )
    s = jnp.asarray(seed, jnp.uint32)
    _, jidx, _, jmask, jkth = jax_topk(
        Cj, jnp.ones((n, m), bool), k, seed=s, return_thresh=True
    )
    jxr = jax_noise_row_state(n, s ^ jnp.uint32(_GATHER_SALT))
    _, tidx, _, fz = torch_sparse.topk_candidates(
        Ct, torch.ones((n, m), dtype=torch.bool), k, seed=seed
    )
    return dict(Cj=Cj, jidx=jidx, jmask=jmask, jkth=jkth, jxr=jxr,
                Ct=Ct, tidx=tidx, fz=fz)


def _targs(p):
    fz = p["fz"]
    return (p["Ct"], fz.thresh, fz.x_row), dict(tau=fz.tau, noised=fz.noised)


class TestHash:
    def test_row_state_bits_equal(self):
        seed = 0xDEADBEEF
        jx = np.asarray(jax_noise_row_state(4096, jnp.uint32(seed)))
        tx = cuda_sparse.noise_row_state(4096, seed, "cpu")
        np.testing.assert_array_equal(
            tx.numpy().astype(np.int64) & 0xFFFFFFFF, jx.astype(np.int64)
        )

    @pytest.mark.parametrize("seed", [0, 9, 0x9E3779B9 ^ 123])
    def test_uniform_bits_equal(self, seed):
        n, m = 300, 257
        jxr = jax_noise_row_state(n, jnp.uint32(seed))
        cols = jnp.arange(m, dtype=jnp.uint32)[None, :]
        jbits = jax_fmix32(jxr[:, None] ^ (cols * jnp.uint32(0x85EBCA6B)))
        tbits = auction.hash_bits(
            auction.row_state(torch.arange(n)[:, None], seed),
            torch.arange(m)[None, :],
        )
        np.testing.assert_array_equal(
            tbits.numpy() >> 8, np.asarray(jbits >> 8).astype(np.int64)
        )

    def test_gumbel_close(self):
        """Bits are equal; the double log is not bitwise across XLA-CPU
        and torch-CPU (up to ~1e-4 apart, measured)."""
        n, m = 200, 300
        rows = jax.lax.broadcasted_iota(jnp.uint32, (n, m), 0)
        cols = jax.lax.broadcasted_iota(jnp.uint32, (n, m), 1)
        jg = np.asarray(jax_hash_gumbel_at(rows, cols, jnp.uint32(42)))
        tg = auction.hash_gumbel_at(
            torch.arange(n)[:, None], torch.arange(m)[None, :], 42
        )
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0, atol=2e-4)

    def test_mul32_wraps_like_uint32(self):
        v = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 123456789])
        for const in (0x85EBCA6B, 0xC2B2AE35):
            want = [(int(x) * const) & 0xFFFFFFFF for x in v]
            assert auction.mul32(v, const).tolist() == want


class TestKernelParity:
    @pytest.mark.parametrize("seed", [7, 9, 123])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_mask_and_gathered_ids_exact(self, shape, seed):
        p = _pair(shape, seed)
        args, kw = _targs(p)
        mask = cuda_sparse.candidate_mask(*args, **kw)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(p["jmask"]))
        np.testing.assert_array_equal(p["tidx"].numpy(), np.asarray(p["jidx"]))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_rowmin_bitwise(self, shape):
        p = _pair(shape)
        args, kw = _targs(p)
        got = cuda_sparse.masked_row_min(*args, **kw)
        ref = jax_row_min(p["Cj"], p["jkth"], p["jxr"], tau=GATHER_TAU,
                          noised=True, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("shape", SHAPES)
    def test_mask_marginals_exact(self, shape):
        """Flat integrand: the matvec pair counts candidates per row and
        per column, as exact integers on both sides."""
        p = _pair(shape)
        args, kw = _targs(p)
        n, m = shape
        rowmin = cuda_sparse.masked_row_min(*args, **kw)
        jrowmin = jnp.asarray(rowmin.numpy())
        jcommon = (p["Cj"], p["jkth"], p["jxr"], jrowmin)
        jkw = dict(eps=1e30, tau=GATHER_TAU, noised=True, interpret=True)
        rows = cuda_sparse.masked_row_matvec(
            *args, rowmin, torch.ones(m), eps=1e30, **kw)
        cols = cuda_sparse.masked_col_matvec(
            *args, rowmin, torch.ones(n), eps=1e30, **kw)
        np.testing.assert_array_equal(
            rows.numpy(),
            np.asarray(jax_row_matvec(*jcommon, jnp.ones(m), **jkw)),
        )
        np.testing.assert_array_equal(
            cols.numpy(),
            np.asarray(jax_col_matvec(*jcommon, jnp.ones(n), **jkw)),
        )

    @pytest.mark.parametrize("shape", SHAPES)
    def test_matvec_pair(self, shape):
        p = _pair(shape)
        args, kw = _targs(p)
        n, m = shape
        rng = np.random.default_rng(1)
        v = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
        u = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        rowmin = cuda_sparse.masked_row_min(*args, **kw)
        jcommon = (p["Cj"], p["jkth"], p["jxr"], jnp.asarray(rowmin.numpy()))
        jkw = dict(eps=0.05, tau=GATHER_TAU, noised=True, interpret=True)
        r = cuda_sparse.masked_row_matvec(
            *args, rowmin, torch.from_numpy(v), eps=0.05, **kw)
        c = cuda_sparse.masked_col_matvec(
            *args, rowmin, torch.from_numpy(u), eps=0.05, **kw)
        np.testing.assert_allclose(
            r.numpy(), np.asarray(jax_row_matvec(*jcommon, v, **jkw)),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            c.numpy(), np.asarray(jax_col_matvec(*jcommon, u, **jkw)),
            rtol=1e-5, atol=1e-6,
        )

    def test_unnoised_mask_bitwise(self):
        n, m, k = 200, 300, 8
        rng = np.random.default_rng(3)
        Cj = jnp.asarray(
            (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
        ).astype(jnp.bfloat16)
        Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(
            torch.bfloat16
        )
        _, _, _, jmask, jkth = jax_topk(
            Cj, jnp.ones((n, m), bool), k, seed=None, return_thresh=True
        )
        _, _, _, fz = torch_sparse.topk_candidates(
            Ct, torch.ones((n, m), dtype=torch.bool), k, seed=None
        )
        assert not fz.noised
        np.testing.assert_array_equal(fz.thresh.numpy(), np.asarray(jkth))
        got = cuda_sparse.masked_row_min(
            Ct, fz.thresh, fz.x_row, tau=fz.tau, noised=False
        )
        ref = jax_row_min(Cj, jkth, jax_noise_row_state(n, jnp.uint32(0)),
                          tau=0.0, noised=False, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestWrapperRouting:
    @pytest.fixture
    def no_build(self, monkeypatch):
        def refuse(name):
            raise AssertionError(f"kernel library {name} loaded")

        monkeypatch.setattr(_build, "load_library", refuse)
        cuda_sparse.reset_launches()

    def test_cpu_tensors_take_plain_versions(self, no_build):
        p = _pair((64, 96))
        args, kw = _targs(p)
        rowmin = cuda_sparse.masked_row_min(*args, **kw)
        cuda_sparse.masked_row_matvec(*args, rowmin, torch.ones(96),
                                      eps=0.05, **kw)
        cuda_sparse.masked_col_matvec(*args, rowmin, torch.ones(64),
                                      eps=0.05, **kw)
        assert all(v == 0 for v in cuda_sparse.launches.values())

    def test_other_devices_raise_without_plain_fallback(self, no_build):
        n, m = 8, 16
        C = torch.zeros((n, m), dtype=torch.bfloat16, device="meta")
        th = torch.zeros(n, device="meta")
        xr = torch.zeros(n, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            cuda_sparse.masked_row_min(C, th, xr, tau=0.5, noised=True)

    def test_mixed_devices_rejected(self, no_build):
        n, m = 8, 16
        C = torch.zeros((n, m), dtype=torch.bfloat16)
        th = torch.zeros(n, device="meta")
        xr = torch.zeros(n, dtype=torch.int32)
        with pytest.raises(ValueError):
            cuda_sparse.masked_row_min(C, th, xr, tau=0.5, noised=True)

    @pytest.mark.parametrize(
        "bad", ["dtype", "cost_dtype", "shape", "contiguous"]
    )
    def test_kernel_operand_checks(self, bad):
        n, m = 8, 16
        C = torch.zeros((n, m), dtype=torch.bfloat16)
        th = torch.zeros(n)
        xr = torch.zeros(n, dtype=torch.int32)
        if bad == "dtype":
            xr = xr.to(torch.int64)
        elif bad == "cost_dtype":
            C = C.to(torch.float32)    # the kernels take bf16 only
        elif bad == "shape":
            th = torch.zeros(n + 1)
        else:
            C = torch.zeros((m, n), dtype=torch.bfloat16).t()
        with pytest.raises((TypeError, ValueError)):
            cuda_sparse._check_operands(C, th, xr)

    def test_kernel_operand_checks_accept_good_operands(self):
        n, m = 8, 16
        got = cuda_sparse._check_operands(
            torch.zeros((n, m), dtype=torch.bfloat16), torch.zeros(n),
            torch.zeros(n, dtype=torch.int32),
            rows=[("u", torch.zeros(n))], cols=[("v", torch.zeros(m))],
        )
        assert got == (n, m)
