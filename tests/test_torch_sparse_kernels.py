"""The port's sparse kernels (modelmesh_tpu_torch/ops/cuda_sparse.py) held
against the JAX package's Pallas kernels (ops/pallas_sparse.py, in
interpret mode) on the CPU.

Each side derives its own row thresholds through its own top-K gather from
the same cost matrix and seed, so the whole chain is compared: the hash
bits, the selection key, the candidate mask and gathered ids (exact), the
packed mask bits (they unpack to the reference's mask exactly), the masked
row minimum (bitwise — an f32 min carries no rounding), the
flat-integrand candidate counts of the row, column and fused products
(exact integers) and the products themselves (rtol 1e-5 / atol 1e-6:
XLA-CPU and torch-CPU round exp/log differently and sum in another order).
The CUDA kernels themselves need a card; the wrappers take their plain
versions only for CPU tensors, which the last tests pin.
"""

import functools

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
# The kernel cases: every shape with the noised mask, a width that is not
# a multiple of 32 or 8 under the fused limit, an odd width past two of the
# column kernels' 1024-column slabs, and the unnoised mask.
CASES = (
    [pytest.param(shape, True, id=f"shape{i}") for i, shape in enumerate(SHAPES)]
    + [pytest.param((48, 1001), True, id="odd_width"),
       pytest.param((40, 2049), True, id="three_slabs"),
       pytest.param((200, 300), False, id="unnoised")]
)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(shape, seed=7, k=K, noised=True):
    """One cost matrix on both sides (bf16 through exact f32) and each
    side's own top-K gather from it (``noised=False``: no selection
    noise). Cached: the tests only read it."""
    n, m = shape
    rng = np.random.default_rng(seed)
    c32 = (rng.standard_normal((n, m)) * 3.0).astype(np.float32)
    Cj = jnp.asarray(c32).astype(jnp.bfloat16)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(
        torch.bfloat16
    )
    s = jnp.asarray(seed, jnp.uint32) if noised else None
    _, jidx, _, jmask, jkth = jax_topk(
        Cj, jnp.ones((n, m), bool), k, seed=s, return_thresh=True
    )
    jxr = jax_noise_row_state(
        n, s ^ jnp.uint32(_GATHER_SALT) if noised else jnp.uint32(0)
    )
    _, tidx, _, fz = torch_sparse.topk_candidates(
        Ct, torch.ones((n, m), dtype=torch.bool), k,
        seed=seed if noised else None,
    )
    jmask_kw = dict(tau=GATHER_TAU if noised else 0.0, noised=noised)
    return dict(Cj=Cj, jidx=jidx, jmask=jmask, jkth=jkth, jxr=jxr,
                jmask_kw=jmask_kw, Ct=Ct, tidx=tidx, fz=fz)


def _targs(p):
    fz = p["fz"]
    return (p["Ct"], fz.thresh, fz.x_row), dict(tau=fz.tau, noised=fz.noised)


def _jref(p, rowmin, eps):
    """The reference's (row, column) products over its own mask, as
    numpy-in, numpy-out callables."""
    common = (p["Cj"], p["jkth"], p["jxr"], jnp.asarray(rowmin.numpy()))
    kw = dict(eps=eps, interpret=True, **p["jmask_kw"])
    return (lambda v: np.asarray(jax_row_matvec(*common, v, **kw)),
            lambda u: np.asarray(jax_col_matvec(*common, u, **kw)))


def _fused_ref(row, col, v, row_mass):
    """The reference's row product -> clamp -> divide -> column product."""
    r = np.maximum(row(v), np.float32(1e-30))
    return r, col((row_mass / r).astype(np.float32))


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


class TestPacking:
    @pytest.mark.parametrize("m", [1, 31, 32, 33, 200, 1001])
    def test_pack_unpack_round_trip(self, m):
        """Bit j of word w is column 32 w + j (bit 31 is the int32 sign
        bit), and the bits past M are zero."""
        rng = np.random.default_rng(m)
        mask = torch.from_numpy(rng.random((5, m)) < 0.4)
        bits = cuda_sparse.pack_mask(mask)
        assert bits.dtype == torch.int32
        assert bits.shape == (5, cuda_sparse.mask_words(m))
        assert torch.equal(cuda_sparse.unpack_mask(bits, m), mask)
        u32 = bits.numpy().astype(np.int64) & 0xFFFFFFFF
        for n, col in zip(*np.nonzero(mask.numpy())):
            assert (u32[n, col // 32] >> (col % 32)) & 1
        assert u32.sum() == sum(
            1 << (col % 32) for _, col in zip(*np.nonzero(mask.numpy()))
        )


class TestKernelParity:
    @pytest.mark.parametrize("seed", [7, 9, 123])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_mask_and_gathered_ids_exact(self, shape, seed):
        p = _pair(shape, seed)
        args, kw = _targs(p)
        mask = cuda_sparse.candidate_mask(*args, **kw)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(p["jmask"]))
        np.testing.assert_array_equal(p["tidx"].numpy(), np.asarray(p["jidx"]))

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_rowmin_bitwise(self, shape, noised):
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        got = cuda_sparse.masked_row_min(*args, **kw).rowmin
        ref = jax_row_min(p["Cj"], p["jkth"], p["jxr"], interpret=True,
                          **p["jmask_kw"])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_bits_unpack_to_reference_mask(self, shape, noised):
        """masked_row_min's bits are the plain packing of the candidate
        mask, and unpack to the reference's mask bit for bit."""
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        bits = cuda_sparse.masked_row_min(*args, **kw).bits
        assert torch.equal(
            bits, cuda_sparse.pack_mask(cuda_sparse.candidate_mask(*args, **kw))
        )
        np.testing.assert_array_equal(
            cuda_sparse.unpack_mask(bits, shape[1]).numpy(),
            np.asarray(p["jmask"]),
        )

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_mask_marginals_exact(self, shape, noised):
        """Flat integrand (eps = 1e30 makes every in-mask term 1.0f): the
        row, column and fused products count candidates per row and per
        column, as exact integers on both sides. The fused step's row mass
        is the row counts, so u = 1 and its column product counts too."""
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        n, m = shape
        rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
        jrow, jcol = _jref(p, rowmin, 1e30)
        want_rows = jrow(np.ones(m, np.float32))
        want_cols = jcol(np.ones(n, np.float32))
        flat = (p["Ct"], bits, rowmin)
        rows = cuda_sparse.masked_row_matvec(*flat, torch.ones(m), eps=1e30)
        cols = cuda_sparse.masked_col_matvec(*flat, torch.ones(n), eps=1e30)
        np.testing.assert_array_equal(rows.numpy(), want_rows)
        np.testing.assert_array_equal(cols.numpy(), want_cols)
        if m > cuda_sparse.FUSED_MAX_COLS:
            with pytest.raises(ValueError, match="at most"):
                cuda_sparse.masked_sinkhorn_step(
                    *flat, torch.ones(m), rows, eps=1e30)
            return
        r, c = cuda_sparse.masked_sinkhorn_step(
            *flat, torch.ones(m), rows, eps=1e30)
        np.testing.assert_array_equal(r.numpy(), want_rows)
        np.testing.assert_array_equal(c.numpy(), want_cols)

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_matvec_pair(self, shape, noised):
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        n, m = shape
        rng = np.random.default_rng(1)
        v = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
        u = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
        rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
        jrow, jcol = _jref(p, rowmin, 0.05)
        r = cuda_sparse.masked_row_matvec(
            p["Ct"], bits, rowmin, torch.from_numpy(v), eps=0.05)
        c = cuda_sparse.masked_col_matvec(
            p["Ct"], bits, rowmin, torch.from_numpy(u), eps=0.05)
        np.testing.assert_allclose(r.numpy(), jrow(v), **TOL)
        np.testing.assert_allclose(c.numpy(), jcol(u), **TOL)

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_fused_step_matches_reference(self, shape, noised):
        """One fused step against the reference's row product, clamp,
        division and column product; wider than FUSED_MAX_COLS the step
        refuses (the solve runs the pair there)."""
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        n, m = shape
        rng = np.random.default_rng(2)
        v = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
        a = (np.abs(rng.standard_normal(n)) * 8 + 1).astype(np.float32)
        rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
        step = functools.partial(
            cuda_sparse.masked_sinkhorn_step, p["Ct"], bits, rowmin,
            torch.from_numpy(v), torch.from_numpy(a), eps=0.05,
        )
        if m > cuda_sparse.FUSED_MAX_COLS:
            with pytest.raises(ValueError, match="at most"):
                step()
            return
        r, c = step()
        r_ref, c_ref = _fused_ref(*_jref(p, rowmin, 0.05), v, a)
        np.testing.assert_allclose(r.numpy(), r_ref, **TOL)
        np.testing.assert_allclose(c.numpy(), c_ref, **TOL)

    @pytest.mark.parametrize("shape,noised", CASES)
    def test_fused_step_is_the_composition(self, shape, noised):
        """On the CPU the fused step is, bit for bit, the row product, the
        clamp to 1e-30, the division and the column product."""
        p = _pair(shape, noised=noised)
        args, kw = _targs(p)
        n, m = shape
        m_fused = min(m, cuda_sparse.FUSED_MAX_COLS)
        rng = np.random.default_rng(3)
        # Wider than the fused limit, C is cut to it (the thresholds stay
        # the full rows', so a row may keep no candidate: the clamp).
        C = p["Ct"][:, :m_fused].contiguous()
        rowmin, bits = cuda_sparse.masked_row_min(
            C, p["fz"].thresh, p["fz"].x_row, **kw)
        v = torch.from_numpy(rng.random(m_fused).astype(np.float32) + 0.1)
        a = torch.from_numpy(rng.random(n).astype(np.float32) * 4 + 0.5)
        r_want = torch.clamp_min(
            cuda_sparse.masked_row_matvec(C, bits, rowmin, v, eps=0.05),
            cuda_sparse.TINY,
        )
        c_want = cuda_sparse.masked_col_matvec(
            C, bits, rowmin, a / r_want, eps=0.05)
        r, c = cuda_sparse.masked_sinkhorn_step(
            C, bits, rowmin, v, a, eps=0.05)
        assert torch.equal(r, r_want)
        assert torch.equal(c, c_want)

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
        got, bits = cuda_sparse.masked_row_min(
            Ct, fz.thresh, fz.x_row, tau=fz.tau, noised=False
        )
        ref = jax_row_min(Cj, jkth, jax_noise_row_state(n, jnp.uint32(0)),
                          tau=0.0, noised=False, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            cuda_sparse.unpack_mask(bits, m).numpy(), np.asarray(jmask))


def _operands(device, n=8, m=16):
    """Zero operands of every wrapper on ``device``."""
    return dict(
        C=torch.zeros((n, m), dtype=torch.bfloat16, device=device),
        thresh=torch.zeros(n, device=device),
        x_row=torch.zeros(n, dtype=torch.int32, device=device),
        bits=torch.zeros((n, cuda_sparse.mask_words(m)), dtype=torch.int32,
                         device=device),
        rowmin=torch.zeros(n, device=device),
        v=torch.ones(m, device=device),
        u=torch.ones(n, device=device),
        row_mass=torch.ones(n, device=device),
    )


# Each wrapper called on a dict of operands (``_operands``).
WRAPPERS = {
    "select_candidates": lambda o: cuda_sparse.select_candidates(
        o["C"], o["x_row"], 4, tau=0.5, noised=True),
    "masked_row_min": lambda o: cuda_sparse.masked_row_min(
        o["C"], o["thresh"], o["x_row"], tau=0.5, noised=True),
    "masked_row_matvec": lambda o: cuda_sparse.masked_row_matvec(
        o["C"], o["bits"], o["rowmin"], o["v"], eps=0.05),
    "masked_col_matvec": lambda o: cuda_sparse.masked_col_matvec(
        o["C"], o["bits"], o["rowmin"], o["u"], eps=0.05),
    "masked_sinkhorn_step": lambda o: cuda_sparse.masked_sinkhorn_step(
        o["C"], o["bits"], o["rowmin"], o["v"], o["row_mass"], eps=0.05),
}
BITS_WRAPPERS = [name for name in WRAPPERS
                 if name not in ("masked_row_min", "select_candidates")]


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
        rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
        flat = (p["Ct"], bits, rowmin)
        cuda_sparse.masked_row_matvec(*flat, torch.ones(96), eps=0.05)
        cuda_sparse.masked_col_matvec(*flat, torch.ones(64), eps=0.05)
        cuda_sparse.masked_sinkhorn_step(*flat, torch.ones(96),
                                         torch.ones(64), eps=0.05)
        assert set(cuda_sparse.launches) == set(WRAPPERS)
        assert all(v == 0 for v in cuda_sparse.launches.values())

    def test_other_devices_raise_without_plain_fallback(self, no_build):
        with pytest.raises(ValueError, match="no kernel"):
            WRAPPERS["masked_row_min"](_operands("meta"))

    @pytest.mark.parametrize("wrapper", BITS_WRAPPERS)
    def test_bit_wrappers_raise_without_plain_fallback(self, no_build,
                                                       wrapper):
        with pytest.raises(ValueError, match="no kernel"):
            WRAPPERS[wrapper](_operands("meta"))

    def test_mixed_devices_rejected(self, no_build):
        ops = _operands("cpu")
        ops["thresh"] = ops["thresh"].to("meta")
        with pytest.raises(ValueError):
            WRAPPERS["masked_row_min"](ops)

    @pytest.mark.parametrize("wrapper,operand", [
        ("masked_row_matvec", "bits"),
        ("masked_col_matvec", "u"),
        ("masked_sinkhorn_step", "row_mass"),
    ])
    def test_bit_wrappers_reject_mixed_devices(self, no_build, wrapper,
                                               operand):
        ops = _operands("cpu")
        ops[operand] = ops[operand].to("meta")
        with pytest.raises(ValueError):
            WRAPPERS[wrapper](ops)

    @pytest.mark.parametrize("wrapper", BITS_WRAPPERS)
    @pytest.mark.parametrize("bad", ["dtype", "width"])
    def test_plain_versions_reject_malformed_bits(self, no_build, wrapper,
                                                  bad):
        ops = _operands("cpu")
        if bad == "dtype":
            ops["bits"] = ops["bits"].to(torch.int64)
        else:
            ops["bits"] = torch.zeros((8, 2), dtype=torch.int32)
        with pytest.raises(TypeError, match="bits must be"):
            WRAPPERS[wrapper](ops)

    @pytest.mark.parametrize(
        "bad", ["dtype", "cost_dtype", "shape", "contiguous", "bits_dtype",
                "bits_width", "bits_contiguous"]
    )
    def test_kernel_operand_checks(self, bad):
        n, m = 8, 40
        C = torch.zeros((n, m), dtype=torch.bfloat16)
        th = torch.zeros(n)
        xr = torch.zeros(n, dtype=torch.int32)
        bits = torch.zeros((n, 2), dtype=torch.int32)
        if bad == "dtype":
            xr = xr.to(torch.int64)
        elif bad == "cost_dtype":
            C = C.to(torch.float32)    # the kernels take bf16 only
        elif bad == "shape":
            th = torch.zeros(n + 1)
        elif bad == "contiguous":
            C = torch.zeros((m, n), dtype=torch.bfloat16).t()
        elif bad == "bits_dtype":
            bits = bits.to(torch.uint8)
        elif bad == "bits_width":
            bits = torch.zeros((n, 1), dtype=torch.int32)  # 40 cols: 2 words
        else:
            bits = torch.zeros((2, n), dtype=torch.int32).t()
        with pytest.raises((TypeError, ValueError)):
            cuda_sparse._check_operands(
                C, rows=[("thresh", th, torch.float32),
                         ("x_row", xr, torch.int32)], bits=bits,
            )

    def test_kernel_operand_checks_accept_good_operands(self):
        n, m = 8, 16
        got = cuda_sparse._check_operands(
            torch.zeros((n, m), dtype=torch.bfloat16),
            rows=[("u", torch.zeros(n), torch.float32)],
            cols=[("v", torch.zeros(m), torch.float32)],
            bits=torch.zeros((n, 1), dtype=torch.int32),
        )
        assert got == (n, m)

    def test_fused_step_refuses_wide_rows(self, no_build):
        """The shape rule: wider than FUSED_MAX_COLS a warp cannot hold a
        row, on the CPU as on the card."""
        ops = _operands("cpu", m=cuda_sparse.FUSED_MAX_COLS + 8)
        with pytest.raises(ValueError, match="at most"):
            WRAPPERS["masked_sinkhorn_step"](ops)
