"""The port's fused LSE kernels (modelmesh_tpu_torch/ops/cuda_lse.py) held
against the JAX package's Pallas kernels (ops/pallas_lse.py, in interpret
mode) and its XLA ``sinkhorn._row_lse``/``_col_lse`` on the CPU.

Same numpy-seeded inputs on both sides; gates are the reference tests'
(tests/test_pallas_lse.py): atol 1e-4 / rtol 1e-5 on the LSE and on the
partials' running max, rtol 1e-5 on the extreme-value case. The raw
rescaled sums are compared through the recombined LSE, since a 1-ulp
difference in the max (Pallas multiplies by 1/eps, the port divides)
rescales them. The CUDA kernels themselves need a card; the wrappers take
their plain versions only for CPU tensors, which the last tests pin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops import pallas_lse
from modelmesh_tpu.ops.sinkhorn import _col_lse, _row_lse
from modelmesh_tpu_torch.ops import _build, cuda_lse
from modelmesh_tpu_torch.ops.sinkhorn import resolve_lse_impl, sinkhorn

# The reference tests' shapes (ragged, tile-aligned, tiny, tall, wide).
SHAPES = [(300, 200), (256, 512), (17, 33), (1024, 96), (300, 1000)]
EPS = 0.05
TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed=0, scale=1.0):
    """C (bf16, passed through exact f32), g and f on both sides."""
    n, m = shape
    rng = np.random.default_rng(seed)
    c32 = (rng.standard_normal((n, m)) * scale).astype(np.float32)
    Cj = jnp.asarray(c32).astype(jnp.bfloat16)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(torch.bfloat16)
    g = (rng.standard_normal(m) * scale).astype(np.float32)
    f = (rng.standard_normal(n) * scale).astype(np.float32)
    return Cj, Ct, g, f


def _lse(m, s):
    return np.log(np.maximum(np.asarray(s), 1e-30)) + np.asarray(m)


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_matches_pallas_and_xla(shape):
    Cj, Ct, g, f = _inputs(shape)
    row = cuda_lse.row_lse(Ct, torch.from_numpy(g), EPS).numpy()
    col = cuda_lse.col_lse(Ct, torch.from_numpy(f), EPS).numpy()
    gj, fj = jnp.asarray(g), jnp.asarray(f)
    np.testing.assert_allclose(
        row, np.asarray(pallas_lse.row_lse(Cj, gj, EPS, interpret=True)),
        **TOL)
    np.testing.assert_allclose(
        col, np.asarray(pallas_lse.col_lse(Cj, fj, EPS, interpret=True)),
        **TOL)
    np.testing.assert_allclose(row, np.asarray(_row_lse(Cj, gj, EPS)), **TOL)
    np.testing.assert_allclose(col, np.asarray(_col_lse(Cj, fj, EPS)), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_partials_match_pallas(shape):
    Cj, Ct, g, f = _inputs(shape, seed=1)
    for ours, theirs, shift in (
        (cuda_lse.row_lse_partial, pallas_lse.row_lse_partial, g),
        (cuda_lse.col_lse_partial, pallas_lse.col_lse_partial, f),
    ):
        m, s = ours(Ct, torch.from_numpy(shift), EPS)
        jm, js = theirs(Cj, jnp.asarray(shift), EPS, interpret=True)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(_lse(m, s), _lse(jm, js), **TOL)


def test_extreme_values_stable():
    """Online LSE survives large shifts (C and g scaled by 30, so |z| is
    of order 10^3)."""
    Cj, Ct, g, _ = _inputs((64, 128), seed=3, scale=30.0)
    out = cuda_lse.row_lse(Ct, torch.from_numpy(g), EPS).numpy()
    ref = np.asarray(_row_lse(Cj, jnp.asarray(g), EPS))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def _combine(a, b):
    """Partials over disjoint slices -> the partial over their union."""
    (m1, s1), (m2, s2) = a, b
    mx = torch.maximum(m1, m2)
    return mx, s1 * torch.exp(m1 - mx) + s2 * torch.exp(m2 - mx)


def test_split_and_combine_identity():
    """Two halves of the reduced axis, combined by the max/rescale rule,
    give the whole (the sharded solver's combine)."""
    _, Ct, g, f = _inputs((300, 200), seed=4)
    g, f = torch.from_numpy(g), torch.from_numpy(f)
    whole = cuda_lse.row_lse_partial(Ct, g, EPS)
    halves = _combine(cuda_lse.row_lse_partial(Ct[:, :77].contiguous(),
                                               g[:77], EPS),
                      cuda_lse.row_lse_partial(Ct[:, 77:].contiguous(),
                                               g[77:], EPS))
    np.testing.assert_allclose(_lse(*halves), _lse(*whole), **TOL)
    whole = cuda_lse.col_lse_partial(Ct, f, EPS)
    halves = _combine(cuda_lse.col_lse_partial(Ct[:123], f[:123], EPS),
                      cuda_lse.col_lse_partial(Ct[123:], f[123:], EPS))
    np.testing.assert_allclose(_lse(*halves), _lse(*whole), **TOL)


def test_resolve_lse_impl():
    assert resolve_lse_impl("auto", torch.device("cpu")) == "plain"
    assert resolve_lse_impl("auto", torch.device("cuda")) == "cuda"
    assert resolve_lse_impl("cuda", torch.device("cuda")) == "cuda"
    for ref_value in ("xla", "pallas"):
        with pytest.raises(ValueError, match="expected auto | cuda"):
            resolve_lse_impl(ref_value, torch.device("cpu"))


@pytest.mark.parametrize("impl,err", [
    ("cuda", "CUDA device"), ("xla", "lse_impl"), ("pallas", "lse_impl"),
])
def test_sinkhorn_rejects_impl_on_cpu(impl, err):
    _, Ct, _, _ = _inputs((32, 16))
    with pytest.raises(ValueError, match=err):
        sinkhorn(Ct, torch.ones(32), torch.ones(16), iters=2, lse_impl=impl)


class TestWrapperRouting:
    @pytest.fixture
    def no_build(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("CUDA code reached on CPU tensors")

        monkeypatch.setattr(_build, "load_library", refuse)
        monkeypatch.setattr(_build, "build_all", refuse)
        monkeypatch.setattr(torch.cuda, "current_stream", refuse)
        cuda_lse.reset_launches()

    def test_cpu_sinkhorn_never_builds(self, no_build):
        _, Ct, _, _ = _inputs((96, 48))
        res = sinkhorn(Ct, torch.rand(96) + 0.5, torch.full((48,), 4.0),
                       iters=3, tol=0.02)
        assert torch.isfinite(res.g).all()
        assert all(v == 0 for v in cuda_lse.launches.values())

    def test_other_devices_raise_without_plain_fallback(self, no_build):
        C = torch.zeros((8, 16), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            cuda_lse.row_lse_partial(C, torch.zeros(16, device="meta"), EPS)
        with pytest.raises(ValueError, match="no kernel"):
            cuda_lse.col_lse_partial(C, torch.zeros(8, device="meta"), EPS)

    def test_mixed_devices_rejected(self, no_build):
        C = torch.zeros((8, 16), dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            cuda_lse.row_lse_partial(C, torch.zeros(16, device="meta"), EPS)

    @pytest.mark.parametrize("bad", ["shift_dtype", "cost_dtype", "shape",
                                     "contiguous"])
    def test_kernel_operand_checks(self, bad):
        C = torch.zeros((8, 16), dtype=torch.bfloat16)
        g = torch.zeros(16)
        if bad == "shift_dtype":
            g = g.to(torch.float64)
        elif bad == "cost_dtype":
            C = C.to(torch.float32)    # the kernels take bf16 only
        elif bad == "shape":
            g = torch.zeros(8)
        else:
            C = torch.zeros((16, 8), dtype=torch.bfloat16).t()
        with pytest.raises((TypeError, ValueError)):
            _build.check_operands(C, cols=[("g", g, torch.float32)])
