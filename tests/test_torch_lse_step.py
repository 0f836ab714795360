"""The port's fused dense Sinkhorn step (``cuda_lse.lse_sinkhorn_step``)
and the dense ``sinkhorn`` that routes through it, on the CPU.

- The step against one iteration of the JAX reference's body: the XLA
  ``sinkhorn._row_lse`` then ``_col_lse``, and ``pallas_lse.row_lse`` then
  ``col_lse`` in interpret mode, with ``test_torch_lse.py``'s gates
  (atol 1e-4 / rtol 1e-5 on f and on the column LSE).
- The CPU ``sinkhorn`` against the unfused loop it replaced (the row and
  column LSE back to back, written out below): f, g, ``row_err`` and the
  iteration count bit for bit, fixed and gated, cold and warm, at widths
  that take the fused step and one that does not. The plain versions
  still divide by eps, so the CPU path computes what it did before.
- The step's width limit, operand checks and routing: CPU tensors never
  reach CUDA code, and tensors on other devices raise instead of running
  the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.ops import pallas_lse
from modelmesh_tpu.ops.sinkhorn import _col_lse, _row_lse
from modelmesh_tpu_torch.ops import _build, cuda_lse
from modelmesh_tpu_torch.ops.sinkhorn import run_sinkhorn, sinkhorn

EPS = 0.05
TOL = dict(atol=1e-4, rtol=1e-5)
# test_torch_lse.py's shapes, then the dense tier's narrow padded widths
# and the widest C the fused step takes.
SHAPES = [(300, 200), (256, 512), (17, 33), (1024, 96), (300, 1000),
          (300, 64), (300, 96), (1000, 128), (64, 1024)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and
    PyTorch's default of one thread per core would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed=0):
    """C (bf16, passed through exact f32), g and log_a on both sides."""
    n, m = shape
    rng = np.random.default_rng(seed)
    c32 = rng.standard_normal((n, m)).astype(np.float32)
    Cj = jnp.asarray(c32).astype(jnp.bfloat16)
    Ct = torch.from_numpy(np.array(Cj.astype(jnp.float32))).to(torch.bfloat16)
    g = np.minimum(rng.standard_normal(m), 0.0).astype(np.float32)
    log_a = np.log(rng.random(n) * 4 + 0.5).astype(np.float32)
    return Cj, Ct, g, log_a


@pytest.mark.parametrize("shape", SHAPES)
def test_step_matches_reference_iteration(shape):
    Cj, Ct, g, log_a = _inputs(shape)
    f, m, s = cuda_lse.lse_sinkhorn_step(
        Ct, torch.from_numpy(g), torch.from_numpy(log_a), EPS)
    col = cuda_lse.lse_of(m, s).numpy()
    gj, laj = jnp.asarray(g), jnp.asarray(log_a)
    f_xla = EPS * (laj - _row_lse(Cj, gj, EPS))
    f_pal = EPS * (laj - pallas_lse.row_lse(Cj, gj, EPS, interpret=True))
    for f_ref, col_ref in (
        (f_xla, _col_lse(Cj, f_xla, EPS)),
        (f_pal, pallas_lse.col_lse(Cj, f_pal, EPS, interpret=True)),
    ):
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)
        np.testing.assert_allclose(col, np.asarray(col_ref), **TOL)


@pytest.mark.parametrize("shape", [(300, 96), (17, 33)])
def test_step_is_the_two_plain_calls(shape):
    """The plain step is the row partial, f, then the column partial of
    that f: bit for bit."""
    _, Ct, g, log_a = _inputs(shape, seed=2)
    g, log_a = torch.from_numpy(g), torch.from_numpy(log_a)
    f, m, s = cuda_lse.lse_sinkhorn_step(Ct, g, log_a, EPS)
    f_ref = EPS * (log_a - cuda_lse.row_lse(Ct, g, EPS))
    m_ref, s_ref = cuda_lse.col_lse_partial(Ct, f_ref, EPS)
    assert torch.equal(f, f_ref)
    assert torch.equal(m, m_ref) and torch.equal(s, s_ref)


def _two_call_sinkhorn(C, row_mass, col_mass, *, eps, iters, g0=None,
                       tol=0.0, chunk=4):
    """The dense Sinkhorn as it ran before the fused step: each iteration
    the row LSE, then the column LSE of the new f."""
    row_mass = row_mass.to(torch.float32)
    col_mass = col_mass.to(torch.float32)
    log_a = torch.log(torch.clamp_min(row_mass, 1e-30))
    log_b = torch.log(torch.clamp_min(col_mass, 1e-30))

    def run_iters(f, g, length):
        for _ in range(length):
            f = eps * (log_a - cuda_lse.row_lse(C, g, eps))
            g = torch.clamp_max(
                eps * (log_b - cuda_lse.col_lse(C, f, eps)), 0.0
            )
        return f, g

    def marginal_err(f, g):
        row_sum = torch.exp((f + eps * cuda_lse.row_lse(C, g, eps)) / eps)
        return (row_sum - row_mass).abs().mean() / torch.clamp_min(
            row_mass.mean(), 1e-30
        )

    return run_sinkhorn(run_iters, marginal_err, C.shape[0], g0, log_b,
                        eps=eps, iters=iters, tol=tol, chunk=chunk)


@pytest.mark.parametrize("shape", [(96, 48), (200, 128), (40, 1100)],
                         ids=["fused_48", "fused_128", "wide_1100"])
@pytest.mark.parametrize("gate", [0.0, 0.02], ids=["fixed", "gated"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_cpu_sinkhorn_bitwise_unchanged(shape, gate, warm, dtype):
    n, m = shape
    rng = np.random.default_rng(5)
    C = torch.from_numpy(
        (rng.random((n, m)) * 2).astype(np.float32)).to(dtype)
    row_mass = torch.from_numpy((rng.random(n) + 0.5).astype(np.float32))
    col_mass = torch.full((m,), 1.3 * float(row_mass.sum()) / m)
    g0 = (torch.from_numpy(-rng.random(m).astype(np.float32) * 0.1)
          if warm else None)
    kw = dict(eps=EPS, iters=9, g0=g0, tol=gate, chunk=3)
    got = sinkhorn(C, row_mass, col_mass, **kw)
    want = _two_call_sinkhorn(C, row_mass, col_mass, **kw)
    assert torch.equal(got.f, want.f)
    assert torch.equal(got.g, want.g)
    assert torch.equal(got.row_err, want.row_err)
    assert got.iters_run == want.iters_run


def test_step_rejects_wide_cost():
    C = torch.zeros((8, cuda_lse.FUSED_MAX_COLS + 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 1024 columns"):
        cuda_lse.lse_sinkhorn_step(C, torch.zeros(C.shape[1]),
                                   torch.zeros(8), EPS)


class TestStepRouting:
    @pytest.fixture
    def no_build(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("CUDA code reached on CPU tensors")

        monkeypatch.setattr(_build, "load_library", refuse)
        monkeypatch.setattr(_build, "build_all", refuse)
        monkeypatch.setattr(torch.cuda, "current_stream", refuse)
        cuda_lse.reset_launches()

    def test_cpu_step_never_builds(self, no_build):
        _, Ct, g, log_a = _inputs((64, 128))
        f, m, s = cuda_lse.lse_sinkhorn_step(
            Ct, torch.from_numpy(g), torch.from_numpy(log_a), EPS)
        assert f.shape == (64,) and m.shape == s.shape == (128,)
        assert all(v == 0 for v in cuda_lse.launches.values())

    def test_cpu_sinkhorn_takes_the_step_without_building(self, no_build):
        _, Ct, _, _ = _inputs((96, 64))
        res = sinkhorn(Ct, torch.rand(96) + 0.5, torch.full((64,), 4.0),
                       iters=3, tol=0.02)
        assert torch.isfinite(res.f).all() and torch.isfinite(res.g).all()
        assert all(v == 0 for v in cuda_lse.launches.values())

    def test_other_devices_raise_without_plain_fallback(self, no_build):
        C = torch.zeros((8, 16), dtype=torch.bfloat16, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            cuda_lse.lse_sinkhorn_step(C, torch.zeros(16, device="meta"),
                                       torch.zeros(8, device="meta"), EPS)
        assert cuda_lse.launches["lse_sinkhorn_step"] == 0

    @pytest.mark.parametrize("shift_device", ["meta", "cpu"])
    def test_mixed_devices_rejected(self, no_build, shift_device):
        on_meta = shift_device == "meta"
        C = torch.zeros((8, 16), dtype=torch.bfloat16,
                        device="cpu" if on_meta else "meta")
        with pytest.raises(ValueError):
            cuda_lse.lse_sinkhorn_step(
                C, torch.zeros(16, device=shift_device),
                torch.zeros(8, device=C.device), EPS)

    @pytest.mark.parametrize("bad", ["g_len", "g_dtype", "log_a_len",
                                     "log_a_dtype", "cost_rank"])
    def test_operand_checks(self, no_build, bad):
        C = torch.zeros((8, 16), dtype=torch.bfloat16)
        g, log_a = torch.zeros(16), torch.zeros(8)
        if bad == "g_len":
            g = torch.zeros(8)
        elif bad == "g_dtype":
            g = g.to(torch.float64)
        elif bad == "log_a_len":
            log_a = torch.zeros(16)
        elif bad == "log_a_dtype":
            log_a = log_a.to(torch.float16)
        else:
            C = torch.zeros(16, dtype=torch.bfloat16)
        with pytest.raises(TypeError):
            cuda_lse.lse_sinkhorn_step(C, g, log_a, EPS)


def test_inv_eps_is_the_f32_reciprocal():
    """The kernels' scale: 1 / eps rounded once in f32, the value
    PyTorch's CUDA division by a scalar multiplies by."""
    for eps in (0.05, 0.1, 0.003, 1e30):
        want = np.float32(1) / np.float32(eps)
        assert np.float32(cuda_lse.inv_eps_of(eps)) == want
        assert float(np.float32(cuda_lse.inv_eps_of(eps))) == \
            cuda_lse.inv_eps_of(eps)
