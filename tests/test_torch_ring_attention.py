"""The port's ring attention (``modelmesh_tpu_torch/parallel/ring_attention.py``)
on a mesh of 8 "cpu" shards, against its own oracle and the JAX package's
ring on the 8 virtual CPU devices.

- ``tests/test_ring_attention.py``'s cases on the port: causal and not
  (against ``reference_attention`` at 2e-5), bf16 inputs (3e-2, bf16
  out), causality, a long sequence (5e-5), and an indivisible or wrong
  ``seq_len`` refused.
- Each case also against the reference's ring on the same inputs (made
  from a numpy seed; bf16 by the same round-to-nearest-even cast): f32 at
  2e-5, bf16 at 3e-2, the long sequence at 5e-5.
- ``reference_attention`` against the reference's, and the ring's
  2·(n−1) ``ppermute``s a call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.parallel import ring_attention as jra
from modelmesh_tpu_torch.parallel import ring_attention as tra

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return tra.make_seq_mesh(["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def jax_mesh():
    return jra.make_seq_mesh()


def _qkv(seed, b=2, h=4, s=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference(mesh, jax_mesh, causal):
    x = _qkv(0)
    ring = tra.make_ring_attention(mesh, 64, causal=causal)
    mesh.collectives.clear()
    out = ring(*_torch(x))
    assert mesh.collectives == {"ppermute": 2 * (N_DEV - 1)}
    assert out.dtype == torch.float32 and out.shape == (2, 4, 64, 16)
    _close(out, tra.reference_attention(*_torch(x), causal=causal), 2e-5)
    jring = jra.make_ring_attention(jax_mesh, 64, causal=causal)
    _close(out, jring(*_jax(x)), 2e-5)


def test_bf16_inputs(mesh, jax_mesh):
    x = _qkv(1)
    ring = tra.make_ring_attention(mesh, 64, causal=True)
    out = ring(*_torch(x, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    _close(out, tra.reference_attention(*_torch(x, torch.bfloat16)), 3e-2)
    jring = jra.make_ring_attention(jax_mesh, 64, causal=True)
    _close(out, jring(*_jax(x, jnp.bfloat16)), 3e-2)


def test_causality(mesh, jax_mesh):
    """Perturbing a late key must not change early outputs; perturbing it
    changes late outputs (as the reference's ring, on the same inputs)."""
    q, k, v = _qkv(2)
    ring = tra.make_ring_attention(mesh, 64, causal=True)
    base = ring(*_torch([q, k, v])).numpy()
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 60, :] += 5.0
    v2[:, :, 60, :] += 5.0
    out2 = ring(*_torch([q, k2, v2])).numpy()
    np.testing.assert_array_equal(base[:, :, :60], out2[:, :, :60])
    assert np.abs(base[:, :, 60:] - out2[:, :, 60:]).max() > 1e-4
    jring = jra.make_ring_attention(jax_mesh, 64, causal=True)
    _close(out2, jring(*_jax([q, k2, v2])), 2e-5)


def test_long_sequence_sharded(mesh, jax_mesh):
    """Per-shard block seq / 8 = 64: multi-rotation accumulation."""
    s = 512
    x = _qkv(3, b=1, h=2, s=s, d=8)
    ring = tra.make_ring_attention(mesh, s, causal=True)
    out = ring(*_torch(x))
    _close(out, tra.reference_attention(*_torch(x)), 5e-5)
    jring = jra.make_ring_attention(jax_mesh, s, causal=True)
    _close(out, jring(*_jax(x)), 5e-5)


def test_indivisible_seq_rejected(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        tra.make_ring_attention(mesh, 30)


def test_wrong_seq_len_rejected_at_boundary(mesh):
    ring = tra.make_ring_attention(mesh, 64)
    mesh.collectives.clear()
    with pytest.raises(ValueError, match="built for seq_len"):
        ring(*_torch(_qkv(4, s=128)))
    assert mesh.collectives == {}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_reference_attention_matches_reference(causal, bf16):
    x = _qkv(5, s=48)
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    got = tra.reference_attention(*_torch(x, tdt), causal=causal)
    want = jra.reference_attention(*_jax(x, jdt), causal=causal)
    assert got.dtype == tdt
    _close(got, want, 3e-2 if bf16 else 2e-5)


def test_fully_masked_rows_give_zeros_not_nans():
    """A row that sees no key (a causal mask shifted past it) ends at
    0 / max(0, 1e-30) = 0, as the reference's clamp gives."""
    q, k, v = _torch(_qkv(6, b=1, h=1, s=4, d=2))
    mask = torch.full((4, 4), -1.0e30)
    m, l, o = tra._block_stats(q, k, v, mask)
    assert torch.isfinite(m).all() and (l == 0).all()
    assert (tra._finish((m, l, o), torch.float32) == 0).all()


@pytest.mark.parametrize("n", [2, 4])
def test_smaller_rings(n):
    """Rings of 2 and 4 shards: 2·(n−1) ppermutes, the same attention."""
    mesh = tra.make_seq_mesh(["cpu"] * n)
    x = _qkv(7, s=32)
    ring = tra.make_ring_attention(mesh, 32, causal=True)
    mesh.collectives.clear()
    out = ring(*_torch(x))
    assert mesh.collectives == {"ppermute": 2 * (n - 1)}
    _close(out, tra.reference_attention(*_torch(x)), 2e-5)


def _every_block(q, k, v, n, causal):
    """The reference's ring body for each shard in turn, with no mesh:
    every block's partials computed, its mask added, and merged."""
    blk = q.shape[2] // n
    pos = torch.arange(blk)
    outs = []
    for my in range(n):
        def rows(t, i):
            return t[:, :, i * blk:(i + 1) * blk]

        def mask_for(src):
            return tra._mask(my * blk + pos, src * blk + pos, causal, "cpu")

        acc = tra._block_stats(rows(q, my), rows(k, my), rows(v, my),
                               mask_for(my))
        for step in range(1, n):
            src = (my - step) % n
            acc = tra._merge(acc, tra._block_stats(
                rows(q, my), rows(k, src), rows(v, src), mask_for(src)))
        outs.append(tra._finish(acc, q.dtype))
    return torch.cat(outs, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipped_blocks_change_no_value(mesh, causal, dtype):
    """The ring skips the products of all-hidden blocks and the add of
    zero masks: its output equals the reference's schedule, which
    computes and merges every block, value for value."""
    x = _torch(_qkv(8), dtype)
    out = tra.make_ring_attention(mesh, 64, causal=causal)(*x)
    np.testing.assert_array_equal(
        _f32(out), _f32(_every_block(*x, N_DEV, causal)))
