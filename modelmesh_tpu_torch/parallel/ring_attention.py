"""Ring attention: sequence-parallel exact attention over a device mesh.

Port of ``modelmesh_tpu/parallel/ring_attention.py``. The sequence axis is
split across the shards of a 1-D mesh (axis ``"seq"``); each shard holds
one Q/K/V block, and the K/V blocks rotate around the ring by
``ppermute`` while each shard accumulates its Q block's attention with
online (flash-style) softmax partials ``(m, l, o)``. Exact, not an
approximation: after n-1 rotations every Q block has attended to every
K/V block, equal to single-device attention up to the reassociation of
the softmax sums.

The arithmetic is the reference's: scores in f32 (bf16 operands multiply
exactly in f32), times the f32 reciprocal ``1/sqrt(d)``; an additive mask
of -1e30 with the running maximum clamped at -5e29, so a fully masked row
gives zeros, not NaNs; ``p`` rounded to v's dtype before ``P@V``, which
accumulates in f32; the output divided by ``max(l, 1e-30)`` and cast to
q's dtype. The block products are plain PyTorch: the reference computes
them with ``jnp.einsum`` outside any Pallas kernel.

Layout: [batch, heads, seq, head_dim]. ``make_ring_attention``'s function
takes and returns whole tensors on one device; it splits S over the
shards, runs one ring per call on the mesh's worker threads, and gathers
the output blocks back in order.
"""

from __future__ import annotations

import numpy as np
import torch

from modelmesh_tpu_torch.parallel import mesh as mesh_mod

SEQ_AXIS = "seq"

_NEG_INF = -1.0e30
_F32 = torch.float32


def _inv_sqrt(d: int) -> float:
    """``1.0 / jnp.sqrt(jnp.asarray(d, f32))``: the f32 root, then the
    f32 reciprocal (both correctly rounded). An f32 value, so a tensor
    times it multiplies by exactly that f32, with no scalar tensor copied
    to the device (a copy from the host waits for the stream)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _block_stats(q, k, v, mask=None):
    """One block's attention partials ``(m, l, o)``: q [B, H, Sq, D], k/v
    [B, H, Sk, D], mask [Sq, Sk] additive (``None``: every key visible,
    the same as a mask of zeros). Scores in f32 whatever the input
    dtype."""
    s = (q.to(_F32) @ k.to(_F32).transpose(-1, -2)) * _inv_sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask[None, None, :, :]
    m = s.amax(dim=-1)                            # [B, H, Sq]
    # A fully masked row has m ~ -1e30: shift by -5e29 there, so exp()
    # gives zeros, not NaNs.
    m_safe = torch.clamp_min(m, _NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)                             # [B, H, Sq]
    # P@V in the value dtype, accumulated in f32.
    o = p.to(v.dtype).to(_F32) @ v.to(_F32)
    return m_safe, l, o


def _merge(acc, blk):
    """Combine two online-softmax partials (the flash-attention merge)."""
    m_a, l_a, o_a = acc
    m_b, l_b, o_b = blk
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)
    cb = torch.exp(m_b - m)
    return m, l_a * ca + l_b * cb, o_a * ca[..., None] + o_b * cb[..., None]


def _finish(acc, dtype):
    _, l, o = acc
    return (o / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def _mask(q_pos, k_pos, causal: bool, device) -> torch.Tensor:
    """The additive mask [Sq, Sk]: 0 where a query sees the key, -1e30
    (in f32) where causality hides it."""
    mask = torch.zeros((len(q_pos), len(k_pos)), dtype=_F32, device=device)
    if causal:
        mask.masked_fill_(q_pos[:, None] < k_pos[None, :], _NEG_INF)
    return mask


def _ring_body(q, k, v, *, n_dev: int, block: int, causal: bool,
               axis_name: str):
    """One shard's part: rotate K/V around the ring, accumulate.

    Causal, a block of keys from an earlier shard is all visible (its
    mask is zeros, so it is not added) and one from a later shard is all
    hidden: there every p is 0 and the merge leaves the partials as they
    are (the local block, merged first, leaves no row fully masked), so
    its products are skipped. The K/V blocks still make every rotation."""
    my = mesh_mod.axis_index(axis_name)
    dev = q.device
    pos = torch.arange(block, device=dev)
    # Step 0: the local block.
    acc = _block_stats(q, k, v,
                       _mask(pos, pos, True, dev) if causal else None)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    for step in range(1, n_dev):
        k = mesh_mod.ppermute(k, axis_name, perm)
        v = mesh_mod.ppermute(v, axis_name, perm)
        src = (my - step) % n_dev
        if causal and src > my:
            continue
        acc = _merge(acc, _block_stats(q, k, v))
    return _finish(acc, q.dtype)


def make_ring_attention(mesh: mesh_mod.Mesh, seq_len: int, *,
                        causal: bool = True, axis_name: str = SEQ_AXIS):
    """``fn(q, k, v) -> out`` over whole [B, H, S, D] tensors (one
    device), with S split on ``axis_name``: the output on q's device.
    ``seq_len`` must divide by the axis, and S must equal it. Call it
    from the controlling thread, never from inside a shard: the ring
    runs on the mesh's own workers."""
    n_dev = mesh.shape[axis_name]
    if seq_len % n_dev:
        raise ValueError(f"seq_len {seq_len} not divisible by {n_dev}")
    block = seq_len // n_dev
    spec = (None, None, axis_name, None)

    def body(q, k, v):
        return _ring_body(q, k, v, n_dev=n_dev, block=block, causal=causal,
                          axis_name=axis_name)

    def fn(q, k, v):
        # Fail at the boundary, not inside a shard: the causal mask is
        # sized for seq_len.
        if q.shape[2] != seq_len:
            raise ValueError(
                f"built for seq_len={seq_len}, got {q.shape[2]}")

        def split(t):
            return [mesh.block(r, t, spec).to(mesh.devices[r])
                    for r in range(mesh.size)]

        outs = mesh.run(body, (split(q), split(k), split(v)))
        return torch.cat([outs[r].to(q.device)
                          for r in mesh.group(axis_name)], dim=2)

    return fn


def make_seq_mesh(devices=None, axis_name: str = SEQ_AXIS) -> mesh_mod.Mesh:
    """1-D sequence-parallel mesh over ``devices`` (``None``: every CUDA
    device; a list may name one device more than once, one entry per
    shard). One mesh per device list for the process
    (``mesh.axis_mesh``)."""
    return mesh_mod.axis_mesh(axis_name, devices)


def reference_attention(q, k, v, causal: bool = True):
    """Single-device full attention (the parity oracle)."""
    s_len = q.shape[2]
    pos = torch.arange(s_len, device=q.device)
    mask = _mask(pos, pos, causal, q.device)
    return _finish(_block_stats(q, k, v, mask), q.dtype)
