"""Mixture-of-experts FFN, on one device and expert-parallel, in PyTorch.

Port of ``modelmesh_tpu/parallel/moe.py``: the parameters
(``init_moe_params``, byte for byte the reference's), top-1 (switch)
routing with a per-expert capacity (``_route``), the experts' FFN
(``_expert_ffn``), the dense oracle ``reference_moe``, and the
expert-parallel FFN over a 1-D mesh on ``"exp"``
(``make_expert_parallel_ffn``, ``make_expert_mesh``): the tokens split
over the shards, each shard holding the router whole and its E/n
experts' weights, and two ``all_to_all``s carrying each token slot to the
shard that owns its expert and back (GShard/Switch).

Routing shards the tokens into ``n_dev`` groups and gives each expert
``capacity = max(1, ceil(T_local * capacity_factor / E))`` slots per
group; tokens over capacity are dropped (their output is zero, and the
transformer's residual carries them through). The oracle routes each
group as a shard of the mesh does, so both drop the same tokens.

Arithmetic follows the reference's: the router and the routing in f32;
the experts' products bf16 x bf16 with f32 accumulation and an f32 result
(here the bf16 values multiplied in f32, which is exact per product, with
TF32 off on the card); the hidden activation rounded to bf16; the expert
output never rounded before the gate. The expert products are plain
PyTorch: the reference computes them with ``jnp.einsum`` outside any
Pallas kernel.
"""

from __future__ import annotations

import math
import threading
import weakref

import torch
import torch.nn.functional as F

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.ops import cuda_random
from modelmesh_tpu_torch.parallel import mesh as mesh_mod

EXPERT_AXIS = "exp"

_BF16 = torch.bfloat16
_F32 = torch.float32


def init_moe_params(key: torch.Tensor, d_model: int, d_ff: int,
                    n_experts: int, *, device) -> dict:
    """Router f32 [d, E] (normal * 0.02), expert weights bf16 [E, d, ff]
    and [E, ff, d] (normal / sqrt(fan-in)), drawn on ``device`` from
    ``split(key, 3)`` (``ops/cuda_random.py::normal``: the kernel on a
    card). ``math.sqrt`` is a Python float, weak in JAX, so the expert
    weights stay bf16 (divided by the bf16-rounded root). The scales are
    tensors on ``device``: PyTorch's CUDA division by a CPU scalar
    multiplies by its reciprocal, which the CPU's does not."""
    kg, k1, k2 = prng.split(key, 3)

    def normal(k, shape, dtype):
        return cuda_random.normal(k, shape, dtype, device)

    def weak(v: float, dtype) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=device)

    return {
        "router": normal(kg, (d_model, n_experts), _F32) * weak(0.02, _F32),
        "w_in": normal(k1, (n_experts, d_model, d_ff), _BF16)
        / weak(math.sqrt(d_model), _BF16),
        "w_out": normal(k2, (n_experts, d_ff, d_model), _BF16)
        / weak(math.sqrt(d_ff), _BF16),
    }


def _route(x: torch.Tensor, router: torch.Tensor, n_experts: int,
           capacity: int):
    """Top-1 routing with per-expert capacity: x [T, d] -> (dispatch
    [T, E, C] one-hot f32, gate [T] f32). ``dispatch[t, e, c]`` is 1 iff
    token t is slot c of expert e; a token's slot is the number of
    earlier tokens routed to its expert, and slots past capacity drop.
    The argmax takes the first maximum, as ``jnp.argmax`` does."""
    logits = x.to(_F32) @ router.to(_F32)             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)              # [T]
    gate = probs.gather(1, expert[:, None])[:, 0]     # [T]
    onehot = F.one_hot(expert, n_experts).to(_F32)    # [T, E]
    pos = torch.cumsum(onehot, dim=0) - onehot
    slot = (pos * onehot).sum(dim=1).to(torch.int32)  # [T]
    keep = slot < capacity
    slots = torch.arange(capacity, device=x.device, dtype=torch.int32)
    dispatch = (onehot[:, :, None]
                * (slot[:, None] == slots[None, :]).to(_F32)[:, None, :]
                * keep[:, None, None].to(_F32))       # [T, E, C]
    return dispatch, gate


def _expert_ffn(blocks: torch.Tensor, w_in: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """blocks [E, S, d] -> gelu(x @ w_in) @ w_out per expert: bf16
    operands, f32 accumulation and result; the hidden activation rounded
    to bf16 between the two."""
    h = blocks.to(_BF16).to(_F32) @ w_in.to(_F32)
    h = F.gelu(h, approximate="tanh").to(_BF16)
    return h.to(_F32) @ w_out.to(_F32)


def reference_moe(params: dict, x: torch.Tensor, n_experts: int,
                  capacity_factor: float = 1.25,
                  n_dev: int = 1) -> torch.Tensor:
    """The MoE FFN over x [T, d] on one device, its tokens routed in
    ``n_dev`` equal groups (the routing a mesh of ``n_dev`` devices
    gives): the output in x's dtype."""
    if x.shape[0] % n_dev:
        raise ValueError(
            f"token count {x.shape[0]} not divisible into {n_dev} groups")
    outs = []
    for xs in torch.split(x, x.shape[0] // n_dev, dim=0):
        t_local = xs.shape[0]
        capacity = max(1, math.ceil(t_local * capacity_factor / n_experts))
        dispatch, gate = _route(xs, params["router"], n_experts, capacity)
        slots = torch.einsum("tec,td->ecd", dispatch, xs.to(_F32))
        out_blocks = _expert_ffn(slots, params["w_in"], params["w_out"])
        y = torch.einsum("tec,ecd->td", dispatch, out_blocks)
        outs.append((y * gate[:, None]).to(xs.dtype))
    return torch.cat(outs, dim=0)


class _Placement:
    """Each shard's (router, w_in, w_out) of one parameter dict: views of
    the tensors for a shard on their device (free, never kept), copies
    for a shard on another, made once and kept while the dict's tensors
    live (the copies hold no reference to them)."""

    def __init__(self, mesh: mesh_mod.Mesh, axis_name: str, e_local: int):
        self.mesh = mesh
        self.axis_name = axis_name
        self.e_local = e_local
        self._lock = threading.Lock()
        self._copies: dict = {}  #: guarded-by: _lock

    def __call__(self, params: dict) -> list:
        ts = (params["router"], params["w_in"], params["w_out"])
        views = []
        for r in range(self.mesh.size):
            e0 = self.mesh.block_range(r, self.axis_name, ts[1].shape[0])[0]
            views.append((ts[0], ts[1][e0:e0 + self.e_local],
                          ts[2][e0:e0 + self.e_local]))
        remote = [r for r, dev in enumerate(self.mesh.devices)
                  if any(t.device != dev for t in views[r])]
        if not remote:
            return views
        key = tuple(id(t) for t in ts)
        with self._lock:
            copies = self._copies.get(key)
        if copies is None:
            copies = {r: tuple(t.to(self.mesh.devices[r], copy=True)
                               for t in views[r]) for r in remote}
            with self._lock:
                self._copies[key] = copies
            for t in ts:
                weakref.finalize(t, self._drop, key)
        return [copies.get(r, views[r]) for r in range(self.mesh.size)]

    def _drop(self, key) -> None:
        with self._lock:
            copies = self._copies.pop(key, None)
        del copies   # freed outside the lock


def make_expert_parallel_ffn(mesh: mesh_mod.Mesh, n_experts: int,
                             capacity_factor: float = 1.25,
                             axis_name: str = EXPERT_AXIS):
    """``fn(params, x) -> y`` over whole x [T, d] (one device), the tokens
    split on ``axis_name`` and the experts sharded over it: y on x's
    device, in x's dtype. T and ``n_experts`` must divide by the axis.
    Call it from the controlling thread, never from inside a shard."""
    n_dev = mesh.shape[axis_name]
    if n_experts % n_dev:
        raise ValueError(f"{n_experts} experts not divisible by {n_dev}")
    e_local = n_experts // n_dev
    placement = _Placement(mesh, axis_name, e_local)

    def body(router, w_in, w_out, x):
        # x: [T_local, d], this shard's tokens; router whole; w_in/w_out
        # this shard's [E_local, ...] experts.
        t_local = x.shape[0]
        capacity = max(1, math.ceil(t_local * capacity_factor / n_experts))
        dispatch, gate = _route(x, router, n_experts, capacity)
        # The slots [E, C, d], grouped as [owner shard, local expert] and
        # exchanged: each shard receives, from every peer, the slots of
        # ITS experts (global expert e = owner * E_local + k).
        slots = torch.einsum("tec,td->ecd", dispatch, x.to(_F32))
        slots = slots.reshape(n_dev, e_local, capacity, -1)
        slots = mesh_mod.all_to_all(slots, axis_name, 0, 0, tiled=False)
        blocks = slots.permute(1, 0, 2, 3).reshape(
            e_local, n_dev * capacity, -1)     # [E_local, all slots, d]
        out_blocks = _expert_ffn(blocks, w_in, w_out)
        back = out_blocks.reshape(e_local, n_dev, capacity, -1).permute(
            1, 0, 2, 3)                        # [source shard, E_local, C, d]
        back = mesh_mod.all_to_all(back, axis_name, 0, 0, tiled=False)
        back = back.reshape(n_experts, capacity, -1)
        y = torch.einsum("tec,ecd->td", dispatch, back)
        return (y * gate[:, None]).to(x.dtype)

    def fn(params, x):
        if x.shape[0] % n_dev:
            raise ValueError(
                f"token count {x.shape[0]} not divisible by {n_dev} devices")
        per_shard = placement(params)
        xs = [mesh.block(r, x, (axis_name, None)).to(mesh.devices[r])
              for r in range(mesh.size)]
        outs = mesh.run(body, (*zip(*per_shard), xs))
        return torch.cat([outs[r].to(x.device)
                          for r in mesh.group(axis_name)], dim=0)

    return fn


def make_expert_mesh(devices=None,
                     axis_name: str = EXPERT_AXIS) -> mesh_mod.Mesh:
    """1-D expert-parallel mesh over ``devices`` (``None``: every CUDA
    device; a list may name one device more than once, one entry per
    shard). One mesh per device list for the process
    (``mesh.axis_mesh``)."""
    return mesh_mod.axis_mesh(axis_name, devices)
