"""Mixture-of-experts FFN on one device, in PyTorch.

Port of the single-device half of ``modelmesh_tpu/parallel/moe.py``: the
parameters (``init_moe_params``, byte for byte the reference's), top-1
(switch) routing with a per-expert capacity (``_route``), the experts'
FFN (``_expert_ffn``) and the dense oracle ``reference_moe``, which the
reference's transformer runs on a one-device host. The expert-parallel
path over a device mesh (``make_expert_parallel_ffn``, ``make_expert_mesh``)
is not ported.

Routing shards the tokens into ``n_dev`` groups and gives each expert
``capacity = max(1, ceil(T_local * capacity_factor / E))`` slots per
group; tokens over capacity are dropped (their output is zero, and the
transformer's residual carries them through).

Arithmetic follows the reference's: the router and the routing in f32;
the experts' products bf16 x bf16 with f32 accumulation and an f32 result
(here the bf16 values multiplied in f32, which is exact per product, with
TF32 off on the card); the hidden activation rounded to bf16; the expert
output never rounded before the gate.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from modelmesh_tpu_torch import random as prng

_BF16 = torch.bfloat16
_F32 = torch.float32


def init_moe_params(key: torch.Tensor, d_model: int, d_ff: int,
                    n_experts: int) -> dict:
    """Router f32 [d, E] (normal * 0.02), expert weights bf16 [E, d, ff]
    and [E, ff, d] (normal / sqrt(fan-in)), drawn on the host from
    ``split(key, 3)``. ``math.sqrt`` is a Python float, weak in JAX, so
    the expert weights stay bf16 (divided by the bf16-rounded root)."""
    kg, k1, k2 = prng.split(key, 3)

    def normal(k, shape, dtype):
        return prng.normal(k, shape, dtype, device="cpu")

    def weak(v: float, dtype) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype)

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
