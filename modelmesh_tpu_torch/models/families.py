"""Servable model families of the model runtime, in PyTorch.

Port of ``modelmesh_tpu/models/families.py``: the same five families
(mlp, linear, conv, embedding, transformer, and ``example`` for linear),
built from the model path (``family://k=v,...``) with the same defaults,
and the same initial weights byte for byte: ``jax.random.normal`` (JAX's
threefry) from ``crc32(model_id)`` (or the spec's ``seed``), drawn on the
model's device (``ops/cuda_random.py::normal``: the kernel on a card, the
plain version in ``modelmesh_tpu_torch/random.py`` on the CPU), so a load
on the card holds what a load on the CPU holds. Every scale after a draw
runs where the draw lies with a divisor on that device too: PyTorch's
CUDA division by a CPU scalar multiplies by its reciprocal, which the
CPU's does not.

Parameters are a plain tree of dicts and lists of tensors, shaped and
typed as the reference's pytree: ``leaves`` walks it in
``jax.tree.leaves`` order (dict keys sorted, lists in order), which is the
wire order of weight streaming, and ``unflatten``/``params_from_leaves``
graft leaves back onto a skeleton. A family's ``apply(params, x)`` is a
plain function, so ``torch.func.vmap`` runs it over stacked parameters
(the fused cross-model dispatch).

Dtypes follow the reference's promotions, which PyTorch does not make by
itself: ``bf16 normal * (1.0 / np.sqrt(a))`` multiplies by a NumPy float64
scalar, which JAX types strongly, so the mlp, linear and transformer
weight matrices are f32 and the products that read them run in f32;
``* 0.05`` and the conv's ``* float(...)`` are weak and stay bf16. Every
mixed-dtype product and sum here casts both sides to the promoted dtype
explicitly (``_mm``/``_add``). The layer norm uses the population
variance; gelu is the tanh form (``jax.nn.gelu``'s default); the conv
pads "SAME" at stride 2 asymmetrically, as XLA does.

A transformer with ``experts=E`` takes the MoE FFN in each block
(``parallel/moe.py``): its weights are drawn as the reference's, and it
runs the dense oracle ``reference_moe`` with ``groups`` routing shards.
Its routing couples the rows of a batch, so it is not ``batch_safe``.

Devices: ``build_model(..., devices=[...])`` names the devices a model
may span, the port's counterpart of the reference's ``jax.devices()``
(default: the model's one device). Over n > 1 of them the transformer's
``sp=1`` runs ring attention (``parallel/ring_attention.py``) when n
divides ``seq``, and ``ep=1`` the expert-parallel FFN when n divides
``experts`` and ``seq`` and ``groups == n``; each only on a full-length
input, as in the reference. Otherwise they run the dense path.

Weights split over a serving mesh (``parallel/mesh.py`` ``shard_params``,
the store's ``load_sharded``) are ``ShardedLeaf`` leaves: a product with
a column-split weight runs block by block on the blocks' devices and
gathers the output columns in order (``_mm``); any other read of a split
leaf gathers it for that use (``mesh.local``): in the transformer, the
embedding table, once a call, for its row lookup and its readout. No shard thread runs, so a
split model may also run the ring and the expert-parallel FFN.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.device import resolve_device
from modelmesh_tpu_torch.ops import cuda_random
from modelmesh_tpu_torch.parallel.mesh import ShardedLeaf, local
from modelmesh_tpu_torch.parallel.moe import (
    init_moe_params,
    make_expert_mesh,
    make_expert_parallel_ffn,
    reference_moe,
)
from modelmesh_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    make_seq_mesh,
)

_BF16 = torch.bfloat16
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str
    params: dict[str, int]

    @classmethod
    def parse(cls, model_type: str, model_path: str) -> "ModelSpec":
        """``family://k=v,k=v`` (path) with model_type as fallback family."""
        family, sep, rest = model_path.partition("://")
        if not sep:
            family, rest = model_type, model_path
        kv: dict[str, int] = {}
        if rest:
            for part in rest.split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                kv[k.strip()] = int(v)
        return cls(family=family.strip() or model_type, params=kv)


# -- parameter trees ---------------------------------------------------------

def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def unflatten(skeleton, new_leaves):
    """A tree shaped as ``skeleton`` holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(sub) for sub in node]
        return next(it)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def map_tree(fn, *trees):
    """``fn`` over corresponding leaves of same-shaped trees."""
    return unflatten(trees[0], [fn(*ls) for ls in zip(*map(leaves, trees))])


def leaf_nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def leaf_bytes(t: torch.Tensor) -> bytes:
    """A leaf's bytes in the reference's wire layout (row-major, its own
    dtype); a split leaf's whole bytes."""
    flat = local(t, "cpu").detach().to("cpu").contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def leaf_from_bytes(blob: bytes, like: torch.Tensor) -> torch.Tensor:
    """A CPU tensor of ``like``'s dtype and shape from its wire bytes;
    ValueError when the length differs."""
    want = leaf_nbytes(like)
    if len(blob) != want:
        raise ValueError(f"byte length {len(blob)} != expected {want}")
    if want == 0:
        return torch.empty(like.shape, dtype=like.dtype)
    return torch.frombuffer(bytearray(blob), dtype=like.dtype).reshape(
        like.shape)


def params_from_leaves(skeleton, ref_leaves, device=None):
    """The port's parameters from the reference's
    ``jax.tree.leaves(params)`` (numpy arrays, or anything with
    ``tobytes``): each leaf's bytes grafted onto ``skeleton``'s leaf of the
    same position, shape checked, on ``device`` (``None``: ``cuda:0`` or
    raise). The same graft as ``load_from_stream``."""
    device = resolve_device(device)
    skel = leaves(skeleton)
    if len(ref_leaves) != len(skel):
        raise ValueError(
            f"{len(ref_leaves)} leaves for a tree of {len(skel)}"
        )
    out = []
    for i, (ref, like) in enumerate(zip(ref_leaves, skel)):
        if tuple(np.shape(ref)) != tuple(like.shape):
            raise ValueError(
                f"leaf {i}: shape {tuple(np.shape(ref))} != "
                f"{tuple(like.shape)}"
            )
        out.append(leaf_from_bytes(np.asarray(ref).tobytes(), like)
                   .to(device))
    return unflatten(skeleton, out)


# -- the servable model ------------------------------------------------------

class ServableModel:
    """A loaded model: apply + parameter tree + sizing.

    ``family``/``fuse_key`` are stamped by ``build_model``: the fuse key
    identifies the ARCHITECTURE (family + every non-seed spec param), so
    two models with equal keys have identical tree structure, leaf
    shapes/dtypes, and apply semantics — the eligibility contract for
    the fused cross-model dispatch (models/server.py), where one model's
    apply runs every group member's stacked parameters."""

    def __init__(self, apply_fn: Callable, params, input_shape, input_dtype,
                 family: str = "", fuse_key: str = "",
                 batch_safe: bool = True):
        self.apply = apply_fn
        self.params = params
        self.input_shape = input_shape
        self.input_dtype = input_dtype
        self.family = family
        self.fuse_key = fuse_key
        # Row independence: True when apply computes each input row
        # independently, so row-concat batching / zero-row padding cannot
        # change any real row's output (the batched data plane's
        # eligibility contract).
        self.batch_safe = batch_safe

    @property
    def size_bytes(self) -> int:
        return sum(leaf_nbytes(t) for t in leaves(self.params))

    @property
    def device(self) -> torch.device:
        return leaves(self.params)[0].device

    def decode_rows(self, payload: bytes) -> np.ndarray:
        """Raw request bytes -> [n, *input_shape] numpy rows (the
        family's input dtype, short payloads zero-padded)."""
        flat = np.frombuffer(payload, dtype=self.input_dtype)
        feat = int(np.prod(self.input_shape))
        n = max(1, len(flat) // feat)
        usable = flat[: n * feat]
        if len(usable) < n * feat:
            usable = np.pad(usable, (0, n * feat - len(usable)))
        return usable.reshape((n, *self.input_shape))

    def run(self, rows: np.ndarray) -> np.ndarray:
        """apply over numpy rows on the model's device; f32 logits."""
        x = torch.from_numpy(np.array(rows)).to(self.device)
        with torch.inference_mode():
            out = self.apply(self.params, x)
        return out.to(_F32).cpu().numpy()

    def predict_bytes(self, payload: bytes) -> bytes:
        """Raw-bytes inference: payload is a little-endian array matching
        the family's input dtype; output is f32 logits bytes."""
        return self.run(self.decode_rows(payload)).tobytes()


def _seed_from(spec: ModelSpec, model_id: str) -> int:
    # Stable across processes: every copy of a model (scale-up, failover)
    # must build identical weights. Python's hash() is salted per process.
    return spec.params.get("seed", zlib.crc32(model_id.encode()))


def _draw(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, bf16)``, drawn on ``device``."""
    return cuda_random.normal(key, shape, _BF16, device)


# -- arithmetic with the reference's dtype promotion -------------------------

def _promoted(a: torch.Tensor, b):
    b = local(b, a.device)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(a: torch.Tensor, b) -> torch.Tensor:
    if isinstance(b, ShardedLeaf) and b.split:
        # Column-parallel: each block's product on its device, the output
        # columns gathered in block order.
        return torch.cat([_mm(a.to(blk.device), blk).to(a.device)
                          for blk in b.blocks], dim=-1)
    a, b = _promoted(a, b)
    return a @ b


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promoted(a, b)
    return a + b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _strong_scale(w: torch.Tensor, a: int) -> torch.Tensor:
    """``w * (1.0 / np.sqrt(a))``: a float64 NumPy scalar, strong in JAX,
    promotes the bf16 draw to f32."""
    return w.to(_F32) * torch.tensor(1.0 / np.sqrt(a), dtype=_F32)


def _weak_scale(w: torch.Tensor, s: float) -> torch.Tensor:
    """``w * s`` for a Python float: weak in JAX, so it stays in w's dtype
    (both operands rounded to it first)."""
    return w * torch.tensor(s, dtype=w.dtype)


# -- families ----------------------------------------------------------------

def build_mlp(spec: ModelSpec, model_id: str, device) -> ServableModel:
    d_in = spec.params.get("in", 64)
    hidden = spec.params.get("hidden", 256)
    depth = spec.params.get("depth", 2)
    d_out = spec.params.get("out", 10)
    key = prng.PRNGKey(_seed_from(spec, model_id))
    dims = [d_in] + [hidden] * depth + [d_out]
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        key, k1 = prng.split(key)
        w = _strong_scale(_draw(k1, (a, b), device), a)
        params.append({"w": w, "b": torch.zeros((b,), dtype=_BF16,
                                                device=device)})

    def apply(params, x):
        h = x.to(_BF16)
        for i, layer in enumerate(params):
            h = _add(_mm(h, layer["w"]), layer["b"])
            if i < len(params) - 1:
                h = _gelu(h)
        return h.to(_F32)

    return ServableModel(apply, params, (d_in,), np.float32)


def build_linear(spec: ModelSpec, model_id: str, device) -> ServableModel:
    """Single dense layer — the smallest/cheapest family (density tests)."""
    d_in = spec.params.get("in", 32)
    d_out = spec.params.get("out", 8)
    key = prng.PRNGKey(_seed_from(spec, model_id))
    params = {"w": _strong_scale(_draw(key, (d_in, d_out), device), d_in)}

    def apply(params, x):
        return _mm(x.to(_BF16), params["w"]).to(_F32)

    return ServableModel(apply, params, (d_in,), np.float32)


def _same_pad(size: int, stride: int, kernel: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def build_conv(spec: ModelSpec, model_id: str, device) -> ServableModel:
    """Small conv classifier: f32 image (NHWC) -> class logits. Weights
    HWIO in bf16, as the reference's; the conv runs NCHW (PyTorch's
    layout) with the weights permuted per call, and the head reads the
    features flattened in NHWC order."""
    size = spec.params.get("size", 32)          # square input, HW
    chans = spec.params.get("chans", 3)
    width = spec.params.get("width", 16)        # first conv channels
    depth = spec.params.get("depth", 3)         # conv blocks, stride 2 each
    classes = spec.params.get("classes", 10)
    key = prng.PRNGKey(_seed_from(spec, model_id))

    params = {"convs": []}
    c_in = chans
    for i in range(depth):
        c_out = width << i
        key, k1 = prng.split(key)
        params["convs"].append({
            "w": _weak_scale(_draw(k1, (3, 3, c_in, c_out), device),
                             float(1.0 / np.sqrt(9 * c_in))),
            "b": torch.zeros((c_out,), dtype=_BF16, device=device),
        })
        c_in = c_out
    # SAME padding + stride 2 gives ceil(hw/2) per block.
    final_hw = size
    for _ in range(depth):
        final_hw = max(1, (final_hw + 1) // 2)
    key, k2 = prng.split(key)
    params["head"] = _weak_scale(
        _draw(k2, (final_hw * final_hw * c_in, classes), device),
        float(1.0 / np.sqrt(final_hw * final_hw * c_in)),
    )

    def apply(params, x):
        # x: f32[batch, H, W, C] (NHWC, the reference's layout)
        h = x.to(_BF16).permute(0, 3, 1, 2)
        for layer in params["convs"]:
            top, bottom = _same_pad(h.shape[2], 2, 3)
            left, right = _same_pad(h.shape[3], 2, 3)
            h = F.pad(h, (left, right, top, bottom))
            h = F.conv2d(h, layer["w"].permute(3, 2, 0, 1), stride=2)
            h = _gelu(h + layer["b"][None, :, None, None])
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return (h @ params["head"]).to(_F32)

    return ServableModel(apply, params, (size, size, chans), np.float32)


def build_embedding(spec: ModelSpec, model_id: str,
                    device) -> ServableModel:
    """Embedding-bag scorer: int32 id bag -> similarity logits. The
    reference's one-hot einsum is a gather here: each one-hot row holds a
    single 1.0, so the two are equal exactly."""
    vocab = spec.params.get("vocab", 4096)
    dim = spec.params.get("dim", 64)
    bag = spec.params.get("bag", 16)            # ids per request
    items = spec.params.get("items", 128)       # scored catalog size
    key = prng.PRNGKey(_seed_from(spec, model_id))
    k1, k2 = prng.split(key)
    params = {
        "table": _weak_scale(_draw(k1, (vocab, dim), device), 0.05),
        "items": _weak_scale(_draw(k2, (items, dim), device), 0.05),
    }

    def apply(params, ids):
        # ids: i32[batch, bag]; LITERAL id 0 is the padding slot, masked
        # before the (floor) modulo: an id that wraps onto slot 0 counts.
        mask = (ids != 0).to(_BF16)[..., None]
        emb = params["table"][(ids % vocab).long()]          # [b, bag, d]
        pooled = (emb * mask).sum(1) / torch.clamp_min(mask.sum(1), 1.0)
        return (pooled @ params["items"].T).to(_F32)

    return ServableModel(apply, params, (bag,), np.int32)


def _layer_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The reference's layer norm: f32 statistics, population variance,
    rsqrt, cast back to x's dtype, then the gain (promoted)."""
    x32 = x.to(_F32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = ((x32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    a, b = _promoted(y, g)
    return a * b


def build_transformer(spec: ModelSpec, model_id: str, device,
                      devices=None) -> ServableModel:
    """Tiny causal transformer LM: int32 token payload -> next-token logits.

    Learned embeddings, pre-LN blocks with causal self-attention + gelu
    MLP (or, with ``experts=E``, the MoE FFN routed in ``groups`` token
    shards), weight-tied f32 readout of the last position; f32 attention
    softmax cast to bf16. ``sp=1`` / ``ep=1`` over ``devices`` (module
    docstring)."""
    vocab = spec.params.get("vocab", 256)
    d = spec.params.get("d", 128)
    n_layers = spec.params.get("layers", 2)
    n_heads = spec.params.get("heads", 4)
    seq = spec.params.get("seq", 64)
    head_dim = d // n_heads
    n_experts = spec.params.get("experts", 0)
    moe_groups = spec.params.get("groups", 1)
    if n_experts and moe_groups > 1 and seq % moe_groups:
        raise ValueError(
            f"transformer spec: groups={moe_groups} must divide "
            f"seq={seq} (MoE routing capacity is per token-shard)"
        )
    n_dev = len(devices or ())
    # sp=1: ring attention over the devices. The parameters are the same
    # either way; the schedule differs, so outputs agree at bf16 level
    # (block-wise softmax reassociation, p kept in f32), not bit for bit.
    ring = None
    if spec.params.get("sp", 0) and n_dev > 1 and seq % n_dev == 0:
        ring = make_ring_attention(make_seq_mesh(devices), seq, causal=True)
    # ep=1: the expert-parallel FFN, when the mesh's shards are the
    # model's routing groups (the same drops as the dense oracle).
    moe_fn = None
    if (spec.params.get("ep", 0) and n_experts and n_dev > 1
            and n_experts % n_dev == 0 and seq % n_dev == 0
            and moe_groups == n_dev):
        moe_fn = make_expert_parallel_ffn(make_expert_mesh(devices),
                                          n_experts)
    key = prng.PRNGKey(_seed_from(spec, model_id))

    def dense(k, a, b):
        # ``/ np.sqrt(a)``: a strong float64 scalar, so f32; divided on the
        # draw's device (module docstring).
        return (_draw(k, (a, b), device).to(_F32)
                / torch.tensor(np.sqrt(a), dtype=_F32, device=device))

    keys = prng.split(key, 2 + 6 * n_layers)
    params = {
        "embed": _weak_scale(_draw(keys[0], (vocab, d), device), 0.02),
        "pos": _weak_scale(_draw(keys[1], (seq, d), device), 0.02),
        "blocks": [],
    }
    for layer in range(n_layers):
        k = keys[2 + 6 * layer: 8 + 6 * layer]
        if n_experts:
            ffn = {"moe": init_moe_params(k[2], d, 4 * d, n_experts,
                                          device=device)}
        else:
            ffn = {"up": dense(k[2], d, 4 * d), "down": dense(k[3], 4 * d, d)}
        params["blocks"].append({
            "qkv": dense(k[0], d, 3 * d),
            "proj": dense(k[1], d, d),
            **ffn,
            "ln1": torch.ones((d,), dtype=_BF16, device=device),
            "ln2": torch.ones((d,), dtype=_BF16, device=device),
        })
    scale = torch.tensor(np.sqrt(head_dim), dtype=_F32)

    def apply(params, tokens):
        # tokens: i32[batch, seq]
        b, t = tokens.shape
        embed = local(params["embed"], tokens.device)
        h = (embed[(tokens % vocab).long()]
             + local(params["pos"], tokens.device)[None, :t])
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=tokens.device))
        for blk in params["blocks"]:
            x = _layer_norm(h, blk["ln1"])
            qkv = _mm(x, blk["qkv"])
            q, kk, v = torch.split(qkv, qkv.shape[-1] // 3, dim=-1)

            def heads(z):
                return z.reshape(b, t, n_heads, head_dim).transpose(1, 2)

            q, kk, v = heads(q), heads(kk), heads(v)
            if ring is not None and t == seq:
                z = ring(q, kk, v)      # [b, h, t, hd], causal, f32 softmax
            else:
                att = (q.to(_F32) @ kk.to(_F32).transpose(2, 3)) / scale
                att = torch.where(mask[None, None], att, -1e30)
                att = torch.softmax(att, dim=-1).to(_BF16)
                z = _mm(att, v)
            z = z.transpose(1, 2).reshape(b, t, d)
            h = _add(h, _mm(z, blk["proj"]))
            x = _layer_norm(h, blk["ln2"])
            if "moe" in blk:
                moe = {k: local(w, x.device) for k, w in blk["moe"].items()}
                flat = x.reshape(b * t, d)
                if moe_fn is not None and t == seq:
                    y = moe_fn(moe, flat)
                else:
                    y = reference_moe(moe, flat, n_experts, n_dev=moe_groups)
                h = _add(h, y.reshape(b, t, d).to(h.dtype))
            else:
                h = _add(h, _mm(_gelu(_mm(x, blk["up"])), blk["down"]))
        return h[:, -1].to(_F32) @ embed.T.to(_F32)

    return ServableModel(apply, params, (seq,), np.int32)


# Families whose parameters stream in a layer-by-layer servable order
# (embeddings/first blocks land first). Conv and embedding-bag families
# are deliberately absent: their single dense readout depends on every
# preceding parameter.
LAYER_STREAMABLE_FAMILIES = frozenset({"transformer", "mlp"})

FAMILIES: dict[str, Callable[[ModelSpec, str], ServableModel]] = {
    "mlp": build_mlp,
    "linear": build_linear,
    "conv": build_conv,
    "embedding": build_embedding,
    "transformer": build_transformer,
    # The fake-runtime type used across tests maps to the cheapest family.
    "example": build_linear,
}


def fuse_key_for(spec: ModelSpec) -> str:
    """Architecture identity for fused cross-model dispatch: family plus
    every spec param EXCEPT the seed (the seed moves the weights, not
    the architecture)."""
    arch = ",".join(
        f"{k}={v}" for k, v in sorted(spec.params.items()) if k != "seed"
    )
    return f"{spec.family}|{arch}"


def build_model(model_id: str, model_type: str, model_path: str,
                device=None, devices=None) -> ServableModel:
    """Build with every parameter drawn and made on ``device`` (``None``:
    ``cuda:0`` or raise): on a CUDA device the weights come from the
    threefry kernel and none is drawn on the host. ``devices``: the
    devices the model may span (``None``: ``[device]``), which the
    transformer's ``sp`` and ``ep`` run over."""
    device = resolve_device(device)
    devices = ([device] if devices is None
               else [torch.device(d) for d in devices])
    spec = ModelSpec.parse(model_type, model_path)
    builder = FAMILIES.get(spec.family)
    if builder is None:
        raise ValueError(
            f"unknown model family {spec.family!r} "
            f"(known: {sorted(FAMILIES)})"
        )
    model = (builder(spec, model_id, device, devices)
             if builder is build_transformer
             else builder(spec, model_id, device))
    model.family = spec.family
    model.fuse_key = fuse_key_for(spec)
    # MoE routing couples the rows of a batch (capacity per token group);
    # the rule is the reference's.
    model.batch_safe = not (
        spec.family == "transformer" and spec.params.get("experts", 0) > 0
    )
    return model
