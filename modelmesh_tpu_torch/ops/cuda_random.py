"""The threefry draw on the card: the kernel and its plain version.

The dense tier's ``noise_impl="threefry"`` adds
``jax.random.gumbel(PRNGKey(seed), shape)`` to the plan logits
(``modelmesh_tpu/ops/auction.py::gumbel_perturb``). The plain version is
``modelmesh_tpu_torch/random.py`` (the int64 threefry, bit for bit JAX's);
the kernel (``csrc/threefry.cu``, built at first use by ``_build``) hashes
each element's flat index in 32-bit registers and writes the block once.

``random_bits`` and ``gumbel`` take the plain version only for a CPU
``device``; for a CUDA device they launch the kernel or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.ops import _build

LIB = "threefry"
_MODE_BITS = 0
_MODE_GUMBEL = 1

# Kernel launches since the process started (or the caller last zeroed them
# with reset_launches()).
launches = {"threefry_gumbel": 0, "threefry_bits": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _launch(key: torch.Tensor, shape, device, dtype, mode: int):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    k0, k1 = prng._words(key)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    total = math.prod(shape)
    if total:
        _build.launch(LIB, "mm_threefry", device, out.data_ptr(), k0, k1,
                      total, mode)
    return out


def random_bits(key: torch.Tensor, shape, device) -> torch.Tensor:
    """32-bit ``jax.random.bits`` as int64 values in [0, 2**32)."""
    if torch.device(device).type == "cpu":
        return prng.random_bits(key, 32, shape, device)
    out = _launch(key, shape, device, torch.int32, _MODE_BITS)
    _build.count_launch(launches, "threefry_bits")
    return out.long() & prng.MASK32


def gumbel(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)``: f32 Gumbel(0, 1)."""
    if torch.device(device).type == "cpu":
        return prng.gumbel(key, shape, device)
    out = _launch(key, shape, device, torch.float32, _MODE_GUMBEL)
    _build.count_launch(launches, "threefry_gumbel")
    return out
