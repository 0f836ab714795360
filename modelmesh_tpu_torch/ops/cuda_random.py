"""The threefry draw on the card: the kernels and their plain version.

The dense tier's ``noise_impl="threefry"`` adds
``jax.random.gumbel(PRNGKey(seed), shape)`` to the plan logits
(``modelmesh_tpu/ops/auction.py::gumbel_perturb``), and the model
families draw their initial weights with ``jax.random.normal``
(``modelmesh_tpu/models/families.py``, ``parallel/moe.py``). The plain
version is ``modelmesh_tpu_torch/random.py`` (the int64 threefry, bit for
bit JAX's); the kernels (``csrc/threefry.cu``, built at first use by
``_build``) hash each element's flat index in 32-bit registers and write
the block once. The bf16 normal takes one of 128 values a draw: the
kernel looks them up in ``bf16_normal_table``, the plain version's
results computed on the host once a process.

``random_bits``, ``gumbel`` and ``normal`` take the plain version only for
a CPU ``device``; for a CUDA device they launch the kernel or raise.
``launches`` counts kernel launches, ``plain_draws`` the normal draws that
took the plain version.
"""

from __future__ import annotations

import math
import threading

import torch

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.ops import _build

LIB = "threefry"
_MODE_BITS = 0
_MODE_GUMBEL = 1
# mm_threefry_normal's modes, by dtype.
_NORMAL_MODES = {torch.bfloat16: 0, torch.float32: 1}

# Kernel launches since the process started (or the caller last zeroed them
# with reset_launches()), and normal draws that took the plain version.
launches = {"threefry_gumbel": 0, "threefry_bits": 0, "threefry_normal": 0}
plain_draws = {"threefry_normal": 0}

_table_lock = threading.Lock()
# The bf16 normal's 128 values as int16: on the CPU under None, and a copy
# on each CUDA device that drew.
_tables: dict = {}  #: guarded-by: _table_lock


def reset_launches() -> None:
    for table in (launches, plain_draws):
        for name in table:
            table[name] = 0


def _check_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device on this host for {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _launch(key: torch.Tensor, shape, device, dtype, mode: int):
    device = _check_cuda(device)
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


def bf16_normal_table(device=None) -> torch.Tensor:
    """int16[128]: entry k the bits of the bf16 normal whose uniform has
    the random bits ``2 * k`` (``prng.normal_of_bits``, on the CPU), on
    ``device`` (``None``: the CPU copy)."""
    with _table_lock:
        cpu = _tables.get(None)
        if cpu is None:
            bits = torch.arange(0, 256, 2, dtype=torch.int64)
            cpu = _tables[None] = prng.normal_of_bits(
                bits, torch.bfloat16).view(torch.int16)
        if device is None:
            return cpu
        device = torch.device(device)
        table = _tables.get(device)
        if table is None:
            table = cpu.to(device)
            # Every stream may read it from now on.
            torch.cuda.synchronize(device)
            _tables[device] = table
        return table


def normal(key: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``, bf16 or f32."""
    if dtype not in _NORMAL_MODES:
        raise TypeError(f"normal draws f32 or bf16 (got {dtype})")
    if torch.device(device).type == "cpu":
        _build.count_launch(plain_draws, "threefry_normal")
        return prng.normal(key, shape, dtype, device=device)
    device = _check_cuda(device)
    k0, k1 = prng._words(key)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    table = (bf16_normal_table(device) if dtype == torch.bfloat16
             else None)
    total = math.prod(shape)
    if total:
        _build.launch(LIB, "mm_threefry_normal", device, out.data_ptr(),
                      table.data_ptr() if table is not None else None,
                      k0, k1, total, _NORMAL_MODES[dtype])
        _build.count_launch(launches, "threefry_normal")
    return out
