"""The auction's implied load: the fixed-order kernel and its plain version.

Port of ``modelmesh_tpu/ops/auction.py::_implied_load_fused`` (the
reference's ``load_impl="fused"``):

    load[m] = sum_{n, k} sizes[n] * valid[n, k] * [idx[n, k] == m]

The plain version is the reference's chunked one-hot compare-reduce, line
for line. The kernel (``csrc/implied_load.cu``, built at first use by
``_build``) keeps a histogram per warp, groups the lanes that hold one
instance and sums them in lane order, then sums the warps' and the blocks'
histograms in a fixed order: no float atomics, so unlike ``index_add_`` on
the card it gives the same load on every run.

``implied_load`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from modelmesh_tpu_torch.ops import _build

LIB = "implied_load"
# Flat (idx, weight) entries per step of the plain version's compare-reduce
# (the reference's _FUSED_CHUNK).
FUSED_CHUNK = 8192

# Flat entries per block partial of the kernel (8 warps of 512, 32 a step):
# the partials' count follows from N and S alone, so the summation order
# does not depend on the card.
BLOCK_ENTRIES = 4096

# Kernel launches since the process started (or the caller last zeroed them
# with reset_launches()).
launches = {"implied_load": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def implied_load_ref(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """Plain version: the reference's scatter-free histogram, a one-hot
    compare-reduce over chunks of FUSED_CHUNK flat entries; padded entries
    point one past the instance range and match nothing."""
    dev = sizes.device
    if idx.numel() == 0:  # zero-model problem: nothing contributes
        return torch.zeros(num_instances, dtype=torch.float32, device=dev)
    contrib = sizes[:, None] * valid.to(torch.float32)  # [N, K]
    flat_idx = idx.reshape(-1).to(torch.int32)
    flat_w = contrib.reshape(-1)
    s = flat_idx.shape[0]
    chunk = min(FUSED_CHUNK, s)
    pad = (-s) % chunk
    if pad:
        flat_idx = torch.nn.functional.pad(flat_idx, (0, pad),
                                           value=num_instances)
        flat_w = torch.nn.functional.pad(flat_w, (0, pad))
    cols = torch.arange(num_instances, dtype=torch.int32, device=dev)
    acc = torch.zeros(num_instances, dtype=torch.float32, device=dev)
    for ic, wc in zip(flat_idx.view(-1, chunk), flat_w.view(-1, chunk)):
        acc = acc + torch.where(
            ic[:, None] == cols[None, :], wc[:, None], 0.0
        ).sum(dim=0)
    return acc


def _check(idx, valid, sizes) -> tuple[int, int]:
    """idx i64[N, S] and valid bool[N, S] on sizes' device, sizes f32[N].
    Returns (N, S)."""
    if idx.dim() != 2 or idx.dtype != torch.int64:
        raise TypeError(f"idx must be 2-D int64 (got {idx.dtype}, "
                        f"{idx.dim()}-D)")
    n, s = idx.shape
    if valid.dtype != torch.bool or valid.shape != idx.shape:
        raise TypeError(f"valid must be bool{list(idx.shape)} (got "
                        f"{valid.dtype}{list(valid.shape)})")
    if sizes.dtype != torch.float32 or sizes.shape != (n,):
        raise TypeError(f"sizes must be float32[{n}] (got {sizes.dtype}"
                        f"{list(sizes.shape)})")
    for name, t in (("idx", idx), ("valid", valid)):
        if t.device != sizes.device:
            raise ValueError(f"{name} is on {t.device}, sizes on "
                             f"{sizes.device}")
    return n, s


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit column stride: a view of rows (the sparse auction's
    ``idx[:, :nsel]``) is taken as it is, by its row stride; any other
    layout is copied."""
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def implied_load(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """f32[num_instances]: the memory load the assignment implies per
    instance, summed in a fixed order."""
    n, s = _check(idx, valid, sizes)
    if sizes.device.type == "cpu":
        return implied_load_ref(idx, valid, sizes, num_instances)
    if sizes.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {sizes.device}")
    out = torch.empty(num_instances, dtype=torch.float32, device=sizes.device)
    if n * s == 0 or num_instances == 0:
        return out.zero_()
    idx, valid = _rows(idx), _rows(valid)
    sizes = sizes.contiguous()
    partial = torch.empty((-(-(n * s) // BLOCK_ENTRIES), num_instances),
                          dtype=torch.float32, device=sizes.device)
    _build.launch(
        LIB, "mm_implied_load", sizes.device,
        idx.data_ptr(), valid.data_ptr(), sizes.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, s, idx.stride(0),
        valid.stride(0), num_instances, BLOCK_ENTRIES,
    )
    launches["implied_load"] += 1
    return out
