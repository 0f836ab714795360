"""The sparse solve's three fused kernels: wrappers and plain versions.

Port of ``modelmesh_tpu/ops/pallas_sparse.py``. Each function streams the
cost matrix C once and recomputes the noisy top-K candidate mask from the
row thresholds and the row-side hash state, instead of reading a
materialized bool[N, M] mask or scaled kernel:

    rowmin[n] = min_m { C[n, m] : key(n, m) <= thresh[n] }
    r[n]      = sum_m [key <= thresh] * exp((rowmin[n] - C[n, m]) / eps) * v[m]
    c[m]      = sum_n [key <= thresh] * exp((rowmin[n] - C[n, m]) / eps) * u[n]

with ``key = f32(C) - tau * gumbel(row, col)`` (``selection_key``).

Each wrapper takes its kernel's plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the kernel in
``csrc/masked_sparse.cu`` (built at first use by ``_build``) or raises.
There is no fallback from one to the other. ``launches`` counts kernel
launches per wrapper.
"""

from __future__ import annotations

import torch

from modelmesh_tpu_torch.ops import _build, auction

LIB = "masked_sparse"
# Rows per partial of the two-pass column product (one scratch row each).
ROWS_PER_CHUNK = 256

# Kernel launches per wrapper since the process started (or the caller
# last zeroed them with reset_launches()).
launches = {
    "masked_row_min": 0,
    "masked_row_matvec": 0,
    "masked_col_matvec": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 tensor of the uint32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def noise_row_state(n: int, seed: int, device) -> torch.Tensor:
    """Row-side hash state ``fmix32(row ^ seed * 0xC2B2AE35)`` as int32
    bits — the (row, seed) prefix of ``auction.hash_gumbel_at``, computed
    once per solve so the kernels need only the column-side mix."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    return _as_i32(auction.row_state(rows, seed))


def selection_key(C, x_row, *, tau: float, noised: bool) -> torch.Tensor:
    """f32[N, M] noisy selection key — the one definition both the top-K
    gather and the plain versions use, so their masks agree bitwise."""
    c = C.to(torch.float32)
    if not noised:
        return c
    cols = torch.arange(C.shape[1], dtype=torch.int64, device=C.device)
    bits = auction.hash_bits(_as_u32(x_row)[:, None], cols[None, :])
    return c - tau * auction.gumbel_from_bits(bits)


def candidate_mask(C, thresh, x_row, *, tau: float, noised: bool):
    """bool[N, M]: entries at or under their row's K-th selection key."""
    return selection_key(C, x_row, tau=tau, noised=noised) <= thresh[:, None]


def _scaled_kernel(C, thresh, x_row, rowmin, eps, tau, noised):
    mask = candidate_mask(C, thresh, x_row, tau=tau, noised=noised)
    shifted = torch.exp((rowmin[:, None] - C.to(torch.float32)) / eps)
    return torch.where(mask, shifted, 0.0)


def masked_row_min_ref(C, thresh, x_row, *, tau: float, noised: bool):
    """Plain version of ``masked_row_min``."""
    mask = candidate_mask(C, thresh, x_row, tau=tau, noised=noised)
    return torch.where(mask, C.to(torch.float32), torch.inf).amin(dim=1)


def masked_row_matvec_ref(C, thresh, x_row, rowmin, v, *, eps: float,
                          tau: float, noised: bool):
    """Plain version of ``masked_row_matvec``."""
    return _scaled_kernel(C, thresh, x_row, rowmin, eps, tau, noised) @ v


def masked_col_matvec_ref(C, thresh, x_row, rowmin, u, *, eps: float,
                          tau: float, noised: bool):
    """Plain version of ``masked_col_matvec``."""
    return u @ _scaled_kernel(C, thresh, x_row, rowmin, eps, tau, noised)


def _vectors(thresh, x_row, rows, cols) -> dict:
    return dict(
        rows=[("thresh", thresh, torch.float32),
              ("x_row", x_row, torch.int32)]
        + [(name, t, torch.float32) for name, t in rows],
        cols=[(name, t, torch.float32) for name, t in cols],
    )


def _check_operands(C, thresh, x_row, rows=(), cols=()) -> tuple[int, int]:
    """Shapes, dtypes, devices and contiguity the kernels take; ``rows``
    and ``cols`` are extra f32 ``(name, tensor)`` vectors. Returns
    (n, m)."""
    return _build.check_operands(C, **_vectors(thresh, x_row, rows, cols))


def _check_cuda(C, thresh, x_row, rows=(), cols=()) -> tuple[int, int]:
    """Operands of a kernel launch: CUDA tensors the kernels take."""
    return _build.check_cuda(C, **_vectors(thresh, x_row, rows, cols))


def _launch(name: str, fn_name: str, device, *args) -> None:
    _build.launch(LIB, fn_name, device, *args)
    launches[name] += 1


def masked_row_min(C, thresh, x_row, *, tau: float, noised: bool):
    """min_m { f32(C[n, m]) : key(n, m) <= thresh[n] } -> f32[N]; exact,
    so the kernel and the plain version agree bitwise."""
    if C.device.type == "cpu":
        _build.check_cpu(thresh, x_row)
        return masked_row_min_ref(C, thresh, x_row, tau=tau, noised=noised)
    n, m = _check_cuda(C, thresh, x_row)
    out = torch.empty(n, dtype=torch.float32, device=C.device)
    if n:
        _launch(
            "masked_row_min", "mm_masked_row_min", C.device,
            C.data_ptr(), thresh.data_ptr(), x_row.data_ptr(),
            out.data_ptr(), n, m, tau, int(noised),
        )
    return out


def masked_row_matvec(C, thresh, x_row, rowmin, v, *, eps: float,
                      tau: float, noised: bool):
    """r = P @ v without materializing P -> f32[N]."""
    if C.device.type == "cpu":
        _build.check_cpu(thresh, x_row, rowmin, v)
        return masked_row_matvec_ref(
            C, thresh, x_row, rowmin, v, eps=eps, tau=tau, noised=noised
        )
    n, m = _check_cuda(
        C, thresh, x_row, rows=[("rowmin", rowmin)], cols=[("v", v)]
    )
    out = torch.empty(n, dtype=torch.float32, device=C.device)
    if n:
        _launch(
            "masked_row_matvec", "mm_masked_row_matvec", C.device,
            C.data_ptr(), thresh.data_ptr(), x_row.data_ptr(),
            rowmin.data_ptr(), v.data_ptr(), out.data_ptr(), n, m, eps, tau,
            int(noised),
        )
    return out


def masked_col_matvec(C, thresh, x_row, rowmin, u, *, eps: float,
                      tau: float, noised: bool):
    """c = u @ P without materializing P -> f32[M] (two passes: per-chunk
    partials, then a fixed-order sum; no float atomics)."""
    if C.device.type == "cpu":
        _build.check_cpu(thresh, x_row, rowmin, u)
        return masked_col_matvec_ref(
            C, thresh, x_row, rowmin, u, eps=eps, tau=tau, noised=noised
        )
    n, m = _check_cuda(
        C, thresh, x_row, rows=[("rowmin", rowmin), ("u", u)]
    )
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.float32, device=C.device)
    chunks = -(-n // ROWS_PER_CHUNK)
    partial = torch.empty(
        (chunks, m), dtype=torch.float32, device=C.device
    )
    out = torch.empty(m, dtype=torch.float32, device=C.device)
    _launch(
        "masked_col_matvec", "mm_masked_col_matvec", C.device,
        C.data_ptr(), thresh.data_ptr(), x_row.data_ptr(), rowmin.data_ptr(),
        u.data_ptr(), partial.data_ptr(), out.data_ptr(), n, m,
        ROWS_PER_CHUNK, eps, tau, int(noised),
    )
    return out
