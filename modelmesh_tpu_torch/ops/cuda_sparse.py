"""The sparse Sinkhorn's kernels: wrappers and plain versions.

Port of ``modelmesh_tpu/ops/pallas_sparse.py``. The noisy top-K candidate
mask is evaluated once per solve, by ``select_candidates`` (the top-K
gather, its K-th key as the row threshold, and ``masked_row_min``'s row
minimum and bits, in one pass over C) or, given the thresholds, by
``masked_row_min``, which also packs it into bits (int32[N, ceil(M / 32)], bit j of word w standing for column
32 w + j, bits past M zero). Every later pass streams the cost matrix C
and reads those bits, never a materialized bool mask or scaled kernel:

    rowmin[n] = min_m { C[n, m] : key(n, m) <= thresh[n] }
    r[n]      = sum_m bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * v[m]
    c[m]      = sum_n bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * u[n]

with ``key = f32(C) - tau * gumbel(row, col)`` (``selection_key``).
``masked_sinkhorn_step`` is one Sinkhorn iteration's pair in one pass over
C: r clamped to ``TINY``, and c for u = row_mass / r.

Each wrapper takes its kernel's plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the kernel in
``csrc/masked_sparse.cu`` (built at first use by ``_build``) or raises.
There is no fallback from one to the other. ``launches`` counts kernel
launches per wrapper.

The column products take ``col_psum``: the sum over the row blocks of a
sharded problem (``parallel.mesh.AxisSum`` over the model axis). On the
card each block's pass leaves its block partials, the shards' partials
are gathered in rank order and the combine runs once over all of them, so
blocks whose heights are multiples of ``ROWS_PER_BLOCK`` give the column
sums of the whole problem bit for bit; the combine is part of the
wrapper's launch and is not counted again. On the CPU the plain versions'
column sums are added over the shards (an ordinary sum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch.ops import _build, auction

LIB = "masked_sparse"
# Rows per block partial of the column products (8 warps of 32 rows; a
# multiple of 8). The partials' count follows from N alone, so the
# summation order does not depend on the card.
ROWS_PER_BLOCK = 256
# Widest C the fused step takes: one warp holds a whole row (4 16-byte
# loads per lane). Wider, the row and column products run back to back.
FUSED_MAX_COLS = 1024
# Floor of r in the fused step (the solve's numerical floor).
TINY = 1e-30
# Widest C select_candidates' kernel takes: a warp stages a row's keys in
# shared memory (csrc/masked_sparse.cu, kSelectMaxCols).
SELECT_MAX_COLS = 16384

# Kernel launches per wrapper since the process started (or the caller
# last zeroed them with reset_launches()).
launches = {
    "select_candidates": 0,
    "masked_row_min": 0,
    "masked_row_matvec": 0,
    "masked_col_matvec": 0,
    "masked_sinkhorn_step": 0,
}


class CandidateRows(NamedTuple):
    """What ``masked_row_min`` returns: the masked row minimum and the
    candidate mask as bits."""

    rowmin: torch.Tensor  # f32[N]
    bits: torch.Tensor    # i32[N, ceil(M / 32)]


class SelectedCandidates(NamedTuple):
    """What ``select_candidates`` returns: the top-K gather and, for the
    mask it defines, what ``masked_row_min`` returns."""

    idx: torch.Tensor     # i64[N, K] the K smallest keys' columns, ascending
    thresh: torch.Tensor  # f32[N] the K-th key
    rowmin: torch.Tensor  # f32[N]
    bits: torch.Tensor    # i32[N, ceil(M / 32)]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 tensor of the uint32 values."""
    return x.to(torch.int64) & 0xFFFFFFFF


def mask_words(m: int) -> int:
    """int32 words per row of the packed mask."""
    return -(-m // 32)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[N, M] -> int32[N, ceil(M / 32)]: bit j of word w is column
    32 w + j; bits past M are zero."""
    n, m = mask.shape
    words = mask_words(m)
    padded = torch.zeros((n, words * 32), dtype=torch.int64,
                         device=mask.device)
    padded[:, :m] = mask
    weights = 1 << torch.arange(32, dtype=torch.int64, device=mask.device)
    return _as_i32((padded.view(n, words, 32) * weights).sum(dim=2))


def unpack_mask(bits: torch.Tensor, m: int) -> torch.Tensor:
    """int32[N, ceil(M / 32)] -> bool[N, M] (``pack_mask`` undone)."""
    n, words = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    flat = ((bits[:, :, None] >> shifts) & 1).reshape(n, words * 32)
    return flat[:, :m].bool()


def noise_row_state(n: int, seed: int, device,
                    row_offset: int | None = None) -> torch.Tensor:
    """Row-side hash state ``fmix32(row ^ seed * 0xC2B2AE35)`` as int32
    bits — the (row, seed) prefix of ``auction.hash_gumbel_at``, computed
    once per solve so the kernels need only the column-side mix. Rows
    count from ``row_offset`` (mod 2**32): a block of rows gets the state
    of the same rows of the whole problem."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    if row_offset:
        rows = (rows + int(row_offset)) & 0xFFFFFFFF
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


def _scaled_kernel(C, bits, rowmin, eps):
    mask = unpack_mask(bits, C.shape[1])
    shifted = torch.exp((rowmin[:, None] - C.to(torch.float32)) / eps)
    return torch.where(mask, shifted, 0.0)


def masked_row_min_ref(C, thresh, x_row, *, tau: float,
                       noised: bool) -> CandidateRows:
    """Plain version of ``masked_row_min``."""
    mask = candidate_mask(C, thresh, x_row, tau=tau, noised=noised)
    rowmin = torch.where(mask, C.to(torch.float32), torch.inf).amin(dim=1)
    return CandidateRows(rowmin, pack_mask(mask))


def select_candidates_ref(C, x_row, k: int, *, tau: float,
                          noised: bool) -> SelectedCandidates:
    """Plain version of ``select_candidates``: the PyTorch-op key, the
    tie-stable top-K (ties to the lower column, as ``jax.lax.top_k`` on
    -key), the K-th key via a min over the descending values (as the
    reference takes it), then ``masked_row_min_ref``."""
    key = selection_key(C, x_row, tau=tau, noised=noised)
    neg_vals, idx = auction.top_k(-key, k)
    idx = idx.contiguous()  # frees the sorted rows it is a view of
    thresh = -neg_vals.amin(dim=1)
    rowmin, bits = masked_row_min_ref(C, thresh, x_row, tau=tau,
                                      noised=noised)
    return SelectedCandidates(idx, thresh, rowmin, bits)


def masked_row_matvec_ref(C, bits, rowmin, v, *, eps: float):
    """Plain version of ``masked_row_matvec``."""
    return _scaled_kernel(C, bits, rowmin, eps) @ v


def masked_col_matvec_ref(C, bits, rowmin, u, *, eps: float):
    """Plain version of ``masked_col_matvec``."""
    return u @ _scaled_kernel(C, bits, rowmin, eps)


def masked_sinkhorn_step_ref(C, bits, rowmin, v, row_mass, *, eps: float):
    """Plain version of ``masked_sinkhorn_step``: the row product, the
    clamp, the division and the column product, op for op."""
    P = _scaled_kernel(C, bits, rowmin, eps)
    r = torch.clamp_min(P @ v, TINY)
    return r, (row_mass / r) @ P


def _check_bits(C, bits) -> None:
    """The packed mask of C: int32[N, ceil(M / 32)], contiguous, on C's
    device (the plain versions check it too)."""
    n, m = C.shape
    words = mask_words(m)
    if bits.dtype != torch.int32 or bits.shape != (n, words):
        raise TypeError(
            f"bits must be int32[{n}, {words}] (got {bits.dtype}"
            f"{list(bits.shape)})"
        )
    if bits.device != C.device:
        raise ValueError(f"bits is on {bits.device}, C on {C.device}")
    if not bits.is_contiguous():
        raise ValueError("bits must be contiguous")


def _check_operands(C, rows=(), cols=(), bits=None) -> tuple[int, int]:
    """Shapes, dtypes, devices and contiguity the kernels take: ``rows``
    and ``cols`` are ``(name, tensor, dtype)`` vectors of C's row and
    column count, ``bits`` the packed mask. Returns (n, m)."""
    n, m = _build.check_operands(C, rows=rows, cols=cols)
    if bits is not None:
        _check_bits(C, bits)
    return n, m


def _check_cuda(C, rows=(), cols=(), bits=None) -> tuple[int, int]:
    """Operands of a kernel launch: CUDA tensors the kernels take."""
    if C.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {C.device}")
    return _check_operands(C, rows, cols, bits)


def _check_plain(C, bits, *vectors) -> None:
    """Operands of a plain version: on the CPU, and the bits C's."""
    _build.check_cpu(bits, *vectors)
    _check_bits(C, bits)


def _f32(**named) -> list:
    return [(name, t, torch.float32) for name, t in named.items()]


def _launch(name: str, fn_name: str, device, *args) -> None:
    _build.launch(LIB, fn_name, device, *args)
    _build.count_launch(launches, name)


def _combine_cols(partial: torch.Tensor) -> torch.Tensor:
    """The fixed-order sum of block partials f32[parts, M] -> f32[M]."""
    parts, m = partial.shape
    out = torch.empty(m, dtype=torch.float32, device=partial.device)
    _build.launch(LIB, "mm_col_combine", partial.device,
                  partial.contiguous().data_ptr(), out.data_ptr(), parts, m)
    return out


def masked_row_min(C, thresh, x_row, *, tau: float,
                   noised: bool) -> CandidateRows:
    """min_m { f32(C[n, m]) : key(n, m) <= thresh[n] } -> f32[N], and the
    mask as bits; exact, so the kernel and the plain version agree
    bitwise."""
    if C.device.type == "cpu":
        _build.check_cpu(thresh, x_row)
        return masked_row_min_ref(C, thresh, x_row, tau=tau, noised=noised)
    n, m = _check_cuda(
        C, rows=[("thresh", thresh, torch.float32),
                 ("x_row", x_row, torch.int32)],
    )
    out = torch.empty(n, dtype=torch.float32, device=C.device)
    bits = torch.empty((n, mask_words(m)), dtype=torch.int32,
                       device=C.device)
    if n:
        _launch(
            "masked_row_min", "mm_masked_row_min", C.device,
            C.data_ptr(), thresh.data_ptr(), x_row.data_ptr(),
            out.data_ptr(), bits.data_ptr(), n, m, tau, int(noised),
        )
    return CandidateRows(out, bits)


def select_candidates(C, x_row, k: int, *, tau: float, noised: bool,
                      exact_counts: torch.Tensor | None = None
                      ) -> SelectedCandidates:
    """Each row's ``min(k, M)`` smallest selection keys (ascending, ties to
    the lower column), the K-th key as the row threshold, and the masked
    row minimum and mask bits under it; exact, so the kernel and the plain
    version agree bitwise. ``exact_counts`` (int32[N], kernel only) takes
    the entries per row whose exact key the kernel computed (the guard
    band's members)."""
    k = min(int(k), C.shape[1])
    if k < 1:
        raise ValueError(f"k={k}: select at least one column")
    if C.device.type == "cpu":
        _build.check_cpu(x_row)
        if exact_counts is not None:
            raise ValueError("exact_counts is the kernel's diagnostic")
        return select_candidates_ref(C, x_row, k, tau=tau, noised=noised)
    n, m = _check_cuda(C, rows=[("x_row", x_row, torch.int32)])
    if m > SELECT_MAX_COLS:
        raise ValueError(f"select_candidates takes at most "
                         f"{SELECT_MAX_COLS} columns (got {m})")
    if exact_counts is not None:
        _build.check_vectors(C, rows=[("exact_counts", exact_counts,
                                       torch.int32)])
    dev = C.device
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    thresh = torch.empty(n, dtype=torch.float32, device=dev)
    rowmin = torch.empty(n, dtype=torch.float32, device=dev)
    bits = torch.empty((n, mask_words(m)), dtype=torch.int32, device=dev)
    if n:
        _launch(
            "select_candidates", "mm_select_candidates", dev,
            C.data_ptr(), x_row.data_ptr(), idx.data_ptr(),
            thresh.data_ptr(), rowmin.data_ptr(), bits.data_ptr(),
            None if exact_counts is None else exact_counts.data_ptr(),
            n, m, k, tau, int(noised),
        )
    return SelectedCandidates(idx, thresh, rowmin, bits)


def gumbel_err(device) -> tuple[float, float]:
    """The guard band's check, on the card: the largest |g - g'| between
    the exact and the fast hash-Gumbel draw over all 2^24 uniforms, and
    the bound the kernels were built with."""
    lib = _build.load_library(LIB)
    out = torch.empty(1 + lib.mm_gumbel_err_blocks(), dtype=torch.float32,
                      device=device)
    _build.launch(LIB, "mm_gumbel_err", out.device, out.data_ptr())
    got = out.cpu()
    errs = got[1:]
    worst = float("nan") if torch.isnan(errs).any() else float(errs.max())
    return worst, float(got[0])


def masked_row_matvec(C, bits, rowmin, v, *, eps: float):
    """r = P @ v without materializing P -> f32[N]."""
    if C.device.type == "cpu":
        _check_plain(C, bits, rowmin, v)
        return masked_row_matvec_ref(C, bits, rowmin, v, eps=eps)
    n, m = _check_cuda(C, rows=_f32(rowmin=rowmin), cols=_f32(v=v),
                       bits=bits)
    out = torch.empty(n, dtype=torch.float32, device=C.device)
    if n:
        _launch(
            "masked_row_matvec", "mm_masked_row_matvec", C.device,
            C.data_ptr(), bits.data_ptr(), rowmin.data_ptr(), v.data_ptr(),
            out.data_ptr(), n, m, eps,
        )
    return out


def masked_col_matvec(C, bits, rowmin, u, *, eps: float, col_psum=None):
    """c = u @ P without materializing P -> f32[M] (block partials, then a
    fixed-order sum; no float atomics). ``col_psum``: summed over the row
    blocks of a sharded problem (module docstring)."""
    if C.device.type == "cpu":
        _check_plain(C, bits, rowmin, u)
        c = masked_col_matvec_ref(C, bits, rowmin, u, eps=eps)
        return c if col_psum is None else col_psum(c)
    n, m = _check_cuda(C, rows=_f32(rowmin=rowmin, u=u), bits=bits)
    if n == 0 or m == 0:
        return torch.zeros(m, dtype=torch.float32, device=C.device)
    partial = torch.empty((-(-n // ROWS_PER_BLOCK), m), dtype=torch.float32,
                          device=C.device)
    out = (torch.empty(m, dtype=torch.float32, device=C.device)
           if col_psum is None else None)
    _launch(
        "masked_col_matvec", "mm_masked_col_matvec", C.device,
        C.data_ptr(), bits.data_ptr(), rowmin.data_ptr(), u.data_ptr(),
        partial.data_ptr(), None if out is None else out.data_ptr(), n, m,
        ROWS_PER_BLOCK, eps,
    )
    return out if col_psum is None else col_psum.combine(_combine_cols,
                                                         partial)


def masked_sinkhorn_step(C, bits, rowmin, v, row_mass, *, eps: float,
                         col_psum=None):
    """One Sinkhorn iteration's products in one pass over C (at most
    FUSED_MAX_COLS columns): r = max(P @ v, TINY) -> f32[N] and
    c = (row_mass / r) @ P -> f32[M], ``col_psum`` summing c over the row
    blocks of a sharded problem (module docstring)."""
    if C.shape[-1] > FUSED_MAX_COLS:
        raise ValueError(
            f"masked_sinkhorn_step takes at most {FUSED_MAX_COLS} columns "
            f"(got {C.shape[-1]}): run masked_row_matvec and "
            "masked_col_matvec"
        )
    if C.device.type == "cpu":
        _check_plain(C, bits, rowmin, v, row_mass)
        r, c = masked_sinkhorn_step_ref(C, bits, rowmin, v, row_mass,
                                        eps=eps)
        return r, (c if col_psum is None else col_psum(c))
    n, m = _check_cuda(C, rows=_f32(rowmin=rowmin, row_mass=row_mass),
                       cols=_f32(v=v), bits=bits)
    if n == 0 or m == 0:
        return (torch.full((n,), TINY, device=C.device),
                torch.zeros(m, dtype=torch.float32, device=C.device))
    r = torch.empty(n, dtype=torch.float32, device=C.device)
    partial = torch.empty((-(-n // ROWS_PER_BLOCK), m), dtype=torch.float32,
                          device=C.device)
    c = (torch.empty(m, dtype=torch.float32, device=C.device)
         if col_psum is None else None)
    _launch(
        "masked_sinkhorn_step", "mm_masked_sinkhorn_step", C.device,
        C.data_ptr(), bits.data_ptr(), rowmin.data_ptr(), v.data_ptr(),
        row_mass.data_ptr(), r.data_ptr(), partial.data_ptr(),
        None if c is None else c.data_ptr(), n, m, ROWS_PER_BLOCK, eps,
    )
    return r, (c if col_psum is None
               else col_psum.combine(_combine_cols, partial))
