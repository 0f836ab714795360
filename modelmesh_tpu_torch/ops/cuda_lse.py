"""The dense Sinkhorn's fused LSE kernels: wrappers and plain versions.

Port of ``modelmesh_tpu/ops/pallas_lse.py``. Each partial streams the
cost matrix C once and returns the online-LSE pair (running max ``m``,
rescaled sum ``s``) of

    row: z[n, m] = (g[m] - C[n, m]) / eps   over m  -> f32[N] pair
    col: z[n, m] = (f[n] - C[n, m]) / eps   over n  -> f32[M] pair

so that ``LSE = log(max(s, 1e-30)) + m`` (``row_lse``/``col_lse``), and
partials over disjoint slices combine as ``M = max(m1, m2); s = s1 *
exp(m1 - M) + s2 * exp(m2 - M)`` (how a sharded solver will combine
ranks). The reference pads C to its tile grid (``pad_cost``); the kernels
bounds-check the ragged edge instead, so nothing is padded here.

``lse_sinkhorn_step`` is one dense Sinkhorn iteration's pair in one pass
over C (at most ``FUSED_MAX_COLS`` columns): ``f = eps * (log_a -
row_lse(C, g))`` and the column pair of that f.

The plain versions divide by eps, as the XLA reference spells it. The
kernels multiply by ``inv_eps``, the f32 reciprocal that PyTorch's own
CUDA division by a scalar multiplies by, so on the card a kernel's z is
bit for bit the plain version's.

Each wrapper takes its kernel's plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the kernel in ``csrc/lse.cu`` (built
at first use by ``_build``) or raises. There is no fallback from one to
the other. ``launches`` counts kernel launches per wrapper.

The column passes take ``col_psum``: the combine over the row blocks of a
sharded problem (``parallel.mesh.AxisSum`` over the model axis). On the
card each block's pass leaves its block partials, the shards' partials
are gathered in rank order and the combine runs once over all of them, so
blocks whose heights are multiples of ``ROWS_PER_BLOCK`` give the column
pair of the whole problem bit for bit; the combine is part of the
wrapper's launch and is not counted again. On the CPU each shard's pair
is one partial of ``combine_pairs_ref``.
"""

from __future__ import annotations

import numpy as np
import torch

from modelmesh_tpu_torch.ops import _build

LIB = "lse"
# Rows per block of the column kernels, and so per partial of their
# reductions (one scratch row each; a multiple of 64). Fixed, so the
# combine order follows from N alone and does not depend on the card.
ROWS_PER_BLOCK = 256
# Widest C the fused step takes: a row group holds a whole row (32 lanes x
# 4 16-byte loads). Wider, the row and column passes run back to back.
FUSED_MAX_COLS = 1024
# Floor on the rescaled sum before the log (the reference's 1e-30).
_TINY = 1e-30

# Kernel launches per wrapper since the process started (or the caller
# last zeroed them with reset_launches()).
launches = {
    "row_lse_partial": 0,
    "col_lse_partial": 0,
    "lse_sinkhorn_step": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def inv_eps_of(eps: float) -> float:
    """The f32 reciprocal of eps that the kernels multiply by: what
    PyTorch's CUDA ``x / eps`` multiplies by."""
    return float(np.float32(1) / np.float32(eps))


def row_lse_partial_ref(C, g, eps: float):
    """Plain version of ``row_lse_partial``."""
    z = (g[None, :] - C.to(torch.float32)) / eps
    m = z.amax(dim=1)
    return m, torch.exp(z - m[:, None]).sum(dim=1)


def col_lse_partial_ref(C, f, eps: float):
    """Plain version of ``col_lse_partial``."""
    z = (f[:, None] - C.to(torch.float32)) / eps
    m = z.amax(dim=0)
    return m, torch.exp(z - m[None, :]).sum(dim=0)


def lse_sinkhorn_step_ref(C, g, log_a, eps: float):
    """Plain version of ``lse_sinkhorn_step``: the two plain partials
    composed, op for op what the unfused iteration computes."""
    f = eps * (log_a - lse_of(*row_lse_partial_ref(C, g, eps)))
    return (f, *col_lse_partial_ref(C, f, eps))


def _empty_pair(size: int, device):
    """The (m, s) of a reduction over nothing: (-inf, 0) each."""
    return (torch.full((size,), -torch.inf, dtype=torch.float32,
                       device=device),
            torch.zeros(size, dtype=torch.float32, device=device))


def _partials(n: int, m: int, device):
    """Scratch of the column reductions' block partials (m, s):
    f32[ceil(n / ROWS_PER_BLOCK), m] each."""
    m_part = torch.empty((-(-n // ROWS_PER_BLOCK), m), dtype=torch.float32,
                         device=device)
    return m_part, torch.empty_like(m_part)


def _launch(name: str, fn_name: str, device, *args) -> None:
    _build.launch(LIB, fn_name, device, *args)
    _build.count_launch(launches, name)


def combine_pairs_ref(m_part, s_part):
    """The (m, s) of partials f32[K, M] over disjoint row slices, combined
    in order: ``M = max_k m_k``, ``s = sum_k s_k * exp(m_k - M)`` (an empty
    partial, m = -inf, adds 0). One partial is returned as it is."""
    if m_part.shape[0] == 1:
        return m_part[0], s_part[0]
    mx = m_part.amax(dim=0)
    s = torch.zeros_like(mx)
    for m_k, s_k in zip(m_part, s_part):
        e = torch.exp(torch.where(m_k == -torch.inf, -torch.inf, m_k - mx))
        s = s + s_k * e
    return mx, s


def _combine_pairs(m_part, s_part):
    """The fixed-order combine of block partials f32[chunks, M] (each of
    m and s) -> two f32[M], on the card."""
    chunks, m = m_part.shape
    m_out = torch.empty(m, dtype=torch.float32, device=m_part.device)
    s_out = torch.empty(m, dtype=torch.float32, device=m_part.device)
    _build.launch(LIB, "mm_lse_col_combine", m_part.device,
                  m_part.contiguous().data_ptr(),
                  s_part.contiguous().data_ptr(), m_out.data_ptr(),
                  s_out.data_ptr(), chunks, m)
    return m_out, s_out


def _sum_pairs_ref(col_psum, pair):
    """A CPU column pair combined over the shards (``col_psum``)."""
    if col_psum is None:
        return pair
    return col_psum.combine(combine_pairs_ref, pair[0][None], pair[1][None])


def row_lse_partial(C, g, eps: float):
    """(m, s) of logsumexp_m (g[m] - C[n, m]) / eps -> two f32[N]."""
    if C.device.type == "cpu":
        _build.check_cpu(g)
        return row_lse_partial_ref(C, g, eps)
    n, m = _build.check_cuda(C, cols=[("g", g, torch.float32)])
    if n == 0 or m == 0:
        return _empty_pair(n, C.device)
    m_out = torch.empty(n, dtype=torch.float32, device=C.device)
    s_out = torch.empty(n, dtype=torch.float32, device=C.device)
    _launch(
        "row_lse_partial", "mm_row_lse_partial", C.device, C.data_ptr(),
        g.data_ptr(), m_out.data_ptr(), s_out.data_ptr(), n, m,
        inv_eps_of(eps),
    )
    return m_out, s_out


def col_lse_partial(C, f, eps: float, col_psum=None):
    """(m, s) of logsumexp_n (f[n] - C[n, m]) / eps -> two f32[M] (block
    partials, then a fixed-order combine; no float atomics), ``col_psum``
    combining over the row blocks of a sharded problem (module
    docstring)."""
    if C.device.type == "cpu":
        _build.check_cpu(f)
        return _sum_pairs_ref(col_psum, col_lse_partial_ref(C, f, eps))
    n, m = _build.check_cuda(C, rows=[("f", f, torch.float32)])
    if n == 0 or m == 0:
        return _empty_pair(m, C.device)
    m_part, s_part = _partials(n, m, C.device)
    if col_psum is None:
        m_out = torch.empty(m, dtype=torch.float32, device=C.device)
        s_out = torch.empty(m, dtype=torch.float32, device=C.device)
    else:
        m_out = s_out = None
    _launch(
        "col_lse_partial", "mm_col_lse_partial", C.device, C.data_ptr(),
        f.data_ptr(), m_part.data_ptr(), s_part.data_ptr(),
        None if m_out is None else m_out.data_ptr(),
        None if s_out is None else s_out.data_ptr(), n, m, ROWS_PER_BLOCK,
        inv_eps_of(eps),
    )
    if col_psum is None:
        return m_out, s_out
    return col_psum.combine(_combine_pairs, m_part, s_part)


def lse_sinkhorn_step(C, g, log_a, eps: float, col_psum=None):
    """One dense Sinkhorn iteration's LSE passes in one pass over C (at
    most FUSED_MAX_COLS columns): f = eps * (log_a - row_lse(C, g))
    -> f32[N], and the column pair (m, s) of that f -> two f32[M],
    ``col_psum`` combining it over the row blocks of a sharded problem
    (module docstring)."""
    if C.shape[-1] > FUSED_MAX_COLS:
        raise ValueError(
            f"lse_sinkhorn_step takes at most {FUSED_MAX_COLS} columns "
            f"(got {C.shape[-1]}): run row_lse and col_lse"
        )
    operands = dict(rows=[("log_a", log_a, torch.float32)],
                    cols=[("g", g, torch.float32)])
    if C.device.type == "cpu":
        _build.check_cpu(g, log_a)
        _build.check_vectors(C, **operands)
        f, *pair = lse_sinkhorn_step_ref(C, g, log_a, eps)
        return (f, *_sum_pairs_ref(col_psum, pair))
    n, m = _build.check_cuda(C, **operands)
    if n == 0 or m == 0:
        empty_rows = _empty_pair(n, C.device)
        return (eps * (log_a - lse_of(*empty_rows)), *_empty_pair(m, C.device))
    f = torch.empty(n, dtype=torch.float32, device=C.device)
    m_part, s_part = _partials(n, m, C.device)
    if col_psum is None:
        m_out = torch.empty(m, dtype=torch.float32, device=C.device)
        s_out = torch.empty(m, dtype=torch.float32, device=C.device)
    else:
        m_out = s_out = None
    _launch(
        "lse_sinkhorn_step", "mm_lse_sinkhorn_step", C.device, C.data_ptr(),
        g.data_ptr(), log_a.data_ptr(), f.data_ptr(), m_part.data_ptr(),
        s_part.data_ptr(), None if m_out is None else m_out.data_ptr(),
        None if s_out is None else s_out.data_ptr(), n, m, ROWS_PER_BLOCK,
        eps, inv_eps_of(eps),
    )
    if col_psum is None:
        return f, m_out, s_out
    return (f, *col_psum.combine(_combine_pairs, m_part, s_part))


def lse_of(m, s):
    """The LSE of an online-LSE pair: log(max(s, 1e-30)) + m."""
    return torch.log(torch.clamp_min(s, _TINY)) + m


def row_lse(C, g, eps: float):
    """logsumexp_m (g[m] - C[n, m]) / eps -> f32[N]."""
    return lse_of(*row_lse_partial(C, g, eps))


def col_lse(C, f, eps: float, col_psum=None):
    """logsumexp_n (f[n] - C[n, m]) / eps -> f32[M] (``col_psum`` as
    ``col_lse_partial`` takes it)."""
    return lse_of(*col_lse_partial(C, f, eps, col_psum=col_psum))
