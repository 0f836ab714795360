"""The dense Sinkhorn's two fused LSE kernels: wrappers and plain versions.

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

Each wrapper takes its kernel's plain PyTorch version only for tensors on
the CPU; for CUDA tensors it launches the kernel in ``csrc/lse.cu`` (built
at first use by ``_build``) or raises. There is no fallback from one to
the other. ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from modelmesh_tpu_torch.ops import _build

LIB = "lse"
# Rows per partial of the two-pass column reduction (one scratch row each).
ROWS_PER_CHUNK = 256
# Floor on the rescaled sum before the log (the reference's 1e-30).
_TINY = 1e-30

# Kernel launches per wrapper since the process started (or the caller
# last zeroed them with reset_launches()).
launches = {
    "row_lse_partial": 0,
    "col_lse_partial": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def row_lse_partial(C, g, eps: float):
    """(m, s) of logsumexp_m (g[m] - C[n, m]) / eps -> two f32[N]."""
    if C.device.type == "cpu":
        _build.check_cpu(g)
        return row_lse_partial_ref(C, g, eps)
    n, m = _build.check_cuda(C, cols=[("g", g, torch.float32)])
    m_out = torch.empty(n, dtype=torch.float32, device=C.device)
    s_out = torch.empty(n, dtype=torch.float32, device=C.device)
    if n:
        _build.launch(
            LIB, "mm_row_lse_partial", C.device, C.data_ptr(), g.data_ptr(),
            m_out.data_ptr(), s_out.data_ptr(), n, m, eps,
        )
        launches["row_lse_partial"] += 1
    return m_out, s_out


def col_lse_partial(C, f, eps: float):
    """(m, s) of logsumexp_n (f[n] - C[n, m]) / eps -> two f32[M] (two
    passes: per-chunk partials, then a fixed-order combine; no float
    atomics)."""
    if C.device.type == "cpu":
        _build.check_cpu(f)
        return col_lse_partial_ref(C, f, eps)
    n, m = _build.check_cuda(C, rows=[("f", f, torch.float32)])
    m_out = torch.full((m,), -torch.inf, dtype=torch.float32, device=C.device)
    s_out = torch.zeros(m, dtype=torch.float32, device=C.device)
    if n and m:
        chunks = -(-n // ROWS_PER_CHUNK)
        m_part = torch.empty((chunks, m), dtype=torch.float32, device=C.device)
        s_part = torch.empty_like(m_part)
        _build.launch(
            LIB, "mm_col_lse_partial", C.device, C.data_ptr(), f.data_ptr(),
            m_part.data_ptr(), s_part.data_ptr(), m_out.data_ptr(),
            s_out.data_ptr(), n, m, ROWS_PER_CHUNK, eps,
        )
        launches["col_lse_partial"] += 1
    return m_out, s_out


def lse_of(m, s):
    """The LSE of an online-LSE pair: log(max(s, 1e-30)) + m."""
    return torch.log(torch.clamp_min(s, _TINY)) + m


def row_lse(C, g, eps: float):
    """logsumexp_m (g[m] - C[n, m]) / eps -> f32[N]."""
    return lse_of(*row_lse_partial(C, g, eps))


def col_lse(C, f, eps: float):
    """logsumexp_n (f[n] - C[n, m]) / eps -> f32[M]."""
    return lse_of(*col_lse_partial(C, f, eps))
