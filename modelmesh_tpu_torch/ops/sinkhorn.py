"""Log-domain Sinkhorn for the placement transport prior.

Port of ``modelmesh_tpu/ops/sinkhorn.py``: the dense-tier ``sinkhorn``
over the full cost matrix, whose two LSE passes per iteration run through
the fused kernels of ``cuda_lse``; ``plan_logits``; and the convergence
gate both the dense and the sparse Sinkhorn share. The reference's
``lax.cond`` (warm probe) and ``lax.while_loop`` (chunked iterations)
become Python control flow on 0-d tensors: one counted host sync for the
probe and one per chunk but the last (the budget ends the loop there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import cuda_lse

_TINY = 1e-30


class SinkhornResult(NamedTuple):
    f: torch.Tensor        # f32[N] row potentials
    g: torch.Tensor        # f32[M] column potentials
    row_err: torch.Tensor  # f32[] final L1 row-marginal error (diagnostic)
    # Iterations actually run (a host int: the loop ran on the host).
    iters_run: int = 0


def resolve_lse_impl(lse_impl: str, device) -> str:
    """The LSE kernels' backend: "cuda" | "plain"
    (``device.resolve_kernel_impl``). The reference's "xla" and "pallas"
    are not values of the port."""
    return device_mod.resolve_kernel_impl("lse_impl", lse_impl, device)


def gated_sinkhorn_loop(
    run_iters, marginal_err, f_init, g_init, *,
    eps: float, iters: int, tol: float, chunk: int, dg_reduce=None,
):
    """A single-iteration warm probe, then chunks of ``chunk`` iterations
    until the relative row-marginal error is <= ``tol`` or the budget
    (rounded up to probe + whole chunks) is spent.

    The probe's g-move ``dg`` bounds the relative row-marginal error by
    ~dg/eps, so ``dg <= tol * eps`` exits after one iteration and reports
    ``dg / eps`` as the error. ``dg_reduce`` makes dg the same on every
    shard of a sharded solve (a max over the mesh axis g is split on), so
    every shard takes the same branch. Returns (f, g, row_err,
    iters_run)."""
    chunk = min(chunk, iters)
    n_chunks = -(-iters // chunk)

    f1, g1 = run_iters(f_init, g_init, 1)
    dg = (g1 - g_init).abs().max()
    if dg_reduce is not None:
        dg = dg_reduce(dg)
    if device_mod.item(dg <= tol * eps):
        return f1, g1, dg / eps, 1

    f, g, step = f1, g1, 0
    while True:
        f, g = run_iters(f, g, chunk)
        err = marginal_err(f, g)
        step += 1
        # The last chunk needs no gate read: the budget ends the loop.
        if step >= n_chunks or not device_mod.item(err > tol):
            return f, g, err, step * chunk + 1


def run_sinkhorn(run_iters, marginal_err, n: int, g0, log_b, *,
                 eps: float, iters: int, tol: float,
                 chunk: int, dg_reduce=None) -> SinkhornResult:
    """Drive ``run_iters(f, g, length)`` from f = 0 and ``g0`` (clamped to
    the g <= 0 invariant; zeros when None): a fixed budget when the gate
    is off (``tol``, ``chunk`` or ``iters`` <= 0), else
    ``gated_sinkhorn_loop`` (with ``dg_reduce``)."""
    f_init = torch.zeros(n, dtype=torch.float32, device=log_b.device)
    g_init = (
        torch.clamp_max(g0.to(torch.float32), 0.0)
        if g0 is not None else torch.zeros_like(log_b)
    )
    # iters <= 0 keeps the fixed path: the probe would run one unbudgeted
    # iteration.
    if tol <= 0.0 or chunk <= 0 or iters <= 0:
        f, g = run_iters(f_init, g_init, iters)
        return SinkhornResult(
            f=f, g=g, row_err=marginal_err(f, g), iters_run=iters
        )
    return SinkhornResult(*gated_sinkhorn_loop(
        run_iters, marginal_err, f_init, g_init,
        eps=eps, iters=iters, tol=tol, chunk=chunk, dg_reduce=dg_reduce,
    ))


def sinkhorn(
    C: torch.Tensor,
    row_mass: torch.Tensor,
    col_mass: torch.Tensor,
    *,
    eps: float = 0.05,
    iters: int = 12,
    lse_impl: str = "auto",
    g0: torch.Tensor | None = None,
    tol: float = 0.0,
    chunk: int = 4,
) -> SinkhornResult:
    """Semi-unbalanced log-domain Sinkhorn over the full cost matrix: rows
    are equalities (every model's copy-mass places), columns are caps
    (``g <= 0``). Each iteration is

        f = eps * (log a - row_lse(C, g))
        g = min(0, eps * (log b - col_lse(C, f)))

    with both LSE passes in the fused kernels (CUDA tensors) or their
    plain versions (CPU tensors): up to ``FUSED_MAX_COLS`` columns one
    pass over C per iteration (``lse_sinkhorn_step``), wider the row and
    column passes back to back. ``g0`` warm-starts the column potentials;
    ``tol`` > 0 enables the convergence gate (``gated_sinkhorn_loop``)."""
    resolve_lse_impl(lse_impl, C.device)
    row_mass = row_mass.to(torch.float32)
    col_mass = col_mass.to(torch.float32)
    log_a = torch.log(torch.clamp_min(row_mass, _TINY))
    log_b = torch.log(torch.clamp_min(col_mass, _TINY))
    one_pass = C.shape[1] <= cuda_lse.FUSED_MAX_COLS

    def run_iters(f, g, length):
        for _ in range(length):
            if one_pass:
                f, m, s = cuda_lse.lse_sinkhorn_step(C, g, log_a, eps)
                col = cuda_lse.lse_of(m, s)
            else:
                f = eps * (log_a - cuda_lse.row_lse(C, g, eps))
                col = cuda_lse.col_lse(C, f, eps)
            g = torch.clamp_max(eps * (log_b - col), 0.0)
        return f, g

    def marginal_err(f, g):
        # Relative L1 row-marginal violation of the implied plan.
        row_sum = torch.exp((f + eps * cuda_lse.row_lse(C, g, eps)) / eps)
        return (row_sum - row_mass).abs().mean() / torch.clamp_min(
            row_mass.mean(), _TINY
        )

    return run_sinkhorn(
        run_iters, marginal_err, C.shape[0], g0, log_b,
        eps=eps, iters=iters, tol=tol, chunk=chunk,
    )


def plan_logits(C: torch.Tensor, f: torch.Tensor, g: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Soft-assignment logits (f[n] + g[m] - C[n, m]) / eps, in C's dtype
    (the big buffer stays narrow)."""
    z = (f[:, None] + g[None, :] - C.to(torch.float32)) / eps
    return z.to(C.dtype)
