"""Convergence-gated Sinkhorn loop shared by the sparse solve.

Port of ``SinkhornResult`` and ``gated_sinkhorn_loop`` from
``modelmesh_tpu/ops/sinkhorn.py``. The reference's ``lax.cond`` (warm
probe) and ``lax.while_loop`` (chunked iterations) become Python control
flow on 0-d tensors: one counted host sync for the probe and one per
chunk but the last (the budget ends the loop there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch import device as device_mod


class SinkhornResult(NamedTuple):
    f: torch.Tensor        # f32[N] row potentials
    g: torch.Tensor        # f32[M] column potentials
    row_err: torch.Tensor  # f32[] final L1 row-marginal error (diagnostic)
    # Iterations actually run (a host int: the loop ran on the host).
    iters_run: int = 0


def gated_sinkhorn_loop(
    run_iters, marginal_err, f_init, g_init, *,
    eps: float, iters: int, tol: float, chunk: int,
):
    """A single-iteration warm probe, then chunks of ``chunk`` iterations
    until the relative row-marginal error is <= ``tol`` or the budget
    (rounded up to probe + whole chunks) is spent.

    The probe's g-move ``dg`` bounds the relative row-marginal error by
    ~dg/eps, so ``dg <= tol * eps`` exits after one iteration and reports
    ``dg / eps`` as the error. Returns (f, g, row_err, iters_run)."""
    chunk = min(chunk, iters)
    n_chunks = -(-iters // chunk)

    f1, g1 = run_iters(f_init, g_init, 1)
    dg = (g1 - g_init).abs().max()
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
