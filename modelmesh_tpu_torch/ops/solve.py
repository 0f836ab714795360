"""Single-device global placement solve: the config, result and entry.

Port of ``modelmesh_tpu/ops/solve.py``. A config with ``0 < topk < M``
runs the sparse top-K pipeline (``ops/sparse.py``); any other runs the
dense tier: cost -> full-width Sinkhorn (the LSE kernels) -> plan logits
-> dense auction. The solve runs on the device its problem's tensors are
on. ``solve_placement_incremental`` re-selects a few rows against a
previous solve's frozen column state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch.ops import costs as costs_mod
from modelmesh_tpu_torch.ops.auction import (
    MAX_COPIES,
    auction,
    check_auction_config,
)
from modelmesh_tpu_torch.ops.sinkhorn import plan_logits, sinkhorn
from modelmesh_tpu_torch.ops.sparse import resolve_dirty_rows, solve_sparse


class SolveConfig(NamedTuple):
    """The reference's solver knobs (ops/solve.py documents each one)."""

    eps: float = 0.05
    sinkhorn_iters: int = 10
    auction_iters: int = 40
    eta: float = 0.5
    sinkhorn_tol: float = 0.0
    sinkhorn_chunk: int = 4
    auction_stall_tol: float = 0.0
    tau: float = 1.0
    weights: costs_mod.CostWeights = costs_mod.CostWeights()
    # Dense-tier LSE kernels: auto (CUDA kernels for CUDA tensors, their
    # plain PyTorch versions for CPU tensors) | cuda (CUDA tensors required).
    lse_impl: str = "auto"
    # Implied-load histogram: auto (fused for CUDA tensors, scatter for
    # CPU tensors) | scatter (index_add_; not reproducible on the card) |
    # fused (the fixed-order kernel; on the CPU its one-hot plain version).
    load_impl: str = "auto"
    # Rounding noise: hash (the counter-based draw) | threefry (JAX's
    # PRNG, ``jax.random.gumbel``; the sparse tier refuses it at tau > 0,
    # so the dispatch routes it dense).
    noise_impl: str = "hash"
    final_select: str = "exact"
    # Sparse top-K candidate width: > 0 (and < M) solves sparse.
    topk: int = 0
    # Sparse per-iteration selection width: 0 = MAX_COPIES.
    sel_width: int = 0
    # Cost-matrix dtype. The CUDA kernels take bf16 (the production
    # dtype); f32 runs only through the plain versions, on CPU tensors.
    dtype: torch.dtype = torch.bfloat16
    # Let the dispatch layer swap dense-default knobs for the sparse-tier
    # defaults when it routes sparse.
    tier_defaults: bool = True
    # Sparse kernels: auto (CUDA kernels for CUDA tensors, their plain
    # PyTorch versions for CPU tensors) | cuda (CUDA tensors required).
    sparse_impl: str = "auto"


class Placement(NamedTuple):
    """Integral global placement plan (device tensors)."""

    indices: torch.Tensor   # i64[N, MAX_COPIES]
    valid: torch.Tensor     # bool[N, MAX_COPIES]
    load: torch.Tensor      # f32[M]
    overflow: torch.Tensor  # f32[]
    row_err: torch.Tensor   # f32[] sinkhorn marginal diagnostic
    f: torch.Tensor | None = None       # f32[N] row potentials
    g: torch.Tensor | None = None       # f32[M] column potentials
    prices: torch.Tensor | None = None  # f32[M] warm-start prices
    # Iterations each stage ran (host ints: the gates ran on the host).
    sinkhorn_iters_run: int | None = None
    auction_iters_run: int | None = None


class SolveInit(NamedTuple):
    """Warm-start carry from a previous solve, column-aligned to the
    current problem: Sinkhorn column potentials and auction prices."""

    g0: torch.Tensor                  # f32[M]
    price0: torch.Tensor | None = None  # f32[M] (None = cold prices)


def solve_placement(
    problem: costs_mod.PlacementProblem,
    config: SolveConfig = SolveConfig(),
    seed: int = 0x5EED,
    init: SolveInit | None = None,
):
    """Solve one global placement on the problem's device. ``seed`` varies
    the rounding draw per solve; ``init`` warm-starts the Sinkhorn
    potentials and (with ``init.price0``) the auction prices."""
    if config.topk > 0 and config.topk < problem.num_instances:
        return solve_sparse(problem, config, seed, init)
    return _solve_dense(problem, config, seed, init)


def _solve_dense(problem, config: SolveConfig, seed: int, init) -> Placement:
    check_auction_config(
        noise_impl=config.noise_impl, final_select=config.final_select,
        iters=config.auction_iters, load_impl=config.load_impl,
    )
    C = costs_mod.assemble_cost(
        problem, weights=config.weights, dtype=config.dtype
    )
    # Copies clamped to what rounding can place, before the marginals:
    # otherwise the prior reserves phantom capacity.
    copies = torch.clamp_max(problem.copies, MAX_COPIES)
    row_mass = problem.sizes * copies.to(torch.float32)
    free = torch.clamp_min(problem.capacity - problem.reserved, 0.0)
    sk = sinkhorn(
        C, row_mass, free, eps=config.eps, iters=config.sinkhorn_iters,
        lse_impl=config.lse_impl, g0=None if init is None else init.g0,
        tol=config.sinkhorn_tol, chunk=config.sinkhorn_chunk,
    )
    logits = plan_logits(C, sk.f, sk.g, config.eps)
    res = auction(
        logits, problem.sizes, copies, free, problem.feasible, seed,
        iters=config.auction_iters, eta=config.eta, tau=config.tau,
        load_impl=config.load_impl, noise_impl=config.noise_impl,
        final_select=config.final_select,
        stall_tol=config.auction_stall_tol,
        price0=None if init is None else init.price0,
    )
    return Placement(
        indices=res.indices, valid=res.valid, load=res.load,
        overflow=res.overflow, row_err=sk.row_err, f=sk.f, g=sk.g,
        prices=res.prices, sinkhorn_iters_run=sk.iters_run,
        auction_iters_run=res.iters_run,
    )


def solve_placement_incremental(
    problem: costs_mod.PlacementProblem,
    config: SolveConfig,
    seed: int,
    dirty_rows: torch.Tensor,     # i64[D] row ids, padded with >= N sentinels
    base_indices: torch.Tensor,   # i64[N, MAX_COPIES] previous assignment
    base_valid: torch.Tensor,     # bool[N, MAX_COPIES]
    g0: torch.Tensor,             # f32[M] frozen column potentials
    price0: torch.Tensor,         # f32[M] frozen congestion prices
    base_row_err: torch.Tensor,   # f32[] frozen Sinkhorn diagnostic
) -> Placement:
    """Incremental dirty-row re-solve (``ops/sparse.py``): only the rows
    in ``dirty_rows`` are re-selected, against the FROZEN column
    potentials and prices of the base solve, and merged into the base
    assignment. ``seed`` must be the base solve's, so the positional
    noise draw matches; the dispatch layer enforces that, and the
    dirty-fraction and overflow fallback gates."""
    return resolve_dirty_rows(
        problem, config, seed, dirty_rows, base_indices, base_valid,
        g0, price0, base_row_err,
    )
