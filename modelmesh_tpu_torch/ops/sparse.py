"""Sparse top-K placement solve.

Port of ``modelmesh_tpu/ops/sparse.py`` (the design notes are there):

1. ``topk_candidates``: one pass over the assembled cost
   (``cuda_sparse.select_candidates``) gathers each model's K cheapest
   instances by a noisy selection key, keeps the row's K-th key as the
   threshold that defines the candidate mask, and packs that mask into
   bits with the masked row minimum.
2. ``sparse_sinkhorn``: scaled-kernel Sinkhorn over the masked candidate
   set, always through the kernels of ``cuda_sparse``: each iteration is
   one pass over C and the gather's bits; neither a bool mask nor the
   scaled kernel is materialized.
3. ``sparse_auction``: price repair over the fixed gathered candidates.

Rounding noise is the positional hash-Gumbel draw, a pure function of
(row, col, seed), so the gathered and full-width evaluations agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import costs as costs_mod
from modelmesh_tpu_torch.ops import cuda_sparse
from modelmesh_tpu_torch.ops.auction import (
    MAX_COPIES,
    _NEG_INF,
    AuctionResult,
    _implied_load,
    check_rounding_config,
    hash_gumbel_at,
    price_repair,
    resolve_load_impl,
    select_from_candidates,
)
from modelmesh_tpu_torch.ops.sinkhorn import SinkhornResult, run_sinkhorn

# Gumbel scale for the candidate-selection draw (cost units), and the salt
# that makes it independent of the rounding noise at the same counter.
GATHER_TAU: float = 0.5
_GATHER_SALT = 0x9E3779B9

# Numerical floor shared by the scaled-kernel iterations (the fused step
# clamps r to it).
_TINY = cuda_sparse.TINY


class FusedGather(NamedTuple):
    """The candidate mask of the gather: the row's K-th selection key and
    the row-side hash state of the draw (what ``masked_row_min`` evaluates
    the mask from), the masked row minimum and the mask bits."""

    thresh: torch.Tensor  # f32[N] K-th (tie-inclusive) selection key
    x_row: torch.Tensor   # i32[N] row-side hash state (uint32 bits)
    tau: float
    noised: bool
    rowmin: torch.Tensor  # f32[N]
    bits: torch.Tensor    # i32[N, ceil(M / 32)]


def resolve_sparse_impl(sparse_impl: str, device: torch.device) -> str:
    """The sparse kernels' backend: "cuda" | "plain"
    (``device.resolve_kernel_impl``)."""
    return device_mod.resolve_kernel_impl("sparse_impl", sparse_impl, device)


def topk_candidates(
    C: torch.Tensor,
    feasible: torch.Tensor,
    k: int,
    seed: int | None = None,
):
    """Gather each row's K cheapest instances from the assembled cost.

    Returns ``(cost_k, idx_k, feas_k, fused)``: costs in C's dtype, i64
    column ids, the gathered feasibility, and the ``FusedGather`` whose
    ``thresh`` is the row's K-th selection key — the candidate mask is
    every entry whose key is at or under it (a tie-inclusive superset of
    the gathered columns). Selection is by noisy cost (GATHER_TAU Gumbel
    at a salted counter; ``seed=None`` disables it); the INFEASIBLE
    penalty drowns the noise, so feasible candidates always sort first.
    """
    k = min(k, C.shape[1])
    noised = seed is not None
    salted = 0 if seed is None else (int(seed) ^ _GATHER_SALT) & 0xFFFFFFFF
    x_row = cuda_sparse.noise_row_state(C.shape[0], salted, C.device)
    # Ties (equal keys: no noise, or the coarse INFEASIBLE penalty) go to
    # the lower column, as jax.lax.top_k breaks them.
    sel = cuda_sparse.select_candidates(C, x_row, k, tau=GATHER_TAU,
                                        noised=noised)
    fused = FusedGather(thresh=sel.thresh, x_row=x_row, tau=GATHER_TAU,
                        noised=noised, rowmin=sel.rowmin, bits=sel.bits)
    return (
        torch.gather(C, 1, sel.idx),
        sel.idx,
        torch.gather(feasible, 1, sel.idx),
        fused,
    )


def sparse_sinkhorn(
    C: torch.Tensor,            # [N, M] assembled cost (bf16 ok)
    fused: FusedGather,
    row_mass: torch.Tensor,     # f32[N]
    col_mass: torch.Tensor,     # f32[M] full-width capacity caps
    *,
    eps: float,
    iters: int,
    g0: torch.Tensor | None = None,
    tol: float = 0.0,
    chunk: int = 4,
) -> SinkhornResult:
    """Semi-unbalanced Sinkhorn over the masked candidate set (rows are
    equalities, columns caps via g <= 0). Each iteration is

        v = exp(g / eps);  r = P @ v
        f = eps * (log a - log r) + rowmin
        u = a / r
        g = min(0, eps * (log b - log(u @ P)))

    with ``P = exp((rowmin - C) / eps) * mask`` applied by the kernels,
    never built. The mask comes packed from the gather; up to
    ``FUSED_MAX_COLS`` columns an iteration's two products are one fused
    pass over C (``masked_sinkhorn_step``), wider they run back to back.
    """
    row_mass = row_mass.to(torch.float32)
    col_mass = col_mass.to(torch.float32)
    log_a = torch.log(torch.clamp_min(row_mass, _TINY))
    log_b = torch.log(torch.clamp_min(col_mass, _TINY))
    rowmin, bits = fused.rowmin, fused.bits
    one_pass = C.shape[1] <= cuda_sparse.FUSED_MAX_COLS

    def row_terms(v):
        r = cuda_sparse.masked_row_matvec(C, bits, rowmin, v, eps=eps)
        return torch.clamp_min(r, _TINY)

    def products(v):
        """r = max(P @ v, tiny) and c = (a / r) @ P."""
        if one_pass:
            return cuda_sparse.masked_sinkhorn_step(
                C, bits, rowmin, v, row_mass, eps=eps
            )
        r = row_terms(v)
        u = row_mass / r                           # exp((f - rowmin) / eps)
        return r, cuda_sparse.masked_col_matvec(C, bits, rowmin, u, eps=eps)

    def run_iters(f, g, length):
        for _ in range(length):
            r, c = products(torch.exp(g / eps))
            f = eps * (log_a - torch.log(r)) + rowmin
            g = torch.clamp_max(
                eps * (log_b - torch.log(torch.clamp_min(c, _TINY))), 0.0
            )
        return f, g

    def marginal_err(f, g):
        row_sum = torch.exp((f - rowmin) / eps) * row_terms(torch.exp(g / eps))
        num = (row_sum - row_mass).abs().sum()
        return num / torch.clamp_min(row_mass.sum(), _TINY)

    return run_sinkhorn(
        run_iters, marginal_err, C.shape[0], g0, log_b,
        eps=eps, iters=iters, tol=tol, chunk=chunk,
    )


def sparse_auction(
    scores_k: torch.Tensor,   # f32[N, K] noised+masked plan logits (gathered)
    idx_k: torch.Tensor,      # i64[N, K]
    sizes: torch.Tensor,      # f32[N]
    copies: torch.Tensor,     # i32[N]
    capacity: torch.Tensor,   # f32[M] full-width caps
    *,
    iters: int,
    eta: float,
    final_select: str = "exact",
    stall_tol: float = 0.0,
    price0: torch.Tensor | None = None,
    sel_k: int = MAX_COPIES,
    load_impl: str = "auto",
) -> AuctionResult:
    """Price repair over a fixed candidate set (``price_repair``, with the
    reference's best-iterate tracking, warm probe and stall gates); every
    selection, the epilogue's included, is within the candidates.
    ``load_impl`` as ``auction.resolve_load_impl`` resolves it on the
    problem's device."""
    num_instances = capacity.shape[0]
    load_impl = resolve_load_impl(load_impl, capacity.device)
    cap = torch.clamp_min(capacity.to(torch.float32), 1e-6)
    copies = torch.clamp_max(copies, MAX_COPIES)
    nsel = min(sel_k, MAX_COPIES)

    def implied_load(idx, valid):
        # Slots past sel_k are padding (never valid): skip them. The
        # fixed-order kernel takes the slice by its row stride.
        return _implied_load(
            idx[:, :nsel], valid[:, :nsel], sizes, num_instances, load_impl
        )

    def select(price):
        return select_from_candidates(scores_k, idx_k, copies, price, nsel)

    return price_repair(
        lambda _price: select, select, implied_load, sizes, copies, cap,
        iters=iters, eta=eta, final_select=final_select,
        stall_tol=stall_tol, price0=price0,
    )


def check_sparse_config(config) -> None:
    """Validation of the config knobs the sparse solve reads."""
    check_rounding_config(
        config.noise_impl, config.final_select, config.auction_iters
    )
    if config.tau > 0 and config.noise_impl != "hash":
        raise ValueError(
            "sparse solve requires noise_impl='hash' "
            f"(got {config.noise_impl!r})"
        )
    if config.sel_width and not 0 < config.sel_width <= MAX_COPIES:
        raise ValueError(
            f"sel_width={config.sel_width} (expected 1..{MAX_COPIES}, "
            "or 0 for the MAX_COPIES default)"
        )
    resolve_load_impl(config.load_impl)


def perturb_gathered(
    logits_k: torch.Tensor, idx_k: torch.Tensor, feas_k: torch.Tensor,
    tau: float, seed: int,
) -> torch.Tensor:
    """Noise + feasibility mask for gathered plan logits."""
    scores = logits_k.to(torch.float32)
    if tau > 0:
        rows = torch.arange(idx_k.shape[0], device=idx_k.device)[:, None]
        scores = scores + tau * hash_gumbel_at(rows, idx_k, seed)
    return torch.where(feas_k, scores, _NEG_INF)


def solve_sparse(problem, config, seed: int, init):
    """Cost -> top-K gather -> sparse Sinkhorn -> sparse auction, on the
    problem's device. Returns the same ``Placement`` as the reference
    (f/g/prices full-width, so warm carries work unchanged)."""
    from modelmesh_tpu_torch.ops.solve import Placement

    check_sparse_config(config)
    seed = int(seed) & 0xFFFFFFFF
    C = costs_mod.assemble_cost(
        problem, weights=config.weights, dtype=config.dtype
    )
    resolve_sparse_impl(config.sparse_impl, C.device)
    cost_k, idx_k, feas_k, fused = topk_candidates(
        C, problem.feasible, config.topk, seed=seed
    )
    copies = torch.clamp_max(problem.copies, MAX_COPIES)
    row_mass = problem.sizes * copies.to(torch.float32)
    free = torch.clamp_min(problem.capacity - problem.reserved, 0.0)
    sk = sparse_sinkhorn(
        C, fused, row_mass, free,
        eps=config.eps, iters=config.sinkhorn_iters,
        g0=None if init is None else init.g0,
        tol=config.sinkhorn_tol, chunk=config.sinkhorn_chunk,
    )
    # Per-element arithmetic and the dtype quantization match the
    # reference's gathered plan logits.
    logits_k = (
        (sk.f[:, None] + sk.g[idx_k] - cost_k.to(torch.float32)) / config.eps
    ).to(config.dtype)
    scores_k = perturb_gathered(logits_k, idx_k, feas_k, config.tau, seed)
    res = sparse_auction(
        scores_k, idx_k, problem.sizes, copies, free,
        iters=config.auction_iters, eta=config.eta,
        final_select=config.final_select,
        stall_tol=config.auction_stall_tol,
        price0=None if init is None else init.price0,
        sel_k=config.sel_width or MAX_COPIES,
        load_impl=config.load_impl,
    )
    return Placement(
        indices=res.indices, valid=res.valid, load=res.load,
        overflow=res.overflow, row_err=sk.row_err, f=sk.f, g=sk.g,
        prices=res.prices, sinkhorn_iters_run=sk.iters_run,
        auction_iters_run=res.iters_run,
    )
