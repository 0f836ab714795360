"""Sharded global placement solve over a device mesh.

Port of ``modelmesh_tpu/parallel/sharded_solver.py``: the solve of
``ops/solve.py`` with the cost matrix's rows (the model axis) split over
the mesh's ``mdl`` axis and, optionally, its columns over ``inst``. Each
shard runs its block through the port's single-device ops and kernel
wrappers on its own device (``parallel.mesh.shard_map``):

- cost assembly: fully blocked; the cross-block normalizations use
  ``pmin``/``pmax`` and ``psum``.
- sparse tier: the block's cost rows are gathered to full width along
  ``inst`` (a no-op on an ``n x 1`` mesh); the top-K selection (kernel 1)
  draws the same key as the same rows of the whole problem (its
  ``row_offset``); the Sinkhorn's column products and the auction's
  implied load are combined over ``mdl``.
- dense tier: on an ``n x 1`` mesh up to 1024 columns, one fused LSE step
  per iteration (kernels 4 + 5) gives f on the shard and its column
  partials are combined over ``mdl``; otherwise kernel 4's row pairs are
  combined over ``inst`` (``_lse``) and kernel 5's column partials over
  ``mdl``. The plan logits are gathered to full width along ``inst`` for
  the auction, whose implied load is combined over ``mdl``.

On the card a column reduction over ``mdl`` gathers the shards' block
partials in rank order and runs the kernel's fixed-order combine once over
all of them (``parallel.mesh.AxisSum``), so with block heights that are
multiples of the kernels' row blocks (256 rows; 1024 for the implied load)
the column sums are the single-device solve's bit for bit, and a mesh
whose blocks are whole rows (``n x 1``) gives the single-device placement.
Across ``inst`` the row LSE is combined as the reference combines it,
``M = max(m)``, ``lse = log(sum(s * exp(m - M))) + M``, which rounds apart
from one pass over the whole row. On the CPU the plain versions' column
sums are added over the shards.

Noise: the hash draw counts rows from the shard's global row offset, so it
is the single-device draw bit for bit; threefry folds the shard's ``mdl``
index into the key (``random.fold_in``), as the reference does, and is
not offset-consistent.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch

from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.ops import cuda_lse, cuda_random
from modelmesh_tpu_torch.ops.auction import (
    K_CAND,
    MAX_COPIES,
    _NEG_INF,
    _implied_load,
    _select,
    check_rounding_config,
    hash_gumbel,
    price_repair,
    resolve_load_impl,
    select_from_candidates,
    shortlist,
)
from modelmesh_tpu_torch.ops.costs import (
    INFEASIBLE,
    CostWeights,
    PlacementProblem,
)
from modelmesh_tpu_torch.ops.sinkhorn import (
    plan_logits,
    resolve_lse_impl,
    run_sinkhorn,
)
from modelmesh_tpu_torch.ops.solve import Placement, SolveConfig
from modelmesh_tpu_torch.ops.sparse import (
    check_sparse_config,
    perturb_gathered,
    resolve_sparse_impl,
    sparse_auction,
    sparse_sinkhorn,
    topk_candidates,
)
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.parallel.mesh import (
    INSTANCE_AXIS,
    MODEL_AXIS,
    AxisSum,
    all_gather,
    axis_index,
    axis_size,
    pmax,
    pmin,
    psum,
)

_TINY = 1e-30


def _norm_sharded(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """``costs._minmax_norm`` of a vector split over ``axis_name``."""
    lo = pmin(x.min(), axis_name)
    span = pmax(x.max(), axis_name) - lo
    return torch.where(span > 0, (x - lo) / torch.clamp_min(span, 1e-30), 0.0)


def _cost_block(p: PlacementProblem, w: CostWeights, dtype) -> torch.Tensor:
    """The cost matrix block of a shard's rows and columns:
    ``costs.assemble_cost`` term for term, its full-problem reductions
    combined over the mesh (the loaded mass over ``mdl``, the zone counts
    over ``inst``, the norms over their axis)."""
    loaded_f = p.loaded.to(torch.float32)
    loaded_mass = psum(p.sizes @ loaded_f, MODEL_AXIS)  # [m_blk]
    used_frac = torch.clamp(
        (p.reserved + loaded_mass) / torch.clamp_min(p.capacity, 1.0),
        0.0, 1.5,
    )
    busy = _norm_sharded(p.busyness, INSTANCE_AXIS)
    age = _norm_sharded(p.lru_age, INSTANCE_AXIS)
    rate = _norm_sharded(p.rates, MODEL_AXIS)

    in_range = (p.zone >= 0) & (p.zone < w.num_zones)
    zone_ix = p.zone.long().clamp(0, w.num_zones - 1)
    zone_onehot = (
        torch.nn.functional.one_hot(zone_ix, w.num_zones).to(torch.float32)
        * in_range[:, None]
    )  # [m_blk, Z]
    # Full-width zone counts per row.
    copies_per_zone = psum(loaded_f @ zone_onehot, INSTANCE_AXIS)  # [n_blk, Z]
    denom = torch.clamp_min(copies_per_zone.sum(dim=1, keepdim=True), 1.0)
    crowding = torch.where(
        in_range[None, :], (copies_per_zone / denom)[:, zone_ix], 0.0
    )

    per_instance = w.utilization * used_frac - w.lru_age * age
    cost = (
        w.move * (1.0 - loaded_f)
        + per_instance[None, :]
        + w.balance * rate[:, None] * busy[None, :]
        + w.zone_spread * crowding
        + w.preference * (1.0 - p.preferred.to(torch.float32))
        + INFEASIBLE * (1.0 - p.feasible.to(torch.float32))
    )
    return cost.to(dtype)


def _lse(m: torch.Tensor, s: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The LSE of online pairs ``(m, s)`` over slices split on
    ``axis_name``: ``M = pmax(m)``, ``s = psum(s * exp(m - M))``,
    ``log(max(s, 1e-30)) + M`` (a slice whose max is -inf adds 0)."""
    m_g = pmax(m, axis_name)
    e = torch.exp(torch.where(m == -torch.inf, -torch.inf, m - m_g))
    return cuda_lse.lse_of(m_g, psum(s * e, axis_name))


def _sharded_sinkhorn(C, row_mass, col_mass, eps: float, iters: int,
                      g0=None, tol: float = 0.0, chunk: int = 4):
    """The dense tier's semi-unbalanced Sinkhorn (``ops.sinkhorn.sinkhorn``)
    on a [n_blk, m_blk] block: f for the shard's rows, g for its columns.
    Returns a ``SinkhornResult``; its ``row_err`` is the reference's
    sharded diagnostic, sum|violation| / sum(mass) over the whole problem.
    """
    row_mass = row_mass.to(torch.float32)
    col_mass = col_mass.to(torch.float32)
    log_a = torch.log(torch.clamp_min(row_mass, _TINY))
    log_b = torch.log(torch.clamp_min(col_mass, _TINY))
    whole_rows = axis_size(INSTANCE_AXIS) == 1
    fused = whole_rows and C.shape[1] <= cuda_lse.FUSED_MAX_COLS
    col_sum = AxisSum(MODEL_AXIS)

    def row_lse(g):
        if whole_rows:
            return cuda_lse.row_lse(C, g, eps)
        return _lse(*cuda_lse.row_lse_partial(C, g, eps), INSTANCE_AXIS)

    def run_iters(f, g, length):
        for _ in range(length):
            if fused:
                f, m, s = cuda_lse.lse_sinkhorn_step(C, g, log_a, eps,
                                                     col_psum=col_sum)
                col = cuda_lse.lse_of(m, s)
            else:
                f = eps * (log_a - row_lse(g))
                col = cuda_lse.col_lse(C, f, eps, col_psum=col_sum)
            g = torch.clamp_max(eps * (log_b - col), 0.0)
        return f, g

    total = psum(row_mass.sum(), MODEL_AXIS)

    def marginal_err(f, g):
        row_sum = torch.exp((f + eps * row_lse(g)) / eps)
        err = psum((row_sum - row_mass).abs().sum(), MODEL_AXIS)
        return err / torch.clamp_min(total, _TINY)

    return run_sinkhorn(
        run_iters, marginal_err, C.shape[0], g0, log_b,
        eps=eps, iters=iters, tol=tol, chunk=chunk,
        dg_reduce=lambda dg: pmax(dg, INSTANCE_AXIS),
    )


def _sharded_auction(scores_full, sizes, copies, cap_full, iters: int,
                     eta: float, load_impl: str = "auto",
                     final_select: str = "exact", stall_tol: float = 0.0,
                     price0=None):
    """The dense auction (``ops.auction.auction``) on a shard's rows:
    ``scores_full`` [n_blk, M] already noised and masked (full instance
    width), the implied load and the total demand summed over ``mdl`` so
    every shard tracks the same prices and takes the same branches."""
    num_instances = cap_full.shape[0]
    load_impl = resolve_load_impl(load_impl, scores_full.device)
    cap = torch.clamp_min(cap_full.to(torch.float32), 1e-6)
    copies = torch.clamp_max(copies, MAX_COPIES)
    kc = min(K_CAND, num_instances)
    col_sum = AxisSum(MODEL_AXIS)

    def round_select(price):
        cand_vals, cand_idx = shortlist(scores_full, price, kc)
        return lambda p: select_from_candidates(cand_vals, cand_idx, copies, p)

    def final_select_fn(price):
        return _select(scores_full - price[None, :], copies)

    def load_fn(idx, valid):
        return _implied_load(idx, valid, sizes, num_instances, load_impl,
                             col_psum=col_sum)

    return price_repair(
        round_select, final_select_fn, load_fn, sizes, copies, cap,
        iters=iters, eta=eta, final_select=final_select,
        stall_tol=stall_tol, price0=price0, axis_psum=col_sum,
    )


def _inst_block(x: torch.Tensor) -> torch.Tensor:
    """This shard's ``inst`` block of a full-width vector."""
    m_blk = x.shape[0] // axis_size(INSTANCE_AXIS)
    k = axis_index(INSTANCE_AXIS)
    return x[k * m_blk:(k + 1) * m_blk]


def _sparse_solve_kernel(p: PlacementProblem, seed: int, g0, price0,
                         config: SolveConfig,
                         weights: CostWeights) -> Placement:
    """The sparse top-K pipeline (``ops.sparse.solve_sparse``) on a shard:
    its cost rows gathered to full width along ``inst``, so the selection
    sees whole rows with global column ids and the draw of those rows;
    column products, gate sums and the implied load combined over
    ``mdl``, after which every shard holds the same full-width column
    state. g and the prices come back as the shard's ``inst`` block."""
    C_full = all_gather(_cost_block(p, weights, config.dtype),
                        INSTANCE_AXIS, dim=1)
    resolve_sparse_impl(config.sparse_impl, C_full.device)
    feas_full = all_gather(p.feasible, INSTANCE_AXIS, dim=1)
    row_off = axis_index(MODEL_AXIS) * C_full.shape[0]
    cost_k, idx_k, feas_k, fused = topk_candidates(
        C_full, feas_full, config.topk, seed=seed, row_offset=row_off
    )
    copies = torch.clamp_max(p.copies, MAX_COPIES)
    row_mass = p.sizes * copies.to(torch.float32)
    free = torch.clamp_min(p.capacity - p.reserved, 0.0)
    free_full = all_gather(free, INSTANCE_AXIS)
    col_sum = AxisSum(MODEL_AXIS)
    sk = sparse_sinkhorn(
        C_full, fused, row_mass, free_full,
        eps=config.eps, iters=config.sinkhorn_iters,
        g0=all_gather(g0, INSTANCE_AXIS),
        tol=config.sinkhorn_tol, chunk=config.sinkhorn_chunk,
        col_psum=col_sum, dg_reduce=lambda dg: pmax(dg, MODEL_AXIS),
    )
    logits_k = (
        (sk.f[:, None] + sk.g[idx_k] - cost_k.to(torch.float32)) / config.eps
    ).to(config.dtype)
    scores_k = perturb_gathered(logits_k, idx_k, feas_k, config.tau, seed,
                                row_offset=row_off)
    res = sparse_auction(
        scores_k, idx_k, p.sizes, copies, free_full,
        iters=config.auction_iters, eta=config.eta,
        final_select=config.final_select,
        stall_tol=config.auction_stall_tol,
        price0=all_gather(price0, INSTANCE_AXIS),
        sel_k=config.sel_width or MAX_COPIES,
        load_impl=config.load_impl, axis_psum=col_sum,
    )
    return Placement(
        indices=res.indices, valid=res.valid, load=res.load,
        overflow=res.overflow, row_err=sk.row_err, f=sk.f,
        g=_inst_block(sk.g), prices=_inst_block(res.prices),
        sinkhorn_iters_run=sk.iters_run, auction_iters_run=res.iters_run,
    )


def _solve_kernel(p: PlacementProblem, g0, price0, *, seed: int,
                  config: SolveConfig, weights: CostWeights,
                  n_inst: int = 1) -> Placement:
    """One shard's solve. The route is ``solve_placement``'s on the GLOBAL
    padded width: ``0 < topk < m_blk * n_inst`` runs sparse, any other
    dense, so one config takes one path on and off the mesh."""
    if 0 < config.topk < p.num_instances * n_inst:
        # At solve time, like solve_sparse: a full-width topk runs dense,
        # where the sparse-only constraints do not apply.
        check_sparse_config(config)
        return _sparse_solve_kernel(p, seed, g0, price0, config, weights)
    C = _cost_block(p, weights, config.dtype)
    resolve_lse_impl(config.lse_impl, C.device)
    copies = torch.clamp_max(p.copies, MAX_COPIES)
    row_mass = p.sizes * copies.to(torch.float32)
    free = torch.clamp_min(p.capacity - p.reserved, 0.0)
    sk = _sharded_sinkhorn(
        C, row_mass, free, config.eps, config.sinkhorn_iters, g0=g0,
        tol=config.sinkhorn_tol, chunk=config.sinkhorn_chunk,
    )
    # Quantized to the cost dtype as ops.sinkhorn.plan_logits does, then
    # gathered to full-width rows for the auction's top-k.
    logits_full = all_gather(plan_logits(C, sk.f, sk.g, config.eps),
                             INSTANCE_AXIS, dim=1)
    feas_full = all_gather(p.feasible, INSTANCE_AXIS, dim=1)
    scores = logits_full.to(torch.float32)
    if config.tau > 0:
        # ops.auction.gumbel_perturb on the shard's rows: the hash draw
        # counts from the shard's global row start (the single-device
        # draw); threefry folds the shard index into the key.
        if config.noise_impl == "hash":
            noise = hash_gumbel(
                tuple(scores.shape), seed,
                axis_index(MODEL_AXIS) * scores.shape[0],
                device=scores.device,
            )
        else:
            key = prng.fold_in(prng.PRNGKey(seed), axis_index(MODEL_AXIS))
            noise = cuda_random.gumbel(key, tuple(scores.shape),
                                       scores.device)
        scores = scores + config.tau * noise
    scores = torch.where(feas_full, scores, _NEG_INF)
    res = _sharded_auction(
        scores, p.sizes, copies, all_gather(free, INSTANCE_AXIS),
        config.auction_iters, config.eta, load_impl=config.load_impl,
        final_select=config.final_select,
        stall_tol=config.auction_stall_tol,
        price0=all_gather(price0, INSTANCE_AXIS),
    )
    return Placement(
        indices=res.indices, valid=res.valid, load=res.load,
        overflow=res.overflow, row_err=sk.row_err, f=sk.f, g=sk.g,
        prices=_inst_block(res.prices), sinkhorn_iters_run=sk.iters_run,
        auction_iters_run=res.iters_run,
    )


def _join(mesh, outs: list) -> Placement:
    """The shards' Placements as one with the single-device solve's
    global shapes, on the mesh's first device: the rows (indices, valid,
    f) joined in rank order along ``mdl``, g and the prices along
    ``inst``; load, overflow, row_err and the iteration counts (the same
    on every shard) from shard 0."""
    dev = mesh.devices[0]
    n_mdl, n_inst = mesh.shape[MODEL_AXIS], mesh.shape[INSTANCE_AXIS]
    rows = [outs[mesh.rank_of(i, 0)] for i in range(n_mdl)]
    cols = [outs[mesh.rank_of(0, j)] for j in range(n_inst)]

    def cat(parts):
        return torch.cat([t.to(dev) for t in parts])

    first = outs[0]
    return Placement(
        indices=cat([o.indices for o in rows]),
        valid=cat([o.valid for o in rows]),
        load=first.load.to(dev), overflow=first.overflow.to(dev),
        row_err=first.row_err.to(dev),
        f=cat([o.f for o in rows]),
        g=cat([o.g for o in cols]),
        prices=cat([o.prices for o in cols]),
        sinkhorn_iters_run=first.sinkhorn_iters_run,
        auction_iters_run=first.auction_iters_run,
    )


def make_sharded_solver(mesh, config: SolveConfig = SolveConfig(),
                        weights: CostWeights | None = None):
    """A solver bound to ``mesh``: ``solver(shards, seed=0x5EED, g0=None,
    price0=None)`` solves the problem that ``shards`` (``shard_problem``'s
    blocks) split, with f32[M] warm starts ``g0``/``price0`` (zeros when
    None), and returns a ``Placement`` with the single-device solve's
    global shapes on the mesh's first device (``_join``).

    ``weights`` defaults to ``config.weights``. The rounding knobs are
    checked here, as the single-device auction checks them; the sparse-only
    constraints only when a solve takes the sparse route (``ValueError``),
    since the route depends on the problem's width."""
    check_rounding_config(
        config.noise_impl, config.final_select, config.auction_iters
    )
    weights = config.weights if weights is None else weights
    n_inst = mesh.shape[INSTANCE_AXIS]
    run = mesh_mod.shard_map(
        partial(_solve_kernel, config=config, weights=weights,
                n_inst=n_inst),
        mesh,
    )

    def blocks_of(x):
        """A full-width f32 vector as each shard's ``inst`` block on its
        device."""
        return [mesh.block(r, x, (INSTANCE_AXIS,)).to(mesh.devices[r])
                for r in range(mesh.size)]

    def solver(shards: Sequence[PlacementProblem], seed: int = 0x5EED,
               g0=None, price0=None) -> Placement:
        if len(shards) != mesh.size:
            raise ValueError(
                f"{len(shards)} problem blocks for a mesh of {mesh.size}"
            )
        m = shards[0].num_instances * n_inst
        zeros = torch.zeros(m, dtype=torch.float32, device=mesh.devices[0])
        g0 = zeros if g0 is None else g0.to(torch.float32)
        price0 = zeros if price0 is None else price0.to(torch.float32)
        outs = run(shards, blocks_of(g0), blocks_of(price0),
                   seed=int(seed) & 0xFFFFFFFF)
        return _join(mesh, outs)

    return solver


def shard_problem(problem: PlacementProblem, mesh) -> list:
    """The blocks of ``problem`` that the shards of ``mesh`` solve, in rank
    order, each on its shard's device (``mesh.PROBLEM_LAYOUT``); raises
    ValueError when the mesh does not divide the problem."""
    return [
        PlacementProblem(**{
            name: mesh.block(rank, getattr(problem, name), axes)
            .contiguous().to(mesh.devices[rank])
            for name, axes in mesh_mod.PROBLEM_LAYOUT.items()
        })
        for rank in range(mesh.size)
    ]
