"""Cost-matrix assembly for the global placement problem.

Port of ``modelmesh_tpu/ops/costs.py``: the reference's placement
preferences (ModelMesh.java:4646 PLACEMENT_ORDER plus the cache-miss LB
walk) as terms of a dense ``[num_models, num_instances]`` cost matrix.
Intermediates are f32; the output is bf16 by default. ``assemble_cost_rows``
is the same cost for a subset of rows (the incremental re-solve's).
"""

from __future__ import annotations

import dataclasses

import torch

# Additive penalty marking an infeasible (model, instance) pair. Large enough
# that exp(-INFEASIBLE/eps) == 0 for any sane eps, small enough for bf16.
INFEASIBLE: float = 1.0e4


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """Relative weights of the placement-preference terms (all O(1) scaled;
    the reasoning behind each value is in the JAX package's costs.py)."""

    move: float = 1.0
    utilization: float = 0.5
    balance: float = 0.35
    preference: float = 0.75
    lru_age: float = 0.25
    zone_spread: float = 0.15
    # One-hot width for zone ids; ids outside [0, num_zones) get no spread
    # term.
    num_zones: int = 8


@dataclasses.dataclass(frozen=True)
class PlacementProblem:
    """Tensor snapshot of cluster state for one global solve (N models,
    M instances), all on one device."""

    sizes: torch.Tensor      # f32[N] model size in cache units
    copies: torch.Tensor     # i32[N] desired copy count (>=1)
    rates: torch.Tensor      # f32[N] requests/min
    loaded: torch.Tensor     # bool[N, M] currently-loaded placement
    feasible: torch.Tensor   # bool[N, M] type/label constraints & exclusions
    capacity: torch.Tensor   # f32[M] total cache units per instance
    reserved: torch.Tensor   # f32[M] units the solver does not place
    lru_age: torch.Tensor    # f32[M] age (secs) of oldest cache entry
    busyness: torch.Tensor   # f32[M] request-load proxy
    zone: torch.Tensor       # i32[M] zone id per instance
    preferred: torch.Tensor  # bool[N, M] type-preference (all-True = none)

    @property
    def num_models(self) -> int:
        return self.sizes.shape[0]

    @property
    def num_instances(self) -> int:
        return self.capacity.shape[0]


def _minmax_norm(x: torch.Tensor) -> torch.Tensor:
    """Scale a vector to [0, 1]; constant vectors map to 0."""
    lo = x.min()
    span = x.max() - lo
    return torch.where(span > 0, (x - lo) / torch.clamp_min(span, 1e-30), 0.0)


def assemble_cost(
    problem: PlacementProblem,
    weights: CostWeights = CostWeights(),
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Build the [N, M] placement cost matrix on the problem's device.

    cost[m, i] =
        move * (1 - loaded[m, i])            # keep existing placements
      + utilization * used_frac[i]           # fill free instances first
      + balance * rate_norm[m] * busy[i]     # hot models -> quiet instances
      - lru_age * age_norm[i]                # old caches are cheap to evict into
      + zone_spread * zone_crowding[m, i]    # spread copies across zones
      + preference * (1 - preferred[m, i])   # prefer labeled pools
      + INFEASIBLE * (1 - feasible[m, i])

    The terms are summed in the reference's order. ``sizes @ loaded`` is a
    matrix-vector product whose rounding differs from XLA's, so the f32
    result matches the reference to a tolerance, not bitwise.
    """
    w = weights
    loaded_f = problem.loaded.to(torch.float32)
    loaded_mass = problem.sizes @ loaded_f  # [M]
    used_frac = torch.clamp(
        (problem.reserved + loaded_mass)
        / torch.clamp_min(problem.capacity, 1.0),
        0.0, 1.5,
    )
    busy = _minmax_norm(problem.busyness)
    age = _minmax_norm(problem.lru_age)
    rate = _minmax_norm(problem.rates)

    # Zone crowding: fraction of a model's current copies already in the
    # instance's zone. An out-of-range zone id one-hots to an all-zero
    # column, so its gathered crowding is forced back to 0.
    in_range = (problem.zone >= 0) & (problem.zone < w.num_zones)
    zone_ix = problem.zone.long().clamp(0, w.num_zones - 1)
    zone_onehot = (
        torch.nn.functional.one_hot(zone_ix, w.num_zones).to(torch.float32)
        * in_range[:, None]
    )  # [M, Z]
    copies_per_zone = loaded_f @ zone_onehot  # [N, Z]
    denom = torch.clamp_min(copies_per_zone.sum(dim=1, keepdim=True), 1.0)
    crowding = torch.where(
        in_range[None, :], (copies_per_zone / denom)[:, zone_ix], 0.0
    )  # [N, M]

    per_instance = w.utilization * used_frac - w.lru_age * age  # [M]
    cost = (
        w.move * (1.0 - loaded_f)
        + per_instance[None, :]
        + w.balance * rate[:, None] * busy[None, :]
        + w.zone_spread * crowding
        + w.preference * (1.0 - problem.preferred.to(torch.float32))
        + INFEASIBLE * (1.0 - problem.feasible.to(torch.float32))
    )
    return cost.to(dtype)


def assemble_cost_rows(
    problem: PlacementProblem,
    rows: torch.Tensor,
    weights: CostWeights = CostWeights(),
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``assemble_cost(...)[rows]`` without the full [N, M] result: the
    incremental dirty-row re-solve's assembly (``ops/sparse.py``).

    Every normalization statistic (rate, busyness and age norms, the
    per-column loaded mass) is taken over the FULL problem, as
    ``assemble_cost`` takes it, so a dirty row prices against the cost
    surface of the base solve whichever other rows are dirty. The
    per-element arithmetic is ``assemble_cost``'s, so the rows are equal
    to its rows exactly. ``rows`` (integer, [D]) must be in range:
    callers clamp padded sentinels first."""
    w = weights
    loaded_mass = problem.sizes @ problem.loaded.to(torch.float32)  # [M]
    used_frac = torch.clamp(
        (problem.reserved + loaded_mass)
        / torch.clamp_min(problem.capacity, 1.0),
        0.0, 1.5,
    )
    busy = _minmax_norm(problem.busyness)
    age = _minmax_norm(problem.lru_age)
    rows = rows.long()
    rate = _minmax_norm(problem.rates)[rows]                      # [D]

    loaded_d = problem.loaded[rows].to(torch.float32)             # [D, M]
    in_range = (problem.zone >= 0) & (problem.zone < w.num_zones)
    zone_ix = problem.zone.long().clamp(0, w.num_zones - 1)
    zone_onehot = (
        torch.nn.functional.one_hot(zone_ix, w.num_zones).to(torch.float32)
        * in_range[:, None]
    )  # [M, Z]
    copies_per_zone = loaded_d @ zone_onehot                      # [D, Z]
    denom = torch.clamp_min(copies_per_zone.sum(dim=1, keepdim=True), 1.0)
    crowding = torch.where(
        in_range[None, :], (copies_per_zone / denom)[:, zone_ix], 0.0
    )  # [D, M]

    per_instance = w.utilization * used_frac - w.lru_age * age  # [M]
    cost = (
        w.move * (1.0 - loaded_d)
        + per_instance[None, :]
        + w.balance * rate[:, None] * busy[None, :]
        + w.zone_spread * crowding
        + w.preference * (1.0 - problem.preferred[rows].to(torch.float32))
        + INFEASIBLE * (1.0 - problem.feasible[rows].to(torch.float32))
    )
    return cost.to(dtype)
