"""The comparison that decides ``correct``, and ``placed_pct``.

A refresh's plan is judged against the plain reference
(``reference.py``), worked out anew from the fleet's state at that
refresh, the logical time it ran at and its noise seed (1 + the full
rebuilds before it, the strategy's rule). The one thing taken from the
program is where the refresh started: the previous plan's column
potentials, which warm-start the reference's Sinkhorn as they warm-start
the program's, and on a delta refresh its prices, which warm-start the
reference's auction as they warm-start the program's (a full rebuild
drops them on both sides). The cold first refresh starts from zeros on
both sides, so the start of the chain is checked with nothing taken.

Numbers, each the widest over the judged refreshes:

- ``g_gap``: the widest gap between the plan's column potentials and the
  reference's, in units of eps (the transport);
- ``assign_gap``: the widest gap by which a planned pod's reference score,
  at the plan's own prices, lies below the row's best (the copies-th
  best for a model with several copies) (the columns, the cost, the noise
  and the rounding);
- ``price_gap``: the widest gap between the plan's prices (those its
  assignment was selected at, which the next refresh starts from) and
  the prices of the reference's auction run from the same carried
  prices, in score units (the auction's price steps);
- ``overflow_gap``: the plan's reported overflow against the overflow of
  its assignment's implied loads over the pods' free units (the auction's
  loads), exact;
- ``count_errors``: the models that the plan lacks, or gives another
  count of pods than their copies (capped at MAX_COPIES), or a
  pod twice or an unknown pod (the extracted plan), exact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmbench import reference as ref

NUMBERS = ("g_gap", "assign_gap", "price_gap", "overflow_gap",
           "count_errors")


def carry(plan, pod_ids: list, key: str) -> Optional[np.ndarray]:
    """A plan's per-pod carry (``warm_g`` or ``warm_price``) in pod order;
    None when the plan has none. A pod it lacks reads NaN."""
    d = getattr(plan, key, None)
    if d is None:
        return None
    return np.array([d.get(p, np.nan) for p in pod_ids], np.float64)


def assignment(plan, model_ids: list, pod_ids: list):
    """The plan's pods per model as int64[n, MAX_COPIES] (-1 empty) and
    bool[n]: the rows with a defect that the array cannot hold (model
    missing, an unknown pod, a repeat, more than MAX_COPIES pods)."""
    index = {p: j for j, p in enumerate(pod_ids)}
    placements = plan.placements
    n = len(model_ids)
    idx = np.full((n, ref.MAX_COPIES), -1, np.int64)
    defects = np.zeros(n, bool)
    for i, mid in enumerate(model_ids):
        targets = placements.get(mid)
        if targets is None:
            defects[i] = True
            continue
        js = [index.get(t, -1) for t in targets]
        if -1 in js or len(set(js)) != len(js) or len(js) > ref.MAX_COPIES:
            defects[i] = True
        js = [j for j in dict.fromkeys(js) if j >= 0][:ref.MAX_COPIES]
        idx[i, :len(js)] = js
    return idx, defects


def judge(plan, g0: Optional[np.ndarray], price0: Optional[np.ndarray],
          state: dict, now_ms: int, seed: int, solver: ref.Solver,
          model_ids: list, pod_ids: list, device,
          dtype=torch.bfloat16) -> dict:
    """The numbers of one refresh, its ``placed`` share (percent of demand
    placed within the pods' free units), and for the log the overflow of
    its assignment and of the reference's. ``g0`` and ``price0`` are the
    carries the refresh started from (None: zeros)."""
    dev = torch.device(device)
    cols = ref.columns(state, now_ms)
    n = len(cols.sizes)
    C = ref.cost(cols, dev, dtype)
    tr = ref.transport(C, cols, solver, g0)
    out = {}
    g_prog = carry(plan, pod_ids, "warm_g")
    if g_prog is None:
        out["g_gap"] = float("inf")
    else:
        gap = np.abs(g_prog - tr.g.cpu().numpy()) / solver.eps
        out["g_gap"] = float(np.max(np.where(np.isnan(gap), np.inf, gap)))

    idx_np, defects = assignment(plan, model_ids, pod_ids)
    counts_np = (idx_np >= 0).sum(axis=1)
    out["count_errors"] = int(np.sum(defects | (counts_np != cols.copies)))

    idx = torch.as_tensor(idx_np, device=dev)
    valid = idx >= 0
    safe = torch.clamp_min(idx, 0)
    sizes = torch.as_tensor(cols.sizes, device=dev)
    free = torch.as_tensor(cols.free, device=dev)
    load = ref.implied_load(safe, valid, sizes, len(cols.capacity))
    overflow = float(torch.clamp_min(load - torch.clamp_min(free, 1e-6),
                                     0.0).double().sum())
    reported = plan.stats.get("overflow", float("nan"))
    out["overflow_gap"] = abs(overflow - float(reported))
    if not np.isfinite(out["overflow_gap"]):
        out["overflow_gap"] = float("inf")
    placed = float(torch.minimum(load, free).double().sum()) / max(
        cols.demand, 1e-30) * 100.0

    sc = ref.scores(C, tr, solver, seed, dtype)
    del C
    _, _, ref_price, ref_overflow = ref.auction(sc, cols, solver, price0)
    price = carry(plan, pod_ids, "warm_price")
    if price is None or np.isnan(price).any():
        out["assign_gap"] = float("inf")
        out["price_gap"] = float("inf")
    else:
        out["price_gap"] = float(np.max(np.abs(
            price - ref_price.double().cpu().numpy())))
        eff = sc - torch.as_tensor(price, device=dev).float()[None, :]
        del sc
        best, _ = torch.sort(eff, dim=1, descending=True)
        best = best[:, :ref.MAX_COPIES]
        chosen = torch.where(valid, torch.gather(eff, 1, safe), torch.inf)
        count = valid.sum(dim=1)
        rows = count > 0
        at = torch.clamp_min(count - 1, 0)[:, None]
        kth = torch.gather(best, 1, at)[:, 0]
        worst = chosen.amin(dim=1)
        gap = torch.where(rows, torch.clamp_min(kth - worst, 0.0), 0.0)
        gap = torch.nan_to_num(gap, nan=torch.inf, posinf=torch.inf)
        out["assign_gap"] = float(gap.max()) if n else 0.0
    out["placed"] = placed
    out["overflow"] = overflow
    out["ref_overflow"] = ref_overflow
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
