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

On the top-K tier (``topk`` > 0) the reference narrows each row to its
candidates (``reference.candidates``), and is judged at the iteration
counts the program reports (``plan.stats``): its transport and auction
run to those counts. ``g_gap`` is then over the candidate mask's
transport, ``price_gap`` over the auction on the candidates, and
``assign_gap`` over the row's gathered candidates; two numbers join:

- ``cand_misses``: the planned (model, pod) entries whose pod is not
  among the model's gathered candidates (the selection), exact;
- ``gate_gap``: how far a gate's own criterion, read by the reference at
  the reported counts, contradicts where the program stopped: it has to
  hold where a gate stopped the loop and fail at each earlier reading
  (the probe, each chunk or round before), relative to the gate's
  threshold (the largest of value / threshold - 1 where it has to hold
  and 1 - value / threshold where it has to fail, and 0 where none is
  contradicted; a best overflow of 0, a sum of whole units, is held or
  not, exactly); a count the gate cannot give reads inf (the gates).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmbench import reference as ref

NUMBERS = ("g_gap", "assign_gap", "price_gap", "overflow_gap",
           "count_errors")
TOPK_NUMBERS = NUMBERS + ("cand_misses", "gate_gap")


def numbers(solver: ref.Solver) -> tuple:
    """The numbers compared on ``solver``'s tier."""
    return TOPK_NUMBERS if solver.topk else NUMBERS


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


def _g_gap(plan, pod_ids: list, tr: ref.Transport, eps: float) -> float:
    """The widest gap between the plan's column potentials and the
    reference's, in eps."""
    g_prog = carry(plan, pod_ids, "warm_g")
    if g_prog is None:
        return float("inf")
    gap = np.abs(g_prog - tr.g.cpu().numpy()) / eps
    return float(np.max(np.where(np.isnan(gap), np.inf, gap)))


def _plan_use(plan, cols: ref.Columns, model_ids: list, pod_ids: list, dev,
              out: dict):
    """The plan's assignment and loads: ``count_errors`` and
    ``overflow_gap`` into ``out``; returns the assignment (pod ids, valid
    slots, the ids with -1 at 0), its overflow and its placed share."""
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
    return idx, valid, safe, overflow, placed


def judge(plan, g0: Optional[np.ndarray], price0: Optional[np.ndarray],
          state: dict, now_ms: int, seed: int, solver: ref.Solver,
          model_ids: list, pod_ids: list, device,
          dtype=torch.bfloat16) -> dict:
    """The numbers of one refresh, its ``placed`` share (percent of demand
    placed within the pods' free units), and for the log the overflow of
    its assignment and of the reference's. ``g0`` and ``price0`` are the
    carries the refresh started from (None: zeros)."""
    if solver.topk:
        return judge_topk(plan, g0, price0, state, now_ms, seed, solver,
                          model_ids, pod_ids, device, dtype)
    dev = torch.device(device)
    cols = ref.columns(state, now_ms)
    n = len(cols.sizes)
    C = ref.cost(cols, dev, dtype)
    tr = ref.transport(C, cols, solver, g0)
    out = {"g_gap": _g_gap(plan, pod_ids, tr, solver.eps)}
    idx, valid, safe, overflow, placed = _plan_use(plan, cols, model_ids,
                                                   pod_ids, dev, out)

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


def _held(value: float, threshold: float) -> float:
    """How far ``value <= threshold`` is from failing, relative: <= 0
    where it holds."""
    return value / threshold - 1.0


def sinkhorn_gate_gap(s: ref.Solver, gates: ref.Gates,
                      reported: Optional[int]) -> float:
    """The Sinkhorn gate's contradiction at the reported count (the
    probe's move of g against tol * eps, each chunk's marginal error
    against tol)."""
    if reported is None or gates.run != int(reported):
        return float("inf")
    if not gates.probe:
        return 0.0
    chunks = -(-s.sinkhorn_iters // min(s.sinkhorn_chunk, s.sinkhorn_iters))
    probe = _held(gates.probe[0], s.sinkhorn_tol * s.eps)
    if not gates.steps:
        return max(0.0, probe)
    v = [-probe] + [-_held(e, s.sinkhorn_tol) for e in gates.steps[:-1]]
    if len(gates.steps) < chunks:
        v.append(_held(gates.steps[-1], s.sinkhorn_tol))
    return max(0.0, *v)


def auction_gate_gap(s: ref.Solver, gates: ref.Gates,
                     reported: Optional[int]) -> float:
    """The stall gate's contradiction at the reported count: the probe
    holds where no price moved more than tol or the overflow is at most
    tol of the demand; a round stalls where no price moved more than tol,
    the best overflow is 0, or it improved by at most tol of the
    demand."""
    if reported is None or gates.run != int(reported):
        return float("inf")
    if not gates.probe:
        return 0.0
    tol = s.auction_stall_tol
    moved, of, of_tol = gates.probe
    probe = min(_held(moved, tol), _held(of, of_tol))
    if gates.run == 1:
        return max(0.0, probe)
    # A best overflow of 0 is exact (sums of whole units): held or not.
    rounds = [min(_held(moved, tol), -1.0 if of <= 0.0 else float("inf"),
                  _held(improved, of_tol))
              for moved, of, improved in gates.steps]
    v = [-probe] + [-r for r in rounds[:-1]]
    if len(rounds) < -(-s.auction_iters // ref.ROUND):
        v.append(rounds[-1])
    return max(0.0, *v)


def judge_topk(plan, g0: Optional[np.ndarray], price0: Optional[np.ndarray],
               state: dict, now_ms: int, seed: int, solver: ref.Solver,
               model_ids: list, pod_ids: list, device,
               dtype=torch.bfloat16) -> dict:
    """``judge`` on the top-K tier (the module's docstring)."""
    dev = torch.device(device)
    cols = ref.columns(state, now_ms)
    n = len(cols.sizes)
    stats = plan.stats
    cand = ref.candidates(cols, solver, seed, dev, dtype)
    tr, sk_gates = ref.transport_topk(cand, cols, solver, g0,
                                      stats.get("sinkhorn_iters_run"))
    out = {"g_gap": _g_gap(plan, pod_ids, tr, solver.eps)}
    idx, valid, _, overflow, placed = _plan_use(plan, cols, model_ids,
                                                pod_ids, dev, out)

    idx_k = cand.idx[:, :cand.k]
    # Where each planned pod stands among its row's candidates.
    hit = idx[:, :, None] == idx_k[:, None, :]           # [n, slots, K]
    inside = hit.any(dim=2)
    out["cand_misses"] = int((valid & ~inside).sum())
    sc = ref.scores_topk(cand, tr, solver, seed, dtype)
    res = ref.auction_topk(sc, idx_k, cols, solver, price0,
                           stats.get("auction_iters_run"))
    price = carry(plan, pod_ids, "warm_price")
    if price is None or np.isnan(price).any():
        out["assign_gap"] = out["price_gap"] = float("inf")
    else:
        out["price_gap"] = float(np.max(np.abs(
            price - res.price.double().cpu().numpy())))
        eff = sc - torch.as_tensor(price, device=dev).float()[idx_k]
        best, _ = torch.sort(eff, dim=1, descending=True)
        best = best[:, :ref.MAX_COPIES]
        pos = torch.argmax(hit.to(torch.int32), dim=2)
        mine = valid & inside
        chosen = torch.where(mine, torch.gather(eff, 1, pos), torch.inf)
        count = valid.sum(dim=1)
        at = torch.clamp(count - 1, 0, best.shape[1] - 1)[:, None]
        kth = torch.gather(best, 1, at)[:, 0]
        gap = torch.where(mine.any(dim=1),
                          torch.clamp_min(kth - chosen.amin(dim=1), 0.0), 0.0)
        gap = torch.nan_to_num(gap, nan=torch.inf, posinf=torch.inf)
        out["assign_gap"] = float(gap.max()) if n else 0.0
    out["gate_gap"] = max(
        sinkhorn_gate_gap(solver, sk_gates, stats.get("sinkhorn_iters_run")),
        auction_gate_gap(solver, res.gates, stats.get("auction_iters_run")))
    out["placed"] = placed
    out["overflow"] = overflow
    out["ref_overflow"] = res.overflow
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
