"""The reference put in the program's place.

``StandIn`` answers ``mark_dirty`` and ``refresh`` as the strategy does,
from the fleet's arrays, with the whole solve of ``reference.py`` on the
configuration's tier (the top-K tier with its own gates): the control
(``dtype`` below the configuration's, fp8 for its bf16 cost and logits)
and, in the CPU tests, the reference itself. It follows the
strategy's epochs: a full rebuild every ``MAX_DELTA_STREAK + 1``
refreshes rotates the noise seed and drops the price carry; the column
potentials always carry.
"""

from __future__ import annotations

import time

import torch

from mmbench import reference as ref

MAX_DELTA_STREAK = 64


class Plan:
    """What the benchmark reads of a plan."""

    def __init__(self, placements, warm_g, warm_price, stats):
        self.placements = placements
        self.warm_g = warm_g
        self.warm_price = warm_price
        self.stats = stats


class StandIn:
    def __init__(self, fleet, solver: ref.Solver, clock, device,
                 dtype=torch.float8_e4m3fn):
        self.fleet, self.solver, self.clock = fleet, solver, clock
        self.device, self.dtype = torch.device(device), dtype
        self.seed = 0
        self.streak = None
        self.warm_g = self.warm_price = None

    def mark_dirty(self, models=(), instances=()) -> None:
        pass

    def refresh(self, models, instances, rpm_fn=None, incremental=False):
        t0 = time.perf_counter()
        fl, s = self.fleet, self.solver
        delta = self.streak is not None and self.streak < MAX_DELTA_STREAK
        self.streak = self.streak + 1 if delta else 0
        if not delta:
            self.seed += 1
            self.warm_price = None
        cols = ref.columns(fl.state, self.clock.now_ms())
        if s.topk:
            sol = ref.solve_topk(cols, s, self.seed, self.warm_g,
                                 self.warm_price, self.device, self.dtype)
            idx, valid, price, g = sol.idx, sol.valid, sol.price, sol.g
            overflow = sol.overflow
            iters = {"sinkhorn_iters_run": sol.sinkhorn_iters,
                     "auction_iters_run": sol.auction_iters, "topk": s.topk}
        else:
            C = ref.cost(cols, self.device, self.dtype)
            tr = ref.transport(C, cols, s, self.warm_g)
            sc = ref.scores(C, tr, s, self.seed, self.dtype)
            del C
            idx, valid, price, overflow = ref.auction(sc, cols, s,
                                                      self.warm_price)
            g = tr.g
            iters = {"sinkhorn_iters_run": s.sinkhorn_iters,
                     "auction_iters_run": s.auction_iters}
        idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
        placements = {
            mid: [fl.pod_ids[j] for j in idx[i][valid[i]].tolist()]
            for i, mid in enumerate(fl.model_ids)
        }
        g = g.float().cpu().numpy()
        p = price.float().cpu().numpy()
        self.warm_g = g
        self.warm_price = p
        ms = (time.perf_counter() - t0) * 1e3
        stats = {"overflow": overflow, "delta_snapshot": delta,
                 "solver_path": "sparse" if s.topk else "dense", **iters,
                 "snapshot_ms": 0.0, "dispatch_ms": ms,
                 "readback_wait_ms": 0.0, "extract_ms": 0.0}
        return Plan(placements,
                    dict(zip(fl.pod_ids, g.astype(float).tolist())),
                    dict(zip(fl.pod_ids, p.astype(float).tolist())), stats)
