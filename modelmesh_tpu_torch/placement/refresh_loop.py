"""Pipelined steady-state refresh: the next snapshot overlaps the solve in
flight.

Port of ``modelmesh_tpu/placement/refresh_loop.py`` around
``TorchPlacementStrategy``. The blocking ``refresh`` runs the three
phases of a refresh (host snapshot, device solve, host plan extraction)
one after another. ``PipelinedRefresher.submit(N)`` instead

- builds snapshot N on the host (a delta patch when dirty tracking
  allows),
- dispatches solve N, chaining the warm-start carries (column potentials
  and prices) from solve N-1's output tensors on the device,
- and only then finalizes plan N-1 and installs it.

The installed plan lags the submitted snapshot by one refresh (plans are
advisory). The steady state is incremental-first: when the strategy's
gates allow (``_incremental_rows_locked``), a cycle re-solves only the
dirty rows against the frozen ``SolveBase``, and the base's merge target
advances to the in-flight solve's tensors at once: on one CUDA stream,
stream order makes the next cycle's merge read them after they are
written. Full solves re-freeze the base (the ``MAX_DELTA_STREAK`` rebuild,
instance churn, the drift and overflow gates).

A finished plan is installed by one reference assignment, so readers see
generation N-1 or N, never a mix.

Differences from the reference:

- **Finalizing waits for its own solve only.** ``dispatch_solve``
  enqueues the result's copy to pinned host memory with an event behind
  it; ``finalize_plan(N-1)`` waits on N-1's event, not on solve N's
  kernels, which are enqueued after it (``device.start_readback``).
- **Full dispatches are not asynchronous.** The Sinkhorn and auction
  gates read 0-d tensors on the host (``device.item``), so a full
  dispatch returns after its last gate; only incremental dispatches (no
  gates) return at once. Neither a worker thread nor device-side gates
  (a CUDA graph of fixed chunks) is used yet.
- **The dispatch's host-to-device copies block.** ``_expand_problem_device``
  copies pageable numpy with blocking ``.to()``, which waits for the
  stream, so dispatch N first waits for flight N-1's device work. At
  steady shapes that work is long done by then; ``plan.stats``
  ``dispatch_ms`` and ``readback_wait_ms`` show both costs.
- **No buffer donation.** PyTorch has no analog: ``donate="auto"``
  resolves to False and ``donate=True`` raises, as
  ``dispatch_solve(donate=True)`` does. (The reference also turns it off
  whenever the incremental path is enabled.)
- **Mesh.** A strategy with a mesh dispatches its full solves sharded
  (``dispatch_solve(mesh=...)``); its incremental path is off, so no base
  is frozen, as in the reference.

Not thread-safe per instance (the leader's refresh task is one loop);
plan installation is atomic, so request threads read concurrently.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from modelmesh_tpu_torch.placement.torch_engine import (
    INCREMENTAL_OVERFLOW_FRAC,
    GlobalPlan,
    PendingSolve,
    SolveBase,
    TorchPlacementStrategy,
    _bucket,
    dispatch_solve,
    finalize_plan,
)

log = logging.getLogger(__name__)


class _InFlight(NamedTuple):
    pending: PendingSolve
    generation: int
    delta: Optional[bool]
    # The noise-epoch seed the solve was dispatched under: its prices are
    # adoptable as a warm carry only while this is still the strategy's
    # seed (prices and the draw are a matched pair).
    seed: int


class PipelinedRefresher:
    """Double-buffered refresh loop around a ``TorchPlacementStrategy``."""

    def __init__(self, strategy: TorchPlacementStrategy,
                 donate: str = "auto"):
        if donate == "auto":
            donate = False
        if donate:
            raise NotImplementedError("buffer donation has no PyTorch port")
        self.strategy = strategy
        self._inflight: Optional[_InFlight] = None
        # Instance-id column order the in-flight solve's carry is aligned
        # to; a changed fleet breaks the device chain (the id-keyed host
        # dicts warm the next solve instead).
        self._carry_iids: Optional[list] = None
        self._donate = False

    def submit(
        self,
        models: Sequence,
        instances: Sequence,
        rpm_fn=None,
        incremental: bool = True,
    ) -> Optional[GlobalPlan]:
        """Snapshot and dispatch refresh N, then finalize and install plan
        N-1. Returns plan N-1; None on the first call (the pipeline is
        priming; ``drain()`` flushes the tail) or when plan N-1 was
        superseded by an interleaved blocking ``refresh()``."""
        strat = self.strategy
        if not models or not instances:
            # Nothing to solve: flush the pipeline, and keep the carries
            # for the next real refresh (a transient empty view must not
            # force a cold solve).
            return self.drain()
        with strat._refresh_lock:
            t0 = time.perf_counter()
            cols, delta, dm, di = strat._build_cols_locked(
                models, instances, rpm_fn, incremental
            )
            prev = self._inflight
            carry = None
            donated = False
            rows = strat._incremental_rows_locked(cols, delta, dm, di)
            if rows is not None:
                strat._generation += 1
                pending = dispatch_solve(
                    cols, seed=strat._seed, config=strat.solve_config,
                    base=strat._base, dirty_rows=rows, t_start=t0,
                    device=strat.device,
                )
                # Advance the merge target now, to the in-flight solve's
                # tensors: the next cycle's dirty rows merge into this
                # flight's assignment. The frozen column state (g, prices,
                # the overflow reference) stays at the full solve.
                strat._base = strat._base._replace(
                    indices=pending.sol.indices, valid=pending.sol.valid
                )
            else:
                # A flight superseded by a blocking refresh() must not
                # chain its carry: the newer full rebuild rotated the seed,
                # so the stale flight's prices belong to the old draw.
                cur = strat._plan
                superseded = (
                    prev is not None and cur is not None
                    and cur.generation > prev.generation
                )
                if delta and prev is not None and not superseded and (
                    self._carry_iids == cols.instance_ids
                ):
                    sol = prev.pending.sol
                    if sol.g is not None and sol.prices is not None and (
                        sol.g.shape[0] == _bucket(len(cols.instance_ids), 64)
                    ):
                        # Device to device: stream order, no host sync.
                        carry = (sol.g, sol.prices)
                        donated = self._donate
                # The strategy's noise-epoch discipline; the device chain,
                # when taken, supersedes the id-keyed dicts.
                warm_g, warm_price = strat._epoch_carries_locked(delta)
                strat._generation += 1
                pending = dispatch_solve(
                    cols, seed=strat._seed, mesh=strat.mesh,
                    warm_g=None if carry else warm_g,
                    warm_price=None if carry else warm_price,
                    config=strat.solve_config, carry=carry,
                    donate=donated, t_start=t0, device=strat.device,
                )
            self._inflight = _InFlight(
                pending, strat._generation, delta, strat._seed
            )
            self._carry_iids = cols.instance_ids
            plan = (
                self._finalize_install_locked(
                    prev, consumed=donated, chained=carry is not None
                )
                if prev else None
            )
        return plan

    def drain(self) -> Optional[GlobalPlan]:
        """Finalize the in-flight refresh (if any) and install its plan;
        the freshest installed plan."""
        strat = self.strategy
        with strat._refresh_lock:
            prev, self._inflight = self._inflight, None
            self._carry_iids = None
            if prev is None:
                return strat._plan
            out = self._finalize_install_locked(prev, consumed=False)
            # A superseded flight finalizes to None: the installed plan is
            # still the right one to hand back.
            return out if out is not None else strat._plan

    # -- internals ----------------------------------------------------------

    def _finalize_install_locked(
        self, flight: _InFlight, consumed: bool, chained: bool = False
    ) -> Optional[GlobalPlan]:
        """Wait for solve N-1's readback, pack the plan, install it
        atomically. None when a newer generation was installed meanwhile
        (the stale plan must not reach the caller's publish loop).

        ``consumed``: the carries were donated onward (never, in the
        port), so the host dicts keep their previous values. ``chained``:
        the next solve already took the carries on the device, so the host
        dicts are not rebuilt; incremental flights never rebuild them
        (their g and prices are the frozen base's)."""
        strat = self.strategy
        incremental = flight.pending.path == "incremental"
        plan = finalize_plan(
            flight.pending._replace(
                sol=_without_carries(flight.pending.sol)
                if consumed else flight.pending.sol
            ),
            fetch_carries=not (consumed or chained or incremental),
        )
        if flight.delta is not None:
            plan.stats["delta_snapshot"] = flight.delta
        plan.stats["pipelined"] = True
        plan.generation = flight.generation
        cur = strat._plan
        if cur is not None and cur.generation > flight.generation:
            # A blocking refresh() installed a newer plan while this flight
            # was in the air: installing it, adopting its carries or
            # handing it back would roll readers and the cluster back.
            log.info(
                "pipelined plan gen %d superseded by gen %d; dropped",
                flight.generation, cur.generation,
            )
            return None
        if plan.warm_g is not None:
            strat._warm_g = plan.warm_g
        # Prices only while the flight's seed is current: a full rebuild
        # dispatched after this flight rotated the seed. g is
        # draw-independent.
        if plan.warm_price is not None and flight.seed == strat._seed:
            strat._warm_price = plan.warm_price
        if incremental:
            # The deferred overflow gate: the merged plan already ships (one
            # increment past the budget at most), but a breach drops the
            # base so the next cycle re-freezes it with a full solve.
            base = strat._base
            if base is not None and base.seed == flight.seed:
                cols = flight.pending.cols
                demand = float(np.sum(cols.sizes * cols.copies))
                budget = base.overflow + INCREMENTAL_OVERFLOW_FRAC * max(
                    demand, 1e-9
                )
                if plan.stats["overflow"] > budget:
                    log.info(
                        "pipelined incremental overflow %.3g drifted past "
                        "the base solve's %.3g + %.2f%% of demand; next "
                        "cycle re-freezes the base with a full solve",
                        plan.stats["overflow"], base.overflow,
                        INCREMENTAL_OVERFLOW_FRAC * 100,
                    )
                    strat._base = None
        elif strat.mesh is None and not consumed:
            # Re-freeze the base from this full solve's device tensors,
            # unless the flight now in the air is incremental: it merged
            # into (and advanced) the existing base, and this older full
            # state would resurrect stale rows.
            sol = flight.pending.sol
            inflight = self._inflight
            if (
                sol.g is not None and sol.prices is not None
                and flight.seed == strat._seed
                and not (
                    inflight is not None
                    and inflight.pending.path == "incremental"
                )
            ):
                cols = flight.pending.cols
                strat._base = SolveBase(
                    indices=sol.indices, valid=sol.valid, g=sol.g,
                    prices=sol.prices, row_err=sol.row_err,
                    seed=flight.seed, overflow=plan.stats["overflow"],
                    rates=np.asarray(cols.rates, np.float32).copy(),
                )
        strat._plan = plan  # atomic install: readers see old or new, whole
        log.info(
            "pipelined plan installed: gen %d, %d models in %.1f ms "
            "(delta=%s)",
            plan.generation, plan.num_models(), plan.solve_ms, flight.delta,
        )
        return plan


def _without_carries(sol):
    """A Placement without its warm-carry outputs (carries donated
    onward): ``finalize_plan`` then builds no host dicts."""
    return sol._replace(g=None, prices=None)
