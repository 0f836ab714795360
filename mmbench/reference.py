"""Plain reference of one global rebalance: columns, cost, transport,
rounding.

It imports numpy and torch only, and nothing of the system under test.
From the fleet's state (the numpy arrays the traffic generator wrote
into the records) it works out the snapshot columns, the cost matrix,
the Sinkhorn potentials (float64), the noisy plan scores and, for the
control and the CPU tests, a whole plan by congestion-price repair. The
semantics are those of the placement solve as its design states them:

    cost[i, j] = move (1 - loaded) + utilization used_frac[j]
                 - lru_age age[j] + balance rate[i] busy[j]
                 + zone_spread crowding[i, j] + preference (1 - preferred)
                 + INFEASIBLE (1 - feasible)

in float32, stored in the configuration's cost dtype; semi-unbalanced
log-domain Sinkhorn over every pair (rows equalities, columns caps,
g <= 0) for a fixed number of iterations; plan logits (f + g - C) / eps
in the cost dtype plus counter-hash Gumbel noise; best-iterate
congestion-price repair of the integral assignment for a fixed number of
price steps. That is the dense tier with its convergence gates off, as
the configuration states it.

The top-K tier (``topk`` > 0) narrows each row to candidates first: its
``topk`` columns of least noisy key, cost plus salted counter-hash Gumbel
noise at the gather's temperature, the infeasible penalty sorting
feasible columns first and ties going to the lower column; the candidate
mask is every column whose key is at or under the row's K-th. Sinkhorn
runs over that mask (float64), the plan scores and the price repair over
the K gathered columns, each selection keeping ``sel_width`` slots. Its
two convergence gates run as the configuration states them: a one-step
probe of the column potentials, then chunks until the row marginals are
within ``sinkhorn_tol``; a one-step probe of the prices, then rounds
until they stall under ``auction_stall_tol``. Given the iteration counts
a program reported, the transport and the auction run to those counts
instead, and record what each gate read on the way (``check.py`` judges
the program's stops by them). The top-K tier works in blocks of rows and
keeps only the candidates, so a fleet of a million rows fits on one card.
``solver_from`` refuses any other solve.

Everything works on the real rows and columns: padding a problem to a
bucket adds inert rows (no mass) and infeasible columns, which change no
real potential or choice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

MAX_COPIES = 8
K_CAND = 4 * MAX_COPIES      # the dense auction's shortlist width
ROUND = 8                    # price iterations per shortlist round
NEG = -1.0e9                 # score of an infeasible pair
INFEASIBLE = 1.0e4           # cost penalty of an infeasible pair
TINY = 1e-30
_C1, _C2, _MASK = 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF
# fp8's largest finite value: the control's costs are clamped to it.
FP8_MAX = 448.0
# The top-K tier's gather: the Gumbel scale of its selection key (cost
# units) and the salt that makes its draw independent of the rounding
# noise at the same (row, column).
GATHER_TAU = 0.5
GATHER_SALT = 0x9E3779B9
# Elements of the cost matrix the top-K tier holds at once (a block of
# rows; float32 and int64 temporaries of this many elements).
BLOCK_ELEMENTS = 1 << 26

COST_WEIGHTS = dict(move=1.0, utilization=0.5, balance=0.35, preference=0.75,
                    lru_age=0.25, zone_spread=0.15, num_zones=8)


class Solver(NamedTuple):
    """The solve's knobs, as a configuration states them."""

    eps: float
    sinkhorn_iters: int
    auction_iters: int
    eta: float
    tau: float
    topk: int = 0
    sel_width: int = MAX_COPIES
    sinkhorn_tol: float = 0.0
    sinkhorn_chunk: int = 4
    auction_stall_tol: float = 0.0


def solver_from(cfg: dict) -> Solver:
    """The knobs of ``cfg``. Refused: a dense tier (``topk`` 0) with a
    convergence gate or fewer selection slots than MAX_COPIES; a top-K
    tier as wide as the pods (the program would solve it dense), with
    selection slots outside 1..MAX_COPIES, or with a negative tolerance."""
    s = cfg["solver"]
    solver = Solver(
        eps=float(s["eps"]), sinkhorn_iters=int(s["sinkhorn_iters"]),
        auction_iters=int(s["auction_iters"]), eta=float(s["eta"]),
        tau=float(s["tau"]), topk=int(s["topk"]),
        sel_width=int(s["sel_width"]), sinkhorn_tol=float(s["sinkhorn_tol"]),
        sinkhorn_chunk=int(s["sinkhorn_chunk"]),
        auction_stall_tol=float(s["auction_stall_tol"]),
    )
    if solver.topk == 0:
        if (solver.sinkhorn_tol != 0.0 or solver.auction_stall_tol != 0.0
                or solver.sel_width != MAX_COPIES):
            raise ValueError("the reference implements the dense tier with "
                             "its gates off only")
        return solver
    pods = cfg.get("pods")
    if (solver.topk < 0 or (pods is not None and solver.topk >= int(pods))
            or not 1 <= solver.sel_width <= MAX_COPIES
            or solver.sinkhorn_tol < 0.0 or solver.auction_stall_tol < 0.0):
        raise ValueError("the reference implements a top-K tier narrower "
                         "than the pods, with 1..MAX_COPIES selection slots "
                         "and tolerances of 0 or more")
    return solver


# --------------------------------------------------------------------------
# Columns and cost


class Columns(NamedTuple):
    sizes: np.ndarray      # f32[n]
    copies: np.ndarray     # i64[n], clipped to 1..MAX_COPIES
    rates: np.ndarray      # f32[n]
    rows: np.ndarray       # i64[nnz] loaded pairs
    cols: np.ndarray       # i64[nnz]
    capacity: np.ndarray   # f32[m]
    reserved: np.ndarray   # f32[m]
    lru_age: np.ndarray    # f32[m]
    busy: np.ndarray       # f32[m]
    zone: np.ndarray       # i64[m] the pod's zone among the sorted zones

    @property
    def free(self) -> np.ndarray:
        return np.maximum(self.capacity - self.reserved, 0.0).astype(
            np.float32)

    @property
    def demand(self) -> float:
        return float(np.sum(self.sizes.astype(np.float64) * self.copies))


def columns(state: dict, now_ms: int) -> Columns:
    """The snapshot columns of the fleet in ``state`` at ``now_ms``: a
    model's rate is its rpm, or where that reads 0 a recency proxy
    1000 / (1 + minutes since last use); a pod's reserved units are its
    advertised use beyond the mass of the models loaded on it."""
    sizes = state["sizes"].astype(np.float32)
    copies = np.clip(state["copies"].astype(np.int64), 1, MAX_COPIES)
    rpm = state["rpm"].astype(np.float32)
    age_min = np.maximum(0.0, (now_ms - state["last_used"]) / 60_000.0)
    rates = np.where(rpm > 0, rpm, 1000.0 / (1.0 + age_min)).astype(np.float32)
    loaded_on = state["loaded_on"]
    rows = np.nonzero(loaded_on >= 0)[0].astype(np.int64)
    cols = loaded_on[rows].astype(np.int64)
    m = len(state["capacity"])
    managed = np.bincount(cols, weights=sizes[rows], minlength=m).astype(
        np.float32)
    used = state["used"].astype(np.float32)
    reserved = np.maximum(0.0, used - managed).astype(np.float32)
    lru_ts = state["lru_ts"]
    lru_age = np.where(lru_ts > 0, np.maximum(0.0, (now_ms - lru_ts) / 1000.0),
                       0.0).astype(np.float32)
    return Columns(
        sizes=sizes, copies=copies, rates=rates, rows=rows, cols=cols,
        capacity=np.maximum(state["capacity"].astype(np.float32), 1.0),
        reserved=reserved, lru_age=lru_age,
        busy=state["busy"].astype(np.float32),
        zone=state["zone"].astype(np.int64),
    )


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.min()
    span = x.max() - lo
    return torch.where(span > 0, (x - lo) / torch.clamp_min(span, 1e-30), 0.0)


class CostParts(NamedTuple):
    """The cost's statistics over the whole problem: the per-pod term and
    norms, the zones, the rows' rate norm, the loaded pairs."""

    per_pod: torch.Tensor   # f32[m]
    busy: torch.Tensor      # f32[m]
    rate: torch.Tensor      # f32[n]
    zone_ix: torch.Tensor   # i64[m]
    in_range: torch.Tensor  # bool[m]
    onehot: torch.Tensor    # f32[m, zones]
    rows: torch.Tensor      # i64[nnz] loaded pairs
    cols: torch.Tensor      # i64[nnz]


def cost_parts(c: Columns, device) -> CostParts:
    """The cost's whole-problem statistics, without the [n, m] matrix."""
    w = COST_WEIGHTS
    m = len(c.capacity)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    # Integer sizes: the sums are exact in any order.
    loaded_mass = torch.bincount(
        t(c.cols), weights=t(c.sizes)[t(c.rows)].double(),
        minlength=m).float()
    used_frac = torch.clamp((t(c.reserved) + loaded_mass)
                            / torch.clamp_min(t(c.capacity), 1.0), 0.0, 1.5)
    zone = t(c.zone)
    in_range = (zone >= 0) & (zone < w["num_zones"])
    zone_ix = zone.clamp(0, w["num_zones"] - 1)
    onehot = (torch.nn.functional.one_hot(zone_ix, w["num_zones"]).float()
              * in_range[:, None])
    return CostParts(
        per_pod=w["utilization"] * used_frac - w["lru_age"] * _minmax(
            t(c.lru_age)),
        busy=_minmax(t(c.busy)), rate=_minmax(t(c.rates)), zone_ix=zone_ix,
        in_range=in_range, onehot=onehot, rows=t(c.rows), cols=t(c.cols),
    )


def cost_rows(parts: CostParts, r0: int, r1: int,
              dtype=torch.bfloat16) -> torch.Tensor:
    """Rows ``r0:r1`` of the cost matrix: each element from its row's
    loaded pods and zone counts and the whole problem's statistics
    (``cost_parts``), so a block's elements are the whole matrix's."""
    w = COST_WEIGHTS
    m = len(parts.per_pod)
    dev = parts.per_pod.device
    loaded = torch.zeros((r1 - r0, m), dtype=torch.float32, device=dev)
    inside = (parts.rows >= r0) & (parts.rows < r1)
    loaded[parts.rows[inside] - r0, parts.cols[inside]] = 1.0
    per_zone = loaded @ parts.onehot
    denom = torch.clamp_min(per_zone.sum(dim=1, keepdim=True), 1.0)
    crowding = torch.where(parts.in_range[None, :],
                           (per_zone / denom)[:, parts.zone_ix], 0.0)
    out = (w["move"] * (1.0 - loaded) + parts.per_pod[None, :]
           + w["balance"] * parts.rate[r0:r1, None] * parts.busy[None, :]
           + w["zone_spread"] * crowding)
    return quantize(out, dtype)


def cost(c: Columns, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The [n, m] cost matrix in float32 arithmetic, stored in ``dtype``
    (bf16 as the configurations state it; fp8 for the control, clamped to
    fp8's range first). No pod here has type constraints or is out of
    service, so every pair is feasible and preferred: those two terms add
    0. ``cost_rows`` gives a block of its rows."""
    return cost_rows(cost_parts(c, device), 0, len(c.sizes), dtype)


def quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held as float32 (fp8 saturates)."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        x = torch.clamp(x, -FP8_MAX, FP8_MAX)
    return x.to(dtype).to(torch.float32)


# --------------------------------------------------------------------------
# The counter-hash Gumbel draw: fmix32 (murmur3's finalizer) of the row
# state and the column, uint32 values held in int64.


def _mul32(v: torch.Tensor, k: int) -> torch.Tensor:
    lo = v * (k & 0xFFFF)
    hi = ((v * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(v: torch.Tensor) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = _mul32(v, _C1)
    v = v ^ (v >> 13)
    v = _mul32(v, _C2)
    return v ^ (v >> 16)


def gumbel(rows: torch.Tensor, cols: torch.Tensor, seed: int) -> torch.Tensor:
    """Gumbel(0, 1) at (row, col) for ``seed``, in float32: the top 24
    bits of the hash as a uniform in [1e-7, 1), then -log(-log(u)).
    ``rows`` and ``cols`` broadcast."""
    x_row = _fmix32(rows.long() ^ ((int(seed) * _C2) & _MASK))
    bits = _fmix32(x_row ^ _mul32(cols.long(), _C1))
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-7)))


def _grid(n: int, m: int, device):
    return (torch.arange(n, device=device)[:, None],
            torch.arange(m, device=device)[None, :])


# --------------------------------------------------------------------------
# Transport


class Transport(NamedTuple):
    f: torch.Tensor        # f64[n]
    g: torch.Tensor        # f64[m]


def transport(C: torch.Tensor, c: Columns, s: Solver,
              g0: Optional[np.ndarray]) -> Transport:
    """Sinkhorn potentials in float64 from ``g0`` (clamped to g <= 0;
    zeros when None) over every pair, ``s.sinkhorn_iters`` iterations."""
    dev = C.device
    Cd = C.double()
    a = torch.as_tensor(c.sizes, device=dev).double() * torch.as_tensor(
        c.copies, device=dev).double()
    b = torch.as_tensor(c.free, device=dev).double()
    la, lb = torch.log(torch.clamp_min(a, TINY)), torch.log(
        torch.clamp_min(b, TINY))
    eps = s.eps
    g = torch.zeros(len(b), dtype=torch.float64, device=dev)
    if g0 is not None:
        g = torch.clamp_max(torch.as_tensor(g0, device=dev).double(), 0.0)
    f = torch.zeros_like(a)
    for _ in range(s.sinkhorn_iters):
        f = eps * (la - torch.logsumexp((g[None, :] - Cd) / eps, dim=1))
        g = torch.clamp_max(
            eps * (lb - torch.logsumexp((f[:, None] - Cd) / eps, dim=0)), 0.0)
    return Transport(f, g)


def scores(C: torch.Tensor, tr: Transport, s: Solver, seed: int,
           dtype=torch.bfloat16) -> torch.Tensor:
    """The noisy plan scores [n, m] in float32: logits (f + g - C) / eps
    from float32 potentials, rounded to ``dtype``, plus tau Gumbel(0, 1)
    at ``seed``."""
    f, g = tr.f.float(), tr.g.float()
    z = quantize((f[:, None] + g[None, :] - C) / s.eps, dtype)
    rows, cols = _grid(*C.shape, C.device)
    return z + s.tau * gumbel(rows, cols, seed) if s.tau > 0 else z


# --------------------------------------------------------------------------
# Rounding: best-iterate congestion-price repair


def price_step(load, cap, price, eta):
    pressure = load / cap - 1.0
    step = torch.where(pressure > 0, torch.clamp(pressure, 0.0, 2.0),
                       0.25 * torch.clamp_max(pressure + 0.1, 0.0))
    return torch.clamp_min(price + eta * step, 0.0)


def _top(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _pick(vals, cols, copies, width: int = MAX_COPIES):
    """The best ``width`` (at most MAX_COPIES) of each row's (vals, cols)
    in MAX_COPIES slots, valid where the slot is under the row's copies
    and feasible."""
    k = min(width, vals.shape[1])
    v, pos = _top(vals, k)
    idx = torch.gather(cols, 1, pos)
    if k < MAX_COPIES:
        v = torch.nn.functional.pad(v, (0, MAX_COPIES - k), value=NEG)
        idx = torch.nn.functional.pad(idx, (0, MAX_COPIES - k))
    slot = torch.arange(MAX_COPIES, device=v.device)[None, :]
    return idx, (slot < copies[:, None]) & (v > NEG / 2)


def implied_load(idx, valid, sizes, m: int) -> torch.Tensor:
    """Units the assignment puts on each pod (exact: integer sizes)."""
    w = (sizes.double()[:, None] * valid.double()).reshape(-1)
    load = torch.zeros(m, dtype=torch.float64, device=sizes.device)
    return load.index_add_(0, idx.reshape(-1), w).float()


def auction(sc: torch.Tensor, c: Columns, s: Solver,
            price0: Optional[np.ndarray]):
    """Integral assignment of the scores ``sc`` [n, m] from the prices
    ``price0`` (zeros when None): rounds of ROUND price steps, each
    selecting the rows' best slots at the current prices within the
    K_CAND best at the round's opening prices, tracking the
    least-overflow iterate and its prices; then a last selection over
    every pod at the final prices competes with it. Returns (idx, valid,
    prices, overflow)."""
    dev = sc.device
    n, m = sc.shape
    sizes = torch.as_tensor(c.sizes, device=dev)
    copies = torch.as_tensor(c.copies, device=dev)
    cap = torch.clamp_min(torch.as_tensor(c.free, device=dev), 1e-6)
    kc = min(K_CAND, m)
    all_cols = torch.arange(m, device=dev)[None, :].expand(n, m)

    def overflow(idx, valid):
        load = implied_load(idx, valid, sizes, m)
        return load, float(torch.clamp_min(load - cap, 0.0).sum())

    price = torch.zeros(m, dtype=torch.float32, device=dev)
    if price0 is not None:
        price = torch.clamp_min(torch.as_tensor(price0, device=dev).float(),
                                0.0)
    best = None    # (price, idx, valid, overflow)
    left = s.auction_iters
    while left > 0:
        _, cols = _top(sc - price[None, :], kc)
        vals = torch.gather(sc, 1, cols)
        for _ in range(min(ROUND, left)):
            idx, valid = _pick(vals - price[cols], cols, copies)
            load, of = overflow(idx, valid)
            if best is None or of < best[3]:
                best = (price, idx, valid, of)
            price = price_step(load, cap, price, s.eta)
        left -= ROUND
    idx, valid = _pick(sc - price[None, :], all_cols, copies)
    _, of = overflow(idx, valid)
    if best is None or of <= best[3]:
        return idx, valid, price, of
    return best[1], best[2], best[0], best[3]


# --------------------------------------------------------------------------
# The top-K tier: candidates, masked transport, price repair over the
# candidates, and the two convergence gates


class Candidates(NamedTuple):
    """Each row's candidate mask, in the order of its selection key
    (ascending, ties to the lower column): ``idx`` its columns (-1 past
    the row's count), ``member`` where an entry is one, ``cost`` the cost
    there (float32, 0 past the count). The first ``k`` are the gathered
    candidates the auction works over."""

    idx: torch.Tensor      # i64[n, W]
    member: torch.Tensor   # bool[n, W]
    cost: torch.Tensor     # f32[n, W]
    k: int


def candidates(c: Columns, s: Solver, seed: int, device,
               dtype=torch.bfloat16, block_rows: Optional[int] = None
               ) -> Candidates:
    """The top-K tier's candidates at noise ``seed``, a block of rows at a
    time: the key is the cost minus GATHER_TAU Gumbel(0, 1) drawn at
    (row, column) under the salted seed; each row keeps its ``s.topk``
    least keys and every column whose key ties the K-th."""
    n, m = len(c.sizes), len(c.capacity)
    k = min(s.topk, m)
    salted = (int(seed) ^ GATHER_SALT) & _MASK
    parts = cost_parts(c, device)
    step = block_rows or max(1, BLOCK_ELEMENTS // max(m, 1))
    cols = torch.arange(m, device=device)[None, :]
    blocks = []
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        C = cost_rows(parts, r0, r1, dtype)
        rows = torch.arange(r0, r1, device=device)[:, None]
        key = C - GATHER_TAU * gumbel(rows, cols, salted)
        thresh = torch.topk(key, k, dim=1, largest=False).values.amax(dim=1)
        width = int((key <= thresh[:, None]).sum(dim=1).max())
        ix = torch.topk(key, width, dim=1, largest=False).indices
        ix = torch.sort(ix, dim=1).values
        order = torch.sort(torch.gather(key, 1, ix), dim=1,
                           stable=True).indices
        ix = torch.gather(ix, 1, order)
        member = torch.gather(key, 1, ix) <= thresh[:, None]
        blocks.append((r0, ix, member, torch.gather(C, 1, ix)))
        del C, key
    width = max((b[1].shape[1] for b in blocks), default=k)
    idx = torch.full((n, width), -1, dtype=torch.int64, device=device)
    member = torch.zeros((n, width), dtype=torch.bool, device=device)
    cost_k = torch.zeros((n, width), dtype=torch.float32, device=device)
    for r0, ix, mb, cb in blocks:
        r1, w = r0 + ix.shape[0], ix.shape[1]
        idx[r0:r1, :w] = torch.where(mb, ix, -1)
        member[r0:r1, :w] = mb
        cost_k[r0:r1, :w] = torch.where(mb, cb, 0.0)
    return Candidates(idx=idx, member=member, cost=cost_k, k=k)


def _lse_rows(z: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(torch.where(member, z, -torch.inf), dim=1)


def _lse_cols(z: torch.Tensor, idx: torch.Tensor, member: torch.Tensor,
              m: int) -> torch.Tensor:
    """Each column's log-sum-exp of ``z`` over the rows whose candidate it
    is (-inf where it is nobody's)."""
    zf = torch.where(member, z, -torch.inf).reshape(-1)
    j = torch.clamp_min(idx, 0).reshape(-1)
    top = torch.full((m,), -torch.inf, dtype=z.dtype, device=z.device)
    top = top.scatter_reduce(0, j, zf, "amax")
    shift = torch.where(torch.isfinite(top), top, 0.0)
    total = torch.zeros(m, dtype=z.dtype, device=z.device).index_add_(
        0, j, torch.exp(zf - shift[j]))
    return torch.log(total) + shift


class Gates(NamedTuple):
    """What a gate read on the way: the probe's reading and each later
    chunk's or round's, and the iterations run."""

    probe: tuple
    steps: list
    run: int


def transport_topk(cand: Candidates, c: Columns, s: Solver,
                   g0: Optional[np.ndarray], iters_run: Optional[int] = None
                   ) -> tuple[Transport, Gates]:
    """Semi-unbalanced Sinkhorn over the candidate mask, float64, from
    ``g0`` (clamped to g <= 0; zeros when None). With P = exp((rowmin -
    C) / eps) on the mask, an iteration is r = max(P exp(g / eps), TINY),
    f = eps (log a - log r) + rowmin, g = min(0, eps (log b - log max(
    (a / r) P, TINY))). The gate (``sinkhorn_tol`` > 0): one probing
    iteration, done when its largest move of g is at most tol * eps;
    else chunks of ``sinkhorn_chunk`` iterations until the row marginals'
    relative L1 error is at most tol or ceil(iters / chunk) chunks have
    run. ``iters_run`` given: run to it (the gate's readings recorded),
    whatever the gate would say."""
    dev = cand.cost.device
    n, m = len(c.sizes), len(c.capacity)
    Ck = cand.cost.double()
    idx, member = torch.clamp_min(cand.idx, 0), cand.member
    eps = s.eps
    a = torch.as_tensor(c.sizes, device=dev).double() * torch.as_tensor(
        c.copies, device=dev).double()
    b = torch.as_tensor(c.free, device=dev).double()
    la, lb = torch.log(torch.clamp_min(a, TINY)), torch.log(
        torch.clamp_min(b, TINY))
    log_tiny = math.log(TINY)
    rowmin = torch.where(member, Ck, torch.inf).amin(dim=1)
    shifted = rowmin[:, None] - Ck

    def log_r(g):
        return torch.clamp_min(_lse_rows((shifted + g[idx]) / eps, member),
                               log_tiny)

    def iterate(g):
        f = eps * (la - log_r(g)) + rowmin
        log_c = torch.clamp_min(_lse_cols((f[:, None] - Ck) / eps, idx,
                                          member, m), log_tiny)
        return f, torch.clamp_max(eps * (lb - log_c), 0.0)

    def err(f, g):
        row_sum = torch.exp((f - rowmin) / eps + log_r(g))
        return float((row_sum - a).abs().sum() / torch.clamp_min(a.sum(),
                                                                 TINY))

    g = torch.zeros(m, dtype=torch.float64, device=dev)
    if g0 is not None:
        g = torch.clamp_max(torch.as_tensor(g0, device=dev).double(), 0.0)
    f = torch.zeros(n, dtype=torch.float64, device=dev)
    iters, tol = s.sinkhorn_iters, s.sinkhorn_tol
    if tol <= 0.0 or s.sinkhorn_chunk <= 0 or iters <= 0:
        run = iters if iters_run is None else int(iters_run)
        for _ in range(run):
            f, g = iterate(g)
        return Transport(f, g), Gates((), [], run)
    chunk = min(s.sinkhorn_chunk, iters)
    chunks = -(-iters // chunk)
    f, g1 = iterate(g)
    probe = (float((g1 - g).abs().max()) if m else 0.0,)
    g, run, steps = g1, 1, []
    if (probe[0] <= tol * eps) if iters_run is None else iters_run <= 1:
        return Transport(f, g), Gates(probe, steps, run)
    while True:
        for _ in range(chunk):
            f, g = iterate(g)
        run += chunk
        steps.append(err(f, g))
        if len(steps) >= chunks or (
                not steps[-1] > tol if iters_run is None
                else run >= iters_run):
            return Transport(f, g), Gates(probe, steps, run)


def scores_topk(cand: Candidates, tr: Transport, s: Solver, seed: int,
                dtype=torch.bfloat16) -> torch.Tensor:
    """The noisy plan scores of the K gathered candidates [n, K], as
    ``scores`` gives them at those columns."""
    idx, C = cand.idx[:, :cand.k], cand.cost[:, :cand.k]
    f, g = tr.f.float(), tr.g.float()
    z = quantize((f[:, None] + g[idx] - C) / s.eps, dtype)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return z + s.tau * gumbel(rows, idx, seed) if s.tau > 0 else z


class Auction(NamedTuple):
    idx: torch.Tensor      # i64[n, MAX_COPIES]
    valid: torch.Tensor    # bool[n, MAX_COPIES]
    price: torch.Tensor    # f32[m] the prices the assignment was chosen at
    overflow: float
    gates: Gates


def auction_topk(sc: torch.Tensor, idx_k: torch.Tensor, c: Columns,
                 s: Solver, price0: Optional[np.ndarray],
                 iters_run: Optional[int] = None) -> Auction:
    """Best-iterate congestion-price repair over the gathered candidates
    (scores ``sc`` [n, K] at columns ``idx_k``) from ``price0`` (zeros
    when None); every selection keeps each row's ``sel_width`` best
    candidates at the current prices. Gates off (``auction_stall_tol``
    0): rounds of ROUND price steps, ``auction_iters`` in all. On: a
    selection and one price step at the carried prices, done when the
    step moves no price by more than tol or the overflow is at most tol
    of the demand; else rounds of ROUND steps until one stalls (no price
    moves more than tol, the best overflow is 0, or it improved by at
    most tol of the demand) or ceil(iters / ROUND) have run. The best
    iterate then competes with a selection at the final prices.
    ``iters_run`` given: run to it, the gates' readings recorded."""
    dev = sc.device
    m = len(c.capacity)
    sizes = torch.as_tensor(c.sizes, device=dev)
    copies = torch.as_tensor(c.copies, device=dev)
    cap = torch.clamp_min(torch.as_tensor(c.free, device=dev), 1e-6)
    width = min(s.sel_width, MAX_COPIES)
    stall, eta = s.auction_stall_tol, s.eta

    def select(price):
        return _pick(sc - price[idx_k], idx_k, copies, width)

    def overflow(idx, valid):
        load = implied_load(idx, valid, sizes, m)
        return load, float(torch.clamp_min(load - cap, 0.0).sum())

    def rounds(state, length):
        price, best = state
        for _ in range(length):
            idx, valid = select(price)
            load, of = overflow(idx, valid)
            if of < best[3]:
                best = (price, idx, valid, of)
            price = price_step(load, cap, price, eta)
        return price, best

    def finish(state, gates):
        price, best = state
        idx, valid = select(price)
        _, of = overflow(idx, valid)
        if of <= best[3]:
            return Auction(idx, valid, price, of, gates)
        return Auction(best[1], best[2], best[0], best[3], gates)

    price = torch.zeros(m, dtype=torch.float32, device=dev)
    if price0 is not None:
        price = torch.clamp_min(torch.as_tensor(price0, device=dev).float(),
                                0.0)
    none = (price, None, None, math.inf)
    if stall <= 0.0:
        state, left = (price, none), s.auction_iters
        while left > 0:
            state = rounds(state, min(ROUND, left))
            left -= ROUND
        return finish(state, Gates((), [], s.auction_iters))
    demand = float((sizes * copies.float()).sum())
    of_tol = stall * max(demand, 1e-30)
    idx, valid = select(price)
    load, of = overflow(idx, valid)
    stepped = price_step(load, cap, price, eta)
    probe = (float((stepped - price).abs().max()) if m else 0.0, of, of_tol)
    if ((probe[0] <= stall or of <= of_tol) if iters_run is None
            else iters_run <= 1):
        return Auction(idx, valid, stepped, of, Gates(probe, [], 1))
    state, steps, run = (stepped, (price, idx, valid, of)), [], 1
    limit = -(-s.auction_iters // ROUND)
    while len(steps) < limit:
        opened, best_in = state[0], state[1][3]
        state = rounds(state, ROUND)
        run += ROUND
        best_out = state[1][3]
        steps.append((float((state[0] - opened).abs().max()) if m else 0.0,
                      best_out, best_in - best_out))
        stalled = (steps[-1][0] <= stall or best_out <= 0.0
                   or steps[-1][2] <= of_tol)
        if (stalled and len(steps) < limit) if iters_run is None else (
                run >= iters_run):
            break
    return finish(state, Gates(probe, steps, run))


class TopK(NamedTuple):
    """A whole top-K solve: the assignment, its prices and overflow, the
    column potentials, and the iterations each gate let run."""

    idx: torch.Tensor
    valid: torch.Tensor
    price: torch.Tensor
    overflow: float
    g: torch.Tensor
    sinkhorn_iters: int
    auction_iters: int


def solve_topk(c: Columns, s: Solver, seed: int, g0, price0, device,
               dtype=torch.bfloat16) -> TopK:
    """The top-K tier with its own gates (the stand-ins')."""
    cand = candidates(c, s, seed, device, dtype)
    tr, sk = transport_topk(cand, c, s, g0)
    sc = scores_topk(cand, tr, s, seed, dtype)
    res = auction_topk(sc, cand.idx[:, :cand.k], c, s, price0)
    return TopK(res.idx, res.valid, res.price, res.overflow, tr.g, sk.run,
                res.gates.run)
