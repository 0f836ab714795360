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
the configuration states it; ``solver_from`` refuses any other.

Everything works on the real rows and columns: padding a problem to a
bucket adds inert rows (no mass) and infeasible columns, which change no
real potential or choice.
"""

from __future__ import annotations

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

COST_WEIGHTS = dict(move=1.0, utilization=0.5, balance=0.35, preference=0.75,
                    lru_age=0.25, zone_spread=0.15, num_zones=8)


class Solver(NamedTuple):
    """The solve's knobs, as a configuration states them."""

    eps: float
    sinkhorn_iters: int
    auction_iters: int
    eta: float
    tau: float


def solver_from(cfg: dict) -> Solver:
    """The knobs of ``cfg``; a solve this reference does not implement (a
    top-K tier, a convergence gate, fewer selection slots than
    MAX_COPIES) is refused."""
    s = cfg["solver"]
    if (int(s["topk"]) != 0 or float(s["sinkhorn_tol"]) != 0.0
            or float(s["auction_stall_tol"]) != 0.0
            or int(s["sel_width"]) != MAX_COPIES):
        raise ValueError("the reference implements the dense tier with its "
                         "gates off only")
    return Solver(
        eps=float(s["eps"]), sinkhorn_iters=int(s["sinkhorn_iters"]),
        auction_iters=int(s["auction_iters"]), eta=float(s["eta"]),
        tau=float(s["tau"]),
    )


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


def cost(c: Columns, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The [n, m] cost matrix in float32 arithmetic, stored in ``dtype``
    (bf16 as the configurations state it; fp8 for the control, clamped to
    fp8's range first). No pod here has type constraints or is out of
    service, so every pair is feasible and preferred."""
    w = COST_WEIGHTS
    n, m = len(c.sizes), len(c.capacity)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    loaded = torch.zeros((n, m), dtype=torch.float32, device=device)
    loaded[t(c.rows), t(c.cols)] = 1.0
    sizes = t(c.sizes)
    # Integer sizes: the sums are exact in any order.
    loaded_mass = (sizes.double() @ loaded.double()).float()
    used_frac = torch.clamp((t(c.reserved) + loaded_mass)
                            / torch.clamp_min(t(c.capacity), 1.0), 0.0, 1.5)
    busy, age, rate = _minmax(t(c.busy)), _minmax(t(c.lru_age)), _minmax(
        t(c.rates))
    zone = t(c.zone)
    in_range = (zone >= 0) & (zone < w["num_zones"])
    zone_ix = zone.clamp(0, w["num_zones"] - 1)
    onehot = (torch.nn.functional.one_hot(zone_ix, w["num_zones"]).float()
              * in_range[:, None])
    per_zone = loaded @ onehot
    denom = torch.clamp_min(per_zone.sum(dim=1, keepdim=True), 1.0)
    crowding = torch.where(in_range[None, :], (per_zone / denom)[:, zone_ix],
                           0.0)
    per_pod = w["utilization"] * used_frac - w["lru_age"] * age
    # Every pair is preferred and feasible: those two terms add 0.
    out = (w["move"] * (1.0 - loaded) + per_pod[None, :]
           + w["balance"] * rate[:, None] * busy[None, :]
           + w["zone_spread"] * crowding)
    return quantize(out, dtype)


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


def _pick(vals, cols, copies):
    """The best MAX_COPIES of each row's (vals, cols), valid where the
    slot is under the row's copies and feasible."""
    k = min(MAX_COPIES, vals.shape[1])
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
