"""Integral rounding of the Sinkhorn soft plan: Gumbel-top-k + price repair.

Port of ``modelmesh_tpu/ops/auction.py`` (the design notes are there):
the hash-Gumbel draw, candidate selection, the implied load, the
congestion-price step and its gates, the dense ``auction`` over full-width
plan logits, and ``price_repair``, the best-iterate price loop that the
dense auction and the sparse one (``ops/sparse.py``) share. The JAX
version's ``lax.while_loop``/``lax.cond`` gates become Python control flow
on a 0-d tensor, each read through ``device.item`` (one counted host sync
per decision).

Integers: PyTorch on the CPU has no uint32 ``>>``, so the murmur mix runs
on int64 tensors holding uint32 values, with every multiply split into
16-bit halves (no int64 overflow) and masked back to 32 bits. The bits are
the reference's exactly.

Top-k order: ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` in no fixed order. Ties are common in the dense auction
(bf16 plan logits at tau = 0, infeasible entries all at -1e9), so every
selection here goes through ``top_k``, which keeps the reference's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import cuda_load

# Max copies of a single model the solver will place.
MAX_COPIES: int = 8
# Shortlist width of the dense auction's narrow rounds.
K_CAND: int = 4 * MAX_COPIES
# Price iterations per round (and per convergence-gated round).
RESHORTLIST_EVERY: int = 8

_NEG_INF = -1.0e9
_JITTER_KEY = 0x5EED
_MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35

THREEFRY_MISSING = (
    "noise_impl='threefry': the dense tier's threefry Gumbel draw is not "
    "ported (ROADMAP queue 1); use noise_impl='hash' or tau=0"
)


class AuctionResult(NamedTuple):
    indices: torch.Tensor   # i64[N, MAX_COPIES] chosen instance per slot
    valid: torch.Tensor     # bool[N, MAX_COPIES] slot is a real pick
    load: torch.Tensor      # f32[M] implied memory load
    prices: torch.Tensor    # f32[M] prices the assignment was selected at
    overflow: torch.Tensor  # f32[] sum of capacity overflow
    # Price iterations actually run (a host int: the gates ran on the host).
    iters_run: int = 0


def mul32(v: torch.Tensor, const: int) -> torch.Tensor:
    """``(v * const) mod 2**32`` for an int64 tensor of uint32 values."""
    lo = v * (const & 0xFFFF)                          # < 2**48
    hi = ((v * (const >> 16)) & 0xFFFF) << 16          # < 2**32
    return (lo + hi) & _MASK32


def fmix32(v: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    v = v ^ (v >> 16)
    v = mul32(v, _C1)
    v = v ^ (v >> 13)
    v = mul32(v, _C2)
    return v ^ (v >> 16)


def row_state(rows: torch.Tensor, seed: int) -> torch.Tensor:
    """Row-side half of the counter hash: ``fmix32(row ^ seed * C2)``."""
    return fmix32(rows ^ ((int(seed) * _C2) & _MASK32))


def hash_bits(x_row: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Full 32-bit counter hash from the row state and the column ids."""
    return fmix32(x_row ^ mul32(cols, _C1))


def gumbel_from_bits(x: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) from the hash: the top 24 bits give a uniform in
    [1e-7, 1) (0 would blow up the outer log), then the double log."""
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(torch.clamp_min(u, 1e-7)))


def hash_gumbel_at(
    rows: torch.Tensor, cols: torch.Tensor, seed: int
) -> torch.Tensor:
    """Gumbel(0, 1) at explicit (row, col) counter positions — a pure
    function of (row, col, seed), so gathered and full-width evaluations
    of one position see the same draw. ``rows``/``cols`` are integer
    tensors that broadcast against each other."""
    return gumbel_from_bits(hash_bits(row_state(rows.long(), seed),
                                      cols.long()))


def hash_gumbel(shape: tuple[int, int], seed: int, row_offset: int = 0,
                device=None) -> torch.Tensor:
    """Counter-based Gumbel(0, 1) noise over a whole [N, M] block; rows
    count from ``row_offset``, so a block of rows draws what the full
    matrix draws there."""
    n, m = shape
    rows = torch.arange(n, dtype=torch.int64, device=device) + int(row_offset)
    cols = torch.arange(m, dtype=torch.int64, device=device)
    return hash_gumbel_at(rows[:, None], cols[None, :], seed)


def gumbel_perturb(scores: torch.Tensor, tau: float, seed: int,
                   impl: str = "hash", row_offset: int = 0) -> torch.Tensor:
    """``scores`` in f32 plus Gumbel(0, tau) noise, so top-k draws ~
    softmax(scores / tau). Only the "hash" draw is ported."""
    if impl not in ("threefry", "hash"):
        raise ValueError(f"noise impl {impl!r} (expected threefry | hash)")
    if impl == "threefry":
        raise NotImplementedError(THREEFRY_MISSING)
    g = hash_gumbel(scores.shape, seed, row_offset, device=scores.device)
    return scores.to(torch.float32) + tau * g


def top_k(x: torch.Tensor, k: int):
    """Top-``k`` of ``x`` along dim 1, descending, ties broken toward the
    lower index (``jax.lax.top_k``'s order). Returns (vals, idx).

    A stable descending sort, cut to ``k``: on an H100 at [131072, 1024]
    it takes about what ``torch.topk`` takes, and a third of what
    ``torch.topk`` over a tie-free packed int64 key takes (PERF.md). The
    results are views into the sorted rows (no copy)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _finalize_topk(vals, idx, copies):
    """Pad to MAX_COPIES slots + validity mask."""
    k = vals.shape[1]
    if k < MAX_COPIES:
        pad = MAX_COPIES - k
        vals = torch.nn.functional.pad(vals, (0, pad), value=_NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad))
    slot = torch.arange(MAX_COPIES, device=vals.device)[None, :]
    valid = (slot < copies[:, None]) & (vals > _NEG_INF / 2)
    return idx, valid


def select_from_candidates(cand_vals, cand_idx, copies, price,
                           sel_k: int = MAX_COPIES):
    """Top-``sel_k`` within a row's candidate shortlist at ``price``,
    padded to the MAX_COPIES output slots. ``cand_vals`` holds raw scores
    (no price baked in), so the selection is exact at any price."""
    eff = cand_vals - price[cand_idx]                    # [N, kc]
    k = min(min(sel_k, MAX_COPIES), eff.shape[1])
    vals, pos = top_k(eff, k)
    return _finalize_topk(vals, torch.gather(cand_idx, 1, pos), copies)


def shortlist(scores: torch.Tensor, price: torch.Tensor, kc: int):
    """Row shortlist at current prices; returns (raw_vals, idx). The
    reference's approx_max_k equals its exact top_k off the TPU, and the
    port has only the exact one."""
    _, idx = top_k(scores - price[None, :], kc)
    return torch.gather(scores, 1, idx), idx


def _select(scores_minus_price: torch.Tensor, copies: torch.Tensor):
    """Full-width exact top-MAX_COPIES per row + validity mask (padded to
    MAX_COPIES slots on clusters smaller than that)."""
    k = min(MAX_COPIES, scores_minus_price.shape[1])
    vals, idx = top_k(scores_minus_price, k)
    return _finalize_topk(vals, idx, copies)


def _implied_load(idx, valid, sizes, num_instances: int,
                  impl: str = "scatter") -> torch.Tensor:
    """Memory load the assignment implies per instance: "scatter"
    (``index_add_``; on the card its float atomics sum in another order on
    every run) or "fused" (``cuda_load.implied_load``: the fixed-order
    kernel on the card, the reference's one-hot compare-reduce on the
    CPU). ``impl`` comes resolved (``resolve_load_impl``)."""
    if impl not in ("scatter", "fused"):
        raise ValueError(f"unresolved load impl {impl!r}")
    if impl == "fused":
        return cuda_load.implied_load(idx, valid, sizes, num_instances)
    contrib = sizes[:, None] * valid.to(torch.float32)  # [N, K]
    load = torch.zeros(num_instances, dtype=torch.float32, device=sizes.device)
    return load.index_add_(0, idx.reshape(-1), contrib.reshape(-1))


def resolve_load_impl(load_impl: str, device=None) -> str:
    """Validate the implied-load knob and resolve "auto" for ``device``:
    "fused" (the fixed-order kernel, reproducible run to run) for CUDA
    tensors, "scatter" elsewhere, as the reference's "auto" means scatter
    off the TPU. An explicit "scatter" on the card is ``index_add_``, whose
    float atomics make the load, and so the placement, differ from run to
    run."""
    if load_impl not in ("auto", "scatter", "fused"):
        raise ValueError(
            f"load_impl={load_impl!r} (expected auto | scatter | fused)"
        )
    if load_impl != "auto":
        return load_impl
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return "fused" if on_cuda else "scatter"


def check_rounding_config(noise_impl: str, final_select: str, iters: int):
    """Validate the rounding knobs (the reference's checks, unchanged)."""
    if noise_impl not in ("threefry", "hash"):
        raise ValueError(
            f"noise_impl={noise_impl!r} (expected threefry | hash)"
        )
    if final_select not in ("exact", "approx", "none"):
        raise ValueError(
            f"final_select={final_select!r} (expected exact | approx | none)"
        )
    if final_select == "none" and iters < 1:
        raise ValueError("final_select='none' requires iters >= 1")


def check_auction_config(*, noise_impl: str, final_select: str, iters: int,
                         tau: float, load_impl: str) -> None:
    """Every knob the dense auction reads, checked before any work."""
    check_rounding_config(noise_impl, final_select, iters)
    resolve_load_impl(load_impl)
    if tau > 0 and noise_impl == "threefry":
        raise NotImplementedError(THREEFRY_MISSING)


def price_step(load, cap, price, eta_t):
    """One synchronous congestion-price update: rise with clipped overload
    pressure; decay gently when under 90% full."""
    pressure = load / cap - 1.0
    step = torch.where(
        pressure > 0,
        torch.clamp(pressure, 0.0, 2.0),
        0.25 * torch.clamp_max(pressure + 0.1, 0.0),
    )
    return torch.clamp_min(price + eta_t * step, 0.0)


def warm_probe(select_fn, p_init, cap, load_fn, eta_eff, stall_tol: float,
               total_demand):
    """One selection at the carried prices and one price step. ``probe_ok``
    (a 0-d bool tensor) certifies the carry: the step stalled, or the
    overflow is already below the stall noise floor. Returns
    (idx_p, valid_p, load_p, of_p, p_probe, probe_ok)."""
    of_tol = stall_tol * torch.clamp_min(total_demand, 1e-30)
    idx_p, valid_p = select_fn(p_init)
    load_p = load_fn(idx_p, valid_p)
    of_p = torch.clamp_min(load_p - cap, 0.0).sum()
    p_probe = price_step(load_p, cap, p_init, eta_eff)
    dprice = (p_probe - p_init).abs().max()
    probe_ok = (dprice <= stall_tol) | (of_p <= of_tol)
    return idx_p, valid_p, load_p, of_p, p_probe, probe_ok


def _stall_gated_rounds(narrow_round, carry, iters: int, stall_tol: float,
                        total_demand):
    """Rounds of RESHORTLIST_EVERY price iterations until one stalls (price
    movement <= stall_tol, best overflow at zero, or best-overflow
    improvement <= stall_tol of demand) or the budget is spent. One host
    sync per round. Returns (carry, iterations_run)."""
    n_rounds = -(-iters // RESHORTLIST_EVERY)
    of_tol = stall_tol * torch.clamp_min(total_demand, 1e-30)
    rnd = 0
    while rnd < n_rounds:
        # The carry leads with the price vector and ends with the best
        # overflow.
        price_in, bo_in = carry[0], carry[-1]
        carry = narrow_round(carry, RESHORTLIST_EVERY)
        price_out, bo_out = carry[0], carry[-1]
        dprice = (price_out - price_in).abs().max()
        improved = torch.where(torch.isinf(bo_in), torch.inf, bo_in - bo_out)
        stalled = (dprice <= stall_tol) | (bo_out <= 0.0) | (improved <= of_tol)
        rnd += 1
        # The last round needs no gate read: the budget ends the loop.
        if rnd < n_rounds and device_mod.item(stalled):
            break
    return carry, rnd * RESHORTLIST_EVERY


def price_repair(round_select, final_select_fn, load_fn, sizes, copies, cap,
                 *, iters: int, eta: float, final_select: str,
                 stall_tol: float, price0) -> AuctionResult:
    """Best-iterate congestion-price repair, shared by the dense and the
    sparse auction. ``round_select(price)`` gives the selection function
    of a round opening at ``price`` (the dense auction shortlists there;
    the sparse candidates are fixed); ``final_select_fn(price)`` is the
    epilogue-grade selection (full width dense, the candidates sparse);
    ``load_fn(idx, valid)`` the implied load. ``copies`` is clamped to
    MAX_COPIES and ``cap`` to >= 1e-6 by the caller.

    Synchronous price dynamics limit-cycle, so the loop tracks the
    best-overflow assignment seen and the price it was selected at (the
    warm-start carry); the epilogue's selection at the final prices
    competes with it unless ``final_select == "none"``. ``stall_tol`` > 0
    gates the rounds (``_stall_gated_rounds``) after a one-step warm probe
    (``warm_probe``), which "none" skips."""
    n = copies.shape[0]
    dev = cap.device

    def overflow(load):
        return torch.clamp_min(load - cap, 0.0).sum()

    def narrow_round(carry, length):
        price, bp, bi, bv, bl, bo = carry
        select = round_select(price)
        for _ in range(length):
            idx, valid = select(price)
            load = load_fn(idx, valid)
            of = overflow(load)
            better = of < bo
            bp = torch.where(better, price, bp)
            bi = torch.where(better, idx, bi)
            bv = torch.where(better, valid, bv)
            bl = torch.where(better, load, bl)
            bo = torch.minimum(of, bo)
            price = price_step(load, cap, price, eta)
        return price, bp, bi, bv, bl, bo

    def epilogue(carry, iters_run):
        price, best_price, best_idx, best_valid, best_load, best_of = carry
        if final_select == "none":
            return AuctionResult(best_idx, best_valid, best_load, best_price,
                                 best_of, iters_run)
        idx_l, valid_l = final_select_fn(price)
        load_l = load_fn(idx_l, valid_l)
        of_l = overflow(load_l)
        use_last = of_l <= best_of
        return AuctionResult(
            indices=torch.where(use_last, idx_l, best_idx),
            valid=torch.where(use_last, valid_l, best_valid),
            load=torch.where(use_last, load_l, best_load),
            prices=torch.where(use_last, price, best_price),
            overflow=torch.minimum(of_l, best_of),
            iters_run=iters_run,
        )

    p_init = (
        torch.clamp_min(price0.to(torch.float32), 0.0)  # price >= 0 invariant
        if price0 is not None
        else torch.zeros(cap.shape[0], dtype=torch.float32, device=dev)
    )
    carry = (
        p_init,
        p_init,
        torch.zeros((n, MAX_COPIES), dtype=torch.int64, device=dev),
        torch.zeros((n, MAX_COPIES), dtype=torch.bool, device=dev),
        torch.zeros(cap.shape[0], dtype=torch.float32, device=dev),
        torch.tensor(torch.inf, dtype=torch.float32, device=dev),
    )
    if stall_tol <= 0.0:
        # Honor `iters` exactly: whole rounds plus one partial round.
        for length in [RESHORTLIST_EVERY] * (iters // RESHORTLIST_EVERY) + (
            [iters % RESHORTLIST_EVERY] if iters % RESHORTLIST_EVERY else []
        ):
            carry = narrow_round(carry, length)
        return epilogue(carry, iters)

    total_demand = (sizes * copies.to(torch.float32)).sum()
    if final_select == "none":
        carry, iters_run = _stall_gated_rounds(
            narrow_round, carry, iters, stall_tol, total_demand,
        )
        return epilogue(carry, iters_run)

    idx_p, valid_p, load_p, of_p, p_probe, probe_ok = warm_probe(
        final_select_fn, p_init, cap, load_fn, eta, stall_tol, total_demand,
    )
    if device_mod.item(probe_ok):
        # The stepped prices, not p_init: steady-state drift keeps nudging
        # the carry toward the current load pattern.
        return AuctionResult(idx_p, valid_p, load_p, p_probe, of_p, 1)
    seeded = (p_probe, p_init, idx_p, valid_p, load_p, of_p)
    carry, iters_run = _stall_gated_rounds(
        narrow_round, seeded, iters, stall_tol, total_demand,
    )
    return epilogue(carry, iters_run + 1)


def auction(
    scores: torch.Tensor,     # [N, M] plan logits, higher is better
    sizes: torch.Tensor,      # f32[N]
    copies: torch.Tensor,     # i32[N]
    capacity: torch.Tensor,   # f32[M]
    feasible: torch.Tensor,   # bool[N, M]
    seed: int = _JITTER_KEY,
    *,
    iters: int = 40,
    eta: float = 0.5,
    price_scale: float = 1.0,
    tau: float = 1.0,
    load_impl: str = "auto",
    noise_impl: str = "hash",
    final_select: str = "exact",
    stall_tol: float = 0.0,
    price0: torch.Tensor | None = None,
) -> AuctionResult:
    """Gumbel-top-k sampling + best-iterate congestion-price repair over
    the full-width plan logits (the dense tier).

    Each round shortlists every row's K_CAND best instances at the round's
    opening prices, then runs its price iterations on that [N, K_CAND]
    block (``price_repair``). ``final_select``: "exact" competes a
    full-width top-k at the final prices with the best iterate; "approx"
    is the same here (the reference's approx_max_k equals its exact top_k
    off the TPU); "none" returns the best iterate. ``price_scale``
    converts prices into score units."""
    check_auction_config(noise_impl=noise_impl, final_select=final_select,
                         iters=iters, tau=tau, load_impl=load_impl)
    num_instances = capacity.shape[0]
    load_impl = resolve_load_impl(load_impl, scores.device)
    seed = int(seed) & _MASK32
    scores_f32 = (
        gumbel_perturb(scores, tau, seed, impl=noise_impl)
        if tau > 0 else scores.to(torch.float32)
    )
    scores_f32 = torch.where(feasible, scores_f32, _NEG_INF)
    cap = torch.clamp_min(capacity.to(torch.float32), 1e-6)
    copies = torch.clamp_max(copies, MAX_COPIES)
    kc = min(K_CAND, num_instances)

    def round_select(price):
        cand_vals, cand_idx = shortlist(scores_f32, price, kc)
        return lambda p: select_from_candidates(cand_vals, cand_idx, copies, p)

    def final_select_fn(price):
        return _select(scores_f32 - price[None, :], copies)

    def load_fn(idx, valid):
        return _implied_load(idx, valid, sizes, num_instances, load_impl)

    return price_repair(
        round_select, final_select_fn, load_fn, sizes, copies, cap,
        iters=iters, eta=eta * price_scale, final_select=final_select,
        stall_tol=stall_tol, price0=price0,
    )
