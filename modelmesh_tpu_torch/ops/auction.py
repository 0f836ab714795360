"""Integral rounding helpers of the sparse path: hash-Gumbel noise,
candidate selection, implied load and the congestion-price gates.

Port of the parts of ``modelmesh_tpu/ops/auction.py`` the sparse solve
uses. The JAX version's ``lax.while_loop``/``lax.cond`` gates become Python
control flow on a 0-d tensor, each read through ``device.item`` (one
counted host sync per decision).

Integers: PyTorch on the CPU has no uint32 ``>>``, so the murmur mix runs
on int64 tensors holding uint32 values, with every multiply split into
16-bit halves (no int64 overflow) and masked back to 32 bits. The bits are
the reference's exactly.
"""

from __future__ import annotations

import torch

from modelmesh_tpu_torch import device as device_mod

# Max copies of a single model the solver will place.
MAX_COPIES: int = 8
# Price iterations per convergence-gated round.
RESHORTLIST_EVERY: int = 8

_NEG_INF = -1.0e9
_MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


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
    vals, pos = torch.topk(eff, k, dim=1)
    return _finalize_topk(vals, torch.gather(cand_idx, 1, pos), copies)


def _implied_load(idx, valid, sizes, num_instances: int) -> torch.Tensor:
    """Memory load the assignment implies per instance (scatter-add)."""
    contrib = sizes[:, None] * valid.to(torch.float32)  # [N, K]
    load = torch.zeros(num_instances, dtype=torch.float32, device=sizes.device)
    return load.index_add_(0, idx.reshape(-1), contrib.reshape(-1))


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
        # Both solvers' carries lead with the price vector and end with the
        # best overflow.
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
