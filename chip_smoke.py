#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``modelmesh_tpu_torch/csrc``
             (nvcc, sm_90a, one process per source, all at once) and print
             the card's name and power limit.
2. kernels — each sparse kernel against its plain PyTorch version on the
             card at the 100k x 1k tier's padded shape (C bf16[131072, 1024]
             from a seed; the top-K selection with K = 24, and the
             mask-only mode on its thresholds), at the
             wide path's [12288, 1536] (two column slabs, the cp.async ring),
             at a ragged [1000, 1001] and an odd [1000, 1537] (scalar loads,
             the register stage), and on 4096 rows of tied costs (hundreds
             of candidates a row) 1024 and 1536 wide: the selection's ids,
             thresholds, rowmin and packed mask bits bitwise (and the share
             of entries whose exact key it computed), the mask-only mode's
             rowmin and bits bitwise, the flat-integrand candidate counts of the
             row, column and fused products exact, the products at rtol 1e-5
             / atol 1e-6; time per launch over a run of 20 at the shape each
             kernel's path gives it (the column-only pass: the wide path's;
             it and the row-only pass also at the other shape), the fused
             step beside the row and column products back to back, and the
             column passes' device time split between the pass and the
             combine of its block partials (profiler); the selection beside
             the unfused route it replaces (PyTorch-op key, stable top-K,
             K-th key, the mask-only kernel). The guard band's draw bound,
             checked over all 2^24 uniforms. The implied-load kernel at the
             auctions' shape (int64[131072, 8] -> 1024, the sparse
             auction's 5-slot view, 1536 instances): bitwise at integer
             sizes, rtol 1e-6 at f32 sizes, two launches bitwise, timed
             beside index_add_.
   lse_kernels — the row-only, column-only and fused LSE kernels against
             their plain versions at the tier, at the dense tier's real
             widths ([131072, 128], [1000, 96], [1000, 64]), at a ragged
             [1000, 1001] and, the column-only kernel's slabs, at the wide
             path's [12288, 1536] and an odd [1000, 1537] (LSE, running max
             and the fused step's f at atol 1e-4 / rtol 1e-5), the extreme
             case at the tier (C and shifts x 30: finite, rtol 1e-5), z of
             one row bit for bit; time per launch over a run of 20 at the
             tier, at [131072, 128] and at [12288, 1536], beside the bound,
             the plain version and torch.logsumexp over a materialized z;
             the fused step beside the row and column kernels back to back,
             and its device time split between pass and combine.
3. main    — the production dispatch at 100,000 models x 1,000 instances
             (synthetic fleet at 85% utilization): snapshot_columns ->
             dispatch_solve -> finalize_plan on the sparse path, one warm-up
             then 5 solves with varied seeds, kernel launch counters zeroed
             just before (per solve one selection, no mask-only pass, one
             implied load per auction iteration and one more); two solves
             with one seed byte-identical.
   profile — one more main-path solve under torch.profiler: device time
             by kernel name and the device's idle share of the solve.
4. parity  — one 20,000 x 256 snapshot solved on the card and on the CPU
             (plain versions): placement agreement >= 0.97 and overflow
             within 0.5% of demand.
   wide    — the same at 10,000 x 1,200 (1536 padded instances, wider than
             the fused step's 1024 columns, so each Sinkhorn iteration runs
             the row and column products back to back); the sparse launch
             counters are zeroed just before the card's solve and read just
             after: the column-only kernel's path.
5. dense_main — the same 100k x 1k fleet on the dense tier (the
             reference's "full Sinkhorn", pinned with MM_SOLVER_SPARSE=0
             around the phase): one warm-up, 5 solves with the default
             config, LSE launch counters zeroed just before (per solve: one
             fused step per Sinkhorn iteration, one row-only pass, no
             column-only pass, one host sync, one implied load per auction
             iteration and one more; two same-seed solves byte-identical);
             then one solve with the
             steady gates, and the tie-stable top-k against torch.sort /
             torch.topk at the auction's shortlist shape.
   dense_profile — one dense solve under torch.profiler.
6. dense_parity — a 10,000 x 128 snapshot, which the auto rule routes
             dense, on the card and on the CPU, with phase 4's gates.
7. dense_wide — the wide fleet (10,000 x 1,200, 1536 padded columns)
             pinned dense, on the card and on the CPU, with phase 4's
             gates: the row and column LSE back to back on every
             iteration, no fused step; the column-only kernel's path.

Then the card line from nvidia-smi, one JSON line with every kernel's
numbers, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero before printing any result.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import (
    _build, auction, cuda_lse, cuda_sparse, sparse,
)
from modelmesh_tpu_torch.ops.auction import K_CAND, MAX_COPIES
from modelmesh_tpu_torch.placement.synthetic import synthetic_records
from modelmesh_tpu_torch.placement.torch_engine import (
    dispatch_solve,
    finalize_plan,
    snapshot_columns,
    solve_config_from_env,
)

SEED = 20260
TIER = (131072, 1024)          # _bucket(100_000) x _bucket(1_000, 64)
MAIN_FLEET = (100_000, 1_000)
PARITY_FLEET = (20_000, 256)
WIDE_FLEET = (10_000, 1_200)   # pads to 1536 columns: wider than the fused step
WIDE = (12288, 1536)           # the wide fleet's padded shape
RAGGED = (1000, 1001)
TIES_ROWS = 4096
DENSE_PARITY_FLEET = (10_000, 128)   # pads to 128 columns: auto routes dense
STEADY_UTILIZATION = 0.85
KERNEL_REPS = 20
MAIN_SOLVES = 5
# Published H100 peaks (NVIDIA data sheets): device memory bytes/s by part,
# and f32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
PEAK_F32_OPS_PER_S = 67e12
# f32/int32 operations by the data sheet's count, per cost-matrix element
# and per candidate (set mask bit). select_candidates and masked_row_min:
# the selection key (hash: 10 integer ops; uniform, clamp, two logs, two
# negations, scale, subtract), the mask test and the min, on every element.
# implied_load, per slot: the weight's multiply and the add. The bit-reading
# kernels: a bit test and a convert per element; per candidate a subtract,
# a divide, an exp and a multiply-add (the fused step one more
# multiply-add, for the column). The LSE kernels: subtract, scale, max,
# subtract, exp, add; the fused LSE step both reductions.
OPS_PER_ELEMENT = {"select_candidates": 20, "masked_row_min": 20,
                   "masked_row_matvec": 2,
                   "masked_col_matvec": 2, "masked_sinkhorn_step": 2,
                   "row_lse_partial": 6, "col_lse_partial": 6,
                   "lse_sinkhorn_step": 12, "implied_load": 2}
OPS_PER_CANDIDATE = {"masked_row_matvec": 5, "masked_col_matvec": 5,
                     "masked_sinkhorn_step": 7}
REPLACES = {
    "select_candidates": "modelmesh_tpu/ops/pallas_sparse.py:196",
    "masked_row_min": "modelmesh_tpu/ops/pallas_sparse.py:196",
    "masked_row_matvec": "modelmesh_tpu/ops/pallas_sparse.py:226",
    "masked_col_matvec": "modelmesh_tpu/ops/pallas_sparse.py:260",
    "masked_sinkhorn_step": ("modelmesh_tpu/ops/pallas_sparse.py:226, "
                             "modelmesh_tpu/ops/pallas_sparse.py:260"),
    "row_lse_partial": "modelmesh_tpu/ops/pallas_lse.py:130",
    "col_lse_partial": "modelmesh_tpu/ops/pallas_lse.py:167",
    "lse_sinkhorn_step": ("modelmesh_tpu/ops/pallas_lse.py:130, "
                          "modelmesh_tpu/ops/pallas_lse.py:167"),
    # A TPU-only path, not a Pallas kernel.
    "implied_load": "modelmesh_tpu/ops/auction.py:144",
}
SOURCES = {"masked_sparse": "modelmesh_tpu_torch/csrc/masked_sparse.cu",
           "lse": "modelmesh_tpu_torch/csrc/lse.cu",
           "implied_load": "modelmesh_tpu_torch/csrc/implied_load.cu"}
LSE_EPS = 0.05
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# Where the LSE kernels are held against their plain versions: the tier,
# the dense tier's real widths (128 at 100k models; 96 and 64), ragged C,
# and the column-only kernel's slabs (the wide path's shape and an odd
# width); the extreme case runs at the tier.
LSE_SHAPES = {"tier": TIER, "narrow": (131072, 128), "w96": (1000, 96),
              "w64": (1000, 64), "ragged": RAGGED, "wide": WIDE,
              "wide_odd": (1000, 1537)}
LSE_TIMED = ("tier", "narrow", "wide")
SPARSE_EPS = 0.05
SPARSE_K = 24
SPARSE_TOL = dict(rtol=1e-5, atol=1e-6)
# The auctions' implied load at the main path's shape: N x MAX_COPIES slots
# onto the tier's instances, sizes as the synthetic fleet's (16-255).
LOAD_TOL = dict(rtol=1e-6, atol=0.0)


def load_ops():
    """The implied-load wrappers, imported where a phase needs them, so
    that tools/sparse_kernel_times.py can run this module's helpers on a
    tree from before them."""
    from modelmesh_tpu_torch.ops import cuda_load

    return cuda_load


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peak_bytes_per_s(name: str) -> float:
    for part, rate in PEAK_BYTES_PER_S.items():
        if part in name:
            return rate
    return PEAK_BYTES_PER_S["SXM"]


def time_ms(fn, reps: int) -> float:
    """Device time of one ``fn``: CUDA events around ``reps`` runs back to
    back, over ``reps``, after a warm-up run. The host enqueues ahead of
    the card, so a short kernel is not charged its launch latency."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(name: str, nbytes: int, elements: int, card: str,
          candidates: int = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the f32 rate, whichever is larger. ``candidates``:
    this run's set mask bits, for the kernels whose work depends on them."""
    bytes_ms = nbytes / peak_bytes_per_s(card) * 1e3
    ops = (OPS_PER_ELEMENT[name] * elements
           + OPS_PER_CANDIDATE.get(name, 0) * candidates)
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    # Per library: each kernel's entry line, then its registers and spills.
    ptxas = {
        lib: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
              if "entry function" in ln or "registers" in ln
              or "spill" in ln]
        for lib, log in _build.build_log.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas})


def sparse_operands(C, seed=SEED):
    """Thresholds from the port's top-K gather of C (K = 24; no selection
    noise when ``seed`` is None)."""
    feasible = torch.ones(C.shape, dtype=torch.bool, device=C.device)
    _, _, _, fz = sparse.topk_candidates(C, feasible, SPARSE_K, seed=seed)
    return (C, fz.thresh, fz.x_row), dict(tau=fz.tau, noised=fz.noised)


def selection_operands(C, seed=SEED):
    """The gather's row hash state of C (selection noise at ``seed``,
    none when it is None) and the selection's keywords."""
    noised = seed is not None
    salted = 0 if seed is None else (seed ^ sparse._GATHER_SALT) & 0xFFFFFFFF
    x_row = cuda_sparse.noise_row_state(C.shape[0], salted, C.device)
    return x_row, dict(tau=sparse.GATHER_TAU, noised=noised)


def bitwise_differs(a, b) -> int:
    """Elements of a and b whose bits differ."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum().item())


def check_sparse_kernels(C, tag: str, seed=SEED) -> dict:
    """Every sparse kernel against its plain version on C: the selection's
    ids, thresholds, rowmin and bits bitwise, the mask-only mode's rowmin
    and bits on the plain thresholds bitwise, flat-integrand counts exact,
    products within SPARSE_TOL. Returns what phase_kernels times: the
    operands, the bit-reading kernels (name -> (kernel, plain version)),
    the candidate count, the errors and the selection's exact-key share."""
    n, m = C.shape
    x_row, kw = selection_operands(C, seed)
    exact = torch.zeros(n, dtype=torch.int32, device=C.device)
    sel = cuda_sparse.select_candidates(C, x_row, SPARSE_K,
                                        exact_counts=exact, **kw)
    sel_ref = cuda_sparse.select_candidates_ref(C, x_row, min(SPARSE_K, m),
                                                **kw)
    differs = {f: bitwise_differs(getattr(sel, f), getattr(sel_ref, f))
               for f in sel._fields}
    check(not any(differs.values()),
          f"{tag}: select_candidates differs bitwise from its plain version "
          f"({differs})")
    args = (C, sel_ref.thresh, x_row)
    rowmin, bits = cuda_sparse.masked_row_min(*args, **kw)
    rowmin_ref, bits_ref = cuda_sparse.masked_row_min_ref(*args, **kw)
    check(torch.equal(rowmin.view(torch.int32), rowmin_ref.view(torch.int32)),
          f"{tag}: masked_row_min differs bitwise from its plain version")
    check(torch.equal(bits, bits_ref),
          f"{tag}: masked_row_min's bits differ from the plain packing")
    check(torch.equal(bits, sel.bits),
          f"{tag}: the selection's bits differ from masked_row_min's")
    pass_args = (C, bits, rowmin)
    fused = m <= cuda_sparse.FUSED_MAX_COLS

    # Flat integrand (eps = 1e30 makes every in-mask exp exactly 1.0f): the
    # products count candidates, and must match as exact integers. The
    # fused step's row mass is the row counts, so u = 1 and its column
    # product counts too.
    ones_m = torch.ones(m, device=C.device)
    ones_n = torch.ones(n, device=C.device)
    rc_ref = cuda_sparse.masked_row_matvec_ref(*pass_args, ones_m, eps=1e30)
    cc_ref = cuda_sparse.masked_col_matvec_ref(*pass_args, ones_n, eps=1e30)
    check(torch.equal(
        cuda_sparse.masked_row_matvec(*pass_args, ones_m, eps=1e30), rc_ref),
        f"{tag}: row candidate counts differ")
    check(torch.equal(
        cuda_sparse.masked_col_matvec(*pass_args, ones_n, eps=1e30), cc_ref),
        f"{tag}: column candidate counts differ")
    if fused:
        r, c = cuda_sparse.masked_sinkhorn_step(
            *pass_args, ones_m, rc_ref, eps=1e30)
        check(torch.equal(r, rc_ref) and torch.equal(c, cc_ref),
              f"{tag}: fused candidate counts differ")
    check(int(rc_ref.min().item()) >= SPARSE_K,
          f"{tag}: a row has fewer than K candidates")

    gen = torch.Generator(device=C.device).manual_seed(SEED + 3)
    v = torch.rand(m, generator=gen, device=C.device) + 0.1
    u = torch.rand(n, generator=gen, device=C.device) + 0.1
    row_mass = torch.rand(n, generator=gen, device=C.device) * 8 + 1
    eps = dict(eps=SPARSE_EPS)
    ops = {
        "masked_row_matvec": (
            functools.partial(cuda_sparse.masked_row_matvec, *pass_args, v,
                              **eps),
            functools.partial(cuda_sparse.masked_row_matvec_ref, *pass_args,
                              v, **eps)),
        "masked_col_matvec": (
            functools.partial(cuda_sparse.masked_col_matvec, *pass_args, u,
                              **eps),
            functools.partial(cuda_sparse.masked_col_matvec_ref, *pass_args,
                              u, **eps)),
    }
    if fused:
        ops["masked_sinkhorn_step"] = (
            functools.partial(cuda_sparse.masked_sinkhorn_step, *pass_args,
                              v, row_mass, **eps),
            functools.partial(cuda_sparse.masked_sinkhorn_step_ref,
                              *pass_args, v, row_mass, **eps))

    def flat(out):  # the fused step's (r, c) as one vector
        return torch.cat(out) if isinstance(out, tuple) else out

    errors = {"select_candidates": 0.0, "masked_row_min": 0.0}
    for name, (kernel, plain) in ops.items():
        got, ref = flat(kernel()), flat(plain())
        errors[name] = float((got - ref).abs().max().item())
        check(torch.allclose(got, ref, **SPARSE_TOL),
              f"{tag}: {name} differs from its plain version "
              f"(max abs {errors[name]})")
    return {"args": args, "kw": kw, "x_row": x_row, "pass_args": pass_args,
            "v": v, "row_mass": row_mass, "ops": ops,
            "candidates": int(rc_ref.sum().item()), "errors": errors,
            "exact_share": float(exact.sum().item()) / (n * m),
            "exact_max_per_row": int(exact.max().item())}


def phase_kernels(dev, card: str) -> dict:
    n, m = TIER
    gen = torch.Generator(device=dev).manual_seed(SEED)
    C = (torch.randn((n, m), generator=gen, device=dev) * 3.0).to(
        torch.bfloat16
    )
    wide_odd = (torch.randn((WIDE[0], WIDE[1] + 1), generator=gen,
                            device=dev) * 3.0).to(torch.bfloat16)
    # The guard band's bound on the fast draw, over every uniform.
    draw_err, draw_bound = cuda_sparse.gumbel_err(dev)
    check(math.isfinite(draw_err) and draw_err <= draw_bound,
          f"the fast Gumbel draw is {draw_err} from the exact one, over the "
          f"band's bound {draw_bound}")
    # The unvectorized paths first: odd widths (no 16-byte loads, no ring
    # stage, a ballot per mask word; one and two column slabs) and ragged
    # last words and blocks.
    cases = {
        "ragged": check_sparse_kernels(
            C[:RAGGED[0], :RAGGED[1]].contiguous(), "ragged"),
        "wide_odd": check_sparse_kernels(
            wide_odd[:RAGGED[0]].contiguous(), "wide_odd"),
    }
    # Rows with more than 32 candidates (the column kernels' later rounds,
    # the selection's hundreds of exact keys), in one column slab and in
    # two: costs in {0, 1, 2} and no selection noise, so the K-th key ties
    # with a third of the row.
    ties = torch.randint(0, 3, (TIES_ROWS, WIDE[1]), generator=gen,
                         device=dev).to(torch.bfloat16)
    cases["ties"] = check_sparse_kernels(ties[:, :m].contiguous(), "ties",
                                         seed=None)
    cases["ties_wide"] = check_sparse_kernels(ties, "ties_wide", seed=None)
    del ties
    # The wide path's shape: the column-only pass's second slab.
    w = cases["wide"] = check_sparse_kernels(
        wide_odd[:, :WIDE[1]].contiguous(), "wide")
    del wide_odd
    t = cases["tier"] = check_sparse_kernels(C, "tier")
    args, kw, pass_args = t["args"], t["kw"], t["pass_args"]
    x_row = t["x_row"]

    def unfused_route():
        """What the selection replaces: the PyTorch-op key, the stable
        top-K, the K-th key, then the mask-only kernel."""
        key = cuda_sparse.selection_key(C, x_row, **kw)
        neg_vals, _ = auction.top_k(-key, SPARSE_K)
        cuda_sparse.masked_row_min(C, -neg_vals.amin(dim=1), x_row, **kw)

    def row_then_col():
        """The unfused iteration: row product, clamp, divide, column."""
        r = torch.clamp_min(cuda_sparse.masked_row_matvec(
            *pass_args, t["v"], eps=SPARSE_EPS), cuda_sparse.TINY)
        cuda_sparse.masked_col_matvec(*pass_args, t["row_mass"] / r,
                                      eps=SPARSE_EPS)

    def nbytes(name, shape):
        """Bytes the function must move: its inputs once, its outputs
        once."""
        rows, cols = shape
        c_bytes = rows * cols * 2
        bits_bytes = rows * cuda_sparse.mask_words(cols) * 4
        return {
            "select_candidates": c_bytes + 3 * rows * 4 + bits_bytes
            + rows * SPARSE_K * 8,
            "masked_row_min": c_bytes + 3 * rows * 4 + bits_bytes,
            "masked_row_matvec": c_bytes + bits_bytes + 2 * rows * 4
            + cols * 4,
            "masked_col_matvec": c_bytes + bits_bytes + 2 * rows * 4
            + cols * 4,
            "masked_sinkhorn_step": c_bytes + bits_bytes + 3 * rows * 4
            + 2 * cols * 4,
        }[name]

    calls = {
        "select_candidates": (
            lambda: cuda_sparse.select_candidates(C, x_row, SPARSE_K, **kw),
            lambda: cuda_sparse.select_candidates_ref(C, x_row, SPARSE_K,
                                                      **kw)),
        "masked_row_min": (
            lambda: cuda_sparse.masked_row_min(*args, **kw),
            lambda: cuda_sparse.masked_row_min_ref(*args, **kw)),
    }
    calls.update(t["ops"])
    # Each kernel at the shape its path gives it: the column-only pass runs
    # on the wide path alone (the tier takes the fused step).
    at = {name: (TIER, calls[name], t) for name in calls}
    at["masked_col_matvec"] = (WIDE, w["ops"]["masked_col_matvec"], w)
    results = {}
    for name, (shape, (kernel, plain), case) in at.items():
        results[name] = {
            "shape": list(shape), "max_abs_err": case["errors"][name],
            "ms": time_ms(kernel, KERNEL_REPS),
            "plain_ms": time_ms(plain, 5), "library_ms": None,
            **bound(name, nbytes(name, shape), shape[0] * shape[1], card,
                    case["candidates"]),
        }
    # The row-only and column-only passes at the other path's shape too.
    results["masked_row_matvec"]["wide_ms"] = time_ms(
        w["ops"]["masked_row_matvec"][0], KERNEL_REPS)
    results["masked_col_matvec"]["tier_ms"] = time_ms(
        calls["masked_col_matvec"][0], KERNEL_REPS)
    results["masked_sinkhorn_step"]["row_then_col_ms"] = time_ms(
        row_then_col, KERNEL_REPS)
    results["select_candidates"]["unfused_route_ms"] = time_ms(
        unfused_route, 5)
    results["select_candidates"]["kernel_split_ms"] = kernel_split_ms(
        calls["select_candidates"][0], KERNEL_REPS)
    results["select_candidates"]["unfused_route_split_ms"] = kernel_split_ms(
        unfused_route, 5)
    # The pass and its combine of block partials, apart, at the tier.
    for name in ("masked_col_matvec", "masked_sinkhorn_step"):
        results[name]["tier_kernel_split_ms"] = kernel_split_ms(
            calls[name][0], KERNEL_REPS)
    emit({"phase": "kernels", "card": card,
          "shapes_checked": {"tier": [n, m], "wide": list(WIDE),
                             "ragged": list(RAGGED),
                             "wide_odd": [RAGGED[0], WIDE[1] + 1],
                             "ties": [TIES_ROWS, m],
                             "ties_wide": [TIES_ROWS, WIDE[1]]},
          "counting_exact": True, "candidates": t["candidates"],
          "wide_candidates": w["candidates"],
          "draw_err": draw_err, "draw_bound": draw_bound,
          "select_exact_share": {tag: c["exact_share"]
                                 for tag, c in cases.items()},
          "select_exact_max_per_row": {tag: c["exact_max_per_row"]
                                       for tag, c in cases.items()},
          **results})
    del C, t, w, cases, calls, at, pass_args, args, x_row
    torch.cuda.empty_cache()
    return results


def load_operands(gen, n: int, slots: int, m: int, integer: bool = True):
    """An assignment as the auctions give one: ids in [0, m), 80% of the
    slots valid, sizes as the synthetic fleet's (integers 16-255) or
    uniform f32 in [0, 256)."""
    dev = gen.device
    idx = torch.randint(0, m, (n, slots), generator=gen, device=dev)
    valid = torch.rand((n, slots), generator=gen, device=dev) < 0.8
    if integer:
        sizes = torch.randint(16, 256, (n,), generator=gen,
                              device=dev).to(torch.float32)
    else:
        sizes = torch.rand(n, generator=gen, device=dev) * 256
    return idx, valid, sizes


def phase_load_kernel(dev, card: str) -> dict:
    """The implied-load kernel against its plain version (the one-hot
    compare-reduce) at the auctions' shapes: bitwise at integer sizes
    (every sum exact), within LOAD_TOL at f32 sizes; two launches on one
    input bitwise; timed beside its bound and index_add_."""
    cuda_load = load_ops()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, m = TIER
    checked = {}
    cases = {"tier": (n, MAX_COPIES, m, True),
             "tier_f32": (n, MAX_COPIES, m, False),
             "nsel": (n, MAX_COPIES, m, True),
             "wide": (WIDE[0], MAX_COPIES, WIDE[1], True),
             "ragged": (RAGGED[0], 3, RAGGED[1], True)}
    for tag, (rows, slots, cols, integer) in cases.items():
        idx, valid, sizes = load_operands(gen, rows, slots, cols, integer)
        if tag == "nsel":  # the sparse auction's first 5 slots, as a view
            idx, valid = idx[:, :5], valid[:, :5]
        got = cuda_load.implied_load(idx, valid, sizes, cols)
        again = cuda_load.implied_load(idx, valid, sizes, cols)
        ref = cuda_load.implied_load_ref(idx, valid, sizes, cols)
        err = float((got - ref).abs().max().item())
        checked[tag] = {"shape": [rows, slots], "instances": cols,
                        "max_abs_err": err,
                        "differs_from_plain": bitwise_differs(got, ref)}
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"load {tag}: two launches on one input differ")
        if integer:
            check(torch.equal(got, ref),
                  f"load {tag}: differs from the plain version at integer "
                  f"sizes (max abs {err})")
        else:
            check(torch.allclose(got, ref, **LOAD_TOL),
                  f"load {tag}: differs from the plain version "
                  f"(max abs {err})")
    idx, valid, sizes = load_operands(gen, n, MAX_COPIES, m)
    contrib = (sizes[:, None] * valid.to(torch.float32)).reshape(-1)
    flat = idx.reshape(-1)
    nbytes = idx.numel() * 9 + n * 4 + m * 4
    result = {
        "shape": [n, MAX_COPIES], "instances": m,
        "max_abs_err": checked["tier"]["max_abs_err"],
        "ms": time_ms(lambda: cuda_load.implied_load(idx, valid, sizes, m),
                      KERNEL_REPS),
        "plain_ms": time_ms(
            lambda: cuda_load.implied_load_ref(idx, valid, sizes, m), 5),
        # index_add_ of the weights (built outside the timing).
        "library_ms": time_ms(
            lambda: torch.zeros(m, device=dev).index_add_(0, flat, contrib),
            KERNEL_REPS),
        "kernel_split_ms": kernel_split_ms(
            lambda: cuda_load.implied_load(idx, valid, sizes, m),
            KERNEL_REPS),
        **bound("implied_load", nbytes, idx.numel(), card),
    }
    emit({"phase": "load_kernel", "card": card, "checked": checked,
          "implied_load": result})
    return {"implied_load": result}


def lse_operands(shape, gen, scale: float = 1.0) -> dict:
    """C ~ 3 N(0, 1) in bf16, g, f ~ N(0, 1) and log_a of masses in
    [1, 9), from ``gen``; C and the shifts times ``scale``."""
    n, m = shape
    dev = gen.device
    C = (torch.randn((n, m), generator=gen, device=dev) * (3.0 * scale)).to(
        torch.bfloat16)
    return {"C": C,
            "g": torch.randn(m, generator=gen, device=dev) * scale,
            "f": torch.randn(n, generator=gen, device=dev) * scale,
            "log_a": torch.log(torch.rand(n, generator=gen, device=dev) * 8
                               + 1)}


def lse_calls(op: dict) -> dict:
    """name -> (kernel call, plain call) of every LSE wrapper that takes
    C's width; each returns a tuple of tensors."""
    C, g, f, log_a = op["C"], op["g"], op["f"], op["log_a"]
    calls = {
        "row_lse_partial": (
            lambda: cuda_lse.row_lse_partial(C, g, LSE_EPS),
            lambda: cuda_lse.row_lse_partial_ref(C, g, LSE_EPS)),
        "col_lse_partial": (
            lambda: cuda_lse.col_lse_partial(C, f, LSE_EPS),
            lambda: cuda_lse.col_lse_partial_ref(C, f, LSE_EPS)),
    }
    if C.shape[1] <= cuda_lse.FUSED_MAX_COLS:
        calls["lse_sinkhorn_step"] = (
            lambda: cuda_lse.lse_sinkhorn_step(C, g, log_a, LSE_EPS),
            lambda: cuda_lse.lse_sinkhorn_step_ref(C, g, log_a, LSE_EPS))
    return calls


def max_abs(a, b) -> float:
    return float((a - b).abs().max().item())


def check_lse_kernels(op: dict, tag: str, tol: dict = LSE_TOL) -> dict:
    """Every LSE kernel that takes C's width against its plain version:
    the LSE and the running max within ``tol``, the fused step's f too.
    On the card the kernels' z is the plain z bit for bit, so the running
    maxima are compared bitwise as well (counted), and the fused step
    against the row and column kernels run back to back on the same
    operands (bitwise, counted). Returns the errors by kernel."""
    errors, bitwise = {}, {}
    out = {}
    for name, (kernel, plain) in lse_calls(op).items():
        got, ref = kernel(), plain()
        out[name] = got
        *lead, km, ks = got
        *_, pm, ps = ref
        lse, lse_ref = cuda_lse.lse_of(km, ks), cuda_lse.lse_of(pm, ps)
        errors[name] = max_abs(lse, lse_ref)
        check(bool(torch.isfinite(lse).all()), f"{tag}: {name} not finite")
        check(torch.allclose(lse, lse_ref, **tol),
              f"{tag}: {name}'s LSE differs from the plain version "
              f"(max abs {errors[name]})")
        check(torch.allclose(km, pm, **tol),
              f"{tag}: {name}'s running max differs "
              f"(max abs {max_abs(km, pm)})")
        bitwise[f"{name}_max_differs"] = int((km != pm).sum().item())
        if lead:
            err_f = max_abs(lead[0], ref[0])
            errors[name] = max(errors[name], err_f)
            check(torch.allclose(lead[0], ref[0], **tol),
                  f"{tag}: {name}'s f differs (max abs {err_f})")
    if "lse_sinkhorn_step" in out:
        # The unfused iteration on the kernels: row, f, column.
        f, cm, cs = out["lse_sinkhorn_step"]
        f_pair = LSE_EPS * (op["log_a"]
                            - cuda_lse.lse_of(*out["row_lse_partial"]))
        pm, ps = cuda_lse.col_lse_partial(op["C"], f, LSE_EPS)
        bitwise["step_f_vs_row_kernel_differs"] = int(
            (f != f_pair).sum().item())
        bitwise["step_col_vs_col_kernel_differs"] = int(
            ((cm != pm) | (cs != ps)).sum().item())
    return {"errors": errors, "bitwise": bitwise}


def check_z_bitwise(op: dict, tag: str) -> None:
    """z of one row, bit for bit: over a single row the column kernel's
    running max is z itself (and its rescaled sum 1)."""
    C1, f1 = op["C"][:1].contiguous(), op["f"][:1].contiguous()
    m1, s1 = cuda_lse.col_lse_partial(C1, f1, LSE_EPS)
    z = ((f1[:, None] - C1.to(torch.float32)) / LSE_EPS)[0]
    check(torch.equal(m1.view(torch.int32), z.view(torch.int32)),
          f"{tag}: the kernel's z of row 0 differs bitwise from the plain "
          f"z ({int((m1 != z).sum().item())} of {z.numel()} columns)")
    check(bool((s1 == 1.0).all()), f"{tag}: single-row sums differ from 1")


def lse_nbytes(name: str, shape) -> int:
    """Bytes the function must move: its inputs once, its outputs once."""
    n, m = shape
    return n * m * 2 + {
        "row_lse_partial": m * 4 + 2 * n * 4,
        "col_lse_partial": n * 4 + 2 * m * 4,
        "lse_sinkhorn_step": m * 4 + n * 4 + n * 4 + 2 * m * 4,
    }[name]


def lse_library(op: dict, name: str):
    """One PyTorch call for the same function, timed: torch.logsumexp
    over a materialized f32 z (the row or column kernel); the fused step
    has none. Returns (ms, ms to build z) or (None, None)."""
    if name == "lse_sinkhorn_step":
        return None, None
    C = op["C"]
    row = name == "row_lse_partial"
    shift = op["g"][None, :] if row else op["f"][:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    z = (shift - C.to(torch.float32)) / LSE_EPS
    torch.cuda.synchronize()
    z_ms = (time.perf_counter() - t) * 1e3
    ms = time_ms(lambda: torch.logsumexp(z, dim=1 if row else 0),
                 KERNEL_REPS)
    del z
    return ms, z_ms


def phase_lse_kernels(dev, card: str) -> dict:
    """Kernels 4-5 and the fused step against their plain versions at every
    width their paths give them, timed at the tier, at the dense tier's
    real width and (the column-only kernel) at the wide path's shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    checked, bitwise, timed = {}, {}, {}
    for tag, shape in LSE_SHAPES.items():
        op = lse_operands(shape, gen)
        check_z_bitwise(op, tag)
        case = check_lse_kernels(op, tag)
        checked[tag] = {"shape": list(shape), "max_abs_err": case["errors"]}
        bitwise[tag] = case["bitwise"]
        if tag in LSE_TIMED:
            timed[tag] = lse_times(op, case["errors"], card)
        if tag == "tier":
            # Extreme values: |z| of order 1e3 and more.
            x = lse_operands(shape, gen, scale=30.0)
            xcase = check_lse_kernels(x, "extreme",
                                      dict(rtol=1e-5, atol=0.0))
            checked["extreme"] = {"shape": list(shape), "scale": 30.0,
                                  "max_abs_err": xcase["errors"]}
            del x
        del op
        torch.cuda.empty_cache()
    # Each kernel at the shape its path gives it: the row-only kernel and
    # the fused step at the dense main path's, the column-only kernel at
    # the wide path's (the main path takes the fused step).
    results = {name: dict(timed["tier"][name]) for name in
               ("row_lse_partial", "lse_sinkhorn_step")}
    results["col_lse_partial"] = dict(timed["wide"]["col_lse_partial"])
    for name, entry in results.items():
        for tag, by_name in timed.items():
            if name in by_name:
                entry[f"{tag}_ms"] = by_name[name]["ms"]
                entry[f"{tag}_bound_ms"] = by_name[name]["bound_ms"]
    emit({"phase": "lse_kernels", "eps": LSE_EPS, "card": card,
          "checked": checked, "bitwise": bitwise, "timed": timed})
    return results


def lse_times(op: dict, errors: dict, card: str) -> dict:
    """Per-launch times of the LSE kernels on ``op`` beside their bound,
    plain version and library call; the fused step's pass and combine
    apart (profiler) and the unfused iteration back to back."""
    shape = tuple(op["C"].shape)
    out = {}
    for name, (kernel, plain) in lse_calls(op).items():
        library_ms, z_ms = lse_library(op, name)
        out[name] = {
            "shape": list(shape), "max_abs_err": errors[name],
            "ms": time_ms(kernel, KERNEL_REPS),
            "plain_ms": time_ms(plain, 5),
            "library_ms": library_ms, "library_z_build_ms": z_ms,
            **bound(name, lse_nbytes(name, shape), shape[0] * shape[1], card),
        }
    if "lse_sinkhorn_step" in out:
        C, g, log_a = op["C"], op["g"], op["log_a"]

        def row_then_col():
            """The unfused iteration: row LSE, f, column LSE."""
            f = LSE_EPS * (log_a - cuda_lse.row_lse(C, g, LSE_EPS))
            cuda_lse.col_lse_partial(C, f, LSE_EPS)

        step = out["lse_sinkhorn_step"]
        step["row_then_col_ms"] = time_ms(row_then_col, KERNEL_REPS)
        step["kernel_split_ms"] = kernel_split_ms(lse_calls(op)[
            "lse_sinkhorn_step"][0], KERNEL_REPS)
    return out


def steady_fleet(n: int, m: int):
    """Synthetic fleet at 85% utilization with seeded rpm (the JAX bench's
    _steady_fleet rule)."""
    models, instances = synthetic_records(n, m)
    demand = sum(mr.size_units for _, mr in models)
    cap = max(1, round(demand / (STEADY_UTILIZATION * m)))
    for _, rec in instances:
        rec.capacity_units = cap
    rng = np.random.default_rng(0)
    rpm = {f"m{i}": int(v) for i, v in enumerate(rng.integers(0, 50, n))}
    return snapshot_columns(models, instances, rpm)


def demand_of(cols) -> float:
    return float(np.sum(
        cols.sizes * np.minimum(cols.copies, MAX_COPIES), dtype=np.float64
    ))


PLACEMENT_FIELDS = ("indices", "valid", "load", "prices", "f", "g",
                    "overflow")


def same_bytes(a, b) -> bool:
    """a and b hold the same bytes (shape, dtype and every bit)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a = a.detach().reshape(-1).contiguous().view(torch.uint8)
    return torch.equal(a, b.detach().reshape(-1).contiguous().view(
        torch.uint8))


def check_repeatable(dev, cols, cfg, tag: str) -> dict:
    """Two solves of one snapshot with one seed: byte-identical Placements
    (the implied load sums in a fixed order on the card)."""
    sols = [dispatch_solve(cols, seed=42, config=cfg, device=dev).sol
            for _ in range(2)]
    differs = [f for f in PLACEMENT_FIELDS
               if not same_bytes(getattr(sols[0], f), getattr(sols[1], f))]
    check(not differs, f"{tag}: two same-seed solves differ in {differs}")
    return {"fields": list(PLACEMENT_FIELDS), "byte_identical": True}


def load_launches_expected(stats) -> int:
    """Implied loads the auctions run: one per price iteration and one for
    the epilogue's selection (a warm probe that certifies its carry runs
    one iteration and no epilogue)."""
    return sum(st["auction_iters_run"] + (st["auction_iters_run"] > 1)
               for st in stats)


def phase_main(dev, cols, snapshot_s: float) -> dict:
    cuda_load = load_ops()
    cfg = solve_config_from_env()

    def one_solve(seed):
        return finalize_plan(
            dispatch_solve(cols, seed=seed, config=cfg, device=dev)
        )

    one_solve(1_000_000)                     # warm-up
    torch.cuda.synchronize()
    cuda_sparse.reset_launches()
    cuda_load.reset_launches()
    syncs0 = device_mod.host_syncs
    times, stats = [], []
    for rep in range(MAIN_SOLVES):
        t = time.perf_counter()
        plan = one_solve(rep)
        times.append((time.perf_counter() - t) * 1e3)
        stats.append(plan.stats)
    launches = dict(cuda_sparse.launches, **cuda_load.launches)
    syncs = device_mod.host_syncs - syncs0

    demand = demand_of(cols)
    for st in stats:
        check(st["solver_path"] == "sparse", f"path {st['solver_path']}")
        check(st["sparse_impl"] == "cuda", f"impl {st['sparse_impl']}")
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              "overflow not finite")
        check(math.isfinite(st["row_err"]), "row_err not finite")
    # One selection per solve (it packs the mask; no mask-only pass), one
    # fused pass per Sinkhorn iteration, the row product alone only for the
    # marginal-error gates, no column-only pass at this width, and the
    # fixed-order implied load for every auction selection.
    iters = sum(st["sinkhorn_iters_run"] for st in stats)
    check(launches["select_candidates"] == MAIN_SOLVES
          and launches["masked_row_min"] == 0
          and launches["masked_sinkhorn_step"] == iters
          and launches["masked_col_matvec"] == 0,
          f"sparse launches {launches} for {iters} Sinkhorn iterations")
    check(launches["implied_load"] == load_launches_expected(stats),
          f"implied_load launches {launches['implied_load']} for auction "
          f"iterations {[st['auction_iters_run'] for st in stats]}")
    for name in ("select_candidates", "masked_row_matvec",
                 "masked_sinkhorn_step", "implied_load"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    repeatable = check_repeatable(dev, cols, cfg, "main")
    check(plan.num_models() == MAIN_FLEET[0], "plan lost models")
    inst = set(cols.instance_ids)
    for mid in cols.model_ids[:: MAIN_FLEET[0] // 1000]:
        targets = plan.lookup(mid)
        check(targets is not None and 0 < len(targets) <= MAX_COPIES,
              f"bad targets for {mid}")
        check(set(targets) <= inst, f"unknown instance for {mid}")
    result = {
        "phase": "main", "models": MAIN_FLEET[0],
        "instances": MAIN_FLEET[1], "padded": list(TIER),
        "snapshot_s": snapshot_s, "solves": MAIN_SOLVES,
        "solve_ms_median": float(np.median(times)),
        "solve_ms_max": float(np.max(times)),
        "per_solve_ms": times,
        "device_solve_ms": [st["solve_ms"] for st in stats],
        "extract_ms": [st["extract_ms"] for st in stats],
        "overflow_frac": [st["overflow"] / demand for st in stats],
        "row_err": [st["row_err"] for st in stats],
        "sinkhorn_iters_run": [st["sinkhorn_iters_run"] for st in stats],
        "auction_iters_run": [st["auction_iters_run"] for st in stats],
        "launches": launches,
        "launches_per_solve": {
            k: c / MAIN_SOLVES for k, c in launches.items()
        },
        "host_syncs_per_solve": syncs / MAIN_SOLVES,
        "repeatable": repeatable,
        "topk": stats[-1].get("topk"),
        "solver_path": stats[-1]["solver_path"],
        "sparse_impl": stats[-1]["sparse_impl"],
    }
    emit(result)
    return result


def device_ms_by_kernel(prof) -> dict:
    """name -> [device ms, count] of a torch.profiler run: device-side
    activity only (kernels and copies); the host-side aten:: records would
    count the same work twice."""
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0][:80]
        slot = by_name.setdefault(name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    return by_name


def kernel_split_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name: ms / reps
            for name, (ms, _) in device_ms_by_kernel(prof).items()}


def phase_profile(dev, cols, phase: str = "profile") -> None:
    """Where one solve's time goes: torch.profiler over one dispatch +
    finalize, device time by kernel name and the device's busy share of
    the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = solve_config_from_env()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        finalize_plan(dispatch_solve(cols, seed=77, config=cfg, device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top": [{"name": k, "ms": ms, "count": c}
                  for k, (ms, c) in top]})


def phase_parity(dev, fleet=PARITY_FLEET, phase: str = "parity",
                 path: str = "sparse") -> dict:
    """One snapshot solved on the card and on the CPU; returns the card
    solve's kernel launches, sparse, LSE and implied load (counters zeroed
    just before it)."""
    cuda_load = load_ops()
    cols = steady_fleet(*fleet)
    cfg = solve_config_from_env()
    torch.cuda.synchronize()
    cuda_sparse.reset_launches()
    cuda_lse.reset_launches()
    cuda_load.reset_launches()
    gpu_run = dispatch_solve(cols, seed=5, config=cfg, device=dev)
    launches = dict(cuda_sparse.launches, **cuda_lse.launches,
                    **cuda_load.launches)
    cpu_run = dispatch_solve(cols, seed=5, config=cfg, device="cpu")
    check(gpu_run.path == cpu_run.path == path,
          f"{phase}: paths {gpu_run.path}/{cpu_run.path}, want {path}")
    check((gpu_run.impl, cpu_run.impl) == ("cuda", "plain"),
          f"{phase}: backends {gpu_run.impl}/{cpu_run.impl}")
    gpu, cpu = gpu_run.sol, cpu_run.sol
    gv, gi = gpu.valid.cpu().numpy(), gpu.indices.cpu().numpy()
    cv, ci = cpu.valid.numpy(), cpu.indices.numpy()
    same = gv == cv
    agree = float(((same & (gi == ci)) | (same & ~cv)).mean())
    demand = demand_of(cols)
    d_over = abs(float(gpu.overflow.item()) - float(cpu.overflow.item()))
    emit({"phase": phase, "models": fleet[0], "instances": fleet[1],
          "padded": list(gpu_run.sol.indices.shape[:1])
          + list(gpu_run.sol.load.shape),
          "solver_path": path, "agreement": agree,
          "overflow_gpu": float(gpu.overflow.item()),
          "overflow_cpu": float(cpu.overflow.item()),
          "overflow_diff_frac": d_over / demand,
          "sinkhorn_iters_run": gpu.sinkhorn_iters_run,
          "launches": launches})
    check(agree >= 0.97, f"{phase}: GPU/CPU placement agreement {agree}")
    check(d_over <= 0.005 * demand, f"{phase}: overflow differs by {d_over}")
    return {"launches": launches, "sinkhorn_iters_run": gpu.sinkhorn_iters_run}


def phase_wide(dev) -> dict:
    """The sparse path wider than the fused step: parity, and the row and
    column products back to back on every Sinkhorn iteration."""
    run = phase_parity(dev, WIDE_FLEET, "wide")
    got, iters = run["launches"], run["sinkhorn_iters_run"]
    check(got["masked_sinkhorn_step"] == 0,
          f"wide: the fused step ran at a width above its limit: {got}")
    check(got["masked_col_matvec"] == iters and got["select_candidates"] == 1
          and got["masked_row_min"] == 0,
          f"wide: launches {got} for {iters} Sinkhorn iterations")
    return got


def phase_dense_wide(dev) -> dict:
    """The dense tier wider than the fused LSE step: the wide fleet pinned
    dense (12288 x 1536), parity, and the row and column LSE back to back
    on every Sinkhorn iteration: the column-only kernel's path."""
    with dense_pin():
        run = phase_parity(dev, WIDE_FLEET, "dense_wide", "dense")
    got, iters = run["launches"], run["sinkhorn_iters_run"]
    check(got["lse_sinkhorn_step"] == 0,
          f"dense_wide: the fused step ran at a width above its limit: {got}")
    # Each iteration a row and a column pass, and the row pass of the
    # final marginal error.
    check(got["col_lse_partial"] == iters
          and got["row_lse_partial"] == iters + 1,
          f"dense_wide: launches {got} for {iters} Sinkhorn iterations")
    for name in ("row_lse_partial", "col_lse_partial"):
        check(got[name] > 0, f"{name} never launched on the dense_wide path")
    return got


@contextlib.contextmanager
def dense_pin():
    """MM_SOLVER_SPARSE=0 for the duration, restored after (bench.py's
    run_path pin)."""
    prev = os.environ.get("MM_SOLVER_SPARSE")
    os.environ["MM_SOLVER_SPARSE"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("MM_SOLVER_SPARSE", None)
        else:
            os.environ["MM_SOLVER_SPARSE"] = prev


def packed_key_top_k(x, k: int):
    """The other tie-stable top-k: torch.topk over an int64 key that packs
    the value's order-preserving bits above the reversed column index (no
    two keys tie). Timed here as the alternative to the port's stable
    sort; the port does not use it."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits).to(torch.int64)
    rev = torch.arange(x.shape[1] - 1, -1, -1, device=x.device)
    key.mul_(1 << 32).add_(rev)
    idx = torch.topk(key, k, dim=1).indices
    return torch.gather(x, 1, idx), idx


def time_top_k(dev) -> dict:
    """The auction's tie-stable top-k (a stable descending sort, cut) at
    its shortlist shape against the packed-key top-k and torch.topk
    (fast, but in no fixed tie order), on bf16-rounded scores (many
    ties)."""
    n, m = TIER
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = (torch.randn((n, m), generator=gen, device=dev) * 4.0).to(
        torch.bfloat16).to(torch.float32)
    _, idx = auction.top_k(x, K_CAND)
    check(torch.equal(idx, packed_key_top_k(x, K_CAND)[1]),
          "top_k differs from the packed-key top-k")
    out = {
        "shape": [n, m], "k": K_CAND,
        "stable_sort_top_k_ms": time_ms(lambda: auction.top_k(x, K_CAND), 5),
        "packed_key_topk_ms": time_ms(lambda: packed_key_top_k(x, K_CAND), 5),
        "torch_topk_ms": time_ms(lambda: torch.topk(x, K_CAND, dim=1), 5),
    }
    del x
    torch.cuda.empty_cache()
    return out


def phase_dense_main(dev, cols) -> dict:
    cuda_load = load_ops()
    cfg = solve_config_from_env()

    def one_solve(seed, config=cfg):
        return finalize_plan(
            dispatch_solve(cols, seed=seed, config=config, device=dev)
        )

    one_solve(2_000_000)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lse.reset_launches()
    cuda_sparse.reset_launches()
    cuda_load.reset_launches()
    syncs0 = device_mod.host_syncs
    times, stats = [], []
    for rep in range(MAIN_SOLVES):
        t = time.perf_counter()
        plan = one_solve(100 + rep)
        times.append((time.perf_counter() - t) * 1e3)
        stats.append(plan.stats)
    launches = dict(cuda_lse.launches, **cuda_load.launches)
    sparse_launches = dict(cuda_sparse.launches)
    syncs = device_mod.host_syncs - syncs0
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    demand = demand_of(cols)
    for st in stats:
        check(st["solver_path"] == "dense", f"path {st['solver_path']}")
        check(st["lse_impl"] == "cuda", f"lse_impl {st.get('lse_impl')}")
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              "overflow not finite")
        check(math.isfinite(st["row_err"]), "row_err not finite")
    # Fixed budget: one fused step per iteration, the row LSE of the final
    # marginal error, no column-only pass at this width; and one host sync,
    # the readback.
    iters = cfg.sinkhorn_iters
    want = {"lse_sinkhorn_step": iters, "row_lse_partial": 1,
            "col_lse_partial": 0}
    per_solve = {k: c / MAIN_SOLVES for k, c in launches.items()}
    if cfg.sinkhorn_tol <= 0:
        check({k: per_solve[k] for k in want} == want,
              f"LSE launches per solve {per_solve}")
        if cfg.auction_stall_tol <= 0:
            check(syncs == MAIN_SOLVES,
                  f"{syncs / MAIN_SOLVES} host syncs per dense solve")
    check(launches["implied_load"] == load_launches_expected(stats),
          f"implied_load launches {launches['implied_load']} for auction "
          f"iterations {[st['auction_iters_run'] for st in stats]}")
    for name in ("lse_sinkhorn_step", "row_lse_partial", "implied_load"):
        check(launches[name] > 0, f"{name} never launched on the dense path")
    check(all(c == 0 for c in sparse_launches.values()),
          f"sparse kernels ran on the dense path: {sparse_launches}")
    check(plan.num_models() == MAIN_FLEET[0], "plan lost models")
    inst = set(cols.instance_ids)
    for mid in cols.model_ids[:: MAIN_FLEET[0] // 1000]:
        targets = plan.lookup(mid)
        check(targets is not None and 0 < len(targets) <= MAX_COPIES,
              f"bad targets for {mid}")
        check(set(targets) <= inst, f"unknown instance for {mid}")

    # The steady gates (bench.py's _steady_solve_config): the probe and
    # chunk branches of both stages on the card.
    gated_cfg = cfg._replace(sinkhorn_tol=0.02, auction_stall_tol=1e-3)
    syncs0 = device_mod.host_syncs
    t = time.perf_counter()
    gated = one_solve(7, gated_cfg).stats
    gated_ms = (time.perf_counter() - t) * 1e3
    check(gated["solver_path"] == "dense" and math.isfinite(gated["overflow"]),
          "gated dense solve")
    repeatable = check_repeatable(dev, cols, cfg, "dense_main")
    result = {
        "phase": "dense_main", "models": MAIN_FLEET[0],
        "instances": MAIN_FLEET[1], "padded": list(TIER),
        "pin": "MM_SOLVER_SPARSE=0", "solves": MAIN_SOLVES,
        "solve_ms_median": float(np.median(times)),
        "solve_ms_max": float(np.max(times)),
        "per_solve_ms": times,
        "device_solve_ms": [st["solve_ms"] for st in stats],
        "extract_ms": [st["extract_ms"] for st in stats],
        "overflow_frac": [st["overflow"] / demand for st in stats],
        "row_err": [st["row_err"] for st in stats],
        "sinkhorn_iters_run": [st["sinkhorn_iters_run"] for st in stats],
        "auction_iters_run": [st["auction_iters_run"] for st in stats],
        "launches": launches,
        "launches_per_solve": per_solve,
        "host_syncs_per_solve": syncs / MAIN_SOLVES,
        "peak_device_bytes": peak_bytes,
        "repeatable": repeatable,
        "solver_path": stats[-1]["solver_path"],
        "lse_impl": stats[-1]["lse_impl"],
        "gated": {
            "solve_ms": gated_ms,
            "device_solve_ms": gated["solve_ms"],
            "overflow_frac": gated["overflow"] / demand,
            "row_err": gated["row_err"],
            "sinkhorn_iters_run": gated["sinkhorn_iters_run"],
            "auction_iters_run": gated["auction_iters_run"],
            "host_syncs": device_mod.host_syncs - syncs0,
        },
        "top_k": time_top_k(dev),
    }
    emit(result)
    return result


def kernel_entries(table: dict, lib: str, launches: dict,
                   cells: dict) -> list:
    """The contract's kernel objects; ``launches`` by kernel, each from
    the run of the cell that runs it, ``cells`` by kernel: (cell, solves
    in that run)."""
    return [
        {
            "name": name, "route": "cuda", "source": SOURCES[lib],
            "replaces": REPLACES[name], "launches": launches[name],
            "cell": cells[name][0], "solves": cells[name][1],
            "launches_per_solve": launches[name] / cells[name][1],
            "shape": k["shape"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        }
        for name, k in table.items()
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    phase_build()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card})
    kernels = phase_kernels(dev, card)
    lse_kernels = phase_lse_kernels(dev, card)
    load_kernel = phase_load_kernel(dev, card)
    t0 = time.perf_counter()
    cols = steady_fleet(*MAIN_FLEET)
    main_run = phase_main(dev, cols, time.perf_counter() - t0)
    phase_profile(dev, cols)
    phase_parity(dev)
    wide_launches = phase_wide(dev)
    with dense_pin():
        dense_run = phase_dense_main(dev, cols)
        phase_profile(dev, cols, "dense_profile")
    phase_parity(dev, DENSE_PARITY_FLEET, "dense_parity", "dense")
    dense_wide_launches = phase_dense_wide(dev)
    print(card)
    # The column-only kernels run on the wide paths alone (one solve each;
    # the main paths' 1024 columns take the fused steps).
    sparse_launches = dict(main_run["launches"],
                           masked_col_matvec=wide_launches["masked_col_matvec"])
    sparse_cells = dict.fromkeys(sparse_launches, ("main", MAIN_SOLVES))
    sparse_cells["masked_col_matvec"] = ("wide", 1)
    lse_launches = dict(dense_run["launches"],
                        col_lse_partial=dense_wide_launches["col_lse_partial"])
    lse_cells = dict.fromkeys(lse_launches, ("dense_main", MAIN_SOLVES))
    lse_cells["col_lse_partial"] = ("dense_wide", 1)
    # The implied load runs in both auctions: its launches are the sparse
    # main path's, the dense main path's beside them.
    load_entries = kernel_entries(load_kernel, "implied_load",
                                  main_run["launches"],
                                  {"implied_load": ("main", MAIN_SOLVES)})
    load_entries[0]["dense_main_launches"] = (
        dense_run["launches"]["implied_load"])
    emit({"kernels": (
        kernel_entries(kernels, "masked_sparse", sparse_launches,
                       sparse_cells)
        + kernel_entries(lse_kernels, "lse", lse_launches, lse_cells)
        + load_entries
    )})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
