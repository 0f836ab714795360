#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build   — compile the CUDA kernels from ``modelmesh_tpu_torch/csrc``
             (nvcc, sm_90a) and print the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card at
             the 100k x 1k tier's padded shape (C bf16[131072, 1024] from a
             seed, thresholds from the port's top-K gather): rowmin bitwise,
             the flat-integrand candidate counts exact, the matvecs at
             rtol 1e-5 / atol 1e-6; median kernel time over 20 launches.
3. main    — the production dispatch at 100,000 models x 1,000 instances
             (synthetic fleet at 85% utilization): snapshot_columns ->
             dispatch_solve -> finalize_plan, one warm-up then 5 solves with
             varied seeds, kernel launch counters zeroed just before.
   profile — one more main-path solve under torch.profiler: device time
             by kernel name and the device's idle share of the solve.
4. parity  — one 20,000 x 256 snapshot solved on the card and on the CPU
             (plain versions): placement agreement >= 0.97 and overflow
             within 0.5% of demand.

Then the card line from nvidia-smi, one JSON line with every kernel's
numbers, and, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero before printing any result.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.ops import _build, cuda_sparse, sparse
from modelmesh_tpu_torch.ops.auction import MAX_COPIES
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
STEADY_UTILIZATION = 0.85
KERNEL_REPS = 20
MAIN_SOLVES = 5
# Published H100 peaks (NVIDIA data sheets): device memory bytes/s by part,
# and f32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
PEAK_F32_OPS_PER_S = 67e12
# f32/int32 operations per cost-matrix element: the selection key (hash:
# 10 integer ops; uniform, clamp, two logs, two negations, scale, subtract)
# and the mask test, then the min, or the shifted exp and multiply-add.
OPS_PER_ELEMENT = {"masked_row_min": 20, "masked_row_matvec": 25,
                   "masked_col_matvec": 25}
REPLACES = {
    "masked_row_min": "modelmesh_tpu/ops/pallas_sparse.py:196",
    "masked_row_matvec": "modelmesh_tpu/ops/pallas_sparse.py:226",
    "masked_col_matvec": "modelmesh_tpu/ops/pallas_sparse.py:260",
}
SOURCE = "modelmesh_tpu_torch/csrc/masked_sparse.cu"


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
    """Median device time of ``fn`` over ``reps`` runs, from CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_all()
    ptxas = [ln.strip() for log in _build.build_log.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "ptxas": ptxas})


def phase_kernels(dev, card: str) -> dict:
    n, m = TIER
    gen = torch.Generator(device=dev).manual_seed(SEED)
    C = (torch.randn((n, m), generator=gen, device=dev) * 3.0).to(
        torch.bfloat16
    )
    feasible = torch.ones((n, m), dtype=torch.bool, device=dev)
    _, _, _, fz = sparse.topk_candidates(C, feasible, 24, seed=SEED)
    args = (C, fz.thresh, fz.x_row)
    kw = dict(tau=fz.tau, noised=fz.noised)
    eps = 0.05
    v = torch.rand(m, generator=gen, device=dev) + 0.1
    u = torch.rand(n, generator=gen, device=dev) + 0.1

    rowmin = cuda_sparse.masked_row_min(*args, **kw)
    rowmin_ref = cuda_sparse.masked_row_min_ref(*args, **kw)
    check(torch.equal(rowmin.view(torch.int32), rowmin_ref.view(torch.int32)),
          "masked_row_min differs bitwise from its plain version")

    # Flat integrand (eps = 1e30 makes every in-mask exp exactly 1.0f): the
    # products count candidates, and must match as exact integers.
    ones_m = torch.ones(m, device=dev)
    ones_n = torch.ones(n, device=dev)
    flat = dict(eps=1e30, **kw)
    rc = cuda_sparse.masked_row_matvec(*args, rowmin, ones_m, **flat)
    rc_ref = cuda_sparse.masked_row_matvec_ref(*args, rowmin, ones_m, **flat)
    cc = cuda_sparse.masked_col_matvec(*args, rowmin, ones_n, **flat)
    cc_ref = cuda_sparse.masked_col_matvec_ref(*args, rowmin, ones_n, **flat)
    check(torch.equal(rc, rc_ref), "row candidate counts differ")
    check(torch.equal(cc, cc_ref), "column candidate counts differ")
    check(int(rc.min().item()) >= 24, "a row has fewer than K candidates")

    calls = {
        "masked_row_min": (
            lambda: cuda_sparse.masked_row_min(*args, **kw),
            lambda: cuda_sparse.masked_row_min_ref(*args, **kw),
            3 * n * 4 + n * m * 2,
        ),
        "masked_row_matvec": (
            lambda: cuda_sparse.masked_row_matvec(
                *args, rowmin, v, eps=eps, **kw),
            lambda: cuda_sparse.masked_row_matvec_ref(
                *args, rowmin, v, eps=eps, **kw),
            4 * n * 4 + m * 4 + n * m * 2,
        ),
        "masked_col_matvec": (
            lambda: cuda_sparse.masked_col_matvec(
                *args, rowmin, u, eps=eps, **kw),
            lambda: cuda_sparse.masked_col_matvec_ref(
                *args, rowmin, u, eps=eps, **kw),
            4 * n * 4 + m * 4 + n * m * 2,
        ),
    }
    results = {}
    for name, (kernel, plain, nbytes) in calls.items():
        got, ref = kernel(), plain()
        err = float((got - ref).abs().max().item())
        if name != "masked_row_min":
            check(torch.allclose(got, ref, rtol=1e-5, atol=1e-6),
                  f"{name} differs from its plain version (max abs {err})")
        bytes_ms = nbytes / peak_bytes_per_s(card) * 1e3
        ops_ms = OPS_PER_ELEMENT[name] * n * m / PEAK_F32_OPS_PER_S * 1e3
        results[name] = {
            "max_abs_err": err,
            "ms": time_ms(kernel, KERNEL_REPS),
            "plain_ms": time_ms(plain, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes,
        }
    emit({"phase": "kernels", "shape": [n, m], "card": card,
          "counting_exact": True, **results})
    del C, feasible, fz
    torch.cuda.empty_cache()
    return results


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


def phase_main(dev, cols, snapshot_s: float) -> dict:
    cfg = solve_config_from_env()

    def one_solve(seed):
        return finalize_plan(
            dispatch_solve(cols, seed=seed, config=cfg, device=dev)
        )

    one_solve(1_000_000)                     # warm-up
    torch.cuda.synchronize()
    cuda_sparse.reset_launches()
    syncs0 = device_mod.host_syncs
    times, stats = [], []
    for rep in range(MAIN_SOLVES):
        t = time.perf_counter()
        plan = one_solve(rep)
        times.append((time.perf_counter() - t) * 1e3)
        stats.append(plan.stats)
    launches = dict(cuda_sparse.launches)
    syncs = device_mod.host_syncs - syncs0

    demand = demand_of(cols)
    for st in stats:
        check(st["solver_path"] == "sparse", f"path {st['solver_path']}")
        check(st["sparse_impl"] == "cuda", f"impl {st['sparse_impl']}")
        check(math.isfinite(st["overflow"]) and st["overflow"] >= 0,
              "overflow not finite")
        check(math.isfinite(st["row_err"]), "row_err not finite")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
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
        "topk": stats[-1].get("topk"),
        "solver_path": stats[-1]["solver_path"],
        "sparse_impl": stats[-1]["sparse_impl"],
    }
    emit(result)
    return result


def phase_profile(dev, cols) -> None:
    """Where one main-path solve's time goes: torch.profiler over one
    dispatch + finalize, device time by kernel name and the device's busy
    share of the solve's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = solve_config_from_env()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        finalize_plan(dispatch_solve(cols, seed=77, config=cfg, device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side activity only (kernels and copies), grouped by name; the
    # host-side aten:: records would count the same work twice.
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0][:80]
        slot = by_name.setdefault(name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top": [{"name": k, "ms": ms, "count": c}
                  for k, (ms, c) in top]})


def phase_parity(dev) -> None:
    cols = steady_fleet(*PARITY_FLEET)
    cfg = solve_config_from_env()
    gpu = dispatch_solve(cols, seed=5, config=cfg, device=dev).sol
    cpu = dispatch_solve(cols, seed=5, config=cfg, device="cpu").sol
    gv, gi = gpu.valid.cpu().numpy(), gpu.indices.cpu().numpy()
    cv, ci = cpu.valid.numpy(), cpu.indices.numpy()
    same = gv == cv
    agree = float(((same & (gi == ci)) | (same & ~cv)).mean())
    demand = demand_of(cols)
    d_over = abs(float(gpu.overflow.item()) - float(cpu.overflow.item()))
    emit({"phase": "parity", "models": PARITY_FLEET[0],
          "instances": PARITY_FLEET[1], "agreement": agree,
          "overflow_gpu": float(gpu.overflow.item()),
          "overflow_cpu": float(cpu.overflow.item()),
          "overflow_diff_frac": d_over / demand})
    check(agree >= 0.97, f"GPU/CPU placement agreement {agree}")
    check(d_over <= 0.005 * demand, f"overflow differs by {d_over}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    phase_build()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card})
    kernels = phase_kernels(dev, card)
    t0 = time.perf_counter()
    cols = steady_fleet(*MAIN_FLEET)
    main_run = phase_main(dev, cols, time.perf_counter() - t0)
    phase_profile(dev, cols)
    phase_parity(dev)
    print(card)
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": main_run["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        }
        for name, k in kernels.items()
    ]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
