#!/usr/bin/env python3
"""Per-launch times of one checkout's sparse and LSE kernels on one GPU.

    python3 tools/sparse_kernel_times.py [ROOT]

Times the kernel wrappers of the ``modelmesh_tpu_torch`` package under ROOT
(by default the checkout that holds this script) at the sparse tier's
C bf16[131072, 1024], with this checkout's ``chip_smoke.time_ms`` and
operands: one method for two trees, so an older commit unpacked into ROOT
(``git archive``) is timed beside this one, in one run on the same card.
Takes the sparse wrappers before the packed mask bits (each pass recomputes
the mask from the thresholds) and after (``cuda_sparse.CandidateRows``).
The top-K gather at the tier (K = 24): the unfused route (PyTorch-op key,
stable top-K, the K-th key, the mask-only kernel ``masked_row_min``), the
one-pass selection kernel where the tree has one
(``cuda_sparse.select_candidates``), and the main path's gather as the
tree runs it (``topk_candidates``, then ``masked_row_min`` where the gather
does not pack the mask); each with its device time by kernel. The implied
load where the tree has the kernel (``cuda_load``), beside index_add_.
The LSE wrappers are timed at [131072, 1024] and at the dense tier's real
width [131072, 128]: the row and column kernels, one unfused iteration
(row LSE, f, column LSE) back to back, and the fused step where the tree
has one (``cuda_lse.lse_sinkhorn_step``); beside each, its device time by
kernel under torch.profiler. Prints the card line and one JSON object;
exits non-zero without a CUDA device.
"""

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke(root: str):
    """This checkout's chip_smoke, importing the package under ``root``."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    root = os.path.abspath(argv[1] if len(argv) > 1 else HERE)
    cs = load_chip_smoke(root)
    import torch
    from modelmesh_tpu_torch.ops import cuda_lse, cuda_sparse

    if not cuda_sparse.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {cuda_sparse.__file__}, not {root}")
    if not torch.cuda.is_available():
        print("sparse_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs._build.build_all()
    n, m = cs.TIER
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    C = (torch.randn((n, m), generator=gen, device=dev) * 3.0).to(
        torch.bfloat16)
    (C, thresh, x_row), kw = cs.sparse_operands(C)
    v = torch.rand(m, generator=gen, device=dev) + 0.1
    u = torch.rand(n, generator=gen, device=dev) + 0.1
    row_mass = torch.rand(n, generator=gen, device=dev) * 8 + 1
    eps = cs.SPARSE_EPS

    calls = {"masked_row_min": lambda: cuda_sparse.masked_row_min(
        C, thresh, x_row, **kw)}
    if hasattr(cuda_sparse, "CandidateRows"):
        rowmin, bits = cuda_sparse.masked_row_min(C, thresh, x_row, **kw)
        lead, mask_kw = (C, bits, rowmin), {}
        calls["masked_sinkhorn_step"] = (
            lambda: cuda_sparse.masked_sinkhorn_step(
                *lead, v, row_mass, eps=eps))
    else:
        rowmin = cuda_sparse.masked_row_min(C, thresh, x_row, **kw)
        lead, mask_kw = (C, thresh, x_row, rowmin), kw
    calls["masked_row_matvec"] = lambda: cuda_sparse.masked_row_matvec(
        *lead, v, eps=eps, **mask_kw)
    calls["masked_col_matvec"] = lambda: cuda_sparse.masked_col_matvec(
        *lead, u, eps=eps, **mask_kw)
    ms = {name: cs.time_ms(fn, cs.KERNEL_REPS) for name, fn in calls.items()}
    gather = {name: {"ms": cs.time_ms(fn, 5),
                     "device_ms": cs.kernel_split_ms(fn, 5)}
              for name, fn in gather_calls(cs, C).items()}
    for entry in gather.values():
        entry["device_total_ms"] = sum(entry["device_ms"].values())
    del C, thresh, x_row, rowmin, lead, calls
    torch.cuda.empty_cache()
    load = load_times(cs, gen)

    lse = {}
    for width in (m, 128):
        lse_calls = dense_lse_calls(cuda_lse, cs, n, width, gen)
        lse[width] = {
            name: {"ms": cs.time_ms(fn, cs.KERNEL_REPS),
                   "device_ms": cs.kernel_split_ms(fn, cs.KERNEL_REPS)}
            for name, fn in lse_calls.items()
        }
        del lse_calls
        torch.cuda.empty_cache()

    card = cs.card_line()
    print(card)
    print(json.dumps({
        "root": root, "card": card, "shape": [n, m],
        "reps": cs.KERNEL_REPS, "ms": ms, "gather": gather, "load": load,
        "lse": {f"{n}x{width}": by_name for width, by_name in lse.items()},
    }), flush=True)
    return 0


def gather_calls(cs, C) -> dict:
    """The top-K gather of C by each route the tree has."""
    import torch
    from modelmesh_tpu_torch.ops import auction, cuda_sparse, sparse

    k = cs.SPARSE_K
    x_row, kw = cs.selection_operands(C)
    feasible = torch.ones(C.shape, dtype=torch.bool, device=C.device)

    def unfused_route():
        key = cuda_sparse.selection_key(C, x_row, **kw)
        neg_vals, _ = auction.top_k(-key, k)
        cuda_sparse.masked_row_min(C, -neg_vals.amin(dim=1), x_row, **kw)

    def main_gather():
        _, _, _, fz = sparse.topk_candidates(C, feasible, k, seed=cs.SEED)
        if getattr(fz, "bits", None) is None:
            cuda_sparse.masked_row_min(C, fz.thresh, fz.x_row, tau=fz.tau,
                                       noised=fz.noised)

    calls = {"unfused_route": unfused_route, "main_gather": main_gather}
    if hasattr(cuda_sparse, "select_candidates"):
        calls["select_candidates"] = lambda: cuda_sparse.select_candidates(
            C, x_row, k, **kw)
    return calls


def load_times(cs, gen) -> dict:
    """The implied load at the auctions' shape, where the tree has the
    kernel, beside index_add_ of the same weights."""
    import torch
    from modelmesh_tpu_torch.ops import auction

    n, m = cs.TIER
    idx, valid, sizes = cs.load_operands(gen, n, auction.MAX_COPIES, m)
    contrib = (sizes[:, None] * valid.to(torch.float32)).reshape(-1)
    flat = idx.reshape(-1)
    out = {"index_add_ms": cs.time_ms(
        lambda: torch.zeros(m, device=idx.device).index_add_(0, flat, contrib),
        cs.KERNEL_REPS)}
    if importlib.util.find_spec("modelmesh_tpu_torch.ops.cuda_load") is None:
        return out
    from modelmesh_tpu_torch.ops import cuda_load

    out["implied_load_ms"] = cs.time_ms(
        lambda: cuda_load.implied_load(idx, valid, sizes, m), cs.KERNEL_REPS)
    return out


def dense_lse_calls(cuda_lse, cs, n: int, m: int, gen) -> dict:
    """The LSE wrappers of one dense Sinkhorn iteration on C bf16[n, m]."""
    import torch

    dev = gen.device
    C = (torch.randn((n, m), generator=gen, device=dev) * 3.0).to(
        torch.bfloat16)
    g = torch.randn(m, generator=gen, device=dev)
    f = torch.randn(n, generator=gen, device=dev)
    log_a = torch.log(torch.rand(n, generator=gen, device=dev) * 8 + 1)
    eps = cs.LSE_EPS

    def pair():
        """The unfused iteration: row LSE, f, column LSE."""
        f_new = eps * (log_a - cuda_lse.row_lse(C, g, eps))
        cuda_lse.col_lse_partial(C, f_new, eps)

    calls = {
        "row_lse_partial": lambda: cuda_lse.row_lse_partial(C, g, eps),
        "col_lse_partial": lambda: cuda_lse.col_lse_partial(C, f, eps),
        "lse_pair": pair,
    }
    if hasattr(cuda_lse, "lse_sinkhorn_step"):
        calls["lse_sinkhorn_step"] = (
            lambda: cuda_lse.lse_sinkhorn_step(C, g, log_a, eps))
    return calls


if __name__ == "__main__":
    sys.exit(main(sys.argv))
