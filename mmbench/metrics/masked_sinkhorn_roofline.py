"""masked_sinkhorn_roofline: the least time the window's masked Sinkhorn
solves need at one card's peaks, over the device time of their kernels
(csrc/masked_sparse.cu, kernels 2 and 3: the fused pass ``col_kernel``
with ``col_combine_kernel``, and on fleets wider than the fused pass
takes ``row_matvec_kernel`` before an unfused ``col_kernel``) in the
trace, summed over the cards. The need, for each full solve on the
top-K tier: ``counts.masked_iteration_work`` times its reported
``sinkhorn_iters_run``, and ``counts.masked_row_work`` for each row
product of its marginal error (one a chunk after the gate's probe; with
the gate off, one at the end). A window with no such solve, or no such
kernel, reads nothing."""

from mmbench import counts
from mmbench.trace import kernel_matches

KERNELS = ("col_kernel", "col_combine_kernel", "row_matvec_kernel")
SPARSE_PATHS = ("sparse", "sharded-sparse")


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, (s, _) in run.trace.kernels.items()
                   if kernel_matches(name, KERNELS))
    s = run.solver
    gated = (s.sinkhorn_tol > 0 and s.sinkhorn_chunk > 0
             and s.sinkhorn_iters > 0)
    chunk = min(s.sinkhorn_chunk, s.sinkhorn_iters) if gated else 0
    need = 0.0
    for st in run.stats:
        if st.get("solver_path") not in SPARSE_PATHS or not st.get("topk"):
            continue
        iters, k = int(st.get("sinkhorn_iters_run") or 0), int(st["topk"])
        reads = ((iters - 1) // chunk if iters > 1 else 0) if gated else 1
        need += (iters * counts.least_seconds(
            *counts.masked_iteration_work(run.n, run.m, k))
            + reads * counts.least_seconds(
                *counts.masked_row_work(run.n, run.m, k)))
    if device_s <= 0 or need <= 0:
        return None
    return 100.0 * need / device_s
