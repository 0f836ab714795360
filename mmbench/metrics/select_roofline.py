"""select_roofline: the least time the window's top-K selections need at
one card's peaks (``counts.select_work`` at the real rows, pods and
candidate width, once for each full solve on the top-K tier, on one
card or a mesh), over the device time of ``select_kernel``
(csrc/masked_sparse.cu, kernel 1) in the trace, summed over the cards.
A window with no such solve, or no such kernel, reads nothing."""

from mmbench import counts
from mmbench.trace import kernel_matches

SPARSE_PATHS = ("sparse", "sharded-sparse")


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, (s, _) in run.trace.kernels.items()
                   if kernel_matches(name, ("select_kernel",)))
    need = sum(counts.least_seconds(*counts.select_work(
        run.n, run.m, int(st["topk"])))
        for st in run.stats
        if st.get("solver_path") in SPARSE_PATHS and st.get("topk"))
    if device_s <= 0 or need <= 0:
        return None
    return 100.0 * need / device_s
