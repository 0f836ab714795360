"""sinkhorn_roofline: the least time the window's transport solves
need at the card's peaks (``counts.transport_work``, each refresh's
Sinkhorn iterations from plan.stats), over the device time of the dense
tier's LSE kernels (csrc/lse.cu) in the trace. A refresh on another
solver path is not counted here: the metric is then left out."""

from mmbench import counts
from mmbench.trace import kernel_matches

KERNELS = ("dense_row_kernel", "dense_col_kernel", "col_combine_kernel")


def read(run):
    if run.trace is None or any(st.get("solver_path") != "dense"
                                for st in run.stats):
        return None
    device_s = sum(s for name, (s, _) in run.trace.kernels.items()
                   if kernel_matches(name, KERNELS))
    if device_s <= 0:
        return None
    need = sum(counts.least_seconds(*counts.transport_work(
        run.n, run.m, int(st.get("sinkhorn_iters_run") or 0)))
        for st in run.stats)
    return 100.0 * need / device_s
