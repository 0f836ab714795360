"""implied_load_roofline: the least time the window's implied loads
need at the card's peaks (``counts.implied_load_work`` a load: the
assignment's valid entries, one per wanted copy, the sizes and the
loads; times the loads taken, the port's ``cuda_load.launches`` counter
over the window, where on a mesh every card launches its share of each
load), over the device time of ``load_kernel`` (csrc/implied_load.cu)
in the trace, summed over the cards."""

from mmbench import counts
from mmbench.trace import kernel_matches


def read(run):
    calls = run.launches.get("implied_load", 0)
    if run.trace is None or calls <= 0:
        return None
    device_s = sum(s for name, (s, _) in run.trace.kernels.items()
                   if kernel_matches(name, ("load_kernel",)))
    if device_s <= 0:
        return None
    nbytes, flops = counts.implied_load_work(run.n, run.m, run.entries)
    loads = calls / run.cards
    return 100.0 * loads * counts.least_seconds(nbytes, flops) / device_s
