"""dispatch_ms: plan.stats["dispatch_ms"] averaged over the window's
refreshes, rebuilds included: the host time to expand the problem and
enqueue the solve, the reads of its convergence gates included. Host
clock, the program's own stage timer."""


def read(run):
    vals = [st["dispatch_ms"] for st in run.stats if "dispatch_ms" in st]
    return sum(vals) / len(vals) if vals else None
