"""readback_wait_ms: plan.stats["readback_wait_ms"] averaged over the
window's refreshes, rebuilds included: the wait for the solve's one
readback (finish_readback). Host clock, the program's own stage timer."""


def read(run):
    vals = [st["readback_wait_ms"] for st in run.stats
            if "readback_wait_ms" in st]
    return sum(vals) / len(vals) if vals else None
