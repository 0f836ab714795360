"""solve_device_ms: plan.stats["solve_device_ms"] averaged over the
window's refreshes: the solve's stream time from the dispatch's start to
its readback copy's event (CUDA event marks of the program's refresh
spans); idle time inside counts. None where the program marks no
layers."""


def read(run):
    vals = [st["solve_device_ms"] for st in run.stats
            if "solve_device_ms" in st]
    return sum(vals) / len(vals) if vals else None
