"""cost_device_ms: plan.stats["cost_device_ms"] averaged over the window's
refreshes: the solve's stream time from the dispatch's start to the cost
matrix assembled (the problem's expansion and ``assemble_cost``),
between the program's CUDA event marks at the ends of the refresh spans
(``mm.refresh.cost``); idle time inside counts. None where the program
marks no layers."""


def read(run):
    vals = [st["cost_device_ms"] for st in run.stats
            if "cost_device_ms" in st]
    return sum(vals) / len(vals) if vals else None
