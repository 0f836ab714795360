"""extract_ms: plan.stats["extract_ms"] averaged over the window's
refreshes, rebuilds included: the plan's extraction on the host
(finalize_plan). Host clock, the program's own stage timer."""


def read(run):
    vals = [st["extract_ms"] for st in run.stats if "extract_ms" in st]
    return sum(vals) / len(vals) if vals else None
