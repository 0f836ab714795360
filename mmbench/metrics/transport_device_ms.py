"""transport_device_ms: plan.stats["transport_device_ms"] averaged over the
window's refreshes: the solve's stream time from the cost matrix to the
plan logits (the Sinkhorn loop and ``plan_logits``), between the
program's CUDA event marks at the ends of the refresh spans
(``mm.refresh.transport``); idle time inside counts. None where the
program marks no layers."""


def read(run):
    vals = [st["transport_device_ms"] for st in run.stats
            if "transport_device_ms" in st]
    return sum(vals) / len(vals) if vals else None
