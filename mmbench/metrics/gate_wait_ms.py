"""gate_wait_ms: plan.stats["gate_wait_ms"] averaged over the window's
refreshes: the host's time blocked at the dispatch's convergence gates
(``device.item``, the refresh span ``mm.refresh.gate``), part of
``dispatch_ms``. Host clock, the program's own span; None where the
program does not time them."""


def read(run):
    vals = [st["gate_wait_ms"] for st in run.stats if "gate_wait_ms" in st]
    return sum(vals) / len(vals) if vals else None
