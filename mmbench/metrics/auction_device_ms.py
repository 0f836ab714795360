"""auction_device_ms: plan.stats["auction_device_ms"] averaged over the
window's refreshes: the solve's stream time from the plan logits to the
auction's result (the price repair and its implied loads), between the
program's CUDA event marks at the ends of the refresh spans
(``mm.refresh.auction``); idle time inside counts. None where the
program marks no layers."""


def read(run):
    vals = [st["auction_device_ms"] for st in run.stats
            if "auction_device_ms" in st]
    return sum(vals) / len(vals) if vals else None
