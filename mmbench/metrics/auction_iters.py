"""auction_iters: plan.stats["auction_iters_run"] a refresh, averaged
over the window (a program counter)."""


def read(run):
    vals = [st["auction_iters_run"] for st in run.stats
            if st.get("auction_iters_run") is not None]
    return sum(vals) / len(vals) if vals else None
