"""sinkhorn_iters: plan.stats["sinkhorn_iters_run"] a refresh, averaged
over the window (a program counter)."""


def read(run):
    vals = [st["sinkhorn_iters_run"] for st in run.stats
            if st.get("sinkhorn_iters_run") is not None]
    return sum(vals) / len(vals) if vals else None
