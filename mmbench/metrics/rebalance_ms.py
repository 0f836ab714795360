"""rebalance_ms: the window's seconds over the refreshes completed in it
(host clock), in ms: the time from one fresh plan to the next."""


def read(run):
    if not run.walls_ms:
        return None
    return run.window_s * 1e3 / len(run.walls_ms)
