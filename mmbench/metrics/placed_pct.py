"""placed_pct: the share of demand (each model's size times its wanted
copies, capped at MAX_COPIES) that the plans place within the pods' free
units, from the plans and the fleet's state (``check.judge``), averaged
over the judged window refreshes."""


def read(run):
    if not run.placed:
        return None
    return sum(run.placed) / len(run.placed)
