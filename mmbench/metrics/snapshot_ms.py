"""snapshot_ms: plan.stats["snapshot_ms"] averaged over the window's
refreshes, rebuilds included: the host snapshot: the delta patch
(patch_columns), or on a full rebuild snapshot_columns. Host clock, the
program's own stage timer."""


def read(run):
    vals = [st["snapshot_ms"] for st in run.stats if "snapshot_ms" in st]
    return sum(vals) / len(vals) if vals else None
