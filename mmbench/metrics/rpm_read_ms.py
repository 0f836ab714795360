"""rpm_read_ms: plan.stats["rpm_read_ms"] averaged over the window's
refreshes: the snapshot's per-model rpm read (``_rpm_column``, the
refresh span ``mm.refresh.rpm``), part of ``snapshot_ms``. Host clock, the
program's own span; None where the program has no such span."""


def read(run):
    vals = [st["rpm_read_ms"] for st in run.stats if "rpm_read_ms" in st]
    return sum(vals) / len(vals) if vals else None
