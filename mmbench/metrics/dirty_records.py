"""dirty_records: the records a refresh patched, averaged over the
window: plan.stats["dirty_models"] + ["dirty_instances"], the dirty
marks the refresh consumed (a program counter). None where the program
does not count them."""


def read(run):
    vals = [st["dirty_models"] + st["dirty_instances"] for st in run.stats
            if "dirty_models" in st and "dirty_instances" in st]
    return sum(vals) / len(vals) if vals else None
