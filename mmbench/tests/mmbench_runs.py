"""Runs of the harness on the CPU at a size a test holds: the program
on ``device="cpu"`` (its kernels' plain versions), or a stand-in."""

import time

from mmbench import harness

ROOT = harness.PKG.parent
CELL = "full-100k-1k.rebalance"
SCALE = (1000, 150)
SECONDS = 1.5


def cpu_run(seed=2**31 + 99, sut=None, trace=False, seconds=SECONDS):
    return harness.run(ROOT, CELL, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu", sut=sut,
                       scale=SCALE, log=lambda line: None)


class Wrapped:
    """The port's strategy with a fault planted between the harness and
    it."""

    def __init__(self, inner, fleet):
        self.inner, self.fleet = inner, fleet
        self.calls = 0

    def mark_dirty(self, models=(), instances=()):
        self.inner.mark_dirty(models, instances)

    def refresh(self, *args, **kwargs):
        self.calls += 1
        return self.inner.refresh(*args, **kwargs)


def wrapped(cls):
    """A ``sut`` factory: the port's strategy wrapped in ``cls``."""
    cfg = harness.load(ROOT, CELL)[2]

    def make(fleet, solver, clock, device):
        return cls(harness.program(device, cfg), fleet)

    return make
