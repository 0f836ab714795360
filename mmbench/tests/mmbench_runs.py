"""Runs of the harness on the CPU at a size a test holds: the program
on ``device="cpu"`` (its kernels' plain versions), or a stand-in; and
the faults planted in the program's top-K tier (``topk_fault``), which
the trial runs (``trial.py``) also plant on the card."""

import contextlib
import time
from pathlib import Path

from mmbench import harness

ROOT = harness.PKG.parent
CELL = "full-100k-1k.rebalance"
SCALE = (1000, 150)
SECONDS = 1.5
# The top-K tier on the cell's traffic: a configuration that no cell
# names, at a size the CPU holds, with the tier's width and gates.
TOPK = Path(__file__).resolve().parent / "configs" / "topk-100k-1k.json"
TOPK_SCALE = (2048, 256)


def cpu_run(seed=2**31 + 99, sut=None, trace=False, seconds=SECONDS,
            config=None, scale=None, chips=None):
    return harness.run(ROOT, CELL, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu", sut=sut,
                       scale=scale or (TOPK_SCALE if config else SCALE),
                       config=config, chips=chips, log=lambda line: None)


def topk_run(seed=2**31 + 99, sut=None, chips=None, seconds=SECONDS):
    return cpu_run(seed, sut, seconds=seconds, config=TOPK, chips=chips)


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


class NoPriceSteps(Wrapped):
    """The auction's price steps left out (eta 0): every selection is made
    at the carried prices, which then never move from the cold zeros."""

    def __init__(self, inner, fleet):
        super().__init__(inner, fleet)
        from modelmesh_tpu_torch.ops.solve import SolveConfig

        inner.solve_config = (inner.solve_config or SolveConfig())._replace(
            eta=0.0)


def wrapped(cls, config=None, chips=1):
    """A ``sut`` factory: the port's strategy wrapped in ``cls``."""
    cfg = harness.load(ROOT, CELL, config)[2]

    def make(fleet, solver, clock, device):
        devices = harness.cards(chips, device)
        return cls(harness.program(devices, cfg), fleet)

    return make


@contextlib.contextmanager
def wider_gather(extra: int = 8):
    """A candidate outside the K-th key: the gather hands the auction
    ``extra`` candidates past each row's K-th key (the transport keeps
    the tier's mask)."""
    from modelmesh_tpu_torch.ops import sparse
    from modelmesh_tpu_torch.parallel import sharded_solver

    orig = sparse.topk_candidates

    def wide(C, feasible, k, seed=None, row_offset=None):
        fused = orig(C, feasible, k, seed, row_offset)[3]
        return (*orig(C, feasible, k + extra, seed, row_offset)[:3], fused)

    with _patched((sparse, "topk_candidates", wide),
                  (sharded_solver, "topk_candidates", wide)):
        yield


@contextlib.contextmanager
def early_gate():
    """A Sinkhorn gate that stops one chunk early: where the gate stopped
    after a chunk, the loop's iterates and error are those of the stop
    before (the probe's, after the first chunk)."""
    from modelmesh_tpu_torch.ops import sinkhorn

    orig = sinkhorn.gated_sinkhorn_loop

    def early(run_iters, marginal_err, f_init, g_init, *, eps, iters, tol,
              chunk, dg_reduce=None):
        f, g, err, run = orig(run_iters, marginal_err, f_init, g_init,
                              eps=eps, iters=iters, tol=tol, chunk=chunk,
                              dg_reduce=dg_reduce)
        if run == 1:
            return f, g, err, run
        run -= min(chunk, iters)
        f, g = run_iters(f_init, g_init, run)
        if run == 1:
            return f, g, (g - g_init).abs().max() / eps, run
        return f, g, marginal_err(f, g), run

    with _patched((sinkhorn, "gated_sinkhorn_loop", early)):
        yield


@contextlib.contextmanager
def dropped_partial():
    """One shard's column partial dropped: every sum over the model axis
    (the transport's column products, the implied load, the demand)
    leaves out the last shard's part."""
    from modelmesh_tpu_torch.parallel import mesh

    def call(self, x):
        ctx = mesh._ctx()
        if ctx.mesh.shape[self.axis] == 1:
            return x
        parts = ctx.mesh._exchange(ctx, x, self.axis)[:-1]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def combine(self, fn, *partials):
        ctx = mesh._ctx()
        groups = ctx.mesh._exchange(ctx, tuple(partials), self.axis)[:-1]
        return fn(*(mesh.torch.cat(parts, 0) for parts in zip(*groups)))

    with _patched((mesh.AxisSum, "__call__", call),
                  (mesh.AxisSum, "combine", combine)):
        yield


@contextlib.contextmanager
def _patched(*patches):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, value in patches:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
