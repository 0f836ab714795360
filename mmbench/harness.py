"""One run of one cell: set-up, the measured window, the check.

Everything cell-specific is found by name: the workload in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json``,
and a reader ``metrics/<metric>.py`` for each metric the run reports.
The traffic's ``driver`` names the loop that drives the system; this
file holds the one the present mixes use, ``rebalance``.

A cell on several cards (``chips`` > 1) hands the strategy a mesh of
that many CUDA cards on the model axis (``parallel.mesh.make_mesh``, as
the strategy's ``auto_mesh`` builds one); a cell on one card runs on
``cuda:0`` with no mesh.

``rebalance``: the leader's refresher as a closed loop with one refresh
in flight. Each tick advances the logical clock by ``tick_ms``, applies
one tick of events to the records and marks the changed ones dirty, then
calls ``TorchPlacementStrategy.refresh(..., incremental=True)``. Set-up
builds the fleet, runs the cold refresh and ``warm_refreshes`` ticks;
the window then runs ticks until ``--seconds`` have passed. After it the
plans of a sample of refreshes drawn from the seed (with the set-up's
cold refresh, the window's last and its last full rebuild) are judged
against the reference (``check.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from mmbench import check
from mmbench import reference as ref

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "modelmesh_tpu")
# The port's logical-time origin for simulations: a fixed wall time, so
# every run's records and columns are the same for the same seed.
EPOCH_MS = 1_700_000_000_000
# Set-up draws the window's events ahead for refreshes down to this
# length; a window of shorter ones draws the rest as it goes.
PREDRAW_MS = 40


class NoDevice(RuntimeError):
    """The run's device is missing: no result is printed."""


class Forbidden(RuntimeError):
    """A forbidden module was loaded: no result is printed."""


def forbidden_modules(names) -> list:
    """Names among ``names`` whose top-level package (the part before the
    first dot, compared whole) is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load(root: Path, workload: str, config=None):
    """(benchmark, workload entry, configuration, traffic). ``config``, a
    configuration file, stands in for the workload's own (the tests run
    a configuration that no cell names through a cell's traffic)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    if config is None:
        config = root / next(c["file"] for c in bench["configs"]
                             if c["name"] == wl["config"])
    cfg = json.loads(Path(config).read_text())
    traffic = json.loads(
        (PKG / "traffic" / f"{wl['traffic']}.json").read_text())
    return bench, wl, cfg, traffic


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mmbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    with ``--trace 0``, its per-layer ones with ``--trace 1``."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if workload in m.get("workloads", [workload])]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def make_clock():
    """A clock for the port that reads the benchmark's logical time."""
    from modelmesh_tpu_torch.utils import clock as clock_mod

    class TickClock(clock_mod.Clock):
        def __init__(self, t: int):
            self.t = t

        def now_ms(self) -> int:
            return self.t

        def monotonic(self) -> float:
            return time.monotonic()

        def sleep(self, seconds: float) -> None:
            time.sleep(seconds)

        def wait_event(self, event, timeout_s: float) -> bool:
            return event.wait(timeout_s)

    return TickClock(EPOCH_MS), clock_mod


def cards(chips: int, device=None) -> list:
    """The devices a run of ``chips`` cards uses, in rank order: the CUDA
    cards ``0 .. chips - 1``, or with ``device`` (the CPU tests) that
    device once a shard."""
    if device is None:
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(device)] * chips


def program(devices: list, cfg: dict):
    """The system under test: the port's strategy on ``devices[0]``, and
    on a mesh over ``devices`` (the model axis) where there are several,
    with the configuration's solver pins in the environment (and no
    other)."""
    for key in [k for k in os.environ if k.startswith("MM_SOLVER_")]:
        del os.environ[key]
    os.environ.update(cfg.get("env", {}))
    from modelmesh_tpu_torch.parallel.mesh import make_mesh
    from modelmesh_tpu_torch.placement.torch_engine import (
        TorchPlacementStrategy,
    )

    mesh = make_mesh(devices=devices) if len(devices) > 1 else None
    return TorchPlacementStrategy(mesh=mesh, device=devices[0])


def launches() -> dict:
    """The port's kernel launch counters (program counters)."""
    from modelmesh_tpu_torch.ops import cuda_load, cuda_lse, cuda_sparse

    return dict(**cuda_load.launches, **cuda_lse.launches,
                **cuda_sparse.launches)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        *, t_start: float, device=None, sut=None, scale=None, config=None,
        chips=None, metrics=None, log=print) -> dict:
    """One run; returns the result object. ``device`` None means the
    cell's CUDA cards, and raises ``NoDevice`` without them; a device
    (the CPU tests) holds every shard. ``sut`` builds the system under
    test from (fleet, solver, clock, device): the port's strategy by
    default. ``scale`` overrides the configuration's models and pods,
    ``config`` its file, ``chips`` the cell's cards and ``metrics`` (a
    list of (name, unit)) the metrics it reports (the trial runs of
    configurations that no cell names, and the CPU tests)."""
    bench, wl, cfg, traffic = load(root, workload, config)
    if traffic["driver"] != "rebalance":
        raise ValueError(f"unknown driver {traffic['driver']!r}")
    if scale is not None:
        cfg = dict(cfg, models=scale[0], pods=scale[1])
    wl = dict(wl, chips=int(wl["chips"] if chips is None else chips))
    on_card = device is None
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < wl["chips"]):
        raise NoDevice(f"{workload} needs {wl['chips']} CUDA device(s)")
    devices = cards(wl["chips"], device)
    clock, clock_mod = make_clock()
    previous = clock_mod.install(clock)
    try:
        return _run(bench, wl, cfg, traffic, seed, seconds, trace, t_start,
                    devices, on_card, sut, clock, metrics, log)
    finally:
        clock_mod.install(previous)


def _run(bench, wl, cfg, traffic, seed, seconds, trace, t_start, devices,
         on_card, sut, clock, wanted, log) -> dict:
    workload = wl["name"]
    device = devices[0]
    solver = ref.solver_from(cfg)
    from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

    from mmbench.traffic import Fleet

    phases = {"imports_s": time.perf_counter() - t_start}
    fleet = Fleet(cfg, traffic, seed, records=(ModelRecord, InstanceRecord))
    fleet.predraw(int(traffic["warm_refreshes"])
                  + math.ceil(seconds * 1e3 / PREDRAW_MS))
    phases["fleet_s"] = time.perf_counter() - t_start
    system = (sut or (lambda fl, s, c, d: program(devices, cfg)))(
        fleet, solver, clock, device)
    loop = Loop(system, fleet, clock, traffic, seed)
    loop.setup(int(traffic["warm_refreshes"]))
    phases["refreshes_ms"] = loop.setup_ms
    used = devices if on_card else []    # the cards to sync and read

    def sync():
        for d in used:
            torch.cuda.synchronize(d)

    sync()
    setup_s = time.perf_counter() - t_start
    launches0 = launches()
    host = HostUse()
    tracer = None
    if trace:
        from mmbench.trace import Trace

        tracer = Trace()
        with tracer, host:
            loop.window(seconds, sync)
    else:
        with host:
            loop.window(seconds, sync)
    launched = {k: v - launches0[k] for k, v in launches().items()}
    peaks = [torch.cuda.max_memory_allocated(d) for d in used]
    summary = tracer.summary(loop.stats, len(devices)) if tracer else None
    tracer = None
    mesh = getattr(system, "mesh", None)
    if mesh is not None:
        mesh.close()
    system = loop.system = None
    gc.collect()
    for d in used:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()

    t_check = time.perf_counter()
    judged = []
    for k, item in sorted(loop.sample.items()):
        nums = check.judge(item.plan, item.g0, item.price0, item.state,
                           item.now, item.seed, solver, fleet.model_ids,
                           fleet.pod_ids, device)
        nums["refresh"] = k
        judged.append(nums)
    check_s = time.perf_counter() - t_check
    names = check.numbers(solver)
    numbers = {k: max(j[k] for j in judged) for k in names}
    limits = {k: float(cfg["limits"][k]) for k in names}
    mirror = fleet.records_agree()
    correct = (check.verdict(numbers, limits) and loop.failed == 0
               and mirror)
    placed = [j["placed"] for j in judged if j["refresh"] > 0]

    rec = SimpleNamespace(
        setup_s=setup_s, window_s=loop.window_s, walls_ms=loop.walls_ms,
        stats=loop.stats, placed=placed, trace=summary, launches=launched,
        n=fleet.n, m=fleet.m, entries=fleet.entries, solver=solver,
        cards=len(devices),
        card=card_line() if on_card else "cpu",
    )
    metrics = {}
    for name, unit in wanted or metric_names(bench, workload, trace):
        value = reader(name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": wl["chips"],
        "memory_peak_bytes": int(max(peaks, default=0)),
    }
    result = {"correct": bool(correct), "attempted": loop.attempted,
              "failed": loop.failed, "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        ops = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:10]],
        }
    log(json.dumps({"card": rec.card, "refreshes": loop.attempted,
                    "card_peaks": [int(b) for b in peaks],
                    "card_busy_s": None if summary is None else summary.busy,
                    "window_s": loop.window_s, "setup_s": setup_s,
                    "check_s": check_s, "setup_phases": phases,
                    "walls_ms": loop.walls_ms,
                    "launches": launched, "records_agree": mirror,
                    "host": host.used,
                    "stages": {k: [round(st.get(k, 0.0), 3)
                                   for st in loop.stats]
                               for k in ("snapshot_ms", "dispatch_ms",
                                         "readback_wait_ms", "extract_ms",
                                         "sinkhorn_iters_run",
                                         "auction_iters_run")},
                    "judged": judged}))
    found = forbidden_modules(sys.modules)
    if found:
        raise Forbidden(f"loaded: {', '.join(found)}")
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in names}
    for k in names:
        log(f"check {k} {numbers[k]!r} limit {limits[k]!r}")
    return result


class HostUse:
    """What the window cost the host process, for the log: CPU seconds and
    the garbage collector's passes and seconds by generation."""

    def __init__(self):
        self.used = {}
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = 0.0

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1

    def __enter__(self):
        self._r0 = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        r0 = self._r0
        self.used = {
            "user_s": r1.ru_utime - r0.ru_utime,
            "sys_s": r1.ru_stime - r0.ru_stime,
            "gc_s": self.gc_s, "gc_passes": self.gc_n,
        }
        return False


class Sampled(SimpleNamespace):
    """A refresh kept for the check: its plan, the column potentials and
    prices it started from, the fleet's state, the logical time and the
    seed."""


class Loop:
    """The closed loop: one refresh in flight, each after one tick."""

    def __init__(self, system, fleet, clock, traffic: dict, seed: int):
        self.system, self.fleet, self.clock = system, fleet, clock
        self.tick_ms = int(traffic["tick_ms"])
        self.rng = np.random.default_rng([int(seed), 2])
        self.keep = int(traffic["judged_refreshes"])
        self.k = 0
        self.rebuilds = 0
        self.prev = None
        self.sample: dict[int, Sampled] = {}
        self.reservoir: list[int] = []
        self.seen = 0
        self.walls_ms, self.stats = [], []
        self.attempted = self.failed = 0
        self.window_s = 0.0
        self.last_rebuild = None

    def _refresh(self):
        """One tick and one refresh; returns (plan, wall ms)."""
        from torch.profiler import record_function

        fl, sysm = self.fleet, self.system
        if self.k > 0:
            self.clock.t += self.tick_ms
            with record_function("mmbench.tick"):
                mids, pids = fl.tick(self.clock.t)
            with record_function("mmbench.mark_dirty"):
                sysm.mark_dirty(mids, pids)
        t = time.perf_counter()
        with record_function("mmbench.refresh"):
            plan = sysm.refresh(fl.models, fl.instances, fl.rpm,
                                incremental=True)
        return plan, (time.perf_counter() - t) * 1e3

    def _keep(self, plan) -> Sampled:
        """The refresh's starting point: the previous plan's column
        potentials always, its prices on a delta refresh only (a full
        rebuild drops them)."""
        prev, pods = self.prev, self.fleet.pod_ids
        g0 = None if prev is None else check.carry(prev, pods, "warm_g")
        price0 = None
        if prev is not None and plan.stats.get("delta_snapshot", False):
            price0 = check.carry(prev, pods, "warm_price")
        return Sampled(plan=plan, g0=g0, price0=price0,
                       state=self.fleet.snapshot(), now=self.clock.t,
                       seed=self.rebuilds)

    def _after(self, plan) -> None:
        if not plan.stats.get("delta_snapshot", False):
            self.rebuilds += 1

    def setup(self, warm: int) -> None:
        self.setup_ms = []
        for _ in range(1 + warm):
            plan, ms = self._refresh()
            self.setup_ms.append(ms)
            self._after(plan)
            if self.k == 0:
                self.sample[0] = self._keep(plan)
            self.prev = plan
            self.k += 1

    def window(self, seconds: float, sync) -> None:
        """Refreshes until ``seconds`` have passed; the window ends when
        the last one started returns. What the check needs is copied only
        for the refreshes the sample keeps; the last one's is taken after
        the window, when nothing has changed since."""
        from torch.profiler import record_function

        before_last = None
        t0 = time.perf_counter()
        with record_function("mmbench.window"):
            while time.perf_counter() - t0 < seconds:
                self.attempted += 1
                try:
                    plan, ms = self._refresh()
                except Exception as exc:  # noqa: BLE001 — counted, run ends
                    self.failed += 1
                    print(f"refresh {self.k} failed: {exc!r}",
                          file=sys.stderr)
                    break
                self._after(plan)
                self.walls_ms.append(ms)
                self.stats.append(dict(plan.stats))
                if not plan.stats.get("delta_snapshot", False):
                    self.last_rebuild = (self.k, self._keep(plan))
                self._reservoir(plan)
                before_last, self.prev = self.prev, plan
                self.k += 1
            sync()
        self.window_s = time.perf_counter() - t0
        if self.walls_ms:
            last, self.prev = self.prev, before_last
            self.sample[self.k - 1] = self._keep(last)
            self.prev = last
        if self.last_rebuild is not None:
            self.sample[self.last_rebuild[0]] = self.last_rebuild[1]

    def _reservoir(self, plan) -> None:
        """Keep a uniform sample of ``keep`` window refreshes (the rng is
        the seed's, so the same seed keeps the same positions)."""
        self.seen += 1
        k = self.k
        if len(self.reservoir) < self.keep:
            self.reservoir.append(k)
            self.sample[k] = self._keep(plan)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.keep:
            self.sample.pop(self.reservoir[j], None)
            self.reservoir[j] = k
            self.sample[k] = self._keep(plan)

