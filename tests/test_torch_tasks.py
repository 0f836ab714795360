"""The port's background tasks (``modelmesh_tpu_torch/serving/tasks.py``:
publisher, rate task, janitor, reaper and their helpers) against the JAX
package's, on the CPU.

- **``tests/test_tasks.py``'s five cases** (a second copy, the janitor's
  two repairs, the reaper's prune and its proactive load) on a port
  cluster over localhost gRPC, with the tasks' threads at accelerated
  intervals.
- **One scripted fleet, ticks driven directly, in both packages.** Each
  package runs under its own ``VirtualClock`` (its own
  ``utils/clock.install``), three pods with direct-call peers in front of
  ``tests/test_torch_instance.py``'s stub loader, elections closed and
  the leader set by hand. The script drives the publisher, the rate
  task's 1->2 rule and its threshold rule, the janitor (an unregistered
  copy, a lost placement, an expired failure, lazy ``last_used``), the
  legacy scale-down, and the reaper (the gauges, a ghost's prune at the
  assume-gone boundary, a proactive load). Compared: what each step
  observed, the leader's gauges and the final KV store field by field
  (``TIMING_FIELDS`` by presence, as in ``test_torch_instance.py``).
- **The reaper on ``TorchPlacementStrategy(device="cpu")``:** the
  leader's ``_reaper_tick`` publishes a plan that every follower adopts;
  without a ``refresh`` the scan still feeds the prune pass.
"""

from __future__ import annotations

import contextlib
import os
import random
import time

import pytest

from modelmesh_tpu_torch.observability import metrics as port_metrics
from modelmesh_tpu_torch.placement import plan_sync
from modelmesh_tpu_torch.placement.torch_engine import TorchPlacementStrategy
from tests.test_torch_api import INFO, PORT, REF, Cluster, wait_for
from tests.test_torch_instance import (
    TIMING_FIELDS,
    _compare_stores,
    _store,
    _stub_loader,
)

# -- tests/test_tasks.py on the port -------------------------------------------


def _wait(pred, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(step)
    return True


@pytest.fixture()
def cluster_with_tasks():
    c = Cluster(PORT, n=3)
    cfg = PORT.tasks.TaskConfig(
        publish_interval_s=0.2, rate_interval_s=0.2, janitor_interval_s=0.4,
        reaper_interval_s=0.4, scale_up_rpm=1, second_copy_min_age_ms=0,
        second_copy_max_age_ms=10**9, assume_gone_ms=200,
    )
    tasks = [PORT.tasks.BackgroundTasks(p.instance, cfg) for p in c.pods]
    try:
        for t in tasks:
            t.start()
        yield c
    finally:
        for t in tasks:
            t.stop()
        c.close()


METHOD = PORT.fake.PREDICT_METHOD
TINFO = PORT.spi.ModelInfo(model_type="example", model_path="mem://t")


class TestScaleUp:
    def test_recurring_use_gets_second_copy(self, cluster_with_tasks):
        inst = cluster_with_tasks[0].instance
        inst.register_model("m-hot", TINFO)
        inst.invoke_model("m-hot", METHOD, b"x", [])

        def used_again_and_scaled():
            inst.invoke_model("m-hot", METHOD, b"x", [])
            return len(inst.registry.get("m-hot").instance_ids) >= 2

        assert _wait(used_again_and_scaled, step=0.1), (
            f"copies: {inst.registry.get('m-hot').instance_ids}")


class TestJanitor:
    def test_removes_local_copy_of_unregistered_model(self,
                                                      cluster_with_tasks):
        c = cluster_with_tasks
        inst = c[0].instance
        inst.register_model("m-jan", TINFO)
        inst.invoke_model("m-jan", METHOD, b"x", [])
        holder = c.pod_with_copy("m-jan").instance
        inst.registry.delete("m-jan")
        assert _wait(lambda: holder.cache.get_quietly("m-jan") is None)

    def test_repairs_lost_placement_entry(self, cluster_with_tasks):
        c = cluster_with_tasks
        inst = c[0].instance
        inst.register_model("m-rep", TINFO, load_now=True, sync=True)
        holder = c.pod_with_copy("m-rep").instance

        def strip(cur):
            cur.remove_instance(holder.instance_id)
            return cur

        inst.registry.update_or_create("m-rep", strip)
        assert _wait(lambda: holder.instance_id
                     in inst.registry.get("m-rep").instance_ids)


class TestReaper:
    def test_prunes_gone_instance_placements(self, cluster_with_tasks):
        inst = cluster_with_tasks[0].instance
        inst.register_model("m-ghost", TINFO)

        def haunt(cur):
            cur.promote_loaded("i-ghost", 12345)
            return cur

        inst.registry.update_or_create("m-ghost", haunt)
        assert _wait(lambda: "i-ghost"
                     not in inst.registry.get("m-ghost").instance_ids,
                     timeout=15)

    def test_proactive_load_of_recently_used_model(self, cluster_with_tasks):
        inst = cluster_with_tasks[0].instance
        inst.register_model("m-warm", TINFO)

        def touch(cur):
            cur.last_used = int(time.time() * 1000)
            return cur

        inst.registry.update_or_create("m-warm", touch)
        assert _wait(lambda: len(inst.registry.get("m-warm").instance_ids)
                     >= 1, timeout=15)


# -- one scripted fleet, ticks driven directly, in both packages ---------------


def _recorder(pkg):
    """A metrics sink that keeps the gauges it is given."""
    import importlib

    metrics = importlib.import_module(f"{pkg.root}.observability.metrics")

    class Gauges(metrics.NoopMetrics):
        def __init__(self):
            self.gauges = {}

        def set_gauge(self, metric, value, label=""):
            self.gauges[(metric.metric_name, label)] = value

    return Gauges()


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _advance(clock, ms: int) -> None:
    """Move virtual time in 250 ms steps, letting the session keepalives
    (a third of the 5 s TTL) run between them, so no lease churns."""
    while ms > 0:
        step = min(ms, 250)
        clock.advance(step)
        ms -= step
        time.sleep(0.01)


def _fleet(pkg, kv, loaders, gauges):
    by_endpoint: dict = {}

    def peer_call(endpoint, model_id, method, payload, headers, ctx):
        inst = by_endpoint.get(endpoint)
        if inst is None:
            raise pkg.errors.ServiceUnavailableError(endpoint)
        return inst.invoke_model(model_id, method, payload, headers, ctx,
                                 sync=True)

    insts = []
    try:
        for i, ld in enumerate(loaders):
            inst = pkg.instance.ModelMeshInstance(
                kv, ld, pkg.instance.InstanceConfig(
                    instance_id=f"i-{i}", endpoint=f"ep-{i}",
                    load_timeout_s=10, min_churn_age_ms=0,
                    publish_coalesce_ms=0),
                peer_call=peer_call, metrics=gauges if i == 0 else None,
                runtime_call=(lambda ce, method, payload, headers,
                              cancel_event=None:
                              ce.model_id.encode() + b"|" + payload))
            by_endpoint[inst.config.endpoint] = inst
            insts.append(inst)
        for inst in insts:
            inst.instances_view.wait_for(lambda v: len(v) >= len(loaders),
                                         timeout=20)
            inst._election.close()
        wait_for(lambda: not any(i.is_leader for i in insts),
                 "the closed elections stepping down")
    except BaseException:
        for inst in insts:
            inst.shutdown()
        raise
    return insts


def _holders(insts, mid) -> list:
    mr = insts[0].registry.get(mid)
    return sorted(mr.instance_ids) if mr is not None else None


def _settled(insts) -> None:
    def idle():
        for inst in insts:
            if inst._unload_pool.pending or inst._cleanup_pool.pending:
                return False
            for _mid, ce, _ in inst.cache.descending_items():
                if ce.state.name != "ACTIVE":
                    return False
        for mid, mr in insts[0].registry.items():
            held = {i.instance_id for i in insts
                    if (ce := i.cache.get_quietly(mid)) is not None}
            if set(mr.instance_ids) != held or mr.loading_instances:
                return False
        for inst in insts:
            if {m: r.version for m, r in inst.registry_view.items()} != {
                    m: r.version for m, r in insts[0].registry.items()}:
                return False
        return True

    wait_for(idle, "the fleet settling")


def _info(pkg, units):
    return pkg.spi.ModelInfo("stub", f"mem://u={units}")


def _tick_script(pkg, clock) -> dict:
    kv = pkg.memory.InMemoryKV(sweep_interval_s=1.0)
    loaders = [_stub_loader(pkg, 512) for _ in range(3)]
    gauges = _recorder(pkg)
    insts = _fleet(pkg, kv, loaders, gauges)
    out: dict = {}
    try:
        cfg = pkg.tasks.TaskConfig(
            autoscale_mode="legacy", scale_up_rpm=2000,
            second_copy_min_age_ms=1_000, second_copy_max_age_ms=60_000,
            assume_gone_ms=2_000)
        tasks = [pkg.tasks.BackgroundTasks(i, cfg) for i in insts]
        a, b, c = insts
        a.is_leader = True
        for k, u in enumerate((1, 1, 2, 1, 1, 1, 2)):
            a.register_model(f"m-{k}", _info(pkg, u))
        for k in range(4):
            out[f"miss-{k}"] = a.invoke_model(f"m-{k}", "predict", b"p",
                                              []).served_by
        _settled(insts)
        for t in tasks:
            t._publish_tick()
        # Rate task: a first sample of m-0's use, then the same copy used
        # again past the minimum age: the 1->2 rule adds a copy.
        holder0 = next(t for t in tasks
                       if t.instance.cache.get_quietly("m-0") is not None)
        holder0._rate_tick()
        out["prev_use"] = sorted(holder0._prev_use)
        _advance(clock, 1_500)
        holder0.instance.invoke_model("m-0", "predict", b"q", [])
        holder0._rate_tick()
        wait_for(lambda: len(_holders(insts, "m-0")) == 2, "m-0's 2nd copy")
        _settled(insts)
        out["m-0"] = _holders(insts, "m-0")
        # The threshold rule: local rpm at the per-copy threshold.
        holder3 = next(t for t in tasks
                       if t.instance.cache.get_quietly("m-3") is not None)
        cfg.scale_up_rpm = 1
        holder3.instance.invoke_model("m-3", "predict", b"r", [])
        holder3._rate_tick()
        cfg.scale_up_rpm = 2000
        wait_for(lambda: len(_holders(insts, "m-3")) == 2, "m-3's 2nd copy")
        _settled(insts)
        out["m-3"] = _holders(insts, "m-3")
        # Janitor: an out-of-band delete, a lost placement, a failure
        # past its expiry and an unpersisted last use.
        a.registry.delete("m-1")
        holder2 = _holders(insts, "m-2")[0]

        def strip(cur):
            cur.remove_instance(holder2)
            return cur

        a.registry.update_or_create("m-2", strip)

        def fail(cur):
            cur.add_load_failure("i-9", "old failure")
            return cur

        a.registry.update_or_create("m-3", fail)
        _advance(clock, 1_000)
        for inst in insts:
            inst.registry_view.wait_for(lambda v: "m-1" not in v)
        with _env(MM_LOAD_FAILURE_EXPIRY_MS=500):
            for t in tasks:
                t._janitor_tick()
        wait_for(lambda: all(i.cache.get_quietly("m-1") is None
                             for i in insts), "m-1's copy going")
        _settled(insts)
        out["after_janitor"] = {
            m: (_holders(insts, m),
                sorted(a.registry.get(m).load_failures))
            for m in ("m-2", "m-3")}
        # Legacy scale-down past the surplus cap: the newest copy's
        # holder sheds m-0.
        _advance(clock, 1_000)
        mr = a.registry.get("m-0")
        shedder = max(mr.instance_ids.items(), key=lambda kv: (kv[1],
                                                                kv[0]))[0]
        out["shedder"] = shedder
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pkg.tasks, "SURPLUS_COPY_MIN_AGE_MS", 0)
            mp.setattr(pkg.tasks, "SURPLUS_COPY_MAX_AGE_MS", 1)
            for t in tasks:
                t._janitor_tick()
        wait_for(lambda: shedder not in _holders(insts, "m-0"),
                 "the surplus copy of m-0 going")
        _settled(insts)
        out["m-0-after"] = _holders(insts, "m-0")
        # Reaper: a ghost placement pruned at the assume-gone boundary;
        # a recently used model with no copy loaded proactively.

        def haunt(cur):
            cur.promote_loaded("i-ghost", clock.now_ms())
            return cur

        a.registry.update_or_create("m-4", haunt)
        tasks[0]._reaper_tick()
        out["missing"] = dict(tasks[0]._missing_since)
        _advance(clock, cfg.assume_gone_ms - 250)
        tasks[1]._reaper_tick()  # not the leader: its bookkeeping clears
        tasks[0]._reaper_tick()
        out["ghost_kept"] = "i-ghost" in a.registry.get("m-4").instance_ids
        _advance(clock, 250)

        def touch(cur):
            cur.last_used = clock.now_ms()
            return cur

        a.registry.update_or_create("m-5", touch)
        tasks[0]._reaper_tick()
        wait_for(lambda: "i-ghost" not in a.registry.get("m-4").instance_ids
                 and _holders(insts, "m-5"), "the prune and the proactive "
                 "load")
        _settled(insts)
        out["reaped"] = {m: _holders(insts, m) for m in ("m-4", "m-5")}
        out["gauges"] = sorted(gauges.gauges.items())
        out["fullness"] = [round(pkg.tasks.cluster_fullness(i), 9)
                           for i in insts]
        for inst in insts:
            inst.publish_instance_record(force=True)
        _settled(insts)
        out["store"] = _store(kv)
        return out
    finally:
        for inst in insts:
            inst.shutdown()
        kv.close()


def _run_ticks(pkg) -> dict:
    clock = pkg.clock.VirtualClock()
    prev = pkg.clock.install(clock)
    try:
        return _tick_script(pkg, clock)
    finally:
        pkg.clock.install(prev)
        clock.close()


def test_scripted_ticks_match_reference():
    ref1 = _run_ticks(REF)
    ref2 = _run_ticks(REF)
    port = _run_ticks(PORT)
    moved = _compare_stores(ref1.pop("store"), ref2.pop("store"),
                            port.pop("store"))
    assert moved <= TIMING_FIELDS, moved - TIMING_FIELDS
    assert ref1 == ref2
    assert port == ref1
    assert len(port["m-0"]) == 2 and len(port["m-0-after"]) == 1
    assert port["after_janitor"]["m-3"][1] == []
    assert port["missing"] and port["ghost_kept"]
    assert port["reaped"]["m-4"] == [] and port["reaped"]["m-5"]
    names = {name for (name, _), _ in port["gauges"]}
    assert {"mm_cluster_instances", "mm_cluster_models"} <= names


def test_task_threads_and_jitter_follow_the_reference():
    """The threads each mode starts, and a loop's seeded jitter stream:
    the first wait is ``interval * U[0, 1)`` from
    ``random.Random(f"{instance_id}:{name}")``."""
    c = Cluster(PORT, n=1)
    try:
        inst = c[0].instance
        for mode, expect in (
                ("legacy", {"publisher", "rate", "janitor", "reaper"}),
                ("burn", {"publisher", "autoscale", "janitor", "reaper"}),
                ("off", {"publisher", "janitor", "reaper"})):
            tasks = PORT.tasks.BackgroundTasks(inst, PORT.tasks.TaskConfig(
                autoscale_mode=mode, publish_interval_s=3600,
                rate_interval_s=3600, janitor_interval_s=3600,
                reaper_interval_s=3600, autoscale_interval_s=3600))
            try:
                tasks.start()
                assert {t.name.split("-")[1] for t in tasks._threads} == \
                    expect
            finally:
                tasks.stop()
        with pytest.raises(ValueError):
            PORT.tasks.TaskConfig(autoscale_mode="junk")
    finally:
        c.close()
    # The loop's wait sequence, read off a clock that records its waits.
    waits = {}
    for pkg in (PORT, REF):
        class Recording(pkg.clock.VirtualClock):
            def __init__(self):
                super().__init__()
                self.seen = []

            def wait_event(self, event, timeout=None):
                self.seen.append(timeout)
                return len(self.seen) > 4

        clock = Recording()
        prev = pkg.clock.install(clock)
        try:
            inst = type("I", (), {"instance_id": "i-7",
                                  "shutting_down": False})()
            tasks = pkg.tasks.BackgroundTasks.__new__(pkg.tasks.BackgroundTasks)
            tasks.instance = inst
            tasks.config = pkg.tasks.TaskConfig(jitter_frac=0.1)
            tasks._clock = clock
            tasks._stop = None
            tasks.tick_times = {}
            tasks._loop("janitor", 10.0, lambda: None)
            waits[pkg.root] = clock.seen
        finally:
            pkg.clock.install(prev)
            clock.close()
    assert waits["modelmesh_tpu_torch"] == waits["modelmesh_tpu"]
    rng = random.Random("i-7:janitor")
    assert waits["modelmesh_tpu"][0] == 10.0 * rng.random()


# -- the reaper on the port's strategy -----------------------------------------


def test_reaper_tick_publishes_a_plan_every_follower_adopts():
    c = Cluster(PORT, n=3,
                strategy_factory=lambda: TorchPlacementStrategy(device="cpu"))
    try:
        insts = [p.instance for p in c.pods]
        for k in range(9):
            insts[0].register_model(
                f"q-{k}", PORT.spi.ModelInfo("example", f"mem://q{k}"))
        for inst in insts:
            inst.registry_view.wait_for(lambda v: len(v) == 9, timeout=10)
        wait_for(lambda: sum(i.is_leader for i in insts) == 1, "a leader")
        leader = next(i for i in insts if i.is_leader)
        follower = next(i for i in insts if not i.is_leader)
        tasks = PORT.tasks.BackgroundTasks(leader, PORT.tasks.TaskConfig())
        steps = []
        real = PORT.tasks.reaper_plan_step

        def spy(*args, **kwargs):
            steps.append(real(*args, **kwargs))
            return steps[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PORT.tasks, "reaper_plan_step", spy)
            tasks._reaper_tick()
            # A follower's tick makes no plan.
            PORT.tasks.BackgroundTasks(follower,
                                       PORT.tasks.TaskConfig())._reaper_tick()
        assert len(steps) == 1 and steps[0].plan is not None, steps
        assert steps[0].nbytes > 0 and len(steps[0].records) == 9
        published = c.kv.get(plan_sync.plan_key("mm")).value
        strategies = [i.strategy for i in insts]
        wait_for(lambda: all(s.plan is not None and s.plan.generation
                             == steps[0].plan.generation
                             for s in strategies), "every pod adopting")
        assert all(s.plan.to_bytes() == published for s in strategies)
    finally:
        c.close()


class _SolveTimes(port_metrics.Metrics):
    """Records the placement solve-time samples a pod observes."""

    def __init__(self):
        self.samples = []

    def observe(self, metric, value_ms, model_id=""):
        if metric is port_metrics.Metric.PLACEMENT_SOLVE_TIME:
            self.samples.append(value_ms)


def test_leader_tick_observes_the_solve_time():
    c = Cluster(PORT, n=2,
                strategy_factory=lambda: TorchPlacementStrategy(device="cpu"))
    try:
        insts = [p.instance for p in c.pods]
        for k in range(4):
            insts[0].register_model(
                f"s-{k}", PORT.spi.ModelInfo("example", f"mem://s{k}"))
        for inst in insts:
            inst.registry_view.wait_for(lambda v: len(v) == 4, timeout=10)
        wait_for(lambda: sum(i.is_leader for i in insts) == 1, "a leader")
        leader = next(i for i in insts if i.is_leader)
        follower = next(i for i in insts if not i.is_leader)
        seen = {id(leader): _SolveTimes(), id(follower): _SolveTimes()}
        for inst in (leader, follower):
            inst.metrics = seen[id(inst)]
        steps = []
        real = PORT.tasks.reaper_plan_step

        def spy(*args, **kwargs):
            steps.append(real(*args, **kwargs))
            return steps[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(PORT.tasks, "reaper_plan_step", spy)
            for _ in range(2):
                PORT.tasks.BackgroundTasks(
                    leader, PORT.tasks.TaskConfig())._reaper_tick()
            PORT.tasks.BackgroundTasks(
                follower, PORT.tasks.TaskConfig())._reaper_tick()
        assert len(steps) == 2 and all(s.plan is not None for s in steps)
        assert seen[id(leader)].samples == [s.refresh_ms for s in steps]
        assert seen[id(follower)].samples == []
    finally:
        c.close()


def test_reaper_without_refresh_still_scans_and_prunes():
    """The default greedy strategy has no ``refresh``: the step publishes
    nothing, and the scan it returns feeds the prune pass."""
    c = Cluster(PORT, n=1)
    try:
        inst = c[0].instance
        assert getattr(inst.strategy, "refresh", None) is None
        wait_for(lambda: inst.is_leader, "the leader")
        inst.register_model("m-g", INFO)

        def haunt(cur):
            cur.promote_loaded("i-ghost", 1)
            return cur

        inst.registry.update_or_create("m-g", haunt)
        tasks = PORT.tasks.BackgroundTasks(inst, PORT.tasks.TaskConfig(
            assume_gone_ms=0))
        tasks._reaper_tick()
        assert "i-ghost" not in inst.registry.get("m-g").instance_ids
        assert c.kv.get(plan_sync.plan_key("mm")) is None
    finally:
        c.close()
