"""The port's simulator (``modelmesh_tpu_torch/sim/``) against the JAX
package's, on the CPU, both packages in one process on the same seeds.

Each package reads time through its own ``utils/clock``; the scenario
runner installs that package's ``VirtualClock`` and puts the previous
clock back, and a fixture here checks and restores both packages'
clocks around every test. The tolerance is exact everywhere: the sim
computes on the host, in Python and numpy, with no value from the card.

- **Schedules.** ``random_scenario(seed, steps)`` gives the same events,
  task cadences and KV faults for 24 seeds at three schedule lengths.
- **The event loop.** A seeded schedule (ties, cancels, handlers that
  schedule more) fires in the same ``(due_ms, seq)`` order at the same
  virtual times, in pure mode and in bridged mode.
- **``SimKV``.** A seeded script of reads, writes, CAS under injected
  conflicts, txns, leases, partitions, heals and session expiries gives
  the same results, and every facade's watcher the same events.
- **The macro fleet.** ``run_macro`` gives the same summary (its digest
  included) for a small ``legacy`` fleet and for a ``burn`` fleet with
  admission, a flash crowd and a kill.
- **The explorer.** ``run_seed`` gives the same trace and verdicts for
  three seeds at the reference smoke test's settings.
- **The replayable scenarios.** The four scripted scenarios the
  reference pins as bit-for-bit replayable give the same trace and
  verdicts in both packages.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _wall

import numpy as np
import pytest

import modelmesh_tpu.kv.store as ref_store
import modelmesh_tpu.sim.engine as ref_engine
import modelmesh_tpu.sim.explore as ref_explore
import modelmesh_tpu.sim.kv as ref_simkv
import modelmesh_tpu.sim.scenario as ref_scenario
import modelmesh_tpu.sim.scenarios as ref_scenarios
import modelmesh_tpu.sim.workload as ref_workload
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.kv.store as port_store
import modelmesh_tpu_torch.sim.engine as port_engine
import modelmesh_tpu_torch.sim.explore as port_explore
import modelmesh_tpu_torch.sim.kv as port_simkv
import modelmesh_tpu_torch.sim.scenario as port_scenario
import modelmesh_tpu_torch.sim.scenarios as port_scenarios
import modelmesh_tpu_torch.sim.workload as port_workload
import modelmesh_tpu_torch.utils.clock as port_clock

CLOCKS = (ref_clock, port_clock)


@pytest.fixture(autouse=True)
def restore_clocks():
    """Both packages' installed clocks are the same after the test as
    before it; they are put back either way."""
    before = [c.get_clock() for c in CLOCKS]
    try:
        yield
    finally:
        after = [c.get_clock() for c in CLOCKS]
        for c, prev in zip(CLOCKS, before):
            c.install(prev)
    assert after == before


# -- schedules -----------------------------------------------------------------


def _schedule(explore, seed, steps):
    sc = explore.random_scenario(seed, steps=steps)
    return {
        "events": [(e.at_ms, e.kind, e.args) for e in sc.events],
        "rendered": [e.render() for e in sc.events],
        "fields": (sc.name, sc.seed, sc.n_instances, sc.horizon_ms),
        "tasks": vars(sc.task_config),
        "kv": vars(sc.kv_config),
    }


@pytest.mark.parametrize("steps", [14, 40, 60])
def test_random_schedules_match_reference(steps):
    for seed in range(24):
        want = _schedule(ref_explore, seed, steps)
        got = _schedule(port_explore, seed, steps)
        assert got == want, seed
        assert len(got["events"]) == steps + 6


# -- the event loop ------------------------------------------------------------


def _loop_run(engine, seed, step_ms):
    """A seeded schedule on ``engine.EventLoop``: due times with ties,
    some events cancelled, some handlers scheduling more (within and past
    the horizon), run in segments and drained. Returns each firing as
    (due_ms, seq, now_ms)."""
    rng = np.random.default_rng(seed)
    loop = engine.EventLoop()
    t0 = loop.now_ms
    evs, fired = {}, []

    def fire(label):
        ev = evs[label]
        fired.append((ev.due_ms - t0, ev.seq, loop.now_ms - t0))
        if rng.random() < 0.25:
            new = f"{label}+"
            evs[new] = loop.schedule_in(int(rng.integers(0, 3_000)), fire, new)

    for i in range(200):
        label = f"e{i}"
        evs[label] = loop.schedule_at(
            t0 + int(rng.integers(0, 60)) * 500, fire, label)
    for i in rng.choice(200, 30, replace=False):
        loop.cancel(evs[f"e{i}"])
    for until in (7_000, 7_000, 19_250, 30_000):
        loop.run(t0 + until, step_ms=step_ms)
    ran, pending = len(fired), loop.pending()
    loop.drain()
    return fired, ran, pending, loop.events_processed, loop.now_ms - t0


@pytest.mark.parametrize("step_ms", [0, 700])
def test_event_loop_fires_in_reference_order(step_ms):
    for seed in range(4):
        want = _loop_run(ref_engine, seed, step_ms)
        got = _loop_run(port_engine, seed, step_ms)
        assert got == want, seed
        fired = got[0]
        assert len(fired) > 170
        if step_ms == 0:
            # Pure mode: each event fires at its due time, in (due, seq)
            # order up to the drain.
            head = fired[:got[1]]
            assert got[2] > 0 and len(head) > 150
            assert all(due == now for due, _, now in head)
            assert [f[:2] for f in head] == sorted(f[:2] for f in head)


# -- SimKV ---------------------------------------------------------------------

OWNERS = ["i-a", "i-b", "i-c"]
KEYS = ["k/1", "k/2", "k/3", "k/x/1", "j/1"]


def _simkv_script(seed, steps=160):
    rng = np.random.default_rng(seed)
    ops, leases = [], 0
    for _ in range(steps):
        owner = OWNERS[int(rng.integers(0, len(OWNERS)))]
        key = KEYS[int(rng.integers(0, len(KEYS)))]
        val = bytes(rng.integers(0, 256, int(rng.integers(1, 5)),
                                 dtype=np.uint8))
        k = int(rng.integers(0, 14))
        if k < 3:
            lease = int(rng.integers(0, leases + 1))
            ops.append(("put", owner, key, val, lease))
        elif k < 5:
            ops.append(("cas", owner, key, val))
        elif k == 5:
            ops.append(("txn", owner, key, val))
        elif k == 6:
            ops.append(("get", owner, key))
        elif k == 7:
            ops.append(("range", owner, key[:2]))
        elif k == 8:
            ops.append(("delete", owner, key))
        elif k == 9:
            ops.append(("grant", owner))
            leases += 1
        elif k == 10:
            ops.append(("keepalive", owner, int(rng.integers(1, leases + 1))
                        if leases else 0))
        elif k == 11:
            ops.append(("partition", owner))
        elif k == 12:
            ops.append(("heal", owner))
        else:
            ops.append(("expire", owner, key))
    return ops


def _drained(facade):
    with facade._delivery_cv:
        return not facade._queue and not facade._dispatching


def _settle(sim, facades, timeout=10.0):
    """Every event so far delivered by the store's dispatch thread (its
    barrier runs after the last callback returns) and every reachable
    facade's delivery queue empty, so the next op finds the same backlog
    in both runs."""
    done = threading.Event()
    sim.inner.dispatch_barrier(lambda rev: done.set())
    assert done.wait(timeout), "the store's dispatch never reached the barrier"
    deadline = _wall.monotonic() + timeout
    for owner, facade in facades.items():
        if sim.is_partitioned(owner):
            continue
        while not _drained(facade):
            assert _wall.monotonic() < deadline, f"{owner} never drained"
            _wall.sleep(0.002)


def _simkv_run(simkv, store, clock_mod, seed):
    clock = clock_mod.VirtualClock()
    prev = clock_mod.install(clock)
    sim = simkv.SimKV(seed=seed, config=simkv.SimKVConfig(
        cas_conflict_p=0.3, watch_reorder_p=0.5))
    results, seen, lease_ids = [], {o: [] for o in OWNERS}, []
    try:
        facades = {o: sim.for_instance(o) for o in OWNERS}
        for owner, facade in facades.items():
            facade.watch("k/", lambda evs, o=owner: seen[o].extend(
                (ev.type.name, ev.kv.key, ev.kv.value, ev.kv.mod_rev)
                for ev in evs))
        for op in _simkv_script(seed):
            kind, owner = op[0], op[1]
            f = facades[owner]
            if kind in ("partition", "heal", "expire"):
                _settle(sim, facades)
            try:
                if kind == "put":
                    lease = (lease_ids[op[4] - 1] or 0) if op[4] else 0
                    out = dataclasses.astuple(f.put(op[2], op[3], lease))
                elif kind == "cas":
                    kv = f.get(op[2])
                    out = dataclasses.astuple(f.put_if_version(
                        op[2], op[3], kv.version if kv else 0))
                elif kind == "txn":
                    ok, kvs = f.txn(
                        [store.Compare(op[2], 0)],
                        [store.Op(op[2], op[3])],
                        [store.Op(op[2])])
                    out = (ok, [dataclasses.astuple(kv) for kv in kvs])
                elif kind == "get":
                    kv = f.get(op[2])
                    out = kv and dataclasses.astuple(kv)
                elif kind == "range":
                    out = [dataclasses.astuple(kv) for kv in f.range(op[2])]
                elif kind == "delete":
                    out = f.delete(op[2])
                elif kind == "grant":
                    # A grant cut off by a partition leaves its ordinal
                    # unbacked: later ops name no lease for it.
                    lease_ids.append(None)
                    lease_ids[-1] = f.lease_grant(30.0)
                    out = len(lease_ids)
                elif kind == "keepalive":
                    lease = lease_ids[op[2] - 1] if op[2] else None
                    out = lease and f.lease_keepalive(lease)
                elif kind == "partition":
                    out = sim.partition(owner)
                elif kind == "heal":
                    out = sim.heal(owner)
                else:
                    out = sim.expire_instance_session(op[2])
            except (ConnectionError, ValueError, store.CasFailed) as e:
                out = (type(e).__name__, str(e))
            results.append((op, out))
            if kind == "heal":
                _settle(sim, facades)
        for owner in OWNERS:
            _settle(sim, facades)
            sim.heal(owner)
        _settle(sim, facades)
        return results, seen, sim.inner.revision
    finally:
        sim.close()
        clock_mod.install(prev)
        clock.close()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_simkv_fault_scripts_match_reference(seed):
    want = _simkv_run(ref_simkv, ref_store, ref_clock, seed)
    got = _simkv_run(port_simkv, port_store, port_clock, seed)
    assert got == want
    results, seen, _ = got
    kinds = {out[0] for _, out in results if isinstance(out, tuple)
             and out and out[0] in ("ConnectionError", "CasFailed")}
    assert kinds == {"ConnectionError", "CasFailed"}
    assert any(op[0] == "expire" and out for op, out in results)
    assert all(len(events) > 10 for events in seen.values())


# -- the macro fleet -----------------------------------------------------------


def _macro(workload, engine, kind):
    if kind == "legacy":
        spec = workload.WorkloadSpec(
            users=4_000, models=48, day_s=1_800,
            classes=(("hi", 0.25), ("default", 0.75)))
        cfg = engine.FleetConfig(authority="legacy", scale_up_rpm=30)
        return workload.run_macro(spec, 8, cfg, seed=11)
    # bench_macro.py's flash/kill/burn/admission cell, its day cut to
    # 40 virtual minutes.
    spec = workload.WorkloadSpec(
        users=400_000, models=96, day_s=2_400, slot_ms=5_000,
        think_ms=5_000.0, classes=(("hi", 0.2), ("default", 0.8)),
        flash=(workload.FlashCrowd(at_ms=1_200_000, duration_ms=600_000,
                                   boost=60.0, n_models=4),),
        faults=(workload.FaultOverlay(at_ms=1_800_000, kind="kill",
                                      frac=0.125),))
    cfg = engine.FleetConfig(authority="burn", admission=True,
                             slo_spec="hi:p99<15ms;default:p99<40ms")
    return workload.run_macro(spec, 16, cfg, seed=7)


@pytest.mark.parametrize("kind", ["legacy", "burn"])
def test_run_macro_matches_reference(kind):
    want = _macro(ref_workload, ref_engine, kind)
    got = _macro(port_workload, port_engine, kind)
    assert got == want
    assert got["conservation_violations"] == []
    assert got["offered"] == got["served"] + got["shed"] + got["failed"]
    assert got["requests_simulated"] > 0 and len(got["digest"]) == 64
    assert got["fleet"]["scale_up"] > 0
    if kind == "burn":
        assert got["shed"] > 0


# -- the explorer --------------------------------------------------------------


def test_run_seed_matches_reference():
    """``tests/test_sim_smoke.py``'s sweep settings, three seeds."""
    for seed in (0, 1, 2):
        want = ref_explore.run_seed(seed, steps=14, horizon_ms=60_000,
                                    step_ms=2_000)
        got = port_explore.run_seed(seed, steps=14, horizon_ms=60_000,
                                    step_ms=2_000)
        assert got.trace_lines() == want.trace_lines(), seed
        assert got.verdicts == want.verdicts, seed
        assert got.ok


# -- the replayable scenarios --------------------------------------------------

REPLAYABLE = [
    "transfer_sender_killed_mid_stream",
    "rolling_restart_under_zipf_load",
    "slo_under_flash_crowd",
    "flash_crowd_autoscaled",
]


@pytest.mark.parametrize("name", REPLAYABLE)
def test_replayable_scenario_matches_reference(name):
    want = ref_scenario.run_scenario(getattr(ref_scenarios, name)())
    got = port_scenario.run_scenario(getattr(port_scenarios, name)())
    assert want.ok, want.render()
    assert got.ok, got.render()
    assert got.trace_lines() == want.trace_lines()
    assert got.verdicts == want.verdicts


def test_scenario_catalogue_matches_reference():
    assert [f.__name__ for f in port_scenarios.ALL] == [
        f.__name__ for f in ref_scenarios.ALL]
    assert sorted(port_scenarios.BY_NAME) == sorted(ref_scenarios.BY_NAME)
    assert len(port_scenarios.ALL) == 15
