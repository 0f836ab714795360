"""The port's own copy of the JAX package's ``sim/scenario.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Seeded scenario engine: declarative fault schedules under virtual time.

A ``Scenario`` is a list of ``Event``s pinned to virtual times. The
runner installs a ``VirtualClock``, builds a ``SimCluster``, then walks
time forward in bounded steps — real production cadences (40 s publisher,
6 min janitor, 7 min reaper, 10 s session TTLs) compress into wall-clock
milliseconds — firing events as their virtual times arrive. At the
horizon it heals all partitions, lets the cluster converge for a
reconciliation window, and runs the invariant suite (sim/invariants.py).

Determinism: the event trace is derived ONLY from the scenario (itself
built from a seeded RNG in sim/explore.py) and virtual timestamps — the
same seed replays bit-for-bit identically. Thread scheduling inside a
step may vary; invariants are *quiescent-state* properties, so verdicts
are stable.

Event kinds:
  kill <iid>              crash an instance (lease revoked, no migration)
  drain <iid>             graceful drain (reconfig/drain.py) then kill:
                          pre-copy to survivors, deregister, die
  add_instance [version]  join a fresh instance (cluster defaults),
                          optionally at a new instance_version
  rolling_upgrade <version> [max_unavailable]
                          reconfig/rolling.py coordinator: drain waves +
                          replacements until the fleet is at <version>
  partition <iid>         KV blackout for one instance
  heal <iid>              end the blackout (held watch events flush)
  expire_lease <iid>      revoke the session lease under the instance
  clock_jump <ms>         single large advance (a freeze: leases MAY expire)
  slow_load <iid> <model> <ms>   per-model virtual load delay
  fail_load <iid> <model>        arm a one-shot load failure
  transfer_fault <model> <after_chunks> <kill|partition>
                          kill/partition the weight-stream SENDER once
                          it has served that many chunks (mid-stream)
  squeeze <iid> <units>   shrink the instance's cache capacity (forces
                          evictions + their async deregisters)
  hold_kv_writes <iid> <key-substr>
                          block that instance's matching KV writes until
                          quiesce (deterministic "async mutation lands
                          arbitrarily late")
  register_flat <model>   write a LEGACY flat-layout registry record
                          (pre-bucketing key shape) straight into the
                          store — the live-migration scenarios' seed
  invoke <model> [via]    probe request, optionally entered at a named
                          pod (forces a forward when the pod holds no
                          copy); traced end-to-end, outcome + virtual
                          latency logged for the SLO invariant
  migrate_fence <phase>   advertise the migration epoch (live|done)
                          without running the sweep — how a scenario
                          turns on dual-read before its workload starts
  migrate_live            run the fenced live registry migration
                          (kv/migrate.py) against the serving cluster
  register <model> [type] [scheme]
                          register a model (type = model_type = SLO
                          class, default "sim" — admission scenarios
                          register typed classes; scheme picks the
                          model-path family, a layer-streamable one
                          like "mlp" makes the model eligible for
                          sharded placement groups)
  ensure/unregister <model>   workload
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time as _wall
from typing import Optional

from modelmesh_tpu_torch.serving.tasks import TaskConfig
from modelmesh_tpu_torch.sim.engine import EventLoop
from modelmesh_tpu_torch.sim.harness import SimCluster
from modelmesh_tpu_torch.sim.kv import SimKVConfig
from modelmesh_tpu_torch.sim import invariants
from modelmesh_tpu_torch.utils import clock as _clock

log = logging.getLogger(__name__)

# Virtual step the runner advances per tick. Small enough that session
# keepalives (ttl/3 ≈ 3.3 s) always run between TTL checks — stepping
# PAST a keepalive's deadline by more than the lease TTL would expire
# leases that real continuous time would have kept alive. Large enough
# that an hour of cadence costs ~1.8k steps.
DEFAULT_STEP_MS = 2_000
# Real seconds yielded per step so threads woken by the advance run.
DEFAULT_YIELD_S = 0.001


@dataclasses.dataclass(frozen=True)
class Event:
    at_ms: int
    kind: str
    args: tuple = ()

    def render(self) -> str:
        return f"@{self.at_ms}ms {self.kind}" + (
            " " + " ".join(str(a) for a in self.args) if self.args else ""
        )


@dataclasses.dataclass
class Scenario:
    name: str
    events: list[Event]
    n_instances: int = 3
    horizon_ms: int = 60_000
    seed: int = 0
    kv_config: Optional[SimKVConfig] = None
    task_config: Optional[TaskConfig] = None
    # Extra convergence window after the horizon before invariants run;
    # default covers two reaper cycles (prune + proactive load).
    quiesce_ms: Optional[int] = None
    instance_kwargs: Optional[dict] = None
    load_delay_ms: float = 50.0
    # Scenario-specific quiescent checks: name -> fn(cluster) -> violations.
    # Run alongside the standard invariant suite; verdicts merge.
    extra_checks: Optional[dict] = None
    # Override the runner's virtual step for timing-sensitive scenarios
    # (observed timestamps quantize onto the step grid).
    step_ms: Optional[int] = None
    # Virtual-time runtime service-cost model (SimCluster): per dispatch,
    # base + congestion * (concurrent dispatches - 1) ms. Overload
    # scenarios need a congestion term or latency never degrades.
    # ``service_scope``: "fleet" prices concurrency fleet-global (one
    # accelerator domain — admission scenarios), "instance" per serving
    # pod (copy count/spread changes latency — autoscale scenarios).
    # ``service_congestion_cap`` bounds the priced concurrency (0 =
    # uncapped): the bounded-admission-queue model, without which one
    # deep backlog prices new dispatches long after a recovery action.
    service_base_ms: float = 0.0
    service_congestion_ms: float = 0.0
    service_scope: str = "fleet"
    service_congestion_cap: int = 0
    # Quiesce hygiene: release hold gates, drain pending async
    # deregisters/unloads, and run one inline janitor cycle before the
    # invariant read (the registry_cache_convergence flake fix). Off
    # only for the meta-test proving the regression scenario catches
    # the reverted behavior.
    quiesce_async: bool = True


@dataclasses.dataclass
class ScenarioResult:
    name: str
    seed: int
    trace: list[str]
    verdicts: dict[str, list[str]]
    wall_s: float
    # Flight-recorder tail per pod (observability/flightrec.py), captured
    # automatically when ANY invariant fails — the postmortem that turns
    # "replay the seed and stare" into "read the events before the
    # violation". None on passing runs (nothing to explain).
    flight_records: Optional[dict[str, list[dict]]] = None

    @property
    def ok(self) -> bool:
        return not any(self.verdicts.values())

    def trace_lines(self) -> list[str]:
        """The replay-comparable artifact: events + verdicts, no wall
        (and no flight events — their interleaving is thread-schedule-
        dependent, unlike the verdicts)."""
        lines = list(self.trace)
        for name, violations in self.verdicts.items():
            lines.append(
                f"invariant {name}: "
                + ("PASS" if not violations else "FAIL " + "; ".join(violations))
            )
        return lines

    def render(self, flight_tail: int = 40) -> str:
        lines = self.trace_lines()
        if self.flight_records:
            lines.append("--- flight recorder (per-pod tail) ---")
            for iid in sorted(self.flight_records):
                events = self.flight_records[iid]
                lines.append(f"[{iid}] {len(events)} events recorded")
                for ev in events[-flight_tail:]:
                    fields = " ".join(
                        f"{k}={v}" for k, v in ev.items()
                        if k not in ("seq", "ts_ms", "kind", "instance")
                    )
                    lines.append(
                        f"  @{ev['ts_ms']}ms {ev['kind']} {fields}".rstrip()
                    )
        return "\n".join(lines)


class ScenarioRunner:
    def __init__(self, scenario: Scenario, step_ms: int = DEFAULT_STEP_MS,
                 yield_s: float = DEFAULT_YIELD_S):
        self.scenario = scenario
        self.step_ms = scenario.step_ms or step_ms
        self.yield_s = yield_s
        self.trace: list[str] = []
        self.dead_since_ms: dict[str, int] = {}
        self._workers: list[threading.Thread] = []

    # -- event dispatch ----------------------------------------------------

    def _fire(self, cluster: SimCluster, clock: _clock.VirtualClock,
              ev: Event) -> None:
        self.trace.append(ev.render())
        kind, args = ev.kind, ev.args
        # Pure fault toggles run inline — they never touch the store
        # through a fault-injectable facade. Everything that CAN block on
        # injected latency / a virtual-delay load must run off the
        # advancing thread, or time stops underneath it.
        if kind == "partition":
            cluster.partition(args[0])
            return
        if kind == "heal":
            cluster.heal(args[0])
            return
        if kind == "expire_lease":
            cluster.expire_lease(args[0])  # inner store, bypasses facades
            return
        if kind == "clock_jump":
            clock.advance(int(args[0]))
            return
        if kind == "slow_load":
            cluster.slow_load(args[0], args[1], float(args[2]))
            return
        if kind == "fail_load":
            cluster.fail_next_load(args[0], args[1])
            return
        if kind == "transfer_fault":
            # Arm a mid-stream transfer fault (pure toggle: the fault
            # itself fires later, on the fetching thread, once the
            # chunk-progress threshold is crossed).
            cluster.arm_transfer_fault(args[0], int(args[1]), args[2])
            return
        if kind == "hold_kv_writes":
            cluster.kv.hold_writes(args[0], args[1])
            return
        if kind == "squeeze":
            # Under the eviction lock the listener only SCHEDULES work —
            # safe inline; the interesting part (the async deregister)
            # runs on the pod's unload pool.
            cluster.by_id(args[0]).instance.cache.set_capacity(int(args[1]))
            return
        if kind == "migrate_fence":
            from modelmesh_tpu_torch.kv.migrate import advertise_phase

            advertise_phase(cluster.kv.inner, "mm", args[0])
            return
        if kind == "register_flat":
            # Legacy pre-bucketing key shape, written straight to the
            # inner store (an old-version fleet's leftover state).
            from modelmesh_tpu_torch.records import ModelRecord

            mid = args[0]
            rec = ModelRecord(model_type="sim", model_path=f"mem://{mid}")
            cluster.kv.inner.put(f"mm/registry/{mid}", rec.to_bytes())
            return
        if kind == "kill":
            self.dead_since_ms[args[0]] = clock.now_ms()
            target, targs = cluster.kill, (args[0],)
        elif kind == "drain":
            # Conservative death stamp at fire time (the actual kill
            # lands when the drain completes — a clean drain leaves no
            # placements for the grace to matter).
            self.dead_since_ms[args[0]] = clock.now_ms()
            target, targs = cluster.drain, (args[0],)
        elif kind == "add_instance":
            target, targs = cluster.spawn, (args[0] if args else "",)
        elif kind == "rolling_upgrade":
            mu = int(args[1]) if len(args) > 1 else 1
            target, targs = cluster.rolling_upgrade, (args[0], mu)
        elif kind == "migrate_live":
            from modelmesh_tpu_torch.kv.migrate import migrate_flat_registry_live

            target, targs = (
                lambda: migrate_flat_registry_live(cluster.kv.inner, "mm"),
                (),
            )
        elif kind == "register":
            # Optional second arg: the model_type ("register m hi") —
            # model_type is the SLO class, so admission scenarios need
            # typed registrations. Optional third: the path scheme
            # (family) — "mlp" makes the model shardable.
            target, targs = cluster.register, tuple(args[:3])
        elif kind == "unregister":
            target, targs = cluster.unregister, (args[0],)
        elif kind == "ensure":
            chain = int(args[1]) if len(args) > 1 else 0
            target, targs = cluster.ensure, (args[0], chain)
        elif kind == "invoke":
            # Optional second arg: the entry pod ("invoke via sim-2") —
            # how scenarios guarantee a forward hop instead of relying
            # on placement to keep models off the default entry pod.
            via = args[1] if len(args) > 1 else None
            target, targs = cluster.invoke, (args[0], via)
        else:
            raise ValueError(f"unknown scenario event kind: {kind}")
        t = threading.Thread(
            target=target, args=targs,
            name=f"sim-ev-{kind}-{args[0] if args else ''}", daemon=True,
        )
        t.start()
        self._workers.append(t)

    # -- driving -----------------------------------------------------------

    def run(self) -> ScenarioResult:
        sc = self.scenario
        t_wall = _wall.perf_counter()  #: wall-clock: reports the run's REAL duration (ScenarioResult.wall_s)
        clock = _clock.VirtualClock()
        cluster = None
        # installed() restores the previous clock and closes this one on
        # exit; the cluster teardown (inner finally) runs first.
        with _clock.installed(clock):
            try:
                # Construct with faults DISARMED: bootstrap runs on the
                # runner thread, and an injected virtual-latency sleep
                # there would deadlock (nobody is advancing time yet).
                # The fault config arms when the drive loop starts and
                # disarms before quiescent invariant reads — which run on
                # this thread too.
                cluster = SimCluster(
                    n=sc.n_instances,
                    seed=sc.seed,
                    task_config=sc.task_config,
                    load_delay_ms=sc.load_delay_ms,
                    instance_kwargs=sc.instance_kwargs,
                    service_base_ms=sc.service_base_ms,
                    service_congestion_ms=sc.service_congestion_ms,
                    service_scope=sc.service_scope,
                    service_congestion_cap=sc.service_congestion_cap,
                )
                if sc.kv_config is not None:
                    cluster.kv.config = sc.kv_config
                start = clock.now_ms()
                events = sorted(
                    sc.events, key=lambda e: (e.at_ms, e.kind, e.args)
                )
                # Scripted events ride the shared event-driven core
                # (sim/engine.py): the loop owns the heap and drives the
                # clock in bridged mode — bounded steps with a wall
                # yield each, so full-fidelity pod threads woken by the
                # advance run between steps (the historical drive loop,
                # now one implementation shared with the macro path).
                # Scheduling in sorted order preserves the firing order
                # (the heap tie-breaks equal due times by schedule seq).
                loop = EventLoop(clock)
                for ev in events:
                    loop.schedule_at(
                        start + ev.at_ms, self._fire, cluster, clock, ev
                    )
                loop.run(
                    start + sc.horizon_ms,
                    step_ms=self.step_ms,
                    yield_s=self.yield_s,
                )
                # Events scheduled at/past the horizon still fire (the
                # pre-engine runner flushed its remaining schedule too).
                loop.drain()
                # Quiesce: heal every partition (a permanently-partitioned
                # store has no convergence obligations), then give the
                # protocol its reconciliation window.
                for pod in cluster.pods:
                    cluster.heal(pod.iid)
                tc = cluster.task_config
                quiesce = sc.quiesce_ms
                if quiesce is None:
                    quiesce = int(
                        2 * max(tc.reaper_interval_s, tc.janitor_interval_s)
                        * 1000
                    ) + tc.assume_gone_ms
                end = clock.now_ms() + quiesce
                while clock.now_ms() < end:
                    clock.advance(self.step_ms)
                    _wall.sleep(self.yield_s)  #: wall-clock: same advancing-thread yield as the event loop
                # Disarm injected latency/conflicts: the invariant suite
                # (and teardown) reads through the same facades on THIS
                # thread.
                cluster.kv.config = SimKVConfig()
                for t in self._workers:
                    t.join(timeout=5.0)  #: wall-clock: bounds REAL worker-thread teardown at quiesce
                cluster.kv.inner.wait_idle(timeout=10.0)
                if sc.quiesce_async:
                    # Async-mutation drain (the registry_cache_convergence
                    # flake fix): release hold gates so deliberately-late
                    # writes land, wait (clock-pumped, wall-bounded) for
                    # every pod's cleanup/unload pools to empty, then run
                    # ONE inline janitor cycle per live pod — a late
                    # eviction's deregister that landed after the last
                    # scheduled janitor pass (or gave up its CAS) is
                    # repaired deterministically before invariants read.
                    cluster.kv.release_holds()
                    cluster.quiesce_async_work(clock, self.step_ms)
                    for pod in cluster.live_pods():
                        try:
                            pod.tasks._janitor_tick()
                        except Exception:  # noqa: BLE001 — repair is
                            # best-effort; invariants report what remains
                            log.exception("quiesce janitor cycle failed")
                    cluster.kv.inner.wait_idle(timeout=5.0)
                _wall.sleep(0.05)  #: wall-clock: lets real listener fan-out threads drain before invariants read
                grace_ms = tc.assume_gone_ms + int(
                    tc.reaper_interval_s * 2000
                )
                # Deaths the runner didn't schedule itself (rolling-
                # upgrade waves kill pods mid-coordinator) are stamped by
                # the cluster; fire-time stamps win (stricter grace).
                dead_since = dict(cluster.deaths)
                dead_since.update(self.dead_since_ms)
                verdicts = invariants.check_all(
                    cluster, dead_since, clock.now_ms(), grace_ms
                )
                for name, fn in (sc.extra_checks or {}).items():
                    verdicts[name] = fn(cluster)
                # Invariant failure => automatic flight-recorder dump:
                # every pod's structured-event tail (state transitions,
                # placements, CAS outcomes, transfer faults, drain
                # phases) rides the result for the postmortem.
                flight = None
                if any(verdicts.values()):
                    flight = {
                        p.iid: p.instance.flightrec.dump()
                        for p in cluster.pods
                    }
                return ScenarioResult(
                    name=sc.name,
                    seed=sc.seed,
                    trace=self.trace,
                    verdicts=verdicts,
                    wall_s=_wall.perf_counter() - t_wall,  #: wall-clock: reports the run's REAL duration
                    flight_records=flight,
                )
            finally:
                if cluster is not None:
                    cluster.close()


def run_scenario(scenario: Scenario, step_ms: int = DEFAULT_STEP_MS,
                 yield_s: float = DEFAULT_YIELD_S) -> ScenarioResult:
    return ScenarioRunner(scenario, step_ms=step_ms, yield_s=yield_s).run()
