"""The port's own copy of the JAX package's ``sim/explore.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Randomized scenario exploration: seed -> schedule -> verdicts.

``random_scenario(seed, steps)`` expands a seed into a deterministic
fault-plus-workload schedule (every draw comes from one ``random.Random``
seeded with it — no wall time, no ids from the environment), so a failing
run is reproduced bit-for-bit by re-running the printed seed:

    python -m modelmesh_tpu_torch.sim --seed 1234 --steps 60

Env defaults (utils/envs.py): MM_SIM_SEED / MM_SIM_STEPS.
"""

from __future__ import annotations

import argparse
import random
import sys
from typing import Optional

from modelmesh_tpu_torch.serving.tasks import TaskConfig
from modelmesh_tpu_torch.sim.kv import SimKVConfig
from modelmesh_tpu_torch.sim.scenario import (
    Event,
    Scenario,
    ScenarioResult,
    run_scenario,
)

# Event mix weights for the random schedule. Workload dominates — faults
# against an idle cluster check nothing.
_KINDS = (
    ("register", 18),
    ("ensure", 22),
    ("invoke", 22),
    ("unregister", 4),
    ("kill", 3),
    ("partition", 6),
    ("heal", 8),
    ("expire_lease", 4),
    ("clock_jump", 3),
    ("slow_load", 5),
    ("fail_load", 5),
)


def random_scenario(
    seed: int,
    steps: int = 40,
    n_instances: int = 3,
    horizon_ms: int = 120_000,
) -> Scenario:
    rng = random.Random(seed)
    model_pool = [f"m-{seed % 1000}-{i}" for i in range(max(4, steps // 6))]
    iids = [f"sim-{i}" for i in range(n_instances)]
    kinds = [k for k, w in _KINDS for _ in range(w)]
    events: list[Event] = []
    # Seed workload so early faults land on a non-empty cluster.
    for i, mid in enumerate(model_pool[:3]):
        events.append(Event(at_ms=200 * i, kind="register", args=(mid,)))
        events.append(Event(at_ms=400 + 200 * i, kind="ensure", args=(mid,)))
    killed: set[str] = set()
    partitioned: set[str] = set()
    for _ in range(steps):
        at = rng.randrange(1_000, horizon_ms)
        kind = rng.choice(kinds)
        mid = rng.choice(model_pool)
        iid = rng.choice(iids)
        if kind == "kill":
            # At most one crash per scenario third — a majority-dead
            # cluster has no availability obligations to check.
            if len(killed) >= max(1, n_instances // 3) or iid in killed:
                kind = "ensure"
            else:
                killed.add(iid)
        if kind == "partition":
            if iid in killed:
                kind = "invoke"
            else:
                partitioned.add(iid)
        if kind == "heal":
            if not partitioned:
                kind = "invoke"
            else:
                iid = rng.choice(sorted(partitioned))
        if kind in ("register", "ensure", "invoke", "unregister"):
            events.append(Event(at_ms=at, kind=kind, args=(mid,)))
        elif kind in ("kill", "partition", "heal", "expire_lease"):
            events.append(Event(at_ms=at, kind=kind, args=(iid,)))
        elif kind == "clock_jump":
            events.append(
                Event(at_ms=at, kind="clock_jump",
                      args=(rng.choice((15_000, 60_000, 300_000)),))
            )
        elif kind == "slow_load":
            events.append(
                Event(at_ms=at, kind="slow_load",
                      args=(iid, mid, rng.choice((500, 2_000, 10_000))))
            )
        elif kind == "fail_load":
            events.append(Event(at_ms=at, kind="fail_load", args=(iid, mid)))
    # Compressed cadences: full production intervals would need hours of
    # virtual horizon per seed; scaled-down intervals keep every protocol
    # interaction while a sweep stays in tier-1 budget (the scripted
    # scenarios in sim/scenarios.py compress the same way; hour-scale
    # production-cadence boundaries are covered by the direct-tick tests
    # in tests/test_sim_cluster.py, which jump the clock precisely).
    tc = TaskConfig(
        publish_interval_s=8.0,
        rate_interval_s=4.0,
        janitor_interval_s=30.0,
        reaper_interval_s=30.0,
        assume_gone_ms=60_000,
    )
    return Scenario(
        name=f"random-{seed}",
        seed=seed,
        events=events,
        n_instances=n_instances,
        horizon_ms=horizon_ms,
        task_config=tc,
        kv_config=SimKVConfig(
            latency_ms=2.0,
            latency_jitter_ms=8.0,
            cas_conflict_p=0.05,
            watch_delay_ms=20.0,
            watch_reorder_p=0.2,
        ),
    )


def run_seed(
    seed: int, steps: int = 40, n_instances: int = 3,
    step_ms: int = 1_000, horizon_ms: int = 120_000,
) -> ScenarioResult:
    return run_scenario(
        random_scenario(
            seed, steps=steps, n_instances=n_instances,
            horizon_ms=horizon_ms,
        ),
        step_ms=step_ms,
    )


def _run_named_scenario(name: str, step_ms: int, trace: bool) -> int:
    """--scenario NAME: one scripted scenario from sim/scenarios.py."""
    from modelmesh_tpu_torch.sim import scenarios

    factory = scenarios.BY_NAME.get(name)
    if factory is None:
        print(f"unknown scenario {name!r}; available:")
        for n in sorted(scenarios.BY_NAME):
            print(f"  {n}")
        return 2
    result = run_scenario(factory(), step_ms=step_ms)
    status = "PASS" if result.ok else "FAIL"
    print(f"[{status}] {result.name} wall={result.wall_s:.1f}s")
    if trace or not result.ok:
        print(result.render())
    if not result.ok:
        print(
            f"REPLAY: python -m modelmesh_tpu_torch.sim --scenario {name} "
            f"--step-ms {step_ms}"
        )
    return 0 if result.ok else 1


def _run_macro(args) -> int:
    """--macro: closed-loop workload-generator run on the modeled
    fleet (sim/engine.py + sim/workload.py) — the CLI door to the
    macro-bench's machinery at hand-picked scale."""
    import json

    from modelmesh_tpu_torch.sim.engine import FleetConfig
    from modelmesh_tpu_torch.sim.workload import WorkloadSpec, run_macro

    seed = args.seed if args.seed is not None else 0
    spec = WorkloadSpec(
        users=args.users,
        models=args.models,
        day_s=args.day_s,
        classes=(("hi", 0.2), ("default", 0.8)),
    )
    cfg = FleetConfig(
        authority=args.authority,
        admission=args.admission,
        slo_spec="hi:p99<25ms;default:p99<100ms",
    )
    out = run_macro(spec, args.pods, cfg, seed=seed)
    print(json.dumps(out))
    if out["conservation_violations"]:
        print(
            f"REPLAY: python -m modelmesh_tpu_torch.sim --macro --seed {seed} "
            f"--pods {args.pods} --users {args.users} "
            f"--models {args.models} --day-s {args.day_s} "
            f"--authority {args.authority}"
            + (" --admission" if args.admission else "")
        )
        return 1
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    from modelmesh_tpu_torch.utils.envs import get_int

    parser = argparse.ArgumentParser(
        prog="python -m modelmesh_tpu_torch.sim",
        description="Deterministic cluster simulation: seeded random "
        "fault exploration with invariant checking, scripted scenarios "
        "by name, or the macro workload generator.",
    )
    parser.add_argument("--seed", type=int, default=None,
                        help="base seed (default: MM_SIM_SEED)")
    parser.add_argument("--steps", type=int, default=None,
                        help="schedule length per seed (default: MM_SIM_STEPS)")
    parser.add_argument("--sweeps", type=int, default=1,
                        help="consecutive seeds to explore from --seed")
    parser.add_argument("--instances", type=int, default=3)
    parser.add_argument("--step-ms", type=int, default=1_000,
                        help="virtual ms advanced per runner tick")
    parser.add_argument("--trace", action="store_true",
                        help="print the full event trace even on success")
    parser.add_argument("--scenario", metavar="NAME", default=None,
                        help="run ONE scripted scenario by name "
                        "(sim/scenarios.py; unknown name lists all)")
    parser.add_argument("--macro", action="store_true",
                        help="run the closed-loop macro workload on the "
                        "modeled fleet instead of fault exploration")
    parser.add_argument("--pods", type=int, default=16,
                        help="[--macro] modeled fleet size")
    parser.add_argument("--users", type=int, default=100_000,
                        help="[--macro] closed-loop synthetic users")
    parser.add_argument("--models", type=int, default=256,
                        help="[--macro] registered model count")
    parser.add_argument("--day-s", type=int, default=3_600,
                        help="[--macro] virtual seconds simulated")
    parser.add_argument("--authority", default="burn",
                        choices=("legacy", "burn", "off"),
                        help="[--macro] autoscale authority mode")
    parser.add_argument("--admission", action="store_true",
                        help="[--macro] enable modeled admission control")
    args = parser.parse_args(argv)
    if args.scenario is not None:
        return _run_named_scenario(args.scenario, args.step_ms, args.trace)
    if args.macro:
        return _run_macro(args)
    seed = args.seed if args.seed is not None else get_int("MM_SIM_SEED")
    steps = args.steps if args.steps is not None else get_int("MM_SIM_STEPS")

    failures = 0
    for s in range(seed, seed + args.sweeps):
        result = run_seed(
            s, steps=steps, n_instances=args.instances, step_ms=args.step_ms
        )
        status = "PASS" if result.ok else "FAIL"
        print(
            f"[{status}] seed={s} steps={steps} events={len(result.trace)} "
            f"wall={result.wall_s:.1f}s"
        )
        if args.trace or not result.ok:
            print(result.render())
        if not result.ok:
            failures += 1
            print(
                f"REPLAY: python -m modelmesh_tpu_torch.sim --seed {s} "
                f"--steps {steps} --instances {args.instances}"
            )
    return 1 if failures else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
