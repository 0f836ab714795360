"""The port's own copy of the JAX package's ``sim/__init__.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Deterministic cluster simulation harness.

FoundationDB-style dynamic correctness checking for the distributed
control plane: N in-process ``ModelMeshInstance``s run against a shared
fault-injectable KV under **virtual time** (utils/clock.py), a seeded
scenario engine injects faults (kill, partition, lease expiry, clock
jumps, slow/failing loads, CAS-conflict amplification, watch delay), and
machine-checked cluster invariants run at quiescence.

The static half of this correctness story is ``tools/analysis`` (lock
discipline within a process); this package is the dynamic half —
cross-instance interleavings through the KV store. See docs/testing.md.

Two fidelity tiers share one event-driven core (``sim/engine.py``):
full-fidelity ``ModelMeshInstance``s bridged over the ``VirtualClock``
(the scripted/random scenarios above), and lightweight
``ModeledInstance`` state machines calibrated against the real stack
(``ModeledFleet``) that the closed-loop workload generator
(``sim/workload.py``) drives to macro scale — a thousand pods and a
million users per virtual day in minutes of wall clock
(``bench_macro.py``).

Entry points:
- ``python -m modelmesh_tpu_torch.sim --seed S --steps K`` — randomized
  exploration; prints a replayable seed on invariant failure.
- ``python -m modelmesh_tpu_torch.sim --scenario NAME`` — one scripted
  scenario by name (unknown name lists all).
- ``python -m modelmesh_tpu_torch.sim --macro --pods N --users U`` — the
  closed-loop macro workload on the modeled fleet.
- ``modelmesh_tpu_torch.sim.scenarios`` — scripted regression scenarios
  replaying previously-fixed distributed races.
"""

from modelmesh_tpu_torch.sim.engine import (  # noqa: F401
    EventLoop,
    FleetConfig,
    ModeledFleet,
)
from modelmesh_tpu_torch.sim.harness import SimCluster, SimLoader  # noqa: F401
from modelmesh_tpu_torch.sim.kv import SimKV, SimKVConfig  # noqa: F401
from modelmesh_tpu_torch.sim.ringlog import RingLog  # noqa: F401
from modelmesh_tpu_torch.sim.scenario import (  # noqa: F401
    Event,
    Scenario,
    ScenarioResult,
    run_scenario,
)
from modelmesh_tpu_torch.sim.workload import (  # noqa: F401
    WorkloadGenerator,
    WorkloadSpec,
    run_macro,
)
