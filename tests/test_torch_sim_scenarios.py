"""The port's scripted scenarios and seeded explorer
(``modelmesh_tpu_torch/sim/scenarios.py``, ``explore.py``) under the
reference's own tests, on the CPU.

- ``tests/test_sim_scenarios.py`` (the 15 scripted regression scenarios,
  their replay pins and the fix-reverted twins) and
  ``tests/test_sim_smoke.py`` (the fixed-seed sweep, its replay and the
  ``python -m modelmesh_tpu_torch.sim`` command line) run whole on the
  port (``mirror``).
- The reference's other cases that need ``sim/``, each alone from its
  module: ``test_batching.py::TestSimBatching``,
  ``test_sharded_exec.py::test_sharded_group_drain_replays_bit_for_bit``,
  ``test_slo_flightrec.py::TestTraceCollector`` and
  ``test_racedebug.py::TestScenarioUnderWitness`` (under the port's
  ``racedebug``).

Every case keeps the reference's step and yield (``DEFAULT_STEP_MS``,
``DEFAULT_YIELD_S``): scenarios run in bridged mode, each virtual step
followed by a real sleep so the pods' threads run.
"""

from __future__ import annotations

import pytest

from tests.test_torch_kv_remote import mirror, twins

PARTS = {
    "test_batching": ["TestSimBatching"],
    "test_sharded_exec": ["test_sharded_group_drain_replays_bit_for_bit"],
    "test_slo_flightrec": ["TestTraceCollector"],
    "test_racedebug": ["TestScenarioUnderWitness"],
}

MIRRORED = {
    ref_test: mirror(ref_test, globals())
    for ref_test in ("test_sim_scenarios", "test_sim_smoke")
}
MIRRORED.update({
    ref_test: mirror(ref_test, globals(), only=only)
    for ref_test, only in PARTS.items()
})


@pytest.mark.parametrize("ref_test", sorted(MIRRORED))
def test_every_reference_case_has_its_port_twin(ref_test):
    ref, port = twins(ref_test, globals(), only=PARTS.get(ref_test))
    assert ref and port == ref
