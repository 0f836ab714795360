"""The port's simulator (``modelmesh_tpu_torch/sim/``) under the
reference's own tests, on the CPU.

``tests/test_sim_engine.py`` (the event loop, the modeled fleet and its
parity gates against the port's real ``SimLoader``, ``SloTracker`` and
``SimCluster``, the CLI's doors), ``tests/test_sim_cluster.py`` (janitor
and reaper edge cases under virtual time, ``SimKV``, ``VirtualClock``)
and ``tests/test_autoscale.py`` (the autoscale controller and forecaster
on the port's ``SimCluster``) run here with their imports re-pointed at
the port (``mirror``): every case, the same parameters, the same
assertions. The scenarios, the seeded explorer and the cross-package
checks are in ``test_torch_sim_scenarios.py`` and
``test_torch_sim_parity.py``.
"""

from __future__ import annotations

import pytest

from tests.test_torch_kv_remote import mirror, twins

MIRRORED = {
    ref_test: mirror(ref_test, globals())
    for ref_test in ("test_sim_engine", "test_sim_cluster", "test_autoscale")
}


@pytest.mark.parametrize("ref_test", sorted(MIRRORED))
def test_every_reference_case_has_its_port_twin(ref_test):
    ref, port = twins(ref_test, globals())
    assert ref and port == ref
