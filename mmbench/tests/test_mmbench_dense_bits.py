"""The dense cell's comparison did not move: on fixed seeds, the check
numbers of the cold refresh and three warm ones are, bit for bit, those
the check and the reference gave before they learned the top-K tier
(recorded on an x86-64 CPU with this test's sizes; the program's plain
versions on the CPU)."""

import pytest
import torch

from mmbench import check, harness
from mmbench import reference as ref
from mmbench.traffic import Fleet
from mmbench_runs import CELL, ROOT, SCALE

# seed -> each refresh's (g_gap, assign_gap, price_gap, overflow_gap,
# count_errors, placed)
BEFORE = {
    2**31 + 11: [
        (1.6133896857395413e-06, 0.0, 0.0, 0.0, 0, 97.74814395181728),
        (2.1676981168394782e-06, 0.0, 0.0, 0.0, 0, 98.62995318882494),
        (2.1700708224825505e-06, 0.0, 0.0, 0.0, 0, 98.97730999731655),
        (1.9390152522502646e-06, 0.0, 0.0, 0.0, 0, 99.14353439279645),
    ],
    5: [
        (1.9597791006686904e-06, 0.0, 0.0, 0.0, 0, 97.67838237612908),
        (1.9413110158988944e-06, 0.0, 0.0, 0.0, 0, 99.00512828213812),
        (2.202425024577792e-06, 0.0, 0.0, 0.0, 0, 99.245399187584),
        (2.4486949365756794e-06, 0.0, 0.0, 0.0, 0, 99.24164495468642),
    ],
}


@pytest.mark.parametrize("seed", sorted(BEFORE))
def test_dense_numbers_are_the_same_bits(seed):
    from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

    _, _, cfg, traffic = harness.load(ROOT, CELL)
    cfg = dict(cfg, models=SCALE[0], pods=SCALE[1])
    solver = ref.solver_from(cfg)
    clock, clock_mod = harness.make_clock()
    previous = clock_mod.install(clock)
    try:
        fleet = Fleet(cfg, traffic, seed,
                      records=(ModelRecord, InstanceRecord))
        loop = harness.Loop(harness.program([torch.device("cpu")], cfg),
                            fleet, clock, traffic, seed)
        got = []
        for _ in range(4):
            plan, _ = loop._refresh()
            loop._after(plan)
            item = loop._keep(plan)
            loop.prev, loop.k = plan, loop.k + 1
            nums = check.judge(plan, item.g0, item.price0, item.state,
                               item.now, item.seed, solver, fleet.model_ids,
                               fleet.pod_ids, "cpu")
            got.append(tuple(nums[k] for k in check.NUMBERS)
                       + (nums["placed"],))
    finally:
        clock_mod.install(previous)
    assert got == BEFORE[seed]
