"""On the card (skipped without one): a short run of the cell at its own
size comes out correct, and the control does not; so does a run of the
top-K configuration that no cell names yet (``configs/topk-100k-1k.json``).

    python -m pytest mmbench/tests -m card
"""

import time

import pytest
import torch

from mmbench import harness
from mmbench.stand_in import StandIn
from mmbench_runs import CELL, ROOT, TOPK

SECONDS = 5.0


@pytest.mark.card
def test_cell_is_correct_on_the_card(cuda_card):
    res = harness.run(ROOT, CELL, 2**31 + 7, SECONDS, False,
                      t_start=time.perf_counter(), log=lambda line: None)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
def test_control_is_not_correct_on_the_card(cuda_card):
    def control(fleet, solver, clock, device):
        return StandIn(fleet, solver, clock, device,
                       dtype=torch.float8_e4m3fn)

    res = harness.run(ROOT, CELL, 2**31 + 8, SECONDS, False,
                      t_start=time.perf_counter(), sut=control,
                      log=lambda line: None)
    assert not res["correct"], res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_top_k_configuration_on_the_card(cuda_card, control):
    def fp8(fleet, solver, clock, device):
        return StandIn(fleet, solver, clock, device,
                       dtype=torch.float8_e4m3fn)

    res = harness.run(ROOT, CELL, 2**31 + 9, SECONDS, False,
                      t_start=time.perf_counter(), config=TOPK,
                      sut=fp8 if control else None, log=lambda line: None)
    assert res["correct"] != control, res["checks"]
