"""The control: the reference put in the program's place, with the cost
and the plan logits in fp8 (the precision below the configuration's
bf16), comes out not correct; the reference itself, in bf16, comes out
correct. The chip's readings at the cell's size (``trial.py --sut
control``) are in PERF.md."""

import torch

from mmbench.stand_in import StandIn
from mmbench_runs import cpu_run


def stand_in(dtype):
    def make(fleet, solver, clock, device):
        return StandIn(fleet, solver, clock, device, dtype=dtype)

    return make


def test_control_is_not_correct():
    res = cpu_run(sut=stand_in(torch.float8_e4m3fn))
    assert not res["correct"], res["checks"]
    assert res["checks"]["g_gap"]["value"] > res["checks"]["g_gap"]["limit"]


def test_reference_in_place_is_correct():
    res = cpu_run(sut=stand_in(torch.bfloat16))
    assert res["correct"], res["checks"]
    assert res["checks"]["assign_gap"]["value"] == 0.0
    assert res["checks"]["price_gap"]["value"] == 0.0
