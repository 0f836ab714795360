"""A cell on several cards: the harness hands the program a mesh over
exactly the cell's cards on the model axis, and none on one card; a run
without that many cards prints no result."""

import pytest
import torch

from mmbench import harness
from mmbench_runs import CELL, ROOT, TOPK


def config():
    return harness.load(ROOT, CELL, TOPK)[2]


def test_cards_are_the_first_chips_cuda_devices():
    assert harness.cards(1) == [torch.device("cuda", 0)]
    assert harness.cards(4) == [torch.device("cuda", i) for i in range(4)]
    assert harness.cards(2, "cpu") == [torch.device("cpu")] * 2


@pytest.mark.parametrize("chips", [1, 2, 4])
def test_program_builds_a_mesh_over_exactly_its_cards(chips):
    # CUDA devices named but never touched: building the strategy and
    # its mesh allocates nothing on them.
    system = harness.program(harness.cards(chips), config())
    try:
        assert system.device == torch.device("cuda", 0)
        if chips == 1:
            assert system.mesh is None
        else:
            assert system.mesh.devices == harness.cards(chips)
            assert system.mesh.shape == {"mdl": chips, "inst": 1}
    finally:
        if system.mesh is not None:
            system.mesh.close()


def test_a_cpu_mesh_is_built_for_the_cpu_runs():
    system = harness.program(harness.cards(2, "cpu"), config())
    try:
        assert system.mesh.devices == [torch.device("cpu")] * 2
    finally:
        system.mesh.close()


def test_too_few_cards_is_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(harness.NoDevice):
        harness.run(ROOT, CELL, 1, 1.0, False, t_start=0.0, config=TOPK,
                    chips=4, log=lambda line: None)
