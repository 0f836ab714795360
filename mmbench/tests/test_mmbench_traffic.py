"""The traffic: the same seed gives the same fleet and events, another
seed others; the records mirror the arrays."""

import numpy as np
import pytest

from mmbench import harness
from mmbench.traffic import Fleet

ROOT = harness.PKG.parent


def fleet(seed, records=None, scale=(2000, 150)):
    _, _, cfg, traffic = harness.load(ROOT, "full-100k-1k.rebalance")
    cfg = dict(cfg, models=scale[0], pods=scale[1])
    return Fleet(cfg, traffic, seed, records=records)


def draw(seed, ticks=5):
    fl = fleet(seed)
    events = [fl.tick(harness.EPOCH_MS + 250 * (t + 1)) for t in range(ticks)]
    return fl, events


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345])
def test_same_seed_same_traffic(seed):
    a, ev_a = draw(seed)
    b, ev_b = draw(seed)
    for key in a.state:
        assert np.array_equal(a.state[key], b.state[key]), key
    assert ev_a == ev_b


def test_other_seed_other_traffic():
    a, ev_a = draw(1)
    b, ev_b = draw(2)
    assert not np.array_equal(a.state["sizes"], b.state["sizes"])
    assert ev_a != ev_b


def test_tick_shapes():
    fl = fleet(5)
    mids, pids = fl.tick(harness.EPOCH_MS + 250)
    assert 0 < len(mids) <= fl.n // 100
    assert len(pids) == 8 and len(set(pids)) == 8
    rows = [int(m[1:]) for m in mids]
    assert (fl.state["last_used"][rows] == harness.EPOCH_MS + 250).all()
    cap = fl.state["capacity"]
    extra = fl.state["used"] - fl.managed
    assert (extra >= 0).all() and (extra <= 0.1 * cap).all()


def test_fleet_is_the_steady_fleet():
    fl = fleet(3)
    st = fl.state
    assert st["sizes"].min() >= 16 and st["sizes"].max() < 256
    assert (st["loaded_on"][::3] >= 0).all()
    assert (st["loaded_on"][1::3] < 0).all()
    util = st["sizes"].sum() / (st["capacity"].sum())
    assert util == pytest.approx(0.85, rel=0.01)


def test_records_mirror_the_arrays():
    from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

    fl = fleet(4, records=(ModelRecord, InstanceRecord))
    for t in range(3):
        fl.tick(harness.EPOCH_MS + 250 * (t + 1))
    assert fl.records_agree()
    fl.models[5][1].last_used += 1
    assert not fl.records_agree()
