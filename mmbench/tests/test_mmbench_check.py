"""The comparison's numbers and placed_pct on hand-made plans."""

import numpy as np
import pytest

from mmbench import check
from mmbench import reference as ref
from mmbench.stand_in import Plan

SOLVER = ref.Solver(eps=0.05, sinkhorn_iters=10, auction_iters=40, eta=0.5,
                    tau=1.0)
MODELS = ["m0", "m1", "m2", "m3"]
PODS = ["i0", "i1"]


def state():
    return {
        "sizes": np.array([10, 20, 30, 40]),
        "copies": np.zeros(4, np.int64),
        "loaded_on": np.full(4, -1),
        "rpm": np.array([5, 6, 7, 8]),
        "last_used": np.zeros(4, np.int64),
        "capacity": np.array([50, 60]),
        "used": np.zeros(2, np.int64),
        "lru_ts": np.full(2, 1000),
        "busy": np.array([0, 1]),
        "zone": np.array([0, 1]),
    }


def plan(placements, overflow):
    zeros = {p: 0.0 for p in PODS}
    return Plan(placements, dict(zeros), dict(zeros), {"overflow": overflow})


def judge(p, price0=None):
    return check.judge(p, None, price0, state(), 10_000, 1, SOLVER, MODELS,
                       PODS, "cpu")


def test_placed_pct_on_a_hand_made_plan():
    # Loads 30 and 70 on free units 50 and 60: 30 + 60 of 100 placed.
    out = judge(plan({"m0": ["i0"], "m1": ["i0"], "m2": ["i1"],
                      "m3": ["i1"]}, 10.0))
    assert out["placed"] == pytest.approx(90.0)
    assert out["overflow_gap"] == 0.0
    assert out["count_errors"] == 0


def test_overflow_gap_is_exact():
    out = judge(plan({"m0": ["i0"], "m1": ["i0"], "m2": ["i1"],
                      "m3": ["i1"]}, 9.0))
    assert out["overflow_gap"] == 1.0


def test_count_errors():
    out = judge(plan({"m0": ["i0", "i0"], "m1": ["i0", "i1"],
                      "m2": ["i9"]}, 0.0))
    # m0 repeats a pod, m1 has two pods for one copy, m2 names an unknown
    # pod (and so has none), m3 is missing.
    assert out["count_errors"] == 4


def test_assign_gap_sees_a_worse_pod():
    st = state()
    cols = ref.columns(st, 10_000)
    C = ref.cost(cols, "cpu")
    tr = ref.transport(C, cols, SOLVER, None)
    sc = ref.scores(C, tr, SOLVER, 1)
    best = sc.argmax(dim=1).tolist()
    g = dict(zip(PODS, tr.g.float().tolist()))
    good = Plan({m: [PODS[j]] for m, j in zip(MODELS, best)}, g,
                {p: 0.0 for p in PODS}, {})
    worst = Plan({m: [PODS[1 - j]] for m, j in zip(MODELS, best)}, g,
                 {p: 0.0 for p in PODS}, {})
    a = check.judge(good, None, None, st, 10_000, 1, SOLVER, MODELS, PODS,
                    "cpu")
    b = check.judge(worst, None, None, st, 10_000, 1, SOLVER, MODELS, PODS,
                    "cpu")
    assert a["assign_gap"] == 0.0 and a["g_gap"] < 1e-5
    gaps = (sc.max(dim=1).values - sc.min(dim=1).values)
    assert b["assign_gap"] == pytest.approx(float(gaps.max()), rel=1e-6)


def test_a_plan_without_carries_fails():
    p = Plan({m: ["i0"] for m in MODELS}, None, None, {"overflow": 0.0})
    out = judge(p)
    assert out["g_gap"] == float("inf") and out["assign_gap"] == float("inf")
    assert out["price_gap"] == float("inf")
    assert not check.verdict(out, dict.fromkeys(check.NUMBERS, 1.0))


def test_price_gap_against_the_reference_auction():
    st = state()
    cols = ref.columns(st, 10_000)
    C = ref.cost(cols, "cpu")
    sc = ref.scores(C, ref.transport(C, cols, SOLVER, None), SOLVER, 1)
    idx, valid, price, of = ref.auction(sc, cols, SOLVER, None)
    placements = {m: [PODS[j] for j in idx[i][valid[i]].tolist()]
                  for i, m in enumerate(MODELS)}
    prices = dict(zip(PODS, price.tolist()))
    same = judge(Plan(placements, {p: 0.0 for p in PODS}, prices,
                      {"overflow": of}))
    assert same["price_gap"] == 0.0 and same["ref_overflow"] == of
    moved = dict(prices, i1=prices["i1"] + 0.25)
    off = judge(Plan(placements, {p: 0.0 for p in PODS}, moved,
                     {"overflow": of}))
    assert off["price_gap"] == pytest.approx(0.25)
    # Judged from other carried prices, the reference's auction ends
    # elsewhere.
    far = judge(Plan(placements, {p: 0.0 for p in PODS}, prices,
                     {"overflow": of}), price0=np.array([0.0, 1e6]))
    assert far["price_gap"] > 1.0


def test_reference_auction_starts_from_the_carried_prices():
    st = state()
    cols = ref.columns(st, 10_000)
    C = ref.cost(cols, "cpu")
    sc = ref.scores(C, ref.transport(C, cols, SOLVER, None), SOLVER, 1)
    cold = ref.auction(sc, cols, SOLVER, None)
    frozen = ref.auction(sc, cols, SOLVER._replace(auction_iters=0),
                         np.array([0.0, 1e6]))
    # At a prohibitive price on i1 every model picks i0.
    assert frozen[0][:, 0].tolist() == [0, 0, 0, 0]
    assert frozen[3] == 50.0 and cold[3] <= 10.0


def test_solver_refuses_what_the_reference_does_not_implement():
    cfg = {"solver": {"eps": 0.05, "sinkhorn_iters": 10, "sinkhorn_tol": 0.0,
                      "auction_iters": 40, "auction_stall_tol": 0.0,
                      "eta": 0.5, "tau": 1.0, "topk": 0, "sel_width": 8}}
    assert ref.solver_from(cfg) == SOLVER
    for key, value in (("topk", 24), ("sinkhorn_tol", 0.02),
                       ("auction_stall_tol", 1e-3), ("sel_width", 2)):
        bad = {"solver": dict(cfg["solver"], **{key: value})}
        with pytest.raises(ValueError):
            ref.solver_from(bad)
