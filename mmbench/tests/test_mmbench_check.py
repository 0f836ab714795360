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
    cfg = {"pods": 150,
           "solver": {"eps": 0.05, "sinkhorn_iters": 10, "sinkhorn_tol": 0.0,
                      "sinkhorn_chunk": 4, "auction_iters": 40,
                      "auction_stall_tol": 0.0, "eta": 0.5, "tau": 1.0,
                      "topk": 0, "sel_width": 8}}
    assert ref.solver_from(cfg) == SOLVER
    # The dense tier with a gate, or fewer slots than MAX_COPIES.
    for key, value in (("sinkhorn_tol", 0.02), ("auction_stall_tol", 1e-3),
                       ("sel_width", 2)):
        bad = {"solver": dict(cfg["solver"], **{key: value})}
        with pytest.raises(ValueError):
            ref.solver_from(bad)
    # The top-K tier with its gates is taken; one as wide as the pods,
    # with slots outside 1..MAX_COPIES or a negative tolerance is not.
    topk = dict(cfg["solver"], topk=24, sinkhorn_tol=0.02,
                auction_stall_tol=1e-3, auction_iters=8, sel_width=2)
    got = ref.solver_from({"pods": 150, "solver": topk})
    assert (got.topk, got.sel_width, got.sinkhorn_tol, got.sinkhorn_chunk,
            got.auction_stall_tol) == (24, 2, 0.02, 4, 1e-3)
    for key, value in (("topk", 150), ("topk", -1), ("sel_width", 0),
                       ("sel_width", 9), ("sinkhorn_tol", -0.1),
                       ("auction_stall_tol", -1.0)):
        bad = {"pods": 150, "solver": dict(topk, **{key: value})}
        with pytest.raises(ValueError):
            ref.solver_from(bad)


TOPK_SOLVER = SOLVER._replace(topk=24, sel_width=2, sinkhorn_tol=0.02,
                              sinkhorn_chunk=4, auction_iters=8,
                              auction_stall_tol=1e-3)
THR = 0.02 * 0.05            # the Sinkhorn probe's threshold, tol * eps


@pytest.mark.parametrize("gates, reported, want", [
    # The probe stopped the loop: its move of g has to be under tol * eps.
    (ref.Gates((0.5 * THR,), [], 1), 1, 0.0),
    (ref.Gates((3.0 * THR,), [], 1), 1, 2.0),
    # One chunk ran: the probe has to have failed and the chunk held.
    (ref.Gates((2.0 * THR,), [0.01], 5), 5, 0.0),
    (ref.Gates((0.5 * THR,), [0.01], 5), 5, 0.5),
    (ref.Gates((2.0 * THR,), [0.03], 5), 5, 0.5),
    # The budget (three chunks) ended the loop: the last need not hold,
    # each before it must have failed.
    (ref.Gates((2.0 * THR,), [0.04, 0.03, 0.025], 13), 13, 0.0),
    (ref.Gates((2.0 * THR,), [0.04, 0.01, 0.025], 13), 13, 0.5),
    # A count the gate cannot give, or none reported.
    (ref.Gates((2.0 * THR,), [0.04, 0.03, 0.025], 13), 9, float("inf")),
    (ref.Gates((2.0 * THR,), [0.01], 5), None, float("inf")),
])
def test_sinkhorn_gate_gap(gates, reported, want):
    got = check.sinkhorn_gate_gap(TOPK_SOLVER, gates, reported)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("gates, reported, want", [
    # The probe held by its price move, or by its overflow.
    (ref.Gates((5e-4, 500.0, 100.0), [], 1), 1, 0.0),
    (ref.Gates((5e-3, 50.0, 100.0), [], 1), 1, 0.0),
    (ref.Gates((5e-3, 300.0, 100.0), [], 1), 1, 2.0),
    # A round ran (the budget's one): the probe has to have failed.
    (ref.Gates((5e-3, 300.0, 100.0), [(1e-2, 10.0, 290.0)], 9), 9, 0.0),
    (ref.Gates((5e-3, 80.0, 100.0), [(1e-2, 10.0, 290.0)], 9), 9, 0.2),
    (ref.Gates((5e-3, 300.0, 100.0), [(1e-2, 10.0, 290.0)], 9), 1,
     float("inf")),
])
def test_auction_gate_gap(gates, reported, want):
    got = check.auction_gate_gap(TOPK_SOLVER, gates, reported)
    assert got == pytest.approx(want)


def test_auction_gate_gap_over_several_rounds():
    s = TOPK_SOLVER._replace(auction_iters=24)     # three rounds at most
    probe = (5e-3, 300.0, 100.0)
    # Stopped after round 2: round 1 must not have stalled, round 2 must.
    stalled = ref.Gates(probe, [(1e-2, 10.0, 290.0), (5e-4, 5.0, 5.0)], 17)
    assert check.auction_gate_gap(s, stalled, 17) == 0.0
    early = ref.Gates(probe, [(5e-4, 10.0, 290.0), (5e-4, 5.0, 5.0)], 17)
    assert check.auction_gate_gap(s, early, 17) == pytest.approx(0.5)
    late = ref.Gates(probe, [(1e-2, 10.0, 290.0), (1e-2, 5.0, 200.0)], 17)
    assert check.auction_gate_gap(s, late, 17) == pytest.approx(1.0)
    # A best overflow of 0 stalls a round.
    zero = ref.Gates(probe, [(1e-2, 0.0, 290.0)], 9)
    assert check.auction_gate_gap(s, zero, 9) == 0.0


def test_gates_off_read_nothing_but_the_count():
    assert check.sinkhorn_gate_gap(SOLVER, ref.Gates((), [], 10), 10) == 0.0
    assert check.auction_gate_gap(SOLVER, ref.Gates((), [], 40), 40) == 0.0
    assert check.sinkhorn_gate_gap(SOLVER, ref.Gates((), [], 10), 9) == (
        float("inf"))


def test_numbers_of_each_tier():
    assert check.numbers(SOLVER) == check.NUMBERS
    assert check.numbers(TOPK_SOLVER) == check.NUMBERS + ("cand_misses",
                                                          "gate_gap")
