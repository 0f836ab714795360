"""The top-K tier: the reference against the port's plain versions, step
by step; whole runs of the harness on a top-K configuration that no cell
names (``configs/topk-100k-1k.json`` at 2,048 models x 256 pods, K 24,
its gates on): the sound program comes out correct, on one device and on
a two-shard mesh; the reference in the program's place too; the control
and each planted fault do not."""

import numpy as np
import pytest
import torch

from mmbench import harness
from mmbench import reference as ref
from mmbench.stand_in import StandIn
from mmbench.traffic import Fleet
from mmbench_runs import (
    TOPK,
    TOPK_SCALE,
    NoPriceSteps,
    dropped_partial,
    early_gate,
    topk_run,
    wider_gather,
    wrapped,
)

SEEDS = [2**31 + 3, 77, 4052739537]


def stand_in(dtype):
    def make(fleet, solver, clock, device):
        return StandIn(fleet, solver, clock, device, dtype=dtype)

    return make


def problem(seed):
    """The port's padded problem and the reference's columns of one
    fleet after a tick."""
    from modelmesh_tpu_torch.placement import torch_engine as te
    from modelmesh_tpu_torch.records import InstanceRecord, ModelRecord

    _, _, cfg, traffic = harness.load(harness.PKG.parent,
                                      "full-100k-1k.rebalance", TOPK)
    cfg = dict(cfg, models=TOPK_SCALE[0], pods=TOPK_SCALE[1])
    fleet = Fleet(cfg, traffic, seed, records=(ModelRecord, InstanceRecord))
    now = harness.EPOCH_MS + 250
    fleet.tick(now)
    clock, clock_mod = harness.make_clock()
    clock.t = now
    previous = clock_mod.install(clock)
    try:
        cols = te.snapshot_columns(fleet.models, fleet.instances, fleet.rpm)
    finally:
        clock_mod.install(previous)
    return (te._expand_problem_device(cols, "cpu"),
            ref.columns(fleet.state, now), ref.solver_from(cfg))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_reference_agrees_with_the_port_step_by_step(seed):
    from modelmesh_tpu_torch.ops import costs, cuda_sparse, sparse

    p, cols, s = problem(seed)
    n, m = len(cols.sizes), len(cols.capacity)
    noise = seed % 1000
    C = costs.assemble_cost(p)
    assert torch.equal(C.float()[:n, :m], ref.cost(cols, "cpu"))
    cost_k, idx_k, feas_k, fused = sparse.topk_candidates(
        C, p.feasible, s.topk, seed=noise)
    cand = ref.candidates(cols, s, noise, "cpu", block_rows=300)
    assert torch.equal(cand.idx[:, :s.topk], idx_k[:n])
    mask = torch.zeros(n, m, dtype=torch.bool)
    rows = torch.arange(n)[:, None].expand_as(cand.idx)
    mask[rows[cand.member], cand.idx[cand.member]] = True
    assert torch.equal(cuda_sparse.unpack_mask(fused.bits, C.shape[1])
                       [:n, :m], mask)

    copies = torch.clamp_max(p.copies, ref.MAX_COPIES)
    free = torch.clamp_min(p.capacity - p.reserved, 0.0)
    rng = np.random.default_rng(seed)
    for g0 in (None, -0.01 * rng.random(C.shape[1]).astype(np.float32)):
        g0_t = None if g0 is None else torch.from_numpy(g0)
        sk = sparse.sparse_sinkhorn(
            C, fused, p.sizes * copies.float(), free, eps=s.eps,
            iters=s.sinkhorn_iters, g0=g0_t, tol=s.sinkhorn_tol,
            chunk=s.sinkhorn_chunk)
        tr, gates = ref.transport_topk(cand, cols, s,
                                       None if g0 is None else g0[:m])
        assert gates.run == sk.iters_run
        assert float((sk.g[:m].double() - tr.g).abs().max()) < 1e-4 * s.eps
        logits = ((sk.f[:, None] + sk.g[idx_k] - cost_k.float())
                  / s.eps).to(torch.bfloat16)
        scores = sparse.perturb_gathered(logits, idx_k, feas_k, s.tau, noise)
        for price0 in (None, 0.3 * rng.random(C.shape[1]).astype(
                np.float32)):
            res = sparse.sparse_auction(
                scores, idx_k, p.sizes, copies, free, iters=s.auction_iters,
                eta=s.eta, stall_tol=s.auction_stall_tol,
                price0=None if price0 is None else torch.from_numpy(price0),
                sel_k=s.sel_width)
            mine = ref.auction_topk(scores[:n], idx_k[:n], cols, s,
                                    None if price0 is None else price0[:m])
            assert mine.gates.run == res.iters_run
            assert torch.equal(mine.price, res.prices[:m])
            assert torch.equal(mine.idx[mine.valid],
                               res.indices[:n][res.valid[:n]])
            assert mine.overflow == float(res.overflow)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sound_program_is_correct(seed):
    res = topk_run(seed)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) >= {"cand_misses", "gate_gap"}
    assert res["checks"]["cand_misses"]["value"] == 0


def test_sound_program_on_a_two_shard_mesh_is_correct():
    res = topk_run(chips=2)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2


def test_reference_in_place_is_correct():
    res = topk_run(sut=stand_in(torch.bfloat16))
    assert res["correct"], res["checks"]
    for name in ("assign_gap", "price_gap", "cand_misses", "gate_gap"):
        assert res["checks"][name]["value"] == 0, name


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed):
    res = topk_run(seed, sut=stand_in(torch.float8_e4m3fn))
    assert not res["correct"], res["checks"]
    got = res["checks"]["cand_misses"]
    assert got["value"] > got["limit"]


@pytest.mark.parametrize("fault, number", [
    (wider_gather, "cand_misses"),
    (early_gate, "gate_gap"),
], ids=["candidate_past_the_kth_key", "gate_one_chunk_early"])
def test_planted_fault_is_not_correct(fault, number):
    with fault():
        res = topk_run()
    assert not res["correct"], res["checks"]
    got = res["checks"][number]
    assert got["value"] > got["limit"], res["checks"]


def test_skipped_price_steps_are_not_correct():
    res = topk_run(sut=wrapped(NoPriceSteps, TOPK))
    assert not res["correct"], res["checks"]
    got = res["checks"]["price_gap"]
    assert got["value"] > got["limit"], res["checks"]


def test_dropped_partial_on_a_two_shard_mesh_is_not_correct():
    with dropped_partial():
        res = topk_run(chips=2)
    assert not res["correct"], res["checks"]
    got = res["checks"]["g_gap"]
    assert got["value"] > got["limit"], res["checks"]
