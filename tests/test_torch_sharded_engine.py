"""The sharded refresh through the port's engine and strategy
(``dispatch_solve(mesh=...)``, ``solve_plan(mesh=...)``,
``TorchPlacementStrategy(mesh=...)``) on meshes of "cpu" shards.

The reference's ``tests/test_jax_engine.py::TestShardedRefresh`` on the
port (the plan well formed and beside the reference's sharded plan, a
strategy on an explicit mesh refreshing and answering decisions, the
"auto" mesh, the indivisible mesh), and what the port adds: the blocks
built from the host columns equal the padded problem's, a sharded
dispatch equals the single-device one on both tiers, donation and the
incremental re-solve stay refused on a mesh, and the strategy keeps its
incremental path off there.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from modelmesh_tpu.parallel import mesh as jax_mesh
from modelmesh_tpu.placement import jax_engine as je
from modelmesh_tpu.placement.greedy import GreedyStrategy
from modelmesh_tpu.placement.strategy import ClusterView, PlacementRequest
from modelmesh_tpu.records import InstanceRecord, ModelRecord
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.parallel.sharded_solver import shard_problem
from modelmesh_tpu_torch.placement import torch_engine as te
from modelmesh_tpu_torch.placement.refresh_loop import PipelinedRefresher
from modelmesh_tpu_torch.placement.synthetic import synthetic_records


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    built = {shape: mesh_mod.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
             for shape in [(8, 1), (4, 2), (2, 4)]}
    yield built
    for m in built.values():
        m.close()


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """One ``now`` for every snapshot, so two snapshots of one fleet
    carry the same time-derived columns."""
    monkeypatch.setattr(te, "now_ms", lambda: 5_000_000)


def _models(n, loaded_on=None, size=64):
    """``tests/test_jax_engine.py``'s fleet helper."""
    out = []
    for i in range(n):
        mr = ModelRecord(model_type="t", size_units=size, last_used=1000)
        if loaded_on:
            mr.promote_loaded(loaded_on[i % len(loaded_on)], 1000)
        out.append((f"m{i}", mr))
    return out


def _instances(m, cap=10_000):
    return [
        (f"i{j}", InstanceRecord(capacity_units=cap, used_units=cap // 10,
                                 zone="ab"[j % 2], lru_ts=1_000))
        for j in range(m)
    ]


def _strategy(**kw):
    return te.TorchPlacementStrategy(fallback=GreedyStrategy(), **kw)


def _agree(a, b, ids) -> float:
    return float(np.mean([a.lookup(mid) == b.lookup(mid) for mid in ids]))


class TestShardedRefresh:
    def test_sharded_plan_structurally_valid(self, meshes):
        models = _models(512, loaded_on=["i0", "i2"])
        instances = _instances(8)
        plan = te.solve_plan(models, instances, mesh=meshes[(8, 1)])
        single = te.solve_plan(models, instances, device="cpu")
        assert plan.num_models() == single.num_models() == 512
        assert plan.stats["solver_path"] == "sharded"
        iids = {iid for iid, _ in instances}
        for mid, _ in models:
            targets = plan.lookup(mid)
            assert targets is not None and targets, mid
            assert set(targets) <= iids
            assert len(set(targets)) == len(targets)
        ids = [mid for mid, _ in models]
        # Whole rows per shard: the single-device plan.
        assert _agree(plan, single, ids) == 1.0
        ref = je.solve_plan(models, instances,
                            mesh=jax_mesh.make_mesh(
                                devices=jax.devices()[:8]))
        assert _agree(plan, ref, ids) >= 0.97

    def test_strategy_on_explicit_mesh_refreshes(self, meshes):
        strat = _strategy(mesh=meshes[(8, 1)])
        assert strat.mesh is meshes[(8, 1)]
        assert strat.device == torch.device("cpu")
        models = _models(256)
        instances = _instances(4)
        plan = strat.refresh(models, instances)
        assert plan.num_models() == 256
        assert plan.stats["solver_path"] == "sharded"
        req = PlacementRequest(
            model_id=models[0][0], model=models[0][1], required_units=64,
            requesting_instance="i-other",
        )
        assert strat.choose_load_target(
            req, ClusterView(instances=instances)) is not None
        # The warm carry threads through the mesh too.
        again = strat.refresh(models, instances)
        assert again.stats["warm"] is True and again.num_models() == 256

    def test_auto_mesh(self, monkeypatch):
        """"auto" is None without several CUDA devices, else the largest
        power-of-two set of them on the model axis."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert te.auto_mesh() is None
        assert _strategy(mesh="auto", device="cpu").mesh is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert te.auto_mesh() is None
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
        mesh = te.auto_mesh()
        assert mesh.shape == {"mdl": 4, "inst": 1}
        assert mesh.devices == [torch.device("cuda", i) for i in range(4)]

    def test_indivisible_mesh_rejected(self):
        mesh = mesh_mod.make_mesh(devices=["cpu"] * 3)
        try:
            with pytest.raises(ValueError, match="does not divide"):
                te.solve_plan(_models(64), _instances(4), mesh=mesh)
        finally:
            mesh.close()

    def test_donation_and_resolve_refused_on_mesh(self, meshes):
        cols = te.snapshot_columns(_models(64), _instances(4))
        mesh = meshes[(8, 1)]
        with pytest.raises(NotImplementedError, match="donation"):
            te.dispatch_solve(cols, mesh=mesh, donate=True)
        full = te.dispatch_solve(cols, device="cpu")
        base = te.SolveBase(full.sol.indices, full.sol.valid, full.sol.g,
                            full.sol.prices, full.sol.row_err, seed=0)
        with pytest.raises(ValueError, match="mesh=None"):
            te.dispatch_solve(cols, mesh=mesh, base=base, dirty_rows=[0])
        with pytest.raises(ValueError, match="first device"):
            te.dispatch_solve(cols, mesh=mesh, device="cuda:0")
        with pytest.raises(NotImplementedError, match="parallel.mesh.Mesh"):
            te.dispatch_solve(cols, mesh=jax_mesh.make_mesh(
                devices=jax.devices()[:8]))

    def test_incremental_path_off_on_mesh(self, meshes):
        """With a mesh every refresh is a full (sharded) solve, as the
        reference's strategy keeps the incremental path off there."""
        models = _models(256)
        instances = _instances(4)
        strat = _strategy(mesh=meshes[(8, 1)])
        strat.incr_max_dirty_frac = 0.5
        paths = [strat.refresh(models, instances,
                               incremental=True).stats["solver_path"]]
        for cycle in range(3):
            mid = models[cycle][0]
            models[cycle][1].last_used += 1
            strat.mark_dirty(models=[mid])
            plan = strat.refresh(models, instances, incremental=True)
            paths.append(plan.stats["solver_path"])
            assert plan.stats["delta_snapshot"] is True
        assert paths == ["sharded"] * 4

    def test_pipelined_refresher_dispatches_on_the_mesh(self, meshes):
        """The pipelined refresher runs a mesh strategy's full solves
        sharded, and freezes no incremental base."""
        models = _models(256)
        instances = _instances(4)
        strat = _strategy(mesh=meshes[(8, 1)])
        refresher = PipelinedRefresher(strat)
        assert refresher.submit(models, instances) is None
        models[0][1].last_used += 1
        strat.mark_dirty(models=[models[0][0]])
        first = refresher.submit(models, instances)
        last = refresher.drain()
        assert [p.stats["solver_path"] for p in (first, last)] == [
            "sharded", "sharded"]
        assert strat._base is None


class TestShardedDispatch:
    @pytest.fixture(scope="class")
    def sparse_cols(self):
        models, instances = synthetic_records(2000, 256)
        return te.snapshot_columns(models, instances)

    def test_blocks_equal_the_padded_problem(self, sparse_cols, meshes):
        """Each shard's block, built from the host columns, is the padded
        problem's block: no shard needed the full matrices."""
        whole = te._expand_problem_device(sparse_cols, "cpu")
        for mesh in meshes.values():
            built = te._expand_problem_blocks(sparse_cols, mesh)
            for got, want in zip(built, shard_problem(whole, mesh)):
                for f in dataclasses.fields(want):
                    assert torch.equal(getattr(got, f.name),
                                       getattr(want, f.name)), f.name

    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
    def test_sparse_dispatch_equals_single_device(self, sparse_cols, meshes,
                                                  shape):
        single = te.dispatch_solve(sparse_cols, seed=3, device="cpu")
        pending = te.dispatch_solve(sparse_cols, seed=3, mesh=meshes[shape])
        assert pending.path == "sharded-sparse"
        assert pending.topk == single.topk > 0
        assert torch.equal(pending.sol.indices, single.sol.indices)
        assert torch.equal(pending.sol.valid, single.sol.valid)
        plan = te.finalize_plan(pending)
        want = te.finalize_plan(single)
        assert _agree(plan, want, sparse_cols.model_ids) == 1.0
        assert plan.stats["sinkhorn_iters_run"] == want.stats[
            "sinkhorn_iters_run"]
        # Every shard reads every gate: 8 reads for each of the
        # single-device dispatch's, plus the one readback.
        assert plan.stats["host_syncs"] - 1 == 8 * (
            want.stats["host_syncs"] - 1)
        assert set(plan.warm_g) == set(sparse_cols.instance_ids)
        np.testing.assert_allclose(
            [plan.warm_g[i] for i in sparse_cols.instance_ids],
            [want.warm_g[i] for i in sparse_cols.instance_ids], atol=1e-5)

    def test_dense_pin_dispatch_equals_single_device(self, sparse_cols,
                                                     meshes, monkeypatch):
        monkeypatch.setenv("MM_SOLVER_SPARSE", "0")
        single = te.dispatch_solve(sparse_cols, seed=4, device="cpu")
        for shape in ((8, 1), (4, 2)):
            pending = te.dispatch_solve(sparse_cols, seed=4,
                                        mesh=meshes[shape])
            assert pending.path == "sharded" and pending.topk == 0
            same = (pending.sol.indices == single.sol.indices) | ~(
                single.sol.valid)
            agree = float(same.all(dim=1).float().mean())
            assert agree >= 0.99, (shape, agree)
            if shape == (8, 1):
                assert torch.equal(pending.sol.indices, single.sol.indices)

    def test_device_carry_on_mesh(self, sparse_cols, meshes):
        first = te.dispatch_solve(sparse_cols, seed=5, device="cpu")
        carry = (first.sol.g, first.sol.prices)
        single = te.dispatch_solve(sparse_cols, seed=6, carry=carry,
                                   device="cpu")
        pending = te.dispatch_solve(sparse_cols, seed=6, carry=carry,
                                    mesh=meshes[(4, 2)])
        assert pending.warm is True
        assert torch.equal(pending.sol.indices, single.sol.indices)
