"""The port's sharded solve (modelmesh_tpu_torch/parallel/sharded_solver.py)
and its mesh (parallel/mesh.py) on meshes of "cpu" shards.

Every case of tests/test_sharded_solver.py, on the port: the reference's
problem (``ops.random_problem(PRNGKey(42), 512, 32, capacity_slack=2.5)``)
carried across as numpy, solved by the port's sharded solver, held
against the port's single-device solve (bit for bit in indices and valid
where the reference pins it, at every mesh shape: the shards' column sums
on the CPU are added in another order, which moved no placement here) and
both against the reference's. Plus the mesh's own contract: a shard's
exception reaches the caller, a collective the others never reach times
out instead of hanging, an axis of size 1 makes every collective the
identity, and the worker threads outlive a solve.
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu import ops
from modelmesh_tpu.ops.solve import SolveConfig as JaxConfig
from modelmesh_tpu.parallel import mesh as jax_mesh
from modelmesh_tpu.parallel.sharded_solver import (
    make_sharded_solver as jax_make_sharded_solver,
)
from modelmesh_tpu.parallel.sharded_solver import (
    shard_problem as jax_shard_problem,
)
from modelmesh_tpu_torch import device as device_mod
from modelmesh_tpu_torch.carry import problem_from_numpy
from modelmesh_tpu_torch.ops import _build, costs, cuda_lse, cuda_sparse
from modelmesh_tpu_torch.ops.sinkhorn import sinkhorn
from modelmesh_tpu_torch.ops.solve import (
    MAX_COPIES,
    SolveConfig,
    SolveInit,
    solve_placement,
)
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.parallel import sharded_solver as ss
from modelmesh_tpu_torch.parallel.sharded_solver import (
    make_sharded_solver,
    shard_problem,
)

SHAPES = [(1, 1), (8, 1), (4, 2), (2, 4)]
SPARSE = dict(topk=16, sel_width=MAX_COPIES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jp():
    return ops.random_problem(jax.random.PRNGKey(42), 512, 32,
                              capacity_slack=2.5)


@pytest.fixture(scope="module")
def problem(jp):
    leaves = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    return problem_from_numpy(leaves, device="cpu")


@pytest.fixture(scope="module")
def meshes():
    """One mesh of "cpu" shards per shape, closed after the module."""
    built = {shape: mesh_mod.make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
             for shape in SHAPES}
    yield built
    for m in built.values():
        m.close()


def _jax_mesh(shape):
    n = shape[0] * shape[1]
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:n])


def _demand(p) -> float:
    return float((p.sizes * torch.clamp_max(p.copies, MAX_COPIES)).sum())


def _check_solution(p, sol, n_check=200):
    idx = sol.indices.numpy()
    valid = sol.valid.numpy()
    copies = torch.clamp_max(p.copies, MAX_COPIES).numpy()
    feas = p.feasible.numpy()
    for m in range(n_check):
        chosen = idx[m][valid[m]]
        assert len(chosen) == copies[m]
        assert len(set(chosen.tolist())) == len(chosen)
        assert feas[m][chosen].all()


def _agreement(a, b) -> float:
    """Rows whose valid slots and their instances are equal."""
    av, bv = np.asarray(a.valid), np.asarray(b.valid)
    ai, bi = np.asarray(a.indices), np.asarray(b.indices)
    same = (av == bv) & ((ai == bi) | ~av)
    return float(same.all(axis=1).mean())


def _same_plan(a, b) -> bool:
    return torch.equal(a.indices, b.indices) and torch.equal(a.valid, b.valid)


class TestShardedSolver:
    def test_1d_model_sharding(self, problem, jp, meshes):
        sol = make_sharded_solver(meshes[(8, 1)])(
            shard_problem(problem, meshes[(8, 1)]))
        _check_solution(problem, sol)
        assert float(sol.row_err) < 0.2
        assert float(sol.overflow) < 0.05 * _demand(problem)
        ref = jax_make_sharded_solver(_jax_mesh((8, 1)))(
            jax_shard_problem(jp, _jax_mesh((8, 1))))
        assert _agreement(sol, ref) >= 0.97

    def test_2d_sharding(self, problem, jp, meshes):
        sol = make_sharded_solver(meshes[(4, 2)])(
            shard_problem(problem, meshes[(4, 2)]))
        _check_solution(problem, sol)
        assert float(sol.overflow) < 0.05 * _demand(problem)
        ref = jax_make_sharded_solver(_jax_mesh((4, 2)))(
            jax_shard_problem(jp, _jax_mesh((4, 2))))
        assert _agreement(sol, ref) >= 0.97

    def test_soft_pipeline_parity_with_single_device(self, problem, jp,
                                                     meshes):
        """The sharded cost block and dense Sinkhorn stay in lockstep with
        the single-device ones: C equal to the port's, f and g within 1e-5
        of the reference's single-device Sinkhorn."""
        from modelmesh_tpu.ops.sinkhorn import sinkhorn as jax_sinkhorn

        mesh = meshes[(4, 2)]
        copies = jnp.minimum(jp.copies, ops.MAX_COPIES)
        sk = jax_sinkhorn(ops.assemble_cost(jp), jp.sizes * copies,
                          jnp.maximum(jp.capacity - jp.reserved, 0.0),
                          eps=0.05, iters=10)

        def kern(prob):
            Cb = ss._cost_block(prob, costs.CostWeights(), torch.float32)
            cps = torch.clamp_max(prob.copies, MAX_COPIES)
            res = ss._sharded_sinkhorn(
                ss._cost_block(prob, costs.CostWeights(), torch.bfloat16),
                prob.sizes * cps.to(torch.float32),
                torch.clamp_min(prob.capacity - prob.reserved, 0.0),
                0.05, 10,
            )
            return Cb, res.f, res.g

        outs = mesh_mod.shard_map(kern, mesh)(shard_problem(problem, mesh))
        C_sh = torch.cat([
            torch.cat([outs[mesh.rank_of(i, j)][0] for j in range(2)], 1)
            for i in range(4)
        ])
        f_sh = torch.cat([outs[mesh.rank_of(i, 0)][1] for i in range(4)])
        g_sh = torch.cat([outs[mesh.rank_of(0, j)][2] for j in range(2)])
        # Equal to the port's single-device cost bit for bit; to the
        # reference's at test_torch_costs.py's f32 tolerance (XLA fuses
        # the terms' sum in another order, an ulp apart on a few entries).
        assert torch.equal(C_sh, costs.assemble_cost(problem,
                                                     dtype=torch.float32))
        C_ref = np.asarray(ops.assemble_cost(jp, dtype=jnp.float32))
        np.testing.assert_allclose(C_sh.numpy(), C_ref, rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(sk.f), f_sh.numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sk.g), g_sh.numpy(), atol=1e-5)

    def test_gated_sinkhorn_parity_with_single_device(self, problem, jp,
                                                      meshes):
        """The gated path too: a converged carry exits after the one-step
        warm probe, as the single-device Sinkhorns (port and reference)
        do, with matching potentials."""
        from modelmesh_tpu.ops.sinkhorn import sinkhorn as jax_sinkhorn

        copies = jnp.minimum(jp.copies, ops.MAX_COPIES)
        jmarg = (jp.sizes * copies, jnp.maximum(jp.capacity - jp.reserved,
                                                0.0))
        cold = jax_sinkhorn(ops.assemble_cost(jp), *jmarg, eps=0.05,
                            iters=10, tol=0.02, chunk=4)
        warm = jax_sinkhorn(ops.assemble_cost(jp), *jmarg, eps=0.05,
                            iters=10, tol=0.02, chunk=4, g0=cold.g)
        assert int(warm.iters_run) == 1
        g0 = torch.from_numpy(np.array(cold.g))
        pcost = costs.assemble_cost(problem)
        pc = torch.clamp_max(problem.copies, MAX_COPIES).to(torch.float32)
        pfree = torch.clamp_min(problem.capacity - problem.reserved, 0.0)
        single = sinkhorn(pcost, problem.sizes * pc, pfree, eps=0.05,
                          iters=10, tol=0.02, chunk=4, g0=g0)

        mesh = meshes[(4, 2)]

        def kern(prob, g0_blk):
            cps = torch.clamp_max(prob.copies, MAX_COPIES)
            return ss._sharded_sinkhorn(
                ss._cost_block(prob, costs.CostWeights(), torch.bfloat16),
                prob.sizes * cps.to(torch.float32),
                torch.clamp_min(prob.capacity - prob.reserved, 0.0),
                0.05, 10, g0=g0_blk, tol=0.02, chunk=4,
            )

        g0_blocks = [mesh.block(r, g0, (mesh_mod.INSTANCE_AXIS,))
                     for r in range(mesh.size)]
        outs = mesh_mod.shard_map(kern, mesh)(shard_problem(problem, mesh),
                                              g0_blocks)
        assert {o.iters_run for o in outs} == {1} == {single.iters_run}
        f_sh = torch.cat([outs[mesh.rank_of(i, 0)].f for i in range(4)])
        g_sh = torch.cat([outs[mesh.rank_of(0, j)].g for j in range(2)])
        np.testing.assert_allclose(np.asarray(warm.f), f_sh.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(warm.g), g_sh.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(single.f.numpy(), f_sh.numpy(), atol=1e-5)

    def test_quality_parity_with_single_device(self, problem, jp, meshes):
        single = solve_placement(problem)
        mesh = meshes[(4, 2)]
        sharded = make_sharded_solver(mesh)(shard_problem(problem, mesh))
        ref = ops.solve_placement(jp)
        total_s = float(single.load.sum())
        np.testing.assert_allclose(total_s, float(sharded.load.sum()),
                                   rtol=1e-5)
        np.testing.assert_allclose(total_s, float(np.asarray(ref.load).sum()),
                                   rtol=1e-5)
        demand = _demand(problem)
        assert float(single.overflow) < 0.05 * demand
        assert float(sharded.overflow) < 0.05 * demand

    def test_new_seed_changes_plan_and_reuses_mesh_threads(self, problem,
                                                           meshes):
        """The reference's seed-without-retrace case: here a new seed
        changes the plan and runs on the same worker threads."""
        mesh = meshes[(8, 1)]
        solver = make_sharded_solver(mesh)
        shards = shard_problem(problem, mesh)
        a = solver(shards, seed=1)
        threads = mesh.threads()
        b = solver(shards, seed=2)
        assert not torch.equal(a.indices, b.indices)
        assert mesh.threads() == threads and len(set(threads)) == mesh.size
        assert all(t.is_alive() for t in mesh._threads)

    def test_load_accounting_matches(self, problem, meshes):
        mesh = meshes[(8, 1)]
        sol = make_sharded_solver(mesh)(shard_problem(problem, mesh))
        idx, valid = sol.indices.numpy(), sol.valid.numpy()
        sizes = problem.sizes.numpy()
        load = np.zeros(problem.num_instances, np.float64)
        for m in range(problem.num_models):
            for k in range(MAX_COPIES):
                if valid[m, k]:
                    load[idx[m, k]] += sizes[m]
        np.testing.assert_allclose(load, sol.load.numpy(), rtol=1e-4)


class TestSingleDeviceMeshParity:
    """On a 1x1 mesh every collective is the identity, so the sharded
    solve is the single-device one bit for bit."""

    def test_dense_bitwise_parity(self, problem, jp, meshes):
        mesh = meshes[(1, 1)]
        single = solve_placement(problem, seed=5)
        sharded = make_sharded_solver(mesh)(shard_problem(problem, mesh),
                                            seed=5)
        assert _same_plan(single, sharded)
        for field in ("load", "f", "g", "prices", "overflow"):
            assert torch.equal(getattr(single, field),
                               getattr(sharded, field)), field
        ref = ops.solve_placement(jp, seed=5)
        assert _agreement(sharded, ref) >= 0.97
        np.testing.assert_allclose(np.asarray(ref.g), sharded.g.numpy(),
                                   atol=1e-3)

    def test_dense_warm_start_bitwise_parity(self, problem, meshes):
        mesh = meshes[(1, 1)]
        cold = solve_placement(problem, seed=5)
        single = solve_placement(problem, seed=6, init=SolveInit(
            g0=cold.g, price0=cold.prices))
        sharded = make_sharded_solver(mesh)(
            shard_problem(problem, mesh), seed=6, g0=cold.g,
            price0=cold.prices,
        )
        assert _same_plan(single, sharded)

    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
    def test_dense_multi_shard_parity(self, problem, meshes, shape):
        """Whole rows per shard (8x1): the placement bit for bit; with
        columns split the row LSE combines over ``inst`` in another
        order, and the placement held equal here too."""
        mesh = meshes[shape]
        single = solve_placement(problem, seed=5)
        sharded = make_sharded_solver(mesh)(shard_problem(problem, mesh),
                                            seed=5)
        assert _same_plan(single, sharded), shape
        np.testing.assert_allclose(single.g.numpy(), sharded.g.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(single.load.numpy(), sharded.load.numpy(),
                                   atol=1e-3)


class TestSparseShardedParity:
    """The sparse pipeline on the mesh: each shard's gather sees global
    column ids and the single-device draw of its rows, so the candidate
    sets, and the whole solve, match on every mesh shape."""

    def test_bitwise_parity_1x1(self, problem, jp, meshes):
        cfg = SolveConfig(**SPARSE)
        mesh = meshes[(1, 1)]
        single = solve_placement(problem, cfg, seed=9)
        sharded = make_sharded_solver(mesh, cfg)(
            shard_problem(problem, mesh), seed=9)
        assert _same_plan(single, sharded)
        assert torch.equal(single.overflow, sharded.overflow)
        ref = ops.solve_placement(jp, JaxConfig(topk=16,
                                                sel_width=ops.MAX_COPIES),
                                  seed=9)
        assert _agreement(sharded, ref) >= 0.97

    @pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
    def test_bitwise_parity_multi_device(self, problem, jp, meshes, shape):
        cfg = SolveConfig(**SPARSE)
        mesh = meshes[shape]
        single = solve_placement(problem, cfg, seed=9)
        sharded = make_sharded_solver(mesh, cfg)(
            shard_problem(problem, mesh), seed=9)
        assert _same_plan(single, sharded), shape
        np.testing.assert_allclose(single.load.numpy(), sharded.load.numpy(),
                                   atol=1e-3)
        np.testing.assert_allclose(single.g.numpy(), sharded.g.numpy(),
                                   atol=1e-5)
        ref_mesh = _jax_mesh(shape)
        ref = jax_make_sharded_solver(
            ref_mesh, JaxConfig(topk=16, sel_width=ops.MAX_COPIES))(
            jax_shard_problem(jp, ref_mesh), seed=9)
        assert _agreement(sharded, ref) >= 0.97

    def test_topk_covering_full_width_routes_dense(self, problem, meshes):
        """topk = the global width runs the dense kernel, bit for bit the
        default-config single-device dense solve."""
        cfg = SolveConfig(topk=problem.num_instances)
        mesh = meshes[(4, 2)]
        dense = solve_placement(problem, seed=9)
        sharded = make_sharded_solver(mesh, cfg)(
            shard_problem(problem, mesh), seed=9)
        assert _same_plan(dense, sharded)

    def test_full_width_topk_accepts_dense_only_knobs(self, problem, meshes):
        cfg = SolveConfig(topk=problem.num_instances, noise_impl="threefry")
        solve_placement(problem, cfg, seed=3)  # accepted off the mesh
        mesh = meshes[(4, 2)]
        sol = make_sharded_solver(mesh, cfg)(shard_problem(problem, mesh),
                                             seed=3)
        _check_solution(problem, sol)

    def test_narrow_topk_with_threefry_rejected_at_solve(self, problem,
                                                         meshes):
        cfg = SolveConfig(topk=8, noise_impl="threefry")
        mesh = meshes[(4, 2)]
        solver = make_sharded_solver(mesh, cfg)  # builds fine
        with pytest.raises(ValueError, match="hash"):
            solver(shard_problem(problem, mesh), seed=3)

    def test_sparse_solution_well_formed_on_mesh(self, problem, meshes):
        cfg = SolveConfig(**SPARSE)
        mesh = meshes[(4, 2)]
        sol = make_sharded_solver(mesh, cfg)(shard_problem(problem, mesh),
                                             seed=2)
        _check_solution(problem, sol)
        assert float(sol.overflow) < 0.05 * _demand(problem)

    def test_gated_sparse_parity(self, problem, meshes):
        """The sparse tier's gates (the dispatch layer's tier defaults):
        probe, chunk and stall reads on every shard, the same branches."""
        cfg = SolveConfig(**SPARSE, sinkhorn_tol=0.02, auction_iters=8,
                          auction_stall_tol=1e-3)
        single = solve_placement(problem, cfg, seed=4)
        for shape in ((8, 1), (2, 4)):
            mesh = meshes[shape]
            sharded = make_sharded_solver(mesh, cfg)(
                shard_problem(problem, mesh), seed=4)
            assert _same_plan(single, sharded), shape
            assert sharded.sinkhorn_iters_run == single.sinkhorn_iters_run
            assert sharded.auction_iters_run == single.auction_iters_run


class TestMesh:
    def test_make_mesh_shapes_and_layout(self):
        mesh = mesh_mod.make_mesh((4, 2), ["cpu"] * 8)
        assert mesh.shape == {"mdl": 4, "inst": 2} and mesh.size == 8
        assert mesh.coords(5) == (2, 1) and mesh.rank_of(2, 1) == 5
        assert mesh.block_range(5, "mdl", 512) == (256, 384)
        assert mesh.block_range(5, "inst", 32) == (16, 32)
        with pytest.raises(ValueError, match="does not divide"):
            mesh.block_range(0, "mdl", 510)
        with pytest.raises(ValueError, match="does not hold"):
            mesh_mod.make_mesh((3, 2), ["cpu"] * 8)
        assert mesh_mod.make_mesh(devices=["cpu"] * 4).shape == {
            "mdl": 4, "inst": 1}
        assert set(mesh_mod.PROBLEM_LAYOUT) == set(
            costs.PlacementProblem.__dataclass_fields__)

    def test_default_devices_without_cuda_raise(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()

    def test_shard_problem_blocks(self, problem, meshes):
        mesh = meshes[(2, 4)]
        blocks = shard_problem(problem, mesh)
        assert len(blocks) == 8
        b = blocks[mesh.rank_of(1, 3)]
        assert torch.equal(b.sizes, problem.sizes[256:])
        assert torch.equal(b.capacity, problem.capacity[24:])
        assert torch.equal(b.feasible, problem.feasible[256:, 24:])
        with pytest.raises(ValueError, match="does not divide"):
            shard_problem(problem, mesh_mod.make_mesh((3, 1), ["cpu"] * 3))

    def test_collectives(self, meshes):
        mesh = meshes[(4, 2)]

        def fn():
            i = mesh_mod.axis_index("mdl")
            j = mesh_mod.axis_index("inst")
            x = torch.tensor([float(10 * i + j)])
            return (mesh_mod.psum(x, "mdl"), mesh_mod.pmax(x, "inst"),
                    mesh_mod.pmin(x, "mdl"),
                    mesh_mod.all_gather(x, "inst"),
                    mesh_mod.all_gather(x, "mdl", tiled=False),
                    mesh_mod.axis_size("inst"))

        outs = mesh_mod.shard_map(fn, mesh)()
        for rank, (s, mx, mn, gi, gm, ni) in enumerate(outs):
            i, j = mesh.coords(rank)
            assert float(s) == 60 + 4 * j
            assert float(mx) == 10 * i + 1 and float(mn) == j
            assert gi.tolist() == [10 * i, 10 * i + 1]
            assert gm.shape == (4, 1) and gm[:, 0].tolist() == [
                10 * k + j for k in range(4)]
            assert ni == 2

    def test_axis_of_size_one_is_identity(self, meshes):
        mesh = meshes[(8, 1)]

        def fn(x):
            got = [mesh_mod.psum(x, "inst"), mesh_mod.pmax(x, "inst"),
                   mesh_mod.pmin(x, "inst"), mesh_mod.all_gather(x, "inst")]
            summed = mesh_mod.AxisSum("inst")
            got.append(summed(x))
            got.append(summed.combine(lambda p: p, x))
            return all(t is x for t in got)

        xs = [torch.arange(3.0) + r for r in range(8)]
        assert mesh_mod.shard_map(fn, mesh)(xs) == [True] * 8

    def test_axis_sum_combine_gathers_in_rank_order(self, meshes):
        mesh = meshes[(4, 2)]

        def fn():
            i = mesh_mod.axis_index("mdl")
            part = torch.full((2, 3), float(i))
            return mesh_mod.AxisSum("mdl").combine(lambda p: p, part)

        for out in mesh_mod.shard_map(fn, mesh)():
            assert out[:, 0].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]

    def test_shard_exception_reaches_caller(self, meshes):
        mesh = meshes[(8, 1)]

        def fn():
            if mesh_mod.axis_index("mdl") == 3:
                raise KeyError("shard 3 failed")
            return mesh_mod.psum(torch.ones(1), "mdl")

        with pytest.raises(KeyError, match="shard 3 failed"):
            mesh_mod.shard_map(fn, mesh)()
        # The mesh is usable again.
        outs = mesh_mod.shard_map(
            lambda: mesh_mod.psum(torch.ones(1), "mdl"), mesh)()
        assert [float(o) for o in outs] == [8.0] * 8

    def test_skipped_collective_times_out(self, monkeypatch):
        monkeypatch.setattr(mesh_mod, "COLLECTIVE_TIMEOUT_S", 0.5)
        mesh = mesh_mod.make_mesh((4, 1), ["cpu"] * 4)
        threads = []
        try:
            def fn():
                if mesh_mod.axis_index("mdl") == 0:
                    return None
                return mesh_mod.psum(torch.ones(1), "mdl")

            t0 = time.monotonic()
            with pytest.raises(TimeoutError, match="collective"):
                mesh_mod.shard_map(fn, mesh)()
            assert time.monotonic() - t0 < 30
            threads = list(mesh._threads)
        finally:
            mesh.close()
        assert len(threads) == 4 and not any(t.is_alive() for t in threads)

    def test_collective_outside_shard_raises(self):
        with pytest.raises(RuntimeError, match="outside shard_map"):
            mesh_mod.psum(torch.ones(1), "mdl")

    def test_sharded_argument_count_checked(self, meshes):
        with pytest.raises(ValueError, match="entries for 8 shards"):
            mesh_mod.shard_map(lambda x: x, meshes[(8, 1)])([1, 2])

    def test_counts_are_thread_safe(self):
        """Launch and host-sync counts from many threads, with a short
        switch interval: no update is lost."""
        table = {"k": 0}
        syncs0 = device_mod.host_syncs
        one = torch.ones(())
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def work():
                for _ in range(500):
                    _build.count_launch(table, "k")
                    device_mod.item(one)

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(interval)
        assert table["k"] == 16 * 500
        assert device_mod.host_syncs - syncs0 == 16 * 500


class TestColumnSumHooks:
    """The kernel wrappers' ``col_psum`` on CPU tensors: each shard's plain
    column sums combined over the model axis; with no hook, nothing
    changes."""

    def test_column_products_sum_over_shards(self, meshes):
        gen = torch.Generator().manual_seed(3)
        C = (torch.rand((64, 40), generator=gen) * 4).to(torch.bfloat16)
        sel = cuda_sparse.select_candidates(
            C, cuda_sparse.noise_row_state(64, 7, "cpu"), 8, tau=0.5,
            noised=True)
        v = torch.rand(40, generator=gen)
        mass = torch.rand(64, generator=gen) + 0.5
        r_all, c_all = cuda_sparse.masked_sinkhorn_step(
            C, sel.bits, sel.rowmin, v, mass, eps=0.05)
        u = torch.rand(64, generator=gen)
        col_all = cuda_sparse.masked_col_matvec(C, sel.bits, sel.rowmin, u,
                                                eps=0.05)
        m_all, s_all = cuda_lse.col_lse_partial(C, u, 0.05)
        mesh = meshes[(4, 2)]
        total = mesh_mod.AxisSum("mdl")

        def fn():
            i = mesh_mod.axis_index("mdl")
            rows = slice(16 * i, 16 * (i + 1))
            bits = sel.bits[rows].contiguous()
            r, c = cuda_sparse.masked_sinkhorn_step(
                C[rows], bits, sel.rowmin[rows], v, mass[rows], eps=0.05,
                col_psum=total)
            col = cuda_sparse.masked_col_matvec(
                C[rows], bits, sel.rowmin[rows], u[rows], eps=0.05,
                col_psum=total)
            pair = cuda_lse.col_lse_partial(C[rows], u[rows], 0.05,
                                            col_psum=total)
            return r, c, col, pair

        for rank, (r, c, col, (m, s)) in enumerate(
                mesh_mod.shard_map(fn, mesh)()):
            i = mesh.coords(rank)[0]
            assert torch.equal(r, r_all[16 * i:16 * (i + 1)])
            torch.testing.assert_close(c, c_all, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(col, col_all, rtol=1e-5, atol=1e-6)
            assert torch.equal(m, m_all)
            torch.testing.assert_close(cuda_lse.lse_of(m, s),
                                       cuda_lse.lse_of(m_all, s_all),
                                       rtol=1e-5, atol=1e-5)

    def test_row_offset_draws_the_rows_of_the_whole_problem(self):
        gen = torch.Generator().manual_seed(5)
        C = (torch.rand((96, 48), generator=gen) * 4).to(torch.bfloat16)
        feas = torch.ones((96, 48), dtype=torch.bool)
        from modelmesh_tpu_torch.ops import sparse

        whole = sparse.topk_candidates(C, feas, 6, seed=11)
        block = sparse.topk_candidates(C[32:64], feas[32:64], 6, seed=11,
                                       row_offset=32)
        assert torch.equal(block[1], whole[1][32:64])
        assert torch.equal(block[3].bits, whole[3].bits[32:64])
        logits = torch.rand((96, 6), generator=gen)
        full = sparse.perturb_gathered(logits, whole[1], whole[2], 1.0, 11)
        part = sparse.perturb_gathered(logits[32:64], block[1], block[2],
                                       1.0, 11, row_offset=32)
        assert torch.equal(part, full[32:64])
        assert torch.equal(
            cuda_sparse.noise_row_state(96, 11, "cpu", 0),
            cuda_sparse.noise_row_state(96, 11, "cpu"))
