"""The port's mesh collectives (``modelmesh_tpu_torch/parallel/mesh.py``)
against ``jax.lax``'s, and the mesh's named axes.

- ``all_to_all`` on 2, 4 and 8 shards, tiled and not, over several split
  and concat axes, and ``ppermute`` (a ring shift, a partial permutation
  whose unnamed receivers get zeros) against the reference's
  ``shard_map`` of ``jax.lax.all_to_all`` / ``jax.lax.ppermute`` on the
  8 virtual CPU devices: integers, compared bit for bit.
- A shard that raises, or one that skips a collective, reaches the
  caller (the first exception; a timeout), and the mesh runs again.
- The solver's (mdl, inst) grid: ``coords``, ``rank_of`` and the axis
  groups as before the axes were named; 1-D meshes on named axes; the
  per-mesh collective counts; one cached mesh per axis and device list.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from modelmesh_tpu.parallel.mesh import shard_map as jax_shard_map
from modelmesh_tpu_torch.parallel import mesh as mesh_mod

AXIS = "x"
A2A_CASES = [  # (split_axis, concat_axis, tiled)
    (0, 0, False), (0, 1, False), (1, 0, False), (2, 1, False),
    (0, 0, True), (0, 1, True), (1, 2, True),
]


@pytest.fixture(scope="module")
def meshes():
    built = {n: mesh_mod.Mesh(["cpu"] * n, (n,), (AXIS,)) for n in (2, 4, 8)}
    yield built
    for m in built.values():
        m.close()


def _jax_run(n, body, x):
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), (AXIS,))
    fn = jax_shard_map(body, mesh=mesh, in_specs=P(AXIS), out_specs=P(AXIS),
                       check_vma=False)
    return np.asarray(jax.jit(fn)(x))


def _port_run(mesh, body, x):
    blocks = list(torch.from_numpy(x).chunk(mesh.size, 0))
    outs = mesh_mod.shard_map(body, mesh)(blocks)
    return torch.cat(outs, 0).numpy()


def _block_shape(n, split_axis, tiled):
    shape = [3, 5, 2]
    shape[split_axis] = 2 * n if tiled else n
    return shape


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("split_axis,concat_axis,tiled", A2A_CASES)
def test_all_to_all_matches_jax(meshes, n, split_axis, concat_axis, tiled):
    shape = _block_shape(n, split_axis, tiled)
    rng = np.random.default_rng(n * 100 + split_axis * 10 + concat_axis)
    x = rng.integers(-2**31, 2**31 - 1, size=(n * shape[0], *shape[1:]),
                     dtype=np.int64).astype(np.int32)
    want = _jax_run(n, lambda b: jax.lax.all_to_all(
        b, AXIS, split_axis, concat_axis, tiled=tiled), x)
    mesh = meshes[n]
    mesh.collectives.clear()
    got = _port_run(mesh, lambda b: mesh_mod.all_to_all(
        b, AXIS, split_axis, concat_axis, tiled=tiled), x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert mesh.collectives == {"all_to_all": 1}


def test_all_to_all_block_rule(meshes):
    """Shard i's output block j is shard j's input block i."""
    mesh = meshes[4]
    blocks = [torch.arange(4 * 3).reshape(4, 3) + 100 * r for r in range(4)]
    outs = mesh_mod.shard_map(
        lambda b: mesh_mod.all_to_all(b, AXIS, 0, 0, tiled=False),
        mesh)(blocks)
    for i in range(4):
        for j in range(4):
            assert torch.equal(outs[i][j], blocks[j][i])


def test_all_to_all_refuses_a_wrong_split(meshes):
    mesh = meshes[4]
    with pytest.raises(ValueError, match="split axis"):
        mesh_mod.shard_map(lambda b: mesh_mod.all_to_all(b, AXIS), mesh)(
            [torch.zeros(3, 2)] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.shard_map(
            lambda b: mesh_mod.all_to_all(b, AXIS, tiled=True), mesh)(
            [torch.zeros(6, 2)] * 4)


PERMS = {
    "ring": lambda n: [(i, (i + 1) % n) for i in range(n)],
    "back": lambda n: [(i, (i - 1) % n) for i in range(n)],
    "partial": lambda n: [(0, n - 1)] + ([(n - 1, 1)] if n > 2 else []),
    "swap": lambda n: [(i, i ^ 1) for i in range(n)],
}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("perm", sorted(PERMS))
def test_ppermute_matches_jax(meshes, n, perm):
    pairs = PERMS[perm](n)
    rng = np.random.default_rng(n + len(perm))
    x = rng.integers(-2**31, 2**31 - 1, size=(n * 3, 4),
                     dtype=np.int64).astype(np.int32)
    want = _jax_run(n, lambda b: jax.lax.ppermute(b, AXIS, pairs), x)
    mesh = meshes[n]
    mesh.collectives.clear()
    got = _port_run(mesh, lambda b: mesh_mod.ppermute(b, AXIS, pairs), x)
    np.testing.assert_array_equal(got, want)
    assert mesh.collectives == {"ppermute": 1}
    if perm == "partial":
        receivers = {d for _, d in pairs}
        for r in range(n):
            blk = got[3 * r: 3 * (r + 1)]
            assert (blk == 0).all() == (r not in receivers)


def test_ppermute_refuses_a_non_permutation(meshes):
    with pytest.raises(ValueError, match="not a permutation"):
        mesh_mod.shard_map(
            lambda b: mesh_mod.ppermute(b, AXIS, [(0, 1), (2, 1)]),
            meshes[4])([torch.zeros(2)] * 4)


def test_collectives_on_a_one_shard_axis_are_the_identity():
    mesh = mesh_mod.Mesh(["cpu"], (1,), (AXIS,))
    try:
        x = torch.arange(6).reshape(1, 6)
        out = mesh_mod.shard_map(lambda b: (
            mesh_mod.all_to_all(b, AXIS, 0, 0, tiled=False),
            mesh_mod.all_to_all(b, AXIS, 1, 1, tiled=True),
            mesh_mod.ppermute(b, AXIS, [(0, 0)]),
            mesh_mod.ppermute(b, AXIS, [])), mesh)([x])[0]
        assert torch.equal(out[0], x) and torch.equal(out[1], x)
        assert torch.equal(out[2], x) and not out[3].any()
        assert mesh.collectives == {"all_to_all": 2, "ppermute": 2}
    finally:
        mesh.close()


def test_a_shard_exception_reaches_the_caller(meshes):
    mesh = meshes[4]

    def body(b):
        if mesh_mod.axis_index(AXIS) == 2:
            raise KeyError("shard two")
        return mesh_mod.ppermute(b, AXIS, PERMS["ring"](4))

    with pytest.raises(KeyError, match="shard two"):
        mesh_mod.shard_map(body, mesh)([torch.zeros(2)] * 4)
    # The mesh serves the next call.
    out = mesh_mod.shard_map(
        lambda b: mesh_mod.all_to_all(b, AXIS, 0, 0), mesh)(
        [torch.full((4, 1), float(r)) for r in range(4)])
    assert torch.equal(out[1][:, 0], torch.arange(4.0))


def test_a_skipped_collective_times_out(monkeypatch):
    monkeypatch.setattr(mesh_mod, "COLLECTIVE_TIMEOUT_S", 0.5)
    mesh = mesh_mod.Mesh(["cpu"] * 4, (4,), (AXIS,))
    try:
        def body(b):
            if mesh_mod.axis_index(AXIS) == 0:
                return b
            return mesh_mod.all_to_all(b, AXIS, 0, 0)

        with pytest.raises(TimeoutError, match="collective"):
            mesh_mod.shard_map(body, mesh)([torch.zeros(4)] * 4)
    finally:
        mesh.close()


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2), (2, 4), (1, 8)])
def test_solver_grid_is_unchanged(shape):
    """The (mdl, inst) grid ranks row-major, as it did with its axes
    fixed: rank i * n_inst + j is (i, j), and each axis group runs along
    its axis in order."""
    n_mdl, n_inst = shape
    mesh = mesh_mod.make_mesh(shape, ["cpu"] * (n_mdl * n_inst))
    assert mesh.axes == mesh_mod.AXES == ("mdl", "inst")
    assert mesh.shape == {"mdl": n_mdl, "inst": n_inst}
    for rank in range(mesh.size):
        i, j = divmod(rank, n_inst)
        assert mesh.coords(rank) == (i, j)
        assert mesh.rank_of(i, j) == rank
        assert mesh.group("mdl", rank) == [k * n_inst + j
                                           for k in range(n_mdl)]
        assert mesh.group("inst", rank) == [i * n_inst + k
                                            for k in range(n_inst)]
    idx = mesh_mod.shard_map(
        lambda: (mesh_mod.axis_index("mdl"), mesh_mod.axis_index("inst")),
        mesh)()
    assert idx == [mesh.coords(r) for r in range(mesh.size)]
    mesh.close()


def test_named_axes_and_blocks():
    mesh = mesh_mod.Mesh(["cpu"] * 6, (3, 2), ("seq", "exp"))
    assert mesh.coords(5) == (2, 1) and mesh.rank_of(2, 1) == 5
    assert mesh.group("seq", 1) == [1, 3, 5]
    t = torch.arange(12).reshape(6, 2)
    assert torch.equal(mesh.block(3, t, ("seq", None)), t[2:4])
    with pytest.raises(ValueError, match="does not hold"):
        mesh_mod.Mesh(["cpu"] * 4, (4,), ("a", "b"))
    with pytest.raises(ValueError, match="does not hold"):
        mesh_mod.Mesh(["cpu"] * 4, (2, 2), ("a", "a"))


def test_axis_meshes_are_cached_per_device_list():
    a = mesh_mod.axis_mesh("seq", ["cpu"] * 4)
    assert mesh_mod.axis_mesh("seq", ["cpu"] * 4) is a
    assert mesh_mod.axis_mesh("exp", ["cpu"] * 4) is not a
    assert mesh_mod.axis_mesh("seq", ["cpu"] * 2) is not a
    assert a.axes == ("seq",) and a.size == 4


def test_collective_counts_by_kind(meshes):
    mesh = meshes[2]
    mesh.collectives.clear()

    def body(b):
        s = mesh_mod.psum(b, AXIS)
        g = mesh_mod.all_gather(b, AXIS)
        return mesh_mod.pmax(s, AXIS) + g.sum()

    mesh_mod.shard_map(body, mesh)([torch.ones(2)] * 2)
    assert mesh.collectives == {"psum": 1, "all_gather": 1, "pmax": 1}
