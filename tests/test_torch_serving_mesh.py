"""The port's serving mesh (``modelmesh_tpu_torch/parallel/mesh.py``
``serving_mesh``, ``param_pspec``, ``shard_params``) and the store's split
loads (``models/server.py`` ``load_sharded``, ``load_shard``,
``export_shard_weights``, ``load_shard_from_stream``) on "cpu" shards.

- ``tests/test_sharded_exec.py``'s mesh and execution cases on the port:
  the mesh cache and sizes, the ``param_pspec`` rule against the
  reference's on the same shapes, ``shard_params`` (each device holds its
  blocks in storage of their own, and every replicated leaf), a 1-shard
  mesh bit for bit the plain ``load``, 4 and 8 shards within 1e-5, the
  non-streamable family refused, the share reported, the owned leaf
  range, the stream round trip and a wrong range refused.
- A shard's export byte for byte the reference loader's for the same
  model and shard (each leaf's whole bytes, in ``jax.tree.leaves`` order).
- Weights carried across: the reference's leaves through
  ``params_from_leaves`` and ``shard_params`` on 4 shards predict what the
  reference's ``load_sharded`` on its ``serving_mesh(4)`` predicts: the
  mlp (f32 products) within 1e-5; the transformer within
  ``FORWARD_TOL["transformer"]``, the bf16 drift between XLA-CPU and
  PyTorch-CPU that its plain load already shows, and within 1e-5 of the
  port's own plain load of the same weights.
"""

import jax
import numpy as np
import pytest
import torch

from modelmesh_tpu.models.server import InProcessJaxLoader
from modelmesh_tpu.parallel.mesh import param_pspec as jax_param_pspec
from modelmesh_tpu.parallel.mesh import serving_mesh as jax_serving_mesh
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.models import server as ts
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.runtime import spi
from modelmesh_tpu_torch.transfer.protocol import shard_chunk_indices

# tests/test_sharded_exec.py's model (``d_model`` is no spec key: d=128).
SPEC = "transformer://layers=2,d_model=64,heads=4,seed=3"
INFO = spi.ModelInfo(model_type="jax", model_path=SPEC)
CPUS = ["cpu"] * 8
TRANSFORMER_TOL = (1e-2, 1e-2)   # tests/test_torch_models.py FORWARD_TOL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _loader(n=4):
    return ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu",
                                   devices=CPUS[:n])


def _input_bytes(model, seed=7, rows=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, *model.input_shape)).astype(
        model.input_dtype)
    return x.tobytes()


def _logits(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.float32)


# -- the mesh and the partition rule -----------------------------------------

def test_serving_mesh_sizes_and_cache(monkeypatch):
    m1 = mesh_mod.serving_mesh(1, CPUS)
    assert m1.size == 1 and m1.axes == (mesh_mod.MODEL_AXIS,)
    assert mesh_mod.serving_mesh(1, CPUS) is m1, "cached per device list"
    assert mesh_mod.serving_mesh(4, CPUS).size == 4
    assert mesh_mod.serving_mesh(0, CPUS).size == 8      # 0: every device
    assert mesh_mod.serving_mesh(99, CPUS).size == 8
    monkeypatch.setenv("MM_SHARDED_MESH_DEVICES", "2")
    assert mesh_mod.serving_mesh(devices=CPUS).size == 2
    monkeypatch.delenv("MM_SHARDED_MESH_DEVICES")
    assert mesh_mod.serving_mesh(devices=CPUS).size == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.serving_mesh(1)


@pytest.mark.parametrize("shape,n", [
    ((8, 64), 4), ((8, 63), 4), ((64,), 4), ((8, 64), 1), ((2, 3, 16), 8),
    ((16, 8), 8), ((5, 6), 3), ((), 4),
])
def test_param_pspec_matches_reference(shape, n):
    want = tuple(jax_param_pspec(np.zeros(shape, np.float32), n))
    assert mesh_mod.param_pspec(torch.zeros(shape), n) == want
    assert mesh_mod.param_pspec(np.zeros(shape, np.float32), n) == want


def test_shard_params_places_leaves_on_mesh():
    mesh = mesh_mod.serving_mesh(4, CPUS)
    params = {"w": torch.arange(4 * 64, dtype=torch.float32).reshape(4, 64),
              "b": torch.ones(64)}
    out = mesh_mod.shard_params(params, mesh)
    w, b = out["w"], out["b"]
    assert w.split and w.spec == (None, mesh_mod.MODEL_AXIS)
    assert w.shape == (4, 64) and w.numel() == 256 and w.element_size() == 4
    for r, blk in enumerate(w.blocks):
        assert blk.shape == (4, 16) and blk.device == mesh.devices[r]
        assert blk.untyped_storage().nbytes() == 4 * 16 * 4   # its own
        assert torch.equal(blk, params["w"][:, 16 * r: 16 * (r + 1)])
    assert torch.equal(w.on("cpu"), params["w"])
    assert not b.split and b.spec == ()
    assert all(blk is b.blocks[0] for blk in b.blocks)   # one per device
    for r in range(4):
        assert mesh_mod.shard_nbytes(out, r) == 4 * 16 * 4 + 64 * 4
    np_out = mesh_mod.shard_params({"w": np.ones((4, 64), np.float32)}, mesh)
    assert float(np_out["w"].on("cpu").sum()) == 4 * 64


# -- execution -----------------------------------------------------------------

def test_sharded_execution_bitwise_parity_on_one_device_mesh():
    """The reference's gate: a 1-shard mesh is bit for bit the plain path."""
    plain, sharded = _loader(), _loader()
    plain.store.load("m-plain", INFO.model_type, INFO.model_path)
    sharded.store.load_sharded("m-shard", INFO.model_type, INFO.model_path,
                               mesh=mesh_mod.serving_mesh(1, CPUS))
    a, b = plain.store.get("m-plain"), sharded.store.get("m-shard")
    for seed, rows in ((7, 1), (8, 3)):
        x = _input_bytes(a, seed, rows)
        assert a.predict_bytes(x) == b.predict_bytes(x)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("mtype,path", [(INFO.model_type, SPEC),
                                        ("mlp", "mlp://")])
def test_sharded_execution_multi_device_allclose(n, mtype, path):
    plain, sharded = _loader(n), _loader(n)
    plain.store.load("m", mtype, path)       # one id: the same weights
    sharded.store.load_sharded("m", mtype, path)           # serving mesh
    model = sharded.store.get("m")
    assert model.fuse_key == "", "sharded copies must never fuse-stack"
    assert all(isinstance(t, mesh_mod.ShardedLeaf)
               for t in tf.leaves(model.params))
    assert {len(t.blocks) for t in tf.leaves(model.params)} == {n}
    assert any(t.split for t in tf.leaves(model.params))
    x = _input_bytes(plain.store.get("m"), rows=2)
    np.testing.assert_allclose(
        _logits(plain.store.get("m").predict_bytes(x)),
        _logits(model.predict_bytes(x)), rtol=1e-5, atol=1e-5)


def test_each_shard_holds_its_blocks_and_the_replicated_leaves():
    ld = _loader(4)
    ld.store.load_sharded("m", INFO.model_type, INFO.model_path)
    params = ld.store.get("m").params
    for r in range(4):
        want = sum(t.numel() * t.element_size() // (4 if t.split else 1)
                   for t in tf.leaves(params))
        assert mesh_mod.shard_nbytes(params, r) == want
    split = sum(tf.leaf_nbytes(t) for t in tf.leaves(params) if t.split)
    assert split > 0.9 * ld.store.get("m").size_bytes
    for t in tf.leaves(params):
        if t.split:
            assert all(b.untyped_storage().nbytes() == b.numel()
                       * b.element_size() for b in t.blocks)


def test_load_sharded_rejects_non_streamable_family():
    with pytest.raises(ValueError, match="not sharded-executable"):
        _loader().store.load_sharded("m-lin", "linear", "linear://in=8,out=2")


def test_load_shard_reports_share_of_bytes():
    loader = _loader()
    lm = loader.load_shard("m", INFO, shard_index=1, shard_count=3)
    total = loader.store.get("m").size_bytes
    assert total == tf.build_model("m", "jax", SPEC, device="cpu").size_bytes
    assert lm.size_bytes == -(-total // 3)
    assert lm.handle.shard_index == 1 and lm.handle.shard_count == 3


# -- per-shard weight streaming ------------------------------------------------

def test_export_shard_weights_yields_only_owned_leaf_range():
    loader = _loader()
    lm = loader.load_shard("m", INFO, shard_index=0, shard_count=2)
    n_leaves = len(tf.leaves(lm.handle.params))
    want = set(shard_chunk_indices(n_leaves, 0, 2))
    layers = {c.layer for c in loader.export_shard_weights("m", lm.handle)}
    assert layers == want


def test_shard_stream_round_trip_matches_store_load():
    sender, receiver = _loader(), _loader()
    lm = sender.load_shard("m", INFO, shard_index=1, shard_count=2)
    chunks = list(sender.export_shard_weights("m", lm.handle))
    got = receiver.load_shard_from_stream("m", INFO, 1, 2, iter(chunks))
    assert got.size_bytes == lm.size_bytes
    assert all(isinstance(t, mesh_mod.ShardedLeaf)
               for t in tf.leaves(got.handle.params))
    x = _input_bytes(lm.handle)
    np.testing.assert_allclose(
        _logits(sender.store.get("m").predict_bytes(x)),
        _logits(receiver.store.get("m").predict_bytes(x)),
        rtol=1e-5, atol=1e-5)


def test_shard_stream_rejects_wrong_leaf_range():
    sender, receiver = _loader(), _loader()
    lm = sender.load_shard("m", INFO, shard_index=0, shard_count=2)
    chunks = list(sender.export_shard_weights("m", lm.handle))
    with pytest.raises(spi.ModelLoadException, match="shard 1/2"):
        receiver.load_shard_from_stream("m", INFO, 1, 2, iter(chunks))


@pytest.mark.parametrize("index,count", [(0, 2), (1, 3)])
def test_shard_export_bytes_equal_the_reference_loaders(index, count):
    ref = InProcessJaxLoader(capacity_bytes=64 << 20)
    ref_lm = ref.load_shard("m", INFO, index, count)
    want = [(c.seq, c.layer, c.payload, c.last)
            for c in ref.export_shard_weights("m", ref_lm.handle)]
    port = _loader(8)
    lm = port.load_shard("m", INFO, index, count)
    got = [(c.seq, c.layer, c.payload, c.last)
           for c in port.export_shard_weights("m", lm.handle)]
    assert got == want
    assert lm.size_bytes == ref_lm.size_bytes


# -- weights carried across ------------------------------------------------------

@pytest.mark.parametrize("mtype,path", [("mlp", "mlp://"),
                                        (INFO.model_type, SPEC)])
def test_reference_leaves_on_a_4_shard_mesh(mtype, path):
    ref = InProcessJaxLoader(capacity_bytes=64 << 20)
    ref.store.load_sharded("m", mtype, path, mesh=jax_serving_mesh(4))
    jm = ref.store.get("m")
    skel = tf.build_model("m", mtype, path, device="cpu")
    params = tf.params_from_leaves(
        skel.params, [np.asarray(leaf) for leaf in jax.tree.leaves(jm.params)],
        device="cpu")
    plain = tf.ServableModel(skel.apply, params, skel.input_shape,
                             skel.input_dtype)
    split = ts.shard_servable(plain, mesh_mod.serving_mesh(4, CPUS))
    x = _input_bytes(plain, rows=2)
    want = _logits(jm.predict_bytes(x))
    got = _logits(split.predict_bytes(x))
    np.testing.assert_allclose(got, _logits(plain.predict_bytes(x)),
                               rtol=1e-5, atol=1e-5)
    if mtype == "mlp":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rtol, atol_frac = TRANSFORMER_TOL
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol_frac * np.abs(want).max())
