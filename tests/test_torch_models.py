"""The port's model families (``modelmesh_tpu_torch/models/families.py``)
against the JAX package's, on the CPU.

- Initial weights: every family, at its default spec and at a small one,
  builds the same leaves in ``jax.tree.leaves`` order, with equal dtypes,
  shapes and bytes, and equal ``size_bytes``.
- Forward passes on the same seeded numpy inputs, with the reference's
  parameters carried across by ``params_from_leaves``, within each
  family's tolerance (``FORWARD_TOL``, beside the largest error measured
  over model ids m1/m2/other and batches of 1 and 4 rows).
- Spec parsing, ``fuse_key_for``, ``predict_size_estimate``, the
  ``example`` alias, ``sp``/``ep`` on one device, the MoE spec check
  (the MoE transformer itself: ``tests/test_torch_moe.py``).
- ``sp=1`` and ``ep=1`` over 8 "cpu" shards (ring attention, the
  expert-parallel FFN): against the reference's ``build_model`` on its 8
  virtual devices (which runs its ring and its expert-parallel FFN) at
  ``FORWARD_TOL``, with the collective counts that prove the mesh ran;
  against the port's own dense run at the reference's 0.08; a shorter
  input takes the dense path bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.models import families as jf
from modelmesh_tpu.models.server import (
    predict_size_estimate as jax_size_estimate,
)
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.parallel import mesh as mesh_mod
from modelmesh_tpu_torch.models.server import predict_size_estimate

SPECS = {
    "mlp": ["mlp://", "mlp://in=8,hidden=16,depth=3,out=4"],
    "linear": ["linear://", "linear://in=8,out=3"],
    "conv": ["conv://", "conv://size=9,chans=2,width=4,depth=2,classes=5"],
    "embedding": ["embedding://",
                  "embedding://vocab=64,dim=8,bag=5,items=12"],
    "transformer": ["transformer://",
                    "transformer://vocab=64,d=32,layers=1,heads=2,seq=8"],
    "example": ["", "example://in=4,out=2"],
}
CASES = [(fam, path) for fam, paths in SPECS.items() for path in paths]
MOE_CASES = [("transformer",
              "transformer://vocab=64,d=32,layers=1,heads=2,seq=8,experts=4"),
             ("transformer", "transformer://experts=8")]
# Forward tolerance per family, as (rtol, atol / max|ref|), beside the
# largest |port - reference| / max|ref| measured over this file's inputs.
# mlp and linear run their products in f32 (the reference promotes them):
# 8.4e-7 / 2.3e-7. conv (bf16 throughout): 1.35e-2; embedding (bf16
# pooling and scores): 3.1e-3; transformer (bf16 activations into f32
# weights): 7.1e-3 — rounding order of bf16 sums and activations between
# XLA-CPU and PyTorch-CPU.
FORWARD_TOL = {
    "mlp": (1e-5, 1e-5), "linear": (1e-5, 1e-5), "example": (1e-5, 1e-5),
    "conv": (1e-2, 1e-2), "embedding": (1e-2, 1e-2),
    "transformer": (1e-2, 1e-2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _inputs(model, n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n, *model.input_shape)
    if model.input_dtype == np.int32:
        # Negative ids, literal 0 (the embedding's padding slot) and ids
        # past the vocabulary all occur.
        return rng.integers(-3, 5000, size=shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("mid", ["m1", "other"])
@pytest.mark.parametrize("family,path", CASES + MOE_CASES)
def test_initial_weights_byte_identical(family, path, mid):
    jm = jf.build_model(mid, family, path)
    tm = tf.build_model(mid, family, path, device="cpu")
    jl, tl = jax.tree.leaves(jm.params), tf.leaves(tm.params)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert str(a.dtype) == _dtype_name(b), i
        assert np.asarray(a).tobytes() == tf.leaf_bytes(b), i
    assert tm.size_bytes == jm.size_bytes
    assert tm.input_shape == jm.input_shape
    assert tm.input_dtype == jm.input_dtype
    assert (tm.family, tm.fuse_key, tm.batch_safe) == (
        jm.family, jm.fuse_key, jm.batch_safe)


def test_default_sizes_and_promoted_dtypes():
    """The reference's default sizes, and its f32 weight matrices where a
    float64 scale promoted the bf16 draw."""
    sizes = {f: tf.build_model("m1", f, f"{f}://",
                               device="cpu").size_bytes
             for f in ("mlp", "transformer", "embedding", "conv")}
    assert sizes == {"mlp": 338964, "transformer": 1655808,
                     "embedding": 540672, "conv": 67648}
    mlp = tf.build_model("m1", "mlp", "mlp://", device="cpu").params
    assert mlp[0]["w"].dtype == torch.float32
    assert mlp[0]["b"].dtype == torch.bfloat16
    blk = tf.build_model("m1", "transformer", "transformer://",
                         device="cpu").params
    assert blk["blocks"][0]["qkv"].dtype == torch.float32
    assert blk["embed"].dtype == torch.bfloat16
    assert blk["blocks"][0]["ln1"].dtype == torch.bfloat16
    conv = tf.build_model("m1", "conv", "conv://", device="cpu").params
    assert {t.dtype for t in tf.leaves(conv)} == {torch.bfloat16}


@pytest.mark.parametrize("mid", ["m1", "m2", "other"])
@pytest.mark.parametrize("family,path", CASES)
def test_forward_matches_reference(family, path, mid):
    jm = jf.build_model(mid, family, path)
    tm = tf.build_model(mid, family, path, device="cpu")
    tm.params = tf.params_from_leaves(
        tm.params, [np.asarray(leaf) for leaf in jax.tree.leaves(jm.params)],
        device="cpu")
    rtol, atol_frac = FORWARD_TOL[family]
    for n in (1, 4):
        x = _inputs(jm, n)
        ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)), np.float32)
        got = tm.run(x)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=atol_frac * np.abs(ref).max())


@pytest.mark.parametrize("family,path", [("mlp", "mlp://in=8,out=3"),
                                         ("embedding", SPECS["embedding"][1])])
def test_predict_bytes_matches_reference(family, path):
    """The raw-bytes front: a short payload zero-padded, rows decoded in
    the family's input dtype, f32 logits out."""
    jm = jf.build_model("m", family, path)
    tm = tf.build_model("m", family, path, device="cpu")
    x = _inputs(jm, 3)
    for payload in (x.tobytes(), x.tobytes()[:-4]):
        ref = np.frombuffer(jm.predict_bytes(payload), np.float32)
        got = np.frombuffer(tm.predict_bytes(payload), np.float32)
        rtol, atol_frac = FORWARD_TOL[family]
        np.testing.assert_allclose(got, ref, rtol=rtol,
                                   atol=atol_frac * np.abs(ref).max())


def test_longest_test_sequence_transformer():
    """d=64, seq=128: the longest sequence the repo's tests serve."""
    path = "transformer://d=64,heads=4,seq=128,layers=2"
    jm, tm = jf.build_model("lm", "transformer", path), tf.build_model(
        "lm", "transformer", path, device="cpu")
    assert tm.size_bytes == jm.size_bytes
    x = _inputs(jm, 2)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(tm.run(x), ref, rtol=1e-2,
                               atol=1e-2 * np.abs(ref).max())


def test_sp_and_ep_run_the_dense_path_on_one_device():
    base = tf.build_model("t", "transformer", SPECS["transformer"][1],
                          device="cpu")
    x = _inputs(base, 3)
    for extra in (",sp=1", ",ep=1", ",sp=1,ep=1"):
        m = tf.build_model("t", "transformer",
                           SPECS["transformer"][1] + extra, device="cpu")
        np.testing.assert_array_equal(m.run(x), base.run(x))
        assert m.fuse_key != base.fuse_key   # a spec param all the same


def test_experts_refused():
    """The spec check of an MoE transformer: a group count that does not
    divide ``seq`` is refused, as the reference refuses it. (``experts >
    0`` itself was refused before the MoE FFN was ported; it now builds,
    with the MoE FFN in every block and ``batch_safe`` False.)"""
    with pytest.raises(ValueError, match="groups=3 must divide"):
        tf.build_model("t", "transformer",
                       "transformer://seq=8,experts=4,groups=3", device="cpu")
    m = tf.build_model("t", "transformer",
                       "transformer://vocab=64,d=32,seq=8,experts=4",
                       device="cpu")
    assert m.batch_safe is False
    assert all(set(blk) == {"qkv", "proj", "moe", "ln1", "ln2"}
               for blk in m.params["blocks"])
    assert m.run(np.zeros((1, 8), np.int32)).shape == (1, 64)


def test_unknown_family_refused():
    with pytest.raises(ValueError, match="unknown model family"):
        tf.build_model("x", "resnet", "resnet://", device="cpu")


@pytest.mark.parametrize("mtype,path", [
    ("mlp", "mlp://in=32,hidden=64,out=4"), ("linear", ""),
    ("mlp", "in=3,hidden=5"), ("x", "transformer://d=64,,heads=2"),
    ("conv", "conv:// size = 9 , depth=2"),
])
def test_spec_parsing_and_fuse_key(mtype, path):
    js, ts = jf.ModelSpec.parse(mtype, path), tf.ModelSpec.parse(mtype, path)
    assert (ts.family, ts.params) == (js.family, js.params)
    assert tf.fuse_key_for(ts) == jf.fuse_key_for(js)
    seeded = tf.ModelSpec(ts.family, dict(ts.params, seed=5))
    assert tf.fuse_key_for(seeded) == tf.fuse_key_for(ts)


def test_families_and_streamable_sets():
    assert set(tf.FAMILIES) == set(jf.FAMILIES)
    assert tf.LAYER_STREAMABLE_FAMILIES == jf.LAYER_STREAMABLE_FAMILIES


@pytest.mark.parametrize("mtype,path", [
    *CASES, ("mlp", "mlp://depth=1"), ("conv", "conv://size=31"),
    ("bogus", "bogus://"), ("transformer", "transformer://layers=3,seq=16"),
])
def test_predict_size_estimate_matches_reference(mtype, path):
    assert predict_size_estimate(mtype, path) == jax_size_estimate(mtype,
                                                                   path)


def test_seed_param_overrides_model_id():
    a = tf.build_model("a", "linear", "linear://seed=9", device="cpu")
    b = tf.build_model("b", "linear", "linear://seed=9", device="cpu")
    c = tf.build_model("a", "linear", "linear://", device="cpu")
    assert tf.leaf_bytes(a.params["w"]) == tf.leaf_bytes(b.params["w"])
    assert tf.leaf_bytes(a.params["w"]) != tf.leaf_bytes(c.params["w"])


def test_embedding_gather_masks_literal_zero():
    """Literal id 0 is padding; an id that wraps onto slot 0 counts."""
    m = tf.build_model("e", "embedding", SPECS["embedding"][1], device="cpu")
    pad = np.array([[5, 0, 0, 0, 0]], np.int32)
    moved = np.array([[0, 0, 0, 5, 0]], np.int32)
    wrapped = np.array([[5, 64, 0, 0, 0]], np.int32)   # 64 % 64 == 0
    np.testing.assert_array_equal(m.run(pad), m.run(moved))
    assert not np.array_equal(m.run(wrapped), m.run(pad))


def test_params_from_leaves_checks_shapes():
    m = tf.build_model("m", "linear", "linear://in=4,out=2", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tf.params_from_leaves(m.params, [np.zeros((2, 4), np.float32)],
                              device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        tf.params_from_leaves(m.params, [], device="cpu")


def test_device_none_needs_cuda(monkeypatch):
    """``device=None`` means ``cuda:0``: without a card the entry points
    raise instead of building on the host."""
    skeleton = tf.build_model("m", "linear", "linear://in=4,out=2",
                              device="cpu").params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.build_model("m", "linear", "linear://in=4,out=2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.params_from_leaves(skeleton, [np.zeros((4, 2), np.float32)])


def test_tree_helpers_round_trip():
    tree = {"b": [torch.ones(2), {"y": torch.zeros(1), "x": torch.ones(3)}],
            "a": torch.arange(4)}
    flat = tf.leaves(tree)
    assert [t.shape[0] for t in flat] == [4, 2, 3, 1]
    back = tf.unflatten(tree, flat)
    assert [t.shape[0] for t in tf.leaves(back)] == [4, 2, 3, 1]
    with pytest.raises(ValueError):
        tf.unflatten(tree, flat + [torch.ones(1)])


CPUS = ["cpu"] * 8
# tests/test_models.py's specs, model ids and token seeds.
SPMD = {
    "sp": ("lc-model", "transformer://d=64,heads=4,seq=128,layers=2,sp=1", 0),
    "ep": ("moe-model", "transformer://d=64,heads=4,seq=64,layers=2,"
           "experts=16,groups=8,ep=1", 7),
}


def _spmd_counts():
    return {
        axis: dict(mesh_mod.axis_mesh(axis, CPUS).collectives)
        for axis in ("seq", "exp")
    }


def _clear_spmd_counts():
    for axis in ("seq", "exp"):
        mesh_mod.axis_mesh(axis, CPUS).collectives.clear()


@pytest.mark.parametrize("kind", sorted(SPMD))
def test_sp_and_ep_on_eight_shards_match_the_reference(kind):
    mid, path, seed = SPMD[kind]
    assert len(jax.devices()) == 8
    jm = jf.build_model(mid, "transformer", path)
    tm = tf.build_model(mid, "transformer", path, device="cpu",
                        devices=CPUS)
    tm.params = tf.params_from_leaves(
        tm.params, [np.asarray(leaf) for leaf in jax.tree.leaves(jm.params)],
        device="cpu")
    seq = tm.input_shape[0]
    tokens = np.random.default_rng(seed).integers(0, 255, (2, seq)).astype(
        np.int32)
    ref = np.asarray(jm.apply(jm.params, jnp.asarray(tokens)), np.float32)
    _clear_spmd_counts()
    got = tm.run(tokens)
    layers = len(tm.params["blocks"])
    want_counts = ({"seq": {"ppermute": 2 * 7 * layers}, "exp": {}}
                   if kind == "sp"
                   else {"seq": {}, "exp": {"all_to_all": 2 * layers}})
    assert _spmd_counts() == want_counts
    rtol, atol_frac = FORWARD_TOL["transformer"]
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_frac * np.abs(ref).max())


@pytest.mark.parametrize("kind", sorted(SPMD))
def test_sp_and_ep_on_eight_shards_match_the_dense_run(kind):
    """The schedule changes, not the function: the same weights give the
    dense run's logits at the reference's 0.08; the output moves with the
    input; a shorter input runs the dense path, bit for bit."""
    mid, path, seed = SPMD[kind]
    dense = tf.build_model(mid, "transformer",
                           path.replace(f",{kind}=1", ""), device="cpu")
    spmd = tf.build_model(mid, "transformer", path, device="cpu",
                          devices=CPUS)
    seq = spmd.input_shape[0]
    tokens = np.random.default_rng(seed).integers(0, 255, (2, seq)).astype(
        np.int32)
    a, b = dense.run(tokens), spmd.run(tokens)
    np.testing.assert_allclose(a, b, atol=0.08, rtol=0.08)
    tokens2 = tokens.copy()
    tokens2[:, -1] ^= 1
    assert np.abs(spmd.run(tokens2) - b).max() > 1e-3
    short = torch.from_numpy(tokens[:, : seq // 2].copy())
    _clear_spmd_counts()
    with torch.inference_mode():
        np.testing.assert_array_equal(
            spmd.apply(spmd.params, short).numpy(),
            dense.apply(dense.params, short).numpy())
    assert _spmd_counts() == {"seq": {}, "exp": {}}


def test_sp_and_ep_need_a_dividing_device_count():
    """Over 3 devices neither divides: the dense path, bit for bit."""
    for kind in sorted(SPMD):
        mid, path, seed = SPMD[kind]
        dense = tf.build_model(mid, "transformer", path, device="cpu")
        three = tf.build_model(mid, "transformer", path, device="cpu",
                               devices=["cpu"] * 3)
        x = np.random.default_rng(seed).integers(
            0, 255, (1, dense.input_shape[0])).astype(np.int32)
        np.testing.assert_array_equal(three.run(x), dense.run(x))
