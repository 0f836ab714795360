"""Model weights drawn on the model's device: the families' and the MoE
FFN's ``jax.random.normal`` through ``ops/cuda_random.py::normal``, on the
CPU.

- The kernel's bf16 route modelled in plain PyTorch (the draw's bits, the
  7-bit index ``(bits >> 1) & 0x7F``, the 128-entry table the wrapper
  hands the kernel) equals ``prng.normal`` on all 65,536 16-bit patterns
  of the hash's low half, and on a seeded draw; the table holds 128
  distinct values, each ``jax.random.normal``'s.
- Every family at its default spec, both MoE transformers and
  ``transformer://d=1024,heads=8,layers=2`` built with ``device="cpu"``:
  the leaves the host draw gave before the draw moved to the model's
  device (their digests, taken from that build) and the JAX package's
  parameters, byte for byte.
- ``_draw``, ``init_moe_params`` and ``build_model`` given a CUDA device
  on this host raise, having drawn nothing on the CPU (the wrapper's
  ``plain_draws`` count); the CPU draws are counted there and launch
  nothing.
- ``_skeleton`` builds on the store's device, and a streamed load frees
  the skeleton's leaves as it grafts.

The kernel against this plain version, and a card build against a CPU
build, are held bit for bit on the card by ``chip_smoke.py`` (phase
``weight_draw``).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modelmesh_tpu.models import families as jf
from modelmesh_tpu.parallel import moe as jmoe
from modelmesh_tpu_torch import random as prng
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.models import server as ts
from modelmesh_tpu_torch.ops import cuda_random
from modelmesh_tpu_torch.parallel import moe as tmoe
from modelmesh_tpu_torch.runtime.spi import ModelInfo

# sha256 (first 32 hex digits) of every leaf's bytes in leaf order, of the
# model "weights" built on the CPU when the families still drew on the
# host and moved the parameters after: chip_smoke.py's MODEL_SPECS,
# MOE_SPECS and INST_SHARDED.
BUILT_BEFORE = {
    "mlp://": "6ce1110c1df2e89cc4530758edeea1d3",
    "linear://": "f6ebe290c1d6f515ba149fa1389908f7",
    "conv://": "80286a3ab26aa8fbfd9c4a6edd4517f2",
    "embedding://": "78b99b3303490f30937974588abb448e",
    "transformer://": "86a43a20cf4ad7f680adfbe92a15364d",
    "transformer://d=64,heads=4,seq=128,layers=2":
        "8820646fef7d344216cc8eb024ad3c92",
    "transformer://experts=8": "ffc93fdecc4923d72134e3d2d4297911",
    "transformer://d=64,heads=4,seq=64,layers=2,experts=16,groups=8":
        "7310ca12ce482c695a5d9ffdadfbda88",
    "transformer://d=1024,heads=8,layers=2":
        "a152485c13309243ea413d51315ee45d",
}
CUDA = torch.device("cuda", 0)


def _family(path: str) -> str:
    return path.partition("://")[0]


def _digest(model) -> str:
    h = hashlib.sha256()
    for leaf in tf.leaves(model.params):
        h.update(tf.leaf_bytes(leaf))
    return h.hexdigest()[:32]


def _kernel_bf16_model(bits: torch.Tensor) -> torch.Tensor:
    """The kernel's bf16 route in plain PyTorch: the table entry at the
    7-bit index of the draw's 32 bits, as bf16."""
    table = cuda_random.bf16_normal_table()
    return table[(bits >> 1) & 0x7F].view(torch.bfloat16)


def test_bf16_route_on_every_16_bit_pattern():
    """The draw keeps the hash's low byte and drops its lowest bit, so
    the 65,536 patterns of the low half reach each index 512 times."""
    bits = torch.arange(1 << 16, dtype=torch.int64)
    want = prng.normal_of_bits(bits & 0xFF, torch.bfloat16)
    got = _kernel_bf16_model(bits)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_bf16_route_on_a_draw(seed):
    key = prng.PRNGKey(seed)
    bits = prng.random_bits(key, 32, (65536,), "cpu")
    want = jax.random.normal(jax.random.PRNGKey(seed), (65536,),
                             jnp.bfloat16)
    got = _kernel_bf16_model(bits)
    assert len(np.unique(np.asarray(want, np.float32))) == 128
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert torch.equal(got.view(torch.int16),
                       prng.normal(key, (65536,), torch.bfloat16,
                                   device="cpu").view(torch.int16))


def test_bf16_table_holds_the_128_values():
    table = cuda_random.bf16_normal_table()
    assert table.dtype == torch.int16 and table.shape == (128,)
    assert table.device.type == "cpu"
    values = table.view(torch.bfloat16).float()
    assert len(torch.unique(values)) == 128
    assert torch.all(values[1:] > values[:-1])   # u rises with the index
    assert cuda_random.bf16_normal_table() is table   # once a process


@pytest.mark.parametrize("path", list(BUILT_BEFORE))
def test_cpu_build_keeps_its_leaves(path):
    """The same leaves as the host draw gave, and as the reference's."""
    tm = tf.build_model("weights", _family(path), path, device="cpu")
    assert _digest(tm) == BUILT_BEFORE[path]
    assert {t.device.type for t in tf.leaves(tm.params)} == {"cpu"}
    jm = jf.build_model("weights", _family(path), path)
    jl = jax.tree.leaves(jm.params)
    assert [np.asarray(a).tobytes() for a in jl] == [
        tf.leaf_bytes(t) for t in tf.leaves(tm.params)]


def test_moe_params_on_the_cpu_are_the_reference_s():
    key, jkey = prng.PRNGKey(5), jax.random.PRNGKey(5)
    got = tmoe.init_moe_params(key, 32, 64, 8, device="cpu")
    want = jmoe.init_moe_params(jkey, 32, 64, 8)
    for name in ("router", "w_in", "w_out"):
        assert np.asarray(want[name]).tobytes() == tf.leaf_bytes(got[name])
    assert got["router"].dtype == torch.float32
    assert got["w_in"].dtype == got["w_out"].dtype == torch.bfloat16


def test_cpu_draws_take_the_plain_route_and_launch_nothing():
    cuda_random.reset_launches()
    tf.build_model("m", "transformer", "transformer://experts=2,layers=1",
                   device="cpu")
    # embed, pos; qkv, proj and the MoE's router and two expert tensors.
    assert cuda_random.plain_draws["threefry_normal"] == 7
    assert all(v == 0 for v in cuda_random.launches.values())


@pytest.mark.parametrize("draw", [
    lambda: tf._draw(prng.PRNGKey(1), (4, 4), CUDA),
    lambda: cuda_random.normal(prng.PRNGKey(1), (4, 4), torch.float32,
                               "cuda"),
    lambda: tmoe.init_moe_params(prng.PRNGKey(1), 8, 16, 2, device=CUDA),
    lambda: tf.build_model("m", "mlp", "mlp://", device=CUDA),
    lambda: tf.build_model("m", "transformer", "transformer://experts=2",
                           device="cuda:0"),
], ids=["_draw", "normal", "init_moe_params", "build_model",
        "build_model_moe"])
def test_a_cuda_device_raises_without_drawing_on_the_host(draw):
    cuda_random.reset_launches()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        draw()
    assert cuda_random.plain_draws["threefry_normal"] == 0
    assert all(v == 0 for v in cuda_random.launches.values())


def test_normal_refuses_other_dtypes_and_devices():
    with pytest.raises(TypeError):
        cuda_random.normal(prng.PRNGKey(1), (2,), torch.float16, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_random.normal(prng.PRNGKey(1), (2,), torch.bfloat16, "meta")


def test_skeleton_is_built_on_the_store_s_device(monkeypatch):
    loader = ts.InProcessTorchLoader(capacity_bytes=1 << 26, device="cpu")
    info = ModelInfo("mlp", "mlp://in=8,hidden=16,depth=1,out=4")
    skeleton = loader._skeleton("s", info)
    assert {t.device for t in tf.leaves(skeleton.params)} == {
        loader.store.device}
    seen = []
    real = ts.build_model

    def recording(*args, **kwargs):
        seen.append((kwargs["device"], kwargs["devices"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(ts, "build_model", recording)
    loader._skeleton("s", info)
    assert seen == [(loader.store.device, loader.store.devices)]


def test_streamed_load_grafts_onto_the_drawn_skeleton():
    """The received bytes replace the drawn leaves, which the skeleton
    gives up."""
    info = ModelInfo("mlp", "mlp://in=8,hidden=16,depth=1,out=4")
    src = ts.InProcessTorchLoader(capacity_bytes=1 << 26, device="cpu")
    handle = src.load("src", info).handle
    handle.params = tf.map_tree(lambda t: t * 2, handle.params)
    dst = ts.InProcessTorchLoader(capacity_bytes=1 << 26, device="cpu")
    skeleton = dst._skeleton("src", info)
    chunks = list(src.export_weights("src", handle))
    params = dst._graft("src", skeleton, ts._by_layer(chunks), "layer")
    assert skeleton.params is None
    assert [tf.leaf_bytes(t) for t in tf.leaves(params)] == [
        tf.leaf_bytes(t) for t in tf.leaves(handle.params)]
