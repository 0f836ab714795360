"""The port's model runtime (``modelmesh_tpu_torch/models/server.py``) and
its copies of the runtime SPI, gRPC definitions and protocol module,
against the JAX package's, on the CPU (``device="cpu"``).

- The store: same-model micro-batches and fused cross-model groups
  against the per-model path, the reference's mixed-architecture and
  missing-model cases, the stacked cache in ``used_bytes`` and under its
  byte budget, the fused/fallback counters.
- The gRPC runtime through the port's own stub, and through the
  reference's ``SidecarRuntime``.
- ``InProcessTorchLoader``: the SPI, weight streaming in both directions
  with ``InProcessJaxLoader`` (leaves byte-identical, logits within the
  families' tolerance), truncated and mismatched streams, shard loads.
- The reference's ``ModelMeshInstance`` serving through the port's
  loader.
- The copies: SPI signatures, the method map, ``shard_chunk_indices``,
  the generated protobuf module byte for byte, the runtime's knobs.

Batched against solo on PyTorch-CPU is not bitwise: a one-row request
runs a matrix-vector product and the same row inside a batch a matrix
product, which sum in another order (measured ≤ 1.8e-7 absolute on these
mlps; the reference's CPU parity holds bit for bit). The store's batches
are held at rtol 1e-5 / atol 1e-6·max|solo|.
"""

import dataclasses
import filecmp
import inspect
import time

import grpc
import jax
import numpy as np
import pytest
import torch

from modelmesh_tpu.kv import InMemoryKV
from modelmesh_tpu.models.server import InProcessJaxLoader
from modelmesh_tpu.proto import mesh_runtime_pb2 as jax_rpb
from modelmesh_tpu.runtime import grpc_defs as jax_grpc_defs
from modelmesh_tpu.runtime import spi as jax_spi
from modelmesh_tpu.runtime.sidecar import SidecarRuntime
from modelmesh_tpu.serving.instance import InstanceConfig, ModelMeshInstance
from modelmesh_tpu.transfer import protocol as jax_protocol
from modelmesh_tpu.utils import envs as jax_envs
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.models import server as ts
from modelmesh_tpu_torch.proto import mesh_runtime_pb2 as rpb
from modelmesh_tpu_torch.runtime import grpc_defs, spi
from modelmesh_tpu_torch.runtime.spi import BatchItem, ModelInfo
from modelmesh_tpu_torch.transfer import protocol
from modelmesh_tpu_torch.utils import envs

MLP = ModelInfo("mlp", "mlp://in=16,hidden=32,out=4,depth=2")
LINEAR = ModelInfo("linear", "linear://in=16,out=4")
TRANSFORMER = ModelInfo("transformer",
                        "transformer://vocab=64,d=32,layers=1,heads=2,seq=8")
CONV = ModelInfo("conv", "conv://size=8,chans=2,width=4,depth=2,classes=3")
EMBEDDING = ModelInfo("embedding", "embedding://vocab=64,dim=8,bag=5,items=6")
BATCH_RTOL, BATCH_ATOL_FRAC = 1e-5, 1e-6
# The families' forward tolerances against the reference
# (tests/test_torch_models.py): f32 products for mlp, bf16 for the rest.
REF_TOL = {"mlp": 1e-5, "linear": 1e-5, "transformer": 1e-2, "conv": 1e-2,
           "embedding": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def loader():
    """The reference batching tests' fixture on the port: three
    same-architecture mlps, a linear, three small transformers."""
    ld = ts.InProcessTorchLoader(capacity_bytes=1 << 30, device="cpu")
    for i in range(3):
        ld.load(f"p-{i}", MLP)
        ld.load(f"t-{i}", TRANSFORMER)
    ld.load("p-linear", LINEAR)
    return ld


def _payloads(counts=(1, 3, 2), width=16, ints=0):
    rng = np.random.default_rng(42)
    if ints:
        return [rng.integers(0, ints, (n, width)).astype(np.int32).tobytes()
                for n in counts]
    return [rng.standard_normal((n, width)).astype(np.float32).tobytes()
            for n in counts]


def _logits(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.float32)


def _assert_batch_close(got: bytes, want: bytes):
    g, w = _logits(got), _logits(want)
    np.testing.assert_allclose(g, w, rtol=BATCH_RTOL,
                               atol=BATCH_ATOL_FRAC * np.abs(w).max())


def _assert_ref_close(got: bytes, want: bytes, family: str):
    g, w = _logits(got), _logits(want)
    tol = REF_TOL[family]
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max())


# -- the store: batching against the per-model path ---------------------------

class TestBatchParity:
    def test_same_model_batch_matches_solo(self, loader):
        pls = _payloads()
        solo = [loader.call_model("p-0", "", p) for p in pls]
        batched = loader.call_model_batch(
            [BatchItem("p-0", payload=p) for p in pls])
        for got, want in zip(batched, solo):
            _assert_batch_close(got, want)

    @pytest.mark.parametrize("prefix,width,ints", [("p", 16, 0),
                                                   ("t", 8, 64)])
    def test_fused_cross_model_matches_solo(self, loader, prefix, width,
                                            ints):
        pls = _payloads(width=width, ints=ints)
        mids = [f"{prefix}-{i}" for i in range(3)]
        solo = [loader.call_model(m, "", p) for m, p in zip(mids, pls)]
        before = (loader.store.fused_dispatches, loader.store.fused_fallbacks)
        batched = loader.call_model_batch(
            [BatchItem(m, payload=p) for m, p in zip(mids, pls)])
        for got, want in zip(batched, solo):
            _assert_batch_close(got, want)
        assert loader.store.fused_dispatches == before[0] + 1
        assert loader.store.fused_fallbacks == before[1]
        keys = {loader.batch_group_key(m) for m in mids}
        assert len(keys) == 1 and next(iter(keys)).startswith("fuse:")

    def test_fused_subset_of_the_group(self, loader):
        """Two of three members batched: the absent one rides zero rows."""
        pls = _payloads((2, 1))
        solo = [loader.call_model(m, "", p)
                for m, p in zip(("p-0", "p-2"), pls)]
        batched = loader.call_model_batch(
            [BatchItem("p-2", payload=pls[1]),
             BatchItem("p-0", payload=pls[0])])
        _assert_batch_close(batched[0], solo[1])
        _assert_batch_close(batched[1], solo[0])

    def test_mixed_architecture_falls_back_per_model(self, loader):
        pls = _payloads((2, 2))
        before = loader.store.fused_dispatches
        batched = loader.call_model_batch([
            BatchItem("p-0", payload=pls[0]),
            BatchItem("p-linear", payload=pls[1]),
        ])
        assert batched[0] == loader.call_model("p-0", "", pls[0])
        assert batched[1] == loader.call_model("p-linear", "", pls[1])
        assert loader.store.fused_dispatches == before
        assert (loader.batch_group_key("p-0")
                != loader.batch_group_key("p-linear"))

    def test_missing_model_isolated_in_batch(self, loader):
        pls = _payloads((1, 1))
        out = loader.call_model_batch([
            BatchItem("no-such-model", payload=pls[0]),
            BatchItem("p-0", payload=pls[1]),
        ])
        assert isinstance(out[0], spi.ModelNotLoadedError)
        assert out[1] == loader.call_model("p-0", "", pls[1])

    def test_stacked_cache_counted_in_used_bytes(self, loader):
        base = sum(m.size_bytes for m in loader.store._models.values())
        pls = _payloads()
        loader.call_model_batch(
            [BatchItem(f"p-{i}", payload=pls[i]) for i in range(3)])
        assert loader.store._stacked
        assert loader.store.used_bytes > base

    def test_fused_disabled_keeps_per_model_groups(self, loader):
        loader.store.fused_enabled = False
        try:
            assert loader.batch_group_key("p-0") == "p-0"
        finally:
            loader.store.fused_enabled = True

    def test_batches_match_the_reference(self, loader):
        """The port's fused and row-concatenated outputs against the
        reference's solo calls on the same weights and inputs."""
        jax_loader = InProcessJaxLoader(capacity_bytes=64 << 20)
        for i in range(3):
            jax_loader.load(f"p-{i}", MLP)
        pls = _payloads()
        ours = loader.call_model_batch(
            [BatchItem(f"p-{i}", payload=p) for i, p in enumerate(pls)])
        for i, (got, p) in enumerate(zip(ours, pls)):
            _assert_ref_close(got, jax_loader.call_model(f"p-{i}", "", p),
                              "mlp")


def test_membership_race_falls_back_per_model(monkeypatch):
    """A batched model missing from the stacked group (it raced a
    reinstall) runs per model, counted as a fallback."""
    ld = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    for i in range(2):
        ld.load(f"p-{i}", MLP)
    stale = ld.store._full_group_stack(ld.store.get("p-0").fuse_key)
    ld.store.install("p-1", ts.build_model("p-1", MLP.model_type,
                                           MLP.model_path, device="cpu"))
    monkeypatch.setattr(ld.store, "_full_group_stack", lambda key: stale)
    pls = _payloads((1, 2))
    out = ld.call_model_batch([BatchItem(f"p-{i}", payload=p)
                               for i, p in enumerate(pls)])
    assert ld.store.fused_fallbacks == 1 and ld.store.fused_dispatches == 0
    for i, (got, p) in enumerate(zip(out, pls)):
        _assert_batch_close(got, ld.call_model(f"p-{i}", "", p))


def test_stack_over_budget_is_used_once_and_not_cached():
    mlp_bytes = ts.build_model("x", MLP.model_type, MLP.model_path,
                               device="cpu").size_bytes
    ld = ts.InProcessTorchLoader(capacity_bytes=3 * mlp_bytes, device="cpu")
    for i in range(2):
        ld.load(f"p-{i}", MLP)
    pls = _payloads((1, 1))
    ld.call_model_batch([BatchItem(f"p-{i}", payload=p)
                         for i, p in enumerate(pls)])
    assert ld.store.fused_dispatches == 1
    assert ld.store._stacked == {}
    assert ld.store.used_bytes == 2 * mlp_bytes


def test_stack_cache_bound_and_invalidation(monkeypatch):
    monkeypatch.setattr(ts.TorchModelStore, "_MAX_STACKED", 1)
    ld = ts.InProcessTorchLoader(capacity_bytes=1 << 30, device="cpu")
    for i in range(2):
        ld.load(f"p-{i}", MLP)
        ld.load(f"t-{i}", TRANSFORMER)
    ld.call_model_batch([BatchItem(f"p-{i}", payload=p)
                         for i, p in enumerate(_payloads((1, 1)))])
    ld.call_model_batch([BatchItem(f"t-{i}", payload=p) for i, p in
                         enumerate(_payloads((1, 1), width=8, ints=64))])
    assert list(ld.store._stacked) == [ld.store.get("t-0").fuse_key]
    ld.unload("t-1")
    assert ld.store._stacked == {}


def test_row_bucket():
    assert [ts.TorchModelStore._row_bucket(n) for n in (1, 2, 3, 5, 8, 9)] \
        == [1, 2, 4, 8, 8, 16]


def test_device_none_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.TorchModelStore(1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.InProcessTorchLoader()


# -- the gRPC runtime ------------------------------------------------------

@pytest.fixture(scope="module")
def runtime():
    server, port, servicer = ts.start_torch_runtime(
        capacity_bytes=64 << 20, device="cpu")
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        yield port, servicer, channel
    finally:
        channel.close()
        server.stop(0)


def test_runtime_over_the_port_stub(runtime):
    port, servicer, channel = runtime
    stub = grpc_defs.make_stub(channel, grpc_defs.RUNTIME_SERVICE,
                               grpc_defs.RUNTIME_METHODS)
    status = stub.RuntimeStatus(rpb.RuntimeStatusRequest(), timeout=10)
    assert status.status == rpb.RuntimeStatusResponse.READY
    assert status.capacity_bytes == 64 << 20
    assert status.runtime_version == "torch-runtime/cpu"
    assert status.device_memory_bytes == 0
    info = rpb.ModelInfo(model_type="mlp", model_path=MLP.model_path)
    size = stub.LoadModel(rpb.LoadModelRequest(model_id="g1", info=info),
                          timeout=30).size_bytes
    assert size == servicer.store.get("g1").size_bytes
    assert stub.ModelSize(rpb.ModelSizeRequest(model_id="g1")).size_bytes \
        == size
    assert stub.PredictModelSize(rpb.PredictModelSizeRequest(
        model_id="g1", info=info)).size_bytes == ts.predict_size_estimate(
            "mlp", MLP.model_path)
    predict = grpc_defs.raw_method(channel, ts.PREDICT_METHOD)
    x = np.ones((2, 16), np.float32).tobytes()
    out = predict(x, metadata=((grpc_defs.MODEL_ID_HEADER, "g1"),),
                  timeout=30)
    assert out == servicer.store.get("g1").predict_bytes(x)
    stub.UnloadModel(rpb.UnloadModelRequest(model_id="g1"))
    assert servicer.store.get("g1") is None
    with pytest.raises(grpc.RpcError) as err:
        predict(x, metadata=((grpc_defs.MODEL_ID_HEADER, "g1"),), timeout=10)
    assert err.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as err:
        stub.LoadModel(rpb.LoadModelRequest(
            model_id="bad", info=rpb.ModelInfo(model_type="resnet")))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_reference_sidecar_drives_the_port_runtime(runtime):
    """The serving core's ``--runtime sidecar:`` client, unchanged."""
    from modelmesh_tpu.models.server import PREDICT_METHOD
    from modelmesh_tpu.runtime import ModelInfo as JaxModelInfo

    port, servicer, _ = runtime
    sidecar = SidecarRuntime(f"127.0.0.1:{port}", startup_timeout_s=10)
    try:
        params = sidecar.startup()
        assert params.capacity_bytes == 64 << 20
        loaded = sidecar.load(
            "mx", JaxModelInfo("mlp", "mlp://in=8,hidden=16,out=2,seed=3"))
        assert loaded.size_bytes == servicer.store.get("mx").size_bytes
        out = sidecar.call_model("mx", PREDICT_METHOD,
                                 np.ones((2, 8), np.float32).tobytes())
        assert _logits(out).shape == (4,)
        sidecar.unload("mx")
        assert servicer.store.get("mx") is None
    finally:
        sidecar.close()


# -- the in-process loader -------------------------------------------------

def test_loader_spi_round_trip():
    ld = ts.InProcessTorchLoader(capacity_bytes=32 << 20, device="cpu")
    params = ld.startup()
    assert params.capacity_bytes == 32 << 20 and params.load_concurrency == 4
    loaded = ld.load("c", CONV)
    assert loaded.size_bytes == loaded.handle.size_bytes
    assert ld.model_size("c", loaded.handle) == loaded.size_bytes
    assert ld.model_size("c", None) == loaded.size_bytes
    assert ld.predict_size("c", CONV) == ts.predict_size_estimate(
        CONV.model_type, CONV.model_path)
    assert ld.supports_batched_dispatch and ld.supports_weight_streaming
    assert ld.supports_sharded_execution and ld.requires_unload
    # conv is not layer-streamable: it batches on its own.
    assert ld.batch_group_key("c") == "c"
    ld.unload("c")
    ld.unload("c")   # idempotent
    with pytest.raises(spi.ModelNotLoadedError):
        ld.call_model("c", "", b"")
    with pytest.raises(spi.ModelLoadException, match="unknown model family"):
        ld.load("r", ModelInfo("resnet", "resnet://"))
    # A spec error of an MoE transformer fails the load the same way.
    with pytest.raises(spi.ModelLoadException, match="groups=3 must divide"):
        ld.load("moe", ModelInfo("transformer",
                                 "transformer://seq=8,experts=4,groups=3"))


def _stream_bytes(chunks) -> dict:
    by_layer = {}
    for c in chunks:
        by_layer.setdefault(c.layer, []).append(c.payload)
    return {k: b"".join(v) for k, v in by_layer.items()}


@pytest.mark.parametrize("info", [MLP, TRANSFORMER, CONV, EMBEDDING],
                         ids=lambda i: i.model_type)
def test_weights_stream_jax_to_torch_and_back(info, monkeypatch):
    """A stream exported by the reference loads into the port, and the
    port's export loads into the reference: leaves byte-identical, logits
    within the family's tolerance. Chunks of 256 bytes split large
    leaves."""
    monkeypatch.setenv("MM_TRANSFER_CHUNK_BYTES", "256")
    jl = InProcessJaxLoader(capacity_bytes=64 << 20)
    tl = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    jax_info = jax_spi.ModelInfo(info.model_type, info.model_path)
    # Weights that no deterministic build gives: the stream, not the
    # skeleton, must carry them.
    src = jl.load("src", jax_info).handle
    src.params = jax.tree.map(lambda a: a * 2, src.params)
    jax_chunks = list(jl.export_weights("src", src))
    assert len(jax_chunks) > len(jax.tree.leaves(src.params))
    got = tl.load_from_stream("src", info, iter(jax_chunks)).handle
    assert [tf.leaf_bytes(t) for t in tf.leaves(got.params)] == [
        np.asarray(a).tobytes() for a in jax.tree.leaves(src.params)]
    assert got.fuse_key == tf.fuse_key_for(tf.ModelSpec.parse(
        info.model_type, info.model_path))
    model = tf.build_model("src", info.model_type, info.model_path,
                           device="cpu")
    x = np.zeros((2, *model.input_shape), model.input_dtype)
    x.flat[::3] = 1
    _assert_ref_close(tl.call_model("src", "", x.tobytes()),
                      jl.call_model("src", "", x.tobytes()), info.model_type)
    torch_chunks = list(tl.export_weights("src", None))
    assert _stream_bytes(torch_chunks) == _stream_bytes(jax_chunks)
    assert [c.seq for c in torch_chunks] == list(range(len(torch_chunks)))
    assert [c.last for c in torch_chunks].count(True) == 1
    assert torch_chunks[-1].last
    back = InProcessJaxLoader(capacity_bytes=64 << 20)
    back.load_from_stream("src", jax_info, iter(torch_chunks))
    assert [np.asarray(a).tobytes() for a in
            jax.tree.leaves(back.store.get("src").params)] == [
        np.asarray(a).tobytes() for a in jax.tree.leaves(src.params)]


def test_truncated_or_mismatched_stream_fails_the_load():
    tl = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    tl.load("m", MLP)
    chunks = list(tl.export_weights("m", None))
    with pytest.raises(spi.ModelLoadException, match="layers"):
        tl.load_from_stream("n", MLP, iter(chunks[:-1]))
    cut = chunks[:-1] + [dataclasses.replace(
        chunks[-1], payload=chunks[-1].payload[:-2])]
    with pytest.raises(spi.ModelLoadException, match="byte length"):
        tl.load_from_stream("n", MLP, iter(cut))
    with pytest.raises(spi.ModelLoadException, match="unknown"):
        tl.load_from_stream("n", ModelInfo("nope", "nope://"), iter(chunks))
    assert tl.store.get("n") is None

    def dying():
        yield chunks[0]
        raise ConnectionError("peer died")

    with pytest.raises(ConnectionError):
        tl.load_from_stream("n", MLP, dying())


def test_shard_load_export_and_stream():
    """One device: the full parameters stay on it, the loader reports the
    shard's share, and a shard's stream carries its leaf range only."""
    tl = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    loaded = tl.load_shard("s", TRANSFORMER, 1, 3)
    total = loaded.handle.size_bytes
    assert loaded.size_bytes == -(-total // 3)
    assert loaded.handle.fuse_key == ""
    assert tl.batch_group_key("s") == "s"
    n_leaves = len(tf.leaves(loaded.handle.params))
    chunks = list(tl.export_shard_weights("s", None))
    assert {c.layer for c in chunks} == set(
        protocol.shard_chunk_indices(n_leaves, 1, 3))
    other = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    got = other.load_shard_from_stream("s", TRANSFORMER, 1, 3, iter(chunks))
    assert got.size_bytes == loaded.size_bytes
    assert [tf.leaf_bytes(t) for t in tf.leaves(got.handle.params)] == [
        tf.leaf_bytes(t) for t in tf.leaves(loaded.handle.params)]
    with pytest.raises(spi.ModelLoadException, match="shard 0/3"):
        other.load_shard_from_stream("s", TRANSFORMER, 0, 3, iter(chunks))
    with pytest.raises(spi.ModelLoadException, match="not sharded"):
        tl.load_shard("c", CONV, 0, 2)
    assert tl.export_shard_weights("nope", None) is None


# -- the serving core on the port's runtime ---------------------------------

def test_moe_transformer_batches_per_request_bitwise():
    """``tests/test_batching.py``'s MoE case on the port's loader: MoE
    routing couples the rows of a batch (capacity per token group), so
    the store runs each request alone inside a batch, never fused, and
    the results equal solo calls bit for bit."""
    moe = ModelInfo(
        "transformer",
        "transformer://vocab=64,d=32,layers=1,heads=2,seq=8,experts=4")
    ld = ts.InProcessTorchLoader(capacity_bytes=1 << 28, device="cpu")
    ld.load("p-moe-a", moe)
    ld.load("p-moe-b", moe)
    assert ld.store.get("p-moe-a").batch_safe is False
    assert ld.batch_group_key("p-moe-a") == "p-moe-a"
    pls = _payloads((1, 3, 2), width=8, ints=64)
    sequential = [ld.call_model("p-moe-a", "", p) for p in pls]
    batched = ld.call_model_batch(
        [BatchItem("p-moe-a", payload=p) for p in pls])
    assert batched == sequential
    out = ld.call_model_batch([BatchItem("p-moe-a", payload=pls[0]),
                               BatchItem("p-moe-b", payload=pls[1])])
    assert out[0] == ld.call_model("p-moe-a", "", pls[0])
    assert out[1] == ld.call_model("p-moe-b", "", pls[1])
    assert ld.store.fused_dispatches == 0


def test_instance_with_inprocess_torch_loader():
    """``tests/test_models.py``'s mesh-instance case, on the port's
    loader: register and invoke an mlp and a transformer."""
    from modelmesh_tpu.models.server import PREDICT_METHOD
    from modelmesh_tpu.runtime import ModelInfo as JaxModelInfo

    store = InMemoryKV(sweep_interval_s=0.05)
    inst = ModelMeshInstance(
        store,
        ts.InProcessTorchLoader(capacity_bytes=32 << 20, device="cpu"),
        InstanceConfig(instance_id="i-torch", load_timeout_s=30,
                       min_churn_age_ms=0),
    )
    try:
        inst.register_model(
            "clf", JaxModelInfo("mlp", "mlp://in=16,hidden=32,out=4,seed=1"))
        x = np.zeros((1, 16), np.float32)
        res = inst.invoke_model("clf", PREDICT_METHOD, x.tobytes(), [])
        assert _logits(res.payload).shape == (4,)
        assert inst.get_status("clf")[0] == "LOADED"
        assert inst.registry.get("clf").size_units > 0
        inst.register_model("lm", JaxModelInfo(
            "transformer",
            "transformer://vocab=32,d=16,layers=1,heads=2,seq=4"))
        toks = np.zeros((1, 4), np.int32)
        res2 = inst.invoke_model("lm", PREDICT_METHOD, toks.tobytes(), [])
        assert _logits(res2.payload).shape == (32,)
    finally:
        inst.shutdown()
        store.close()


# -- the copies ---------------------------------------------------------------

SPI_CLASSES = ["ModelInfo", "LocalInstanceParams", "BatchItem",
               "WeightChunk", "LoadedModel"]
LOADER_METHODS = [
    name for name, _ in inspect.getmembers(jax_spi.ModelLoader)
    if not name.startswith("_")
]


@pytest.mark.parametrize("cls", SPI_CLASSES)
def test_spi_dataclasses_match_reference(cls):
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(spi, cls))]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(getattr(jax_spi, cls))]
    assert ours == theirs


@pytest.mark.parametrize("name", LOADER_METHODS)
def test_loader_spi_signatures_match_reference(name):
    ours, theirs = (getattr(mod.ModelLoader, name) for mod in (spi, jax_spi))
    if isinstance(theirs, property):
        assert isinstance(ours, property)
        ours, theirs = ours.fget, theirs.fget
    assert str(inspect.signature(ours)) == str(inspect.signature(theirs))
    assert getattr(ours, "__isabstractmethod__", False) == getattr(
        theirs, "__isabstractmethod__", False)


@pytest.mark.parametrize("name", LOADER_METHODS)
def test_torch_loader_signatures_match_jax_loader(name):
    ours = getattr(ts.InProcessTorchLoader, name)
    theirs = getattr(InProcessJaxLoader, name)
    if isinstance(theirs, property):
        assert isinstance(ours, property)
        return
    assert str(inspect.signature(ours)) == str(inspect.signature(theirs))


def test_spi_constants_and_exceptions():
    assert spi.CACHE_UNIT_BYTES == jax_spi.CACHE_UNIT_BYTES
    e = spi.ModelLoadException("x", timeout=True)
    assert e.timeout and str(e) == "x"
    assert spi.LocalInstanceParams(1 << 20).capacity_units == (
        jax_spi.LocalInstanceParams(1 << 20).capacity_units)


def test_grpc_defs_match_reference():
    assert grpc_defs.MODEL_ID_HEADER == jax_grpc_defs.MODEL_ID_HEADER
    assert grpc_defs.RUNTIME_SERVICE == jax_grpc_defs.RUNTIME_SERVICE
    ours = {k: tuple(c.DESCRIPTOR.full_name for c in v)
            for k, v in grpc_defs.RUNTIME_METHODS.items()}
    theirs = {k: tuple(c.DESCRIPTOR.full_name for c in v)
              for k, v in jax_grpc_defs.RUNTIME_METHODS.items()}
    assert ours == theirs
    for name in ("make_stub", "add_servicer", "raw_method", "bind_server"):
        assert str(inspect.signature(getattr(grpc_defs, name))) == str(
            inspect.signature(getattr(jax_grpc_defs, name)))


def test_runtime_proto_is_the_reference_module():
    """Byte for byte, so both register one descriptor in one process, and
    a message from either parses as the other."""
    assert filecmp.cmp(rpb.__file__, jax_rpb.__file__, shallow=False)
    msg = rpb.LoadModelRequest(model_id="a", info=rpb.ModelInfo(
        model_type="mlp", model_path="mlp://"))
    back = jax_rpb.LoadModelRequest.FromString(msg.SerializeToString())
    assert back.info.model_path == "mlp://"


@pytest.mark.parametrize("total", [0, 1, 7, 12])
@pytest.mark.parametrize("count", [0, 1, 3, 5])
def test_shard_chunk_indices_match_reference(total, count):
    for index in range(max(count, 1)):
        assert protocol.shard_chunk_indices(total, index, count) == (
            jax_protocol.shard_chunk_indices(total, index, count))


@pytest.mark.parametrize("name", ["MM_FUSED_DISPATCH",
                                  "MM_TRANSFER_CHUNK_BYTES",
                                  "MM_MAX_MSG_BYTES"])
def test_runtime_knobs_have_reference_defaults(name):
    assert envs.REGISTRY[name].default == jax_envs.REGISTRY[name].default
    assert envs.REGISTRY[name].kind == jax_envs.REGISTRY[name].kind


def test_fused_dispatch_knob(monkeypatch):
    monkeypatch.setenv("MM_FUSED_DISPATCH", "off")
    assert not ts.TorchModelStore(1 << 20, device="cpu").fused_enabled
    monkeypatch.setenv("MM_FUSED_DISPATCH", "maybe")
    with pytest.raises(ValueError, match="not a boolean"):
        ts.TorchModelStore(1 << 20, device="cpu")


def test_load_is_idempotent_and_warm():
    st = ts.TorchModelStore(64 << 20, device="cpu")
    t0 = time.perf_counter()
    size = st.load("e", EMBEDDING.model_type, EMBEDDING.model_path)
    assert time.perf_counter() - t0 < 30
    first = st.get("e")
    assert st.load("e", EMBEDDING.model_type, EMBEDDING.model_path) == size
    assert st.get("e") is first
    assert st.used_bytes == size
