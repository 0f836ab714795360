"""The port's weight-transfer subsystem (``modelmesh_tpu_torch/transfer/``)
against the JAX package's, on the CPU.

- ``model_fingerprint``/``shard_fingerprint`` and ``snapshot_reply``
  byte for byte the reference's (each ``TransferSnapshot`` built under its
  package's ``VirtualClock``), ``is_layer_streamable``'s answers and its
  static mirror of the families' declaration.
- ``tests/test_transfer.py``'s fleet cases on both packages, each with
  its own copy of that file's stub streaming loader and peers called
  directly: the second copy streams from the loaded peer, peer fetch off
  uses the store, a sender dying mid-stream falls back to the store, an
  evicted copy demotes into the host tier and re-warms from it, the
  fetch surface's replies. Load counts, registry placements and replies
  are equal across packages.
- Two port instances in front of ``InProcessTorchLoader(device="cpu")``:
  a second copy streamed from the peer holds leaves byte for byte those
  of a store load, and answers as the first copy does.
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

import modelmesh_tpu.kv.memory as ref_memory
import modelmesh_tpu.runtime.spi as ref_spi
import modelmesh_tpu.serving.entry as ref_entry
import modelmesh_tpu.serving.errors as ref_errors
import modelmesh_tpu.serving.instance as ref_instance
import modelmesh_tpu.transfer.protocol as ref_protocol
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.kv.memory as port_memory
import modelmesh_tpu_torch.runtime.spi as port_spi
import modelmesh_tpu_torch.serving.entry as port_entry
import modelmesh_tpu_torch.serving.errors as port_errors
import modelmesh_tpu_torch.serving.instance as port_instance
import modelmesh_tpu_torch.transfer.protocol as port_protocol
import modelmesh_tpu_torch.utils.clock as port_clock
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.models import server as ts
from modelmesh_tpu_torch.observability.metrics import Metric, NoopMetrics

REF = types.SimpleNamespace(memory=ref_memory, spi=ref_spi, entry=ref_entry,
                            errors=ref_errors, instance=ref_instance,
                            protocol=ref_protocol, clock=ref_clock)
PORT = types.SimpleNamespace(memory=port_memory, spi=port_spi,
                             entry=port_entry, errors=port_errors,
                             instance=port_instance, protocol=port_protocol,
                             clock=port_clock)
MODEL_BYTES = 64 * 1024
CHUNKS = 8
WAIT_S = 10.0
INFOS = [("example", "mem://m", ""), ("mlp", "mlp://in=8,out=4", ""),
         ("transformer", "transformer://d=32", "k1"), ("", "", "")]


def _wait(pred, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


@pytest.mark.parametrize("info", INFOS)
def test_fingerprints_match_reference(info):
    r, p = ref_spi.ModelInfo(*info), port_spi.ModelInfo(*info)
    assert (port_protocol.model_fingerprint(p)
            == ref_protocol.model_fingerprint(r))
    for idx, count in ((0, 2), (1, 2), (3, 8)):
        assert (port_protocol.shard_fingerprint(p, idx, count)
                == ref_protocol.shard_fingerprint(r, idx, count))


def _snapshot(pkg, chunks, info):
    with pkg.clock.installed(pkg.clock.VirtualClock()):
        return pkg.protocol.TransferSnapshot.build(
            "m", pkg.spi.ModelInfo(*info),
            [pkg.spi.WeightChunk(seq=c.seq, payload=c.payload, layer=c.layer,
                                 last=c.last) for c in chunks],
            total_bytes=12345)


def test_snapshot_reply_matches_reference(monkeypatch):
    """Snapshots of the port loader's export of an mlp (256-byte chunks):
    every reply, in range and out, with the right, a wrong and no
    fingerprint, and for no snapshot, field for field the reference's."""
    monkeypatch.setenv("MM_TRANSFER_CHUNK_BYTES", "256")
    ld = ts.InProcessTorchLoader(capacity_bytes=64 << 20, device="cpu")
    info = ("mlp", "mlp://in=16,hidden=32,out=4,depth=2", "")
    ld.load("m", port_spi.ModelInfo(*info))
    chunks = list(ld.export_weights("m", None))
    assert len(chunks) > 4
    snaps = {side: _snapshot(pkg, chunks, info)
             for side, pkg in (("ref", REF), ("port", PORT))}
    assert (dataclasses.astuple(snaps["ref"])[1:]
            == dataclasses.astuple(snaps["port"])[1:])
    fp = snaps["port"].fingerprint
    for idx in range(-1, len(chunks) + 2):
        for f in (fp, "", "0" * 16):
            got = [dataclasses.asdict(side.protocol.snapshot_reply(
                snaps[name], idx, f))
                for name, side in (("ref", REF), ("port", PORT))]
            assert got[0] == got[1]
    assert (dataclasses.asdict(port_protocol.snapshot_reply(None, 0, fp))
            == dataclasses.asdict(ref_protocol.snapshot_reply(None, 0, fp)))
    assert port_protocol.FETCH_OK == ref_protocol.FETCH_OK
    assert (port_protocol.FETCH_NOT_AVAILABLE
            == ref_protocol.FETCH_NOT_AVAILABLE)


@pytest.mark.parametrize("spec", [
    ("mlp", "mlp://in=4"), ("transformer", "transformer://"),
    ("conv", "conv://"), ("embedding", ""), ("x", "mlp://"),
    ("transformer", ""), ("linear", "transformer-ish"),
])
def test_streamability_matches_reference(spec):
    assert (port_protocol.is_layer_streamable(*spec)
            == ref_protocol.is_layer_streamable(*spec))


def test_static_mirror_is_the_families_declaration():
    assert port_protocol._FALLBACK_STREAMABLE == tf.LAYER_STREAMABLE_FAMILIES


def _stream_loader(pkg, load_s: float = 0.0):
    """tests/test_transfer.py's ``_StreamLoader`` on ``pkg``'s SPI."""
    spi = pkg.spi

    class StreamLoader(spi.ModelLoader):
        def __init__(self):
            self.loaded: dict = {}
            self.store_loads = 0
            self.stream_loads = 0
            self._lock = threading.Lock()

        def startup(self):
            return spi.LocalInstanceParams(
                capacity_bytes=1 << 24, load_timeout_ms=30_000,
                default_model_size_bytes=MODEL_BYTES)

        def load(self, model_id, info):
            if load_s:
                time.sleep(load_s)
            with self._lock:
                self.loaded[model_id] = MODEL_BYTES
                self.store_loads += 1
            return spi.LoadedModel(handle=model_id, size_bytes=MODEL_BYTES)

        def predict_size(self, model_id, info):
            return MODEL_BYTES

        def unload(self, model_id):
            with self._lock:
                self.loaded.pop(model_id, None)

        @property
        def requires_unload(self):
            return False

        @property
        def supports_weight_streaming(self):
            return True

        def export_weights(self, model_id, handle):
            with self._lock:
                if model_id not in self.loaded:
                    return None
            payload = b"w" * (MODEL_BYTES // CHUNKS)
            return iter([spi.WeightChunk(seq=i, payload=payload, layer=i,
                                         last=i == CHUNKS - 1)
                         for i in range(CHUNKS)])

        def load_from_stream(self, model_id, info, chunks,
                             partial_ready=None):
            n = sum(1 for _ in chunks)
            if n == 0:
                raise spi.ModelLoadException(f"{model_id}: empty stream")
            with self._lock:
                self.loaded[model_id] = MODEL_BYTES
                self.stream_loads += 1
            return spi.LoadedModel(handle=model_id, size_bytes=MODEL_BYTES)

    return StreamLoader()


def _fleet(pkg, n, kv, loaders, **cfg):
    """tests/test_transfer.py's ``_fleet``: direct-call peers and fetches."""
    by_endpoint: dict = {}

    def peer_call(endpoint, model_id, method, payload, headers, ctx):
        inst = by_endpoint.get(endpoint)
        if inst is None:
            raise pkg.errors.ServiceUnavailableError(endpoint)
        return inst.invoke_model(model_id, method, payload, headers, ctx,
                                 sync=True)

    def peer_fetch(endpoint, model_id, chunk_index, fingerprint):
        inst = by_endpoint.get(endpoint)
        if inst is None:
            raise pkg.errors.ServiceUnavailableError(endpoint)
        return inst.handle_weight_fetch(model_id, chunk_index, fingerprint)

    insts = []
    try:
        for i in range(n):
            inst = pkg.instance.ModelMeshInstance(
                kv, loaders[i],
                pkg.instance.InstanceConfig(
                    instance_id=f"t-{i}", endpoint=f"ep-{i}",
                    load_timeout_s=30, min_churn_age_ms=0,
                    publish_coalesce_ms=0, **cfg),
                peer_call=peer_call, peer_fetch=peer_fetch,
                runtime_call=(lambda ce, method, payload, headers,
                              cancel_event=None: payload))
            by_endpoint[inst.config.endpoint] = inst
            insts.append(inst)
        for inst in insts:
            inst.instances_view.wait_for(lambda v: len(v) >= n, timeout=30)
    except BaseException:
        for inst in insts:
            inst.shutdown()
        raise
    return insts


def _run_fleet(pkg, n, scenario, load_s=0.0, **cfg):
    kv = pkg.memory.InMemoryKV(sweep_interval_s=3600.0)
    loaders = [_stream_loader(pkg, load_s) for _ in range(n)]
    insts = []
    try:
        insts = _fleet(pkg, n, kv, loaders, **cfg)
        return scenario(pkg, insts, loaders)
    finally:
        for inst in insts:
            inst.shutdown()
        kv.close()


def _both(n, scenario, **kw):
    ref = _run_fleet(REF, n, scenario, **kw)
    port = _run_fleet(PORT, n, scenario, **kw)
    assert ref == port
    return port


def _counts(loaders):
    return [(ld.store_loads, ld.stream_loads) for ld in loaders]


def _info(pkg):
    return pkg.spi.ModelInfo(model_type="example", model_path="mem://m")


def _second_copy(pkg, insts, loaders):
    a = insts[0]
    a.register_model("m1", _info(pkg))
    a.ensure_loaded("m1", sync=True)
    first = _counts(loaders)
    a.ensure_loaded("m1", sync=True, exclude={"t-0"})
    mr = a.registry.get("m1")
    return (first, _counts(loaders), sorted(mr.instance_ids),
            a.host_tier.peek("m1") is not None)


def test_second_copy_streams_from_loaded_peer():
    first, counts, holders, snapshot = _both(3, _second_copy, load_s=0.05)
    assert first == [(1, 0), (0, 0), (0, 0)]
    assert sum(c[0] for c in counts) == 1 and sum(c[1] for c in counts) == 1
    assert len(holders) == 2 and snapshot


def _fetch_off(pkg, insts, loaders):
    a = insts[0]
    a.register_model("m2", _info(pkg))
    a.ensure_loaded("m2", sync=True)
    a.ensure_loaded("m2", sync=True, exclude={"t-0"})
    return _counts(loaders)


def test_peer_fetch_disabled_uses_store():
    counts = _both(2, _fetch_off, peer_fetch=False)
    assert counts == [(1, 0), (1, 0)]


def _sender_death(pkg, insts, loaders):
    a, b = insts
    inner = b.peer_fetch_transport
    fetched = []

    def dying_fetch(endpoint, model_id, chunk_index, fingerprint):
        fetched.append(chunk_index)
        if chunk_index >= 2:
            raise pkg.errors.ServiceUnavailableError(endpoint)
        return inner(endpoint, model_id, chunk_index, fingerprint)

    b.peer_fetch_transport = dying_fetch
    a.register_model("m3", _info(pkg))
    a.ensure_loaded("m3", sync=True)
    b.invoke_model("m3", None, b"", [], pkg.instance.RoutingContext(
        hop=pkg.instance.RoutingContext.LOAD_LOCAL_ONLY), sync=True)
    ce = b.cache.get_quietly("m3")
    return fetched, _counts(loaders), ce.state.name


def test_sender_death_mid_stream_falls_back_to_store():
    fetched, counts, state = _both(2, _sender_death)
    assert fetched == [0, 1, 2]
    assert counts == [(1, 0), (1, 0)] and state == "ACTIVE"


def _demote_rewarm(pkg, insts, loaders):
    a = insts[0]
    a.register_model("warm", _info(pkg))
    a.ensure_loaded("warm", sync=True)
    a.cache.set_capacity(1)
    _wait(lambda: a.host_tier.peek("warm") is not None, "the demotion")
    _wait(lambda: "t-0" in a.registry.get("warm").host_instances,
          "the host claim")
    mr = a.registry.get("warm")
    demoted = (sorted(mr.instance_ids), sorted(mr.host_instances),
               a.host_tier.size_of("warm"))
    a.cache.set_capacity(1 << 14)
    a.ensure_loaded("warm", sync=True)
    mr = a.registry.get("warm")
    return (demoted, _counts(loaders), sorted(mr.instance_ids),
            sorted(mr.host_instances))


def test_evict_demotes_and_rewarm_streams_from_host():
    demoted, counts, holders, host = _both(1, _demote_rewarm)
    assert demoted[0] == [] and demoted[1] == ["t-0"]
    assert counts == [(1, 1)] and holders == ["t-0"] and host == []


def _fetch_surface(pkg, insts, loaders):
    a = insts[0]
    info = _info(pkg)
    a.register_model("f1", info)
    a.ensure_loaded("f1", sync=True)
    fp = pkg.protocol.model_fingerprint(info)
    replies = [a.handle_weight_fetch("f1", k, f)
               for k in (0, CHUNKS - 1, CHUNKS) for f in (fp, "0" * 16)]
    replies.append(a.handle_weight_fetch("nope", 0, ""))
    return [dataclasses.asdict(r) for r in replies]


def test_fetch_surface_matches_reference():
    replies = _both(1, _fetch_surface)
    assert replies[0]["status"] == port_protocol.FETCH_OK
    assert replies[0]["total_chunks"] == CHUNKS and replies[2]["last"]
    assert all(r["status"] == port_protocol.FETCH_NOT_AVAILABLE
               for r in replies[1::2] + replies[4:])


class _Counting(NoopMetrics):
    def __init__(self):
        self.counts: dict = {}

    def inc(self, metric, value=1.0, model_id=""):
        self.counts[metric] = self.counts.get(metric, 0) + value


@pytest.mark.parametrize("spec", [
    ("mlp", "mlp://in=16,hidden=32,out=4,depth=2"),
    ("transformer", "transformer://vocab=64,d=32,layers=2,heads=2,seq=8"),
    ("conv", "conv://size=8,chans=2,width=4,depth=2,classes=3"),
])
def test_peer_stream_between_port_instances_is_a_store_load(spec,
                                                            monkeypatch):
    """Two port instances in front of the port's own loader on the CPU:
    the second copy streams from the first (in 512-byte chunks) and its
    leaves are byte for byte a store load's; it answers as the first."""
    monkeypatch.setenv("MM_TRANSFER_CHUNK_BYTES", "512")
    kv = port_memory.InMemoryKV(sweep_interval_s=3600.0)
    loaders = [ts.InProcessTorchLoader(capacity_bytes=64 << 20,
                                       device="cpu") for _ in range(2)]
    metrics = [_Counting(), _Counting()]
    by_endpoint: dict = {}

    def peer_fetch(endpoint, model_id, chunk_index, fingerprint):
        return by_endpoint[endpoint].handle_weight_fetch(
            model_id, chunk_index, fingerprint)

    insts = []
    try:
        for i in range(2):
            inst = port_instance.ModelMeshInstance(
                kv, loaders[i], port_instance.InstanceConfig(
                    instance_id=f"s-{i}", endpoint=f"ep-{i}",
                    load_timeout_s=30, min_churn_age_ms=0,
                    publish_coalesce_ms=0),
                peer_fetch=peer_fetch, metrics=metrics[i])
            by_endpoint[inst.config.endpoint] = inst
            insts.append(inst)
        for inst in insts:
            inst.instances_view.wait_for(lambda v: len(v) >= 2, timeout=30)
        a, b = insts
        a.register_model("w", port_spi.ModelInfo(*spec))
        a.invoke_model("w", None, b"", [], port_instance.RoutingContext(
            hop=port_instance.RoutingContext.LOAD_LOCAL_ONLY), sync=True)
        b.invoke_model("w", None, b"", [], port_instance.RoutingContext(
            hop=port_instance.RoutingContext.LOAD_LOCAL_ONLY), sync=True)
        assert metrics[0].counts.get(Metric.LOAD_FROM_STORE_COUNT) == 1
        assert metrics[1].counts.get(Metric.LOAD_FROM_PEER_COUNT) == 1
        assert Metric.LOAD_FROM_STORE_COUNT not in metrics[1].counts
        got = loaders[1].store.get("w")
        want = tf.build_model("w", spec[0], spec[1], device="cpu")
        assert ([tf.leaf_bytes(t) for t in tf.leaves(got.params)]
                == [tf.leaf_bytes(t) for t in tf.leaves(want.params)])
        x = np.zeros((2, *want.input_shape), want.input_dtype)
        x.flat[::3] = 1
        assert (loaders[1].call_model("w", "", x.tobytes())
                == loaders[0].call_model("w", "", x.tobytes()))
        assert sorted(a.registry.get("w").instance_ids) == ["s-0", "s-1"]
    finally:
        for inst in insts:
            inst.shutdown()
        kv.close()
