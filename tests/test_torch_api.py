"""The port's gRPC surfaces (``modelmesh_tpu_torch/serving/api.py`` with
the fake and sidecar runtimes, vmodels, payload processors, the log
context, the dataplane config and TLS) against the JAX package's, on the
CPU, over real localhost gRPC.

- **The cluster harness.** ``Cluster(pkg, n)`` is ``tests/cluster_util.py``
  built from one package's modules: a ``FakeRuntimeServicer`` behind a
  ``SidecarRuntime`` per pod, a ``MeshServer`` with a ``VModelManager``,
  and ``make_grpc_peer_call``/``make_grpc_peer_fetch`` over one shared
  ``PeerChannels``. ``PORT`` and ``REF`` name each package's modules, so
  one script runs in both. The other ``test_torch_*`` files of the
  serving pod import it from here.
- **``tests/test_cluster.py``'s cases** on a port cluster.
- **Across packages:** a reference client stub against a port
  ``MeshServer`` for every API method and a raw ``Predict``, both
  packages' servers answering the same calls the same way; the port's
  peer transport into a reference server's internal surface; the four
  generated ``pb2`` modules byte for byte, with messages round-tripped
  both ways.
- **The payload processors, the log context and the dataplane config**
  beside the reference's; the in-body model id through the splicer.
- **TLS with mutual authentication** through ``generate_self_signed``.
- **The slice as a whole:** a port cluster in front of
  ``InProcessTorchLoader(device="cpu")`` and a reference cluster in front
  of ``InProcessJaxLoader`` answer the same seeded payloads over gRPC
  within ``tests/test_torch_models.py``'s ``FORWARD_TOL``.
"""

from __future__ import annotations

import dataclasses
import filecmp
import importlib
import json
import logging
import threading
import time
import types
from pathlib import Path

import grpc
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_MODULES = {
    "memory": "kv.memory", "kvconfig": "kv.config", "fake": "runtime.fake",
    "sidecar": "runtime.sidecar", "spi": "runtime.spi",
    "grpc_defs": "runtime.grpc_defs", "api": "serving.api",
    "instance": "serving.instance", "vmodels": "serving.vmodels",
    "tasks": "serving.tasks", "health": "serving.health",
    "bootstrap": "serving.bootstrap", "dynamic": "serving.dynamic",
    "dataplane": "serving.dataplane", "tls": "serving.tls",
    "entry": "serving.entry", "errors": "serving.errors",
    "apb": "proto.mesh_api_pb2", "ipb": "proto.mesh_internal_pb2",
    "tpb": "proto.mesh_transfer_pb2", "rpb": "proto.mesh_runtime_pb2",
    "payloads": "observability.payloads", "logctx": "observability.logctx",
    "controller": "autoscale.controller", "forecast": "autoscale.forecast",
    "splicer": "native.proto_splicer", "records": "records",
    "clock": "utils.clock", "lru": "cache.lru",
}


def _package(root: str):
    return types.SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{v}") for k, v in _MODULES.items()
    })


REF = _package("modelmesh_tpu")
PORT = _package("modelmesh_tpu_torch")
WAIT_S = 20.0


def wait_for(pred, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@dataclasses.dataclass
class Pod:
    instance: object
    server: object
    runtime_server: object
    runtime: object
    loader: object
    vmodels: object

    @property
    def iid(self) -> str:
        return self.instance.instance_id

    def stop(self, hard: bool = False) -> None:
        """``hard`` is a crash: the server vanishes and the lease dies."""
        self.server.stop(0 if hard else 0.5)
        self.vmodels.close()
        if hard:
            self.instance._session.close()
            self.instance.loading_pool.shutdown()
            self.instance._election.close()
        else:
            self.instance.shutdown()
        if self.runtime_server is not None:
            self.runtime_server.stop(0)


class Cluster:
    """``tests/cluster_util.Cluster`` on ``pkg``'s modules. ``loader``
    builds a pod's loader in place of the fake runtime's sidecar;
    ``server_kwargs`` go to every ``MeshServer``."""

    def __init__(self, pkg, n: int = 3, capacity_bytes: int = 64 << 20,
                 kv=None, strategy_factory=None, loader=None,
                 server_kwargs=None, vmodel_sweep_s: float = 0.3,
                 **config_kwargs):
        self.pkg = pkg
        self.kv = kv or pkg.memory.InMemoryKV(sweep_interval_s=0.05)
        self.channels = pkg.api.PeerChannels()
        peer_call = pkg.api.make_grpc_peer_call(self.channels, timeout_s=15.0)
        peer_fetch = pkg.api.make_grpc_peer_fetch(self.channels,
                                                  timeout_s=15.0)
        self.pods: list[Pod] = []
        try:
            for i in range(n):
                rt_server = servicer = None
                if loader is None:
                    rt_server, rt_port, servicer = pkg.fake.start_fake_runtime(
                        servicer=pkg.fake.FakeRuntimeServicer(
                            capacity_bytes=capacity_bytes))
                    ld = pkg.sidecar.SidecarRuntime(f"127.0.0.1:{rt_port}",
                                                    startup_timeout_s=10)
                else:
                    ld = loader()
                cfg = dict(instance_id=f"i-{i}", load_timeout_s=10,
                           space_wait_s=2.0, min_churn_age_ms=0)
                cfg.update(config_kwargs)
                inst = pkg.instance.ModelMeshInstance(
                    self.kv, ld, pkg.instance.InstanceConfig(**cfg),
                    peer_call=peer_call, peer_fetch=peer_fetch,
                    strategy=strategy_factory() if strategy_factory else None,
                )
                vmodels = pkg.vmodels.VModelManager(
                    inst, sweep_interval_s=vmodel_sweep_s)
                server = pkg.api.MeshServer(inst, vmodels=vmodels,
                                            **(server_kwargs or {}))
                inst.config.endpoint = server.endpoint
                inst.publish_instance_record(force=True)
                self.pods.append(
                    Pod(inst, server, rt_server, servicer, ld, vmodels))
            for pod in self.pods:
                pod.instance.instances_view.wait_for(
                    lambda v: len(v) >= n, timeout=10)
        except BaseException:
            self.close()
            raise

    def __getitem__(self, i: int) -> Pod:
        return self.pods[i]

    def pod_with_copy(self, model_id: str):
        for pod in self.pods:
            if pod.instance.cache.get_quietly(model_id) is not None:
                return pod
        return None

    def close(self) -> None:
        for pod in self.pods:
            try:
                pod.stop()
            except Exception:  # noqa: BLE001 — teardown of a failed test
                pass
        self.channels.close()
        self.kv.close()


def api_stub(pkg, endpoint: str):
    ch = grpc.insecure_channel(endpoint)
    return ch, pkg.grpc_defs.make_stub(ch, pkg.grpc_defs.API_SERVICE,
                                       pkg.grpc_defs.API_METHODS)


def client_call(pkg, pod, model_id: str, payload: bytes = b"req",
                header: str = "model", method: str = None) -> bytes:
    """An external inference call through a pod's public endpoint, with
    ``pkg``'s client definitions."""
    gd = pkg.grpc_defs
    key = gd.MODEL_ID_HEADER if header == "model" else gd.VMODEL_ID_HEADER
    ch = grpc.insecure_channel(pod.server.endpoint)
    try:
        call = gd.raw_method(ch, method or pkg.fake.PREDICT_METHOD)
        return call(payload, metadata=[(key, model_id)], timeout=20)
    finally:
        ch.close()


INFO = PORT.spi.ModelInfo(model_type="example", model_path="mem://x")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- tests/test_cluster.py on the port -----------------------------------------


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(PORT, n=3)
    yield c
    c.close()


class TestClusterBasics:
    def test_fleet_visible(self, cluster):
        for pod in cluster.pods:
            assert len(pod.instance.instances_view) == 3
        assert sum(p.instance.is_leader for p in cluster.pods) == 1

    def test_register_anywhere_invoke_anywhere(self, cluster):
        cluster[0].instance.register_model("m-c1", INFO)
        out = client_call(PORT, cluster[2], "m-c1")
        assert out.startswith(b"m-c1:category_")
        assert len(cluster[0].instance.registry.get("m-c1").instance_ids) == 1

    def test_forwarding_to_loaded_copy(self, cluster):
        cluster[0].instance.register_model("m-fwd", INFO)
        res = cluster[0].instance.invoke_model(
            "m-fwd", PORT.fake.PREDICT_METHOD, b"warm", [])
        assert res.served_by == "i-0"
        loads_before = [p.runtime.load_count for p in cluster.pods]
        assert client_call(PORT, cluster[1], "m-fwd").startswith(b"m-fwd:")
        assert [p.runtime.load_count for p in cluster.pods] == loads_before

    def test_ensure_loaded_second_copy(self, cluster):
        inst0 = cluster[0].instance
        inst0.register_model("m-2copy", INFO, load_now=True, sync=True)
        holder = cluster.pod_with_copy("m-2copy")
        inst0.ensure_loaded("m-2copy", sync=True, exclude={holder.iid})
        assert len(inst0.registry.get("m-2copy").instance_ids) == 2

    def test_chained_load_fans_copies_across_fleet(self, cluster):
        inst0 = cluster[0].instance
        inst0.register_model("m-chain", INFO)
        inst0.ensure_loaded("m-chain", sync=True, chain=2)
        wait_for(lambda: len(inst0.registry.get("m-chain").instance_ids) == 3,
                 "three copies of m-chain")

    def test_management_api_over_grpc(self, cluster):
        apb = PORT.apb
        ch, stub = api_stub(PORT, cluster[1].server.endpoint)
        try:
            info = apb.ModelInfo(model_type="example", model_path="mem://g")
            st = stub.RegisterModel(apb.RegisterModelRequest(
                model_id="m-api", info=info, load_now=True, sync=True))
            assert st.status == apb.LOADED
            st2 = stub.GetModelStatus(
                apb.GetModelStatusRequest(model_id="m-api"))
            assert st2.status == apb.LOADED and st2.copy_count == 1
            stub.UnregisterModel(apb.UnregisterModelRequest(model_id="m-api"))
            st3 = stub.GetModelStatus(
                apb.GetModelStatusRequest(model_id="m-api"))
            assert st3.status == apb.NOT_FOUND
        finally:
            ch.close()


class TestWatchDrivenDeletionCleanup:
    def test_unregister_at_peer_unloads_holder_promptly(self, cluster):
        pod = cluster.pods[0]
        pod.instance.register_model("del-watch", INFO, load_now=True,
                                    sync=True)
        holder = next(p for p in cluster.pods
                      if "del-watch" in p.runtime.loaded)
        requester = next(p for p in cluster.pods if p is not holder)
        assert requester.instance.unregister_model("del-watch")
        wait_for(lambda: "del-watch" not in holder.runtime.loaded,
                 "the holder unloading within watch latency", timeout=2.0)
        assert holder.instance.cache.get_quietly("del-watch") is None

    def test_reregistration_racing_delete_survives(self, cluster):
        pod = cluster.pods[0]
        pod.instance.register_model("del-race", INFO, load_now=True,
                                    sync=True)
        holder = next(p for p in cluster.pods
                      if "del-race" in p.runtime.loaded)
        requester = next(p for p in cluster.pods if p is not holder)
        assert requester.instance.unregister_model("del-race")
        pod.instance.register_model("del-race", INFO)
        # The stale delete's cleanup gets its chance to misfire.
        time.sleep(1.0)
        assert pod.instance.get_status("del-race")[0] != "NOT_FOUND"
        out = client_call(PORT, pod, "del-race", b"after-race")
        assert out.startswith(b"del-race:")


class TestFailover:
    def test_crash_failover(self):
        c = Cluster(PORT, n=3)
        try:
            c[0].instance.register_model("m-ha", INFO)
            c[0].instance.invoke_model("m-ha", PORT.fake.PREDICT_METHOD,
                                       b"x", [])
            assert c.pod_with_copy("m-ha").iid == "i-0"
            c[0].stop(hard=True)
            c[1].instance.instances_view.wait_for(
                lambda v: "i-0" not in v, timeout=10)
            assert client_call(PORT, c[1], "m-ha").startswith(b"m-ha:")
            mr = c[1].instance.registry.get("m-ha")
            assert set(mr.instance_ids) - {"i-0"}
        finally:
            c.close()

    def test_graceful_shutdown_migrates(self):
        c = Cluster(PORT, n=2)
        try:
            c[0].instance.register_model("m-mig2", INFO)
            c[0].instance.invoke_model("m-mig2", PORT.fake.PREDICT_METHOD,
                                       b"x", [])
            holder = c.pod_with_copy("m-mig2")
            other = c[1] if holder is c[0] else c[0]
            holder.instance.pre_shutdown(deadline_s=10)
            mr = other.instance.registry.get("m-mig2")
            assert holder.iid not in mr.instance_ids
            assert other.iid in mr.instance_ids
            assert other.instance.cache.get_quietly("m-mig2") is not None
        finally:
            c.close()


# -- across packages -----------------------------------------------------------

PB2 = ["mesh_runtime_pb2", "mesh_api_pb2", "mesh_internal_pb2",
       "mesh_transfer_pb2"]


@pytest.mark.parametrize("name", PB2)
def test_pb2_modules_are_the_references_byte_for_byte(name):
    assert filecmp.cmp(REPO / "modelmesh_tpu" / "proto" / f"{name}.py",
                       REPO / "modelmesh_tpu_torch" / "proto" / f"{name}.py",
                       shallow=False)
    import modelmesh_tpu_torch.proto as port_proto

    assert name in port_proto.__all__


def _sample_messages(pkg) -> list:
    apb, ipb, tpb = pkg.apb, pkg.ipb, pkg.tpb
    return [
        apb.RegisterModelRequest(
            model_id="m-1", load_now=True, sync=True,
            info=apb.ModelInfo(model_type="mlp", model_path="mlp://in=4",
                               model_key="k")),
        apb.ModelStatusInfo(status=apb.LOADING_FAILED, errors=["e1", "e2"],
                            model_id="m-2", copy_count=3),
        apb.SetVModelRequest(vmodel_id="v", target_model_id="t", owner="o",
                             auto_delete_target=True, force=True),
        apb.VModelStatusInfo(active_model_id="a", target_model_id="t",
                             transition=apb.VModelStatusInfo.FAILED),
        ipb.ForwardRequest(model_id="f", method_name="/x/Y", payload=b"\0\1",
                           headers={"k": "v"}, ctx=ipb.RoutingContext(
                               hop=2, exclude_serve=["a"], visited=["b"],
                               dest_instance="c", chain_load_count=1,
                               known_size_bytes=9, last_used_ms=7)),
        tpb.FetchWeightsRequest(model_id="w", chunk_index=3,
                                fingerprint="fp"),
        tpb.FetchWeightsResponse(status=1, payload=b"abc", seq=2, layer=1,
                                 last=True, total_chunks=4, total_bytes=99,
                                 total_layers=2, fingerprint="fp"),
    ]


def test_messages_round_trip_across_packages():
    for port_msg, ref_msg in zip(_sample_messages(PORT),
                                 _sample_messages(REF)):
        wire = port_msg.SerializeToString(deterministic=True)
        assert wire == ref_msg.SerializeToString(deterministic=True)
        assert type(ref_msg).FromString(wire) == ref_msg
        assert type(port_msg).FromString(
            ref_msg.SerializeToString()) == port_msg
        # Each package keeps its own message classes over one descriptor.
        assert type(port_msg).DESCRIPTOR.full_name == \
            type(ref_msg).DESCRIPTOR.full_name


def test_service_maps_match_the_references():
    for attr in ("RUNTIME_SERVICE", "API_SERVICE", "INTERNAL_SERVICE",
                 "MODEL_ID_HEADER", "VMODEL_ID_HEADER"):
        assert getattr(PORT.grpc_defs, attr) == getattr(REF.grpc_defs, attr)
    for attr in ("RUNTIME_METHODS", "API_METHODS", "INTERNAL_METHODS"):
        port_map = getattr(PORT.grpc_defs, attr)
        ref_map = getattr(REF.grpc_defs, attr)
        assert sorted(port_map) == sorted(ref_map)
        for name, (req, resp) in port_map.items():
            assert req.DESCRIPTOR.full_name == \
                ref_map[name][0].DESCRIPTOR.full_name
            assert resp.DESCRIPTOR.full_name == \
                ref_map[name][1].DESCRIPTOR.full_name
    assert PORT.fake.PREDICT_METHOD == REF.fake.PREDICT_METHOD


def _api_script(stub, apb, call):
    """Every API method once, then raw predicts by model and vmodel id;
    returns each answer as a dict (or the status code of an error)."""
    from google.protobuf.json_format import MessageToDict

    def rec(fn, req):
        try:
            return MessageToDict(fn(req, timeout=20),
                                 preserving_proto_field_name=True,
                                 always_print_fields_with_no_presence=True)
        except grpc.RpcError as e:
            return e.code().name

    def settled(fn, req, want, timeout_s=10.0):
        """``rec(fn, req)`` once it answers ``want``, or its answer at the
        deadline. A vmodel's status falls back to the pod's watch-fed view
        when the direct KV read misses, and the view drops a deleted vmodel
        a moment after the delete returns (in both packages)."""
        deadline = time.monotonic() + timeout_s
        while True:
            got = rec(fn, req)
            if got == want or time.monotonic() > deadline:
                return got
            time.sleep(0.02)

    info = apb.ModelInfo(model_type="example", model_path="mem://x")
    out = {}
    out["register"] = rec(stub.RegisterModel, apb.RegisterModelRequest(
        model_id="x-1", info=info, load_now=True, sync=True))
    out["register_bad"] = rec(stub.RegisterModel, apb.RegisterModelRequest(
        model_id="a/b", info=info))
    out["register_2"] = rec(stub.RegisterModel, apb.RegisterModelRequest(
        model_id="x-2", info=info))
    out["status"] = rec(stub.GetModelStatus,
                        apb.GetModelStatusRequest(model_id="x-2"))
    out["ensure"] = rec(stub.EnsureLoaded, apb.EnsureLoadedRequest(
        model_id="x-2", sync=True))
    out["ensure_missing"] = rec(stub.EnsureLoaded, apb.EnsureLoadedRequest(
        model_id="x-none", sync=True))
    out["status_loaded"] = rec(stub.GetModelStatus,
                               apb.GetModelStatusRequest(model_id="x-2"))
    out["predict"] = call("x-1", b"payload-1", "model")
    out["predict_missing"] = call("x-none", b"p", "model")
    out["predict_multi"] = call("x-1,x-2", b"fan-out", "model")
    out["set_vmodel"] = rec(stub.SetVModel, apb.SetVModelRequest(
        vmodel_id="vx", target_model_id="x-3", info=info, load_now=True,
        sync=True, auto_delete_target=True))
    out["predict_vmodel"] = call("vx", b"payload-2", "vmodel")
    out["vmodel_status"] = rec(stub.GetVModelStatus,
                               apb.GetVModelStatusRequest(vmodel_id="vx"))
    out["set_vmodel_update_only"] = rec(stub.SetVModel, apb.SetVModelRequest(
        vmodel_id="vy", target_model_id="y", info=info, update_only=True))
    out["delete_vmodel"] = rec(stub.DeleteVModel,
                               apb.DeleteVModelRequest(vmodel_id="vx"))
    out["vmodel_gone"] = settled(stub.GetVModelStatus,
                                 apb.GetVModelStatusRequest(vmodel_id="vx"),
                                 "NOT_FOUND")
    out["unregister"] = rec(stub.UnregisterModel,
                            apb.UnregisterModelRequest(model_id="x-1"))
    out["status_gone"] = rec(stub.GetModelStatus,
                             apb.GetModelStatusRequest(model_id="x-1"))
    return out


def _serve_script(server_pkg):
    """The script from a REFERENCE client stub against ``server_pkg``'s
    cluster of one."""
    c = Cluster(server_pkg, n=1)
    ch, stub = api_stub(REF, c[0].server.endpoint)

    def call(mid, payload, header):
        try:
            return client_call(REF, c[0], mid, payload, header)
        except grpc.RpcError as e:
            return e.code().name

    try:
        return _api_script(stub, REF.apb, call)
    finally:
        ch.close()
        c.close()


def test_reference_client_against_port_server_every_method():
    port = _serve_script(PORT)
    ref = _serve_script(REF)
    assert port == ref
    assert port["register"]["status"] == "LOADED"
    assert port["register_bad"] == "INVALID_ARGUMENT"
    assert port["predict"].startswith(b"x-1:category_")
    assert port["predict_missing"] == "NOT_FOUND"
    assert port["predict_multi"][4:].startswith(b"x-1:category_")
    assert port["predict_vmodel"].startswith(b"x-3:")
    assert port["set_vmodel_update_only"] == "NOT_FOUND"
    assert port["vmodel_gone"] == "NOT_FOUND"
    assert port["status_gone"]["status"] == "NOT_FOUND"


def test_port_peer_transport_into_a_reference_server():
    """The port's ``make_grpc_peer_call``/``make_grpc_peer_fetch`` dial a
    reference pod's internal surface, and answer what the reference's own
    transport answers."""
    c = Cluster(REF, n=1)
    port_ch, ref_ch = PORT.api.PeerChannels(), REF.api.PeerChannels()
    try:
        c[0].instance.register_model(
            "pf-1", REF.spi.ModelInfo("example", "mem://p"), load_now=True,
            sync=True)
        ep = c[0].server.endpoint
        answers = {}
        for name, pkg, ch in (("port", PORT, port_ch), ("ref", REF, ref_ch)):
            call = pkg.api.make_grpc_peer_call(ch, timeout_s=15.0)
            fetch = pkg.api.make_grpc_peer_fetch(ch, timeout_s=15.0)
            ctx = pkg.instance.RoutingContext(hop=1, dest_instance="i-0")
            res = call(ep, "pf-1", PORT.fake.PREDICT_METHOD, b"fwd", [], ctx)
            try:
                call(ep, "pf-none", PORT.fake.PREDICT_METHOD, b"fwd", [],
                     pkg.instance.RoutingContext(hop=1, dest_instance="i-0"))
                missing = None
            except Exception as e:  # noqa: BLE001 — the outcome compared
                missing = type(e).__name__
            reply = fetch(ep, "pf-1", 0, "")
            answers[name] = dict(
                payload=res.payload, served_by=res.served_by,
                status=res.status, feedback=res.feedback is not None,
                missing=missing, fetch=dataclasses.astuple(reply))
        assert answers["port"] == answers["ref"]
        assert answers["port"]["payload"].startswith(b"pf-1:category_")
        assert answers["port"]["served_by"] == "i-0"
        assert answers["port"]["missing"] == "ModelNotFoundError"
    finally:
        port_ch.close()
        ref_ch.close()
        c.close()


# -- payload processors, log context, dataplane --------------------------------


class _Capture:
    def __init__(self):
        self.seen = []

    def process(self, payload):
        self.seen.append(payload)
        return False

    def close(self):
        pass


def _processor_shape(proc) -> tuple:
    name = type(proc).__name__
    if hasattr(proc, "delegates"):
        return (name, tuple(_processor_shape(d) for d in proc.delegates))
    if hasattr(proc, "delegate"):
        return (name, getattr(proc, "model_id", None),
                getattr(proc, "method", None), _processor_shape(proc.delegate))
    return (name, getattr(proc, "url", None))


@pytest.mark.parametrize("uris", [
    [], ["logger"], ["logger?model=m1"], ["logger?model=m1&method=Predict",
                                          "logger"],
    ["async:http://127.0.0.1:9/p"], ["http://h/x?method=/a/B", "async:logger"],
])
def test_build_processor_matches_reference(uris):
    port = PORT.payloads.build_processor(uris)
    ref = REF.payloads.build_processor(uris)
    try:
        assert (port is None) == (ref is None)
        if port is not None:
            assert _processor_shape(port) == _processor_shape(ref)
    finally:
        for p in (port, ref):
            if p is not None:
                p.close()


def test_build_processor_rejects_unknown_uris():
    for pkg in (PORT, REF):
        with pytest.raises(ValueError):
            pkg.payloads.build_processor(["bogus://x"])


def test_processors_filter_fan_out_and_drop_like_the_reference():
    seen = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        P = pkg.payloads
        a, b = _Capture(), _Capture()
        proc = P.CompositePayloadProcessor([
            P.MatchingPayloadProcessor(a, model_id="m1"),
            P.MatchingPayloadProcessor(b, method="/Predict"),
        ])
        for mid, method in (("m1", "/p/Predict"), ("m2", "/p/Predict"),
                            ("m1", "/p/Other"), ("m3", "/q/Other")):
            proc.process(P.Payload("r", mid, method, "request", b"d"))
        seen[name] = ([(p.model_id, p.method) for p in a.seen],
                      [(p.model_id, p.method) for p in b.seen])
        gate = threading.Event()

        class Slow(P.PayloadProcessor):
            def process(self, p):
                gate.wait(5)
                return False

        slow = P.AsyncPayloadProcessor(Slow(), capacity=2, workers=1)
        took = [slow.process(P.Payload("r", "m", "x", "request", b""))
                for _ in range(10)]
        assert all(took) and slow.dropped > 0
        gate.set()
        slow.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"] == ([("m1", "/p/Predict"), ("m1", "/p/Other")],
                            [("m1", "/p/Predict"), ("m2", "/p/Predict")])


@pytest.mark.parametrize("spec", ["", "x-request-id, x-user=user",
                                  "A;b=B ,c"])
def test_log_context_matches_reference(spec):
    headers = [("X-Request-Id", "r-1"), ("x-user", "alice"), ("a", "1"),
               ("B", "2"), ("other", "ignored"), ("c", "3")]
    got = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        lc = pkg.logctx
        hlc = lc.HeaderLogContext(spec)
        with hlc.bind(headers):
            inside = lc.current()
            rec = logging.LogRecord("t", logging.INFO, "f", 1, "msg", (),
                                    None)
            assert lc.LogContextFilter().filter(rec)
        got[name] = (hlc.mapping, inside, rec.reqctx, lc.current())
    assert got["port"] == got["ref"]
    assert got["port"][3] == {}


def test_log_context_from_env_and_filter_install(monkeypatch):
    monkeypatch.setenv("MM_LOG_REQUEST_HEADERS", "x-txn-id=txn")
    assert PORT.logctx.HeaderLogContext.from_env().mapping == \
        REF.logctx.HeaderLogContext.from_env().mapping == {"x-txn-id": "txn"}
    # The root logger holds only this test's handler meanwhile: a filter
    # left on the test runner's own handlers would stamp every later
    # record of the process.
    root = logging.getLogger()
    saved = root.handlers[:]
    handler = logging.NullHandler()
    root.handlers = [handler]
    try:
        PORT.logctx.install_filter()
        PORT.logctx.install_filter()
        assert sum(isinstance(f, PORT.logctx.LogContextFilter)
                   for f in handler.filters) == 1
    finally:
        root.handlers = saved


def test_dataplane_config_matches_reference():
    text = json.dumps({"rpcs": {
        "/a/Predict": {"idExtractionPath": [1]},
        "/a/Alias": {"idExtractionPath": [2, 1], "vmodel": True},
        "/a/Off": {"allowed": False}}, "allowOtherRpcs": False})
    port = PORT.dataplane.DataplaneApiConfig.from_json(text)
    ref = REF.dataplane.DataplaneApiConfig.from_json(text)
    for method in ("/a/Predict", "/a/Alias", "/a/Off", "/a/Other"):
        assert port.is_allowed(method) == ref.is_allowed(method)
        assert port.extraction_path(method) == ref.extraction_path(method)
        p, r = port.rpc(method), ref.rpc(method)
        assert (p and dataclasses.astuple(p)) == (r and dataclasses.astuple(r))
    empty = PORT.dataplane.DataplaneApiConfig.from_json("")
    assert empty.is_allowed("/x") and empty.extraction_path("/x") == ()


def _dataplane_run(pkg):
    """Requests through a pod with a payload sink and a dataplane config:
    the in-body id (field 1 of the request message) through the splicer,
    a vmodel id in the body, a refused method, and a header id."""
    dp = pkg.dataplane
    method = pkg.fake.PREDICT_METHOD
    alias = "/mmtpu.example.Predictor/Alias"
    config = dp.DataplaneApiConfig({
        method: dp.RpcConfig(id_extraction_path=(1,)),
        alias: dp.RpcConfig(id_extraction_path=(1,), vmodel=True),
        "/mmtpu.example.Predictor/Off": dp.RpcConfig(allowed=False),
    })
    sink = _Capture()
    c = Cluster(pkg, n=1, server_kwargs=dict(payload_processor=sink,
                                             dataplane=config))
    try:
        inst = c[0].instance
        info = pkg.spi.ModelInfo("example", "mem://d")
        inst.register_model("dp-1", info)
        c[0].vmodels.table.put("dv", pkg.records.VModelRecord(
            active_model="dp-1", target_model="dp-1"))
        req = pkg.apb.GetModelStatusRequest
        body = req(model_id="dp-1").SerializeToString()
        vbody = req(model_id="dv").SerializeToString()
        ch = grpc.insecure_channel(c[0].server.endpoint)
        out = []
        try:
            gd = pkg.grpc_defs
            for m, payload, md in ((method, body, None), (alias, vbody, None),
                                   ("/mmtpu.example.Predictor/Off", body,
                                    None),
                                   (method, b"hdr", [(gd.MODEL_ID_HEADER,
                                                      "dp-1")])):
                try:
                    out.append(gd.raw_method(ch, m)(payload, metadata=md,
                                                    timeout=20))
                except grpc.RpcError as e:
                    out.append(e.code().name)
        finally:
            ch.close()
        return out, [(p.model_id, p.method, p.kind, p.data, p.status)
                     for p in sink.seen]
    finally:
        c.close()


def test_in_body_ids_and_payload_sink_match_reference(monkeypatch):
    # The splicer's pure-Python path: its native build and both backends'
    # bytes are tests/test_torch_splicer.py's.
    for pkg in (PORT, REF):
        monkeypatch.setattr(pkg.splicer, "_lib", False)
    port = _dataplane_run(PORT)
    ref = _dataplane_run(REF)
    assert port == ref
    answers, seen = port
    assert answers[0].startswith(b"dp-1:category_")
    assert answers[1].startswith(b"dp-1:category_")
    assert answers[2] == "UNIMPLEMENTED"
    assert [s[2] for s in seen] == ["request", "response"] * 3


# -- TLS -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls():
    pytest.importorskip(
        "cryptography",
        reason="cryptography not installed: cannot generate the "
               "self-signed test certificate")
    return PORT.tls.generate_self_signed()


def test_mtls_between_port_pods_and_reference_clients(tls):
    """A port fleet with mutual TLS on every surface: forwards between
    pods ride mTLS, a plaintext client is refused, a reference client
    with the certificate is served, and one without it is refused."""
    mtls = PORT.tls.TlsConfig(
        cert_pem=tls.cert_pem, key_pem=tls.key_pem, ca_pem=tls.ca_pem,
        require_client_auth=True, override_authority="localhost")
    kv = PORT.memory.InMemoryKV(sweep_interval_s=0.05)
    channels = PORT.api.PeerChannels(tls=mtls)
    peer_call = PORT.api.make_grpc_peer_call(channels, timeout_s=15)
    rts, insts, servers = [], [], []
    try:
        for iid in ("i-ta", "i-tb"):
            rt, port, _ = PORT.fake.start_fake_runtime(
                servicer=PORT.fake.FakeRuntimeServicer(
                    capacity_bytes=64 << 20))
            rts.append(rt)
            inst = PORT.instance.ModelMeshInstance(
                kv, PORT.sidecar.SidecarRuntime(f"127.0.0.1:{port}",
                                                startup_timeout_s=10),
                PORT.instance.InstanceConfig(instance_id=iid,
                                             load_timeout_s=10,
                                             min_churn_age_ms=0),
                peer_call=peer_call)
            insts.append(inst)
            servers.append(PORT.api.MeshServer(inst, tls=mtls))
            inst.config.endpoint = servers[-1].endpoint
            inst.publish_instance_record(force=True)
        a, b = insts
        for inst in insts:
            inst.instances_view.wait_for(lambda v: len(v) >= 2)
        a.register_model("m-mtls", INFO, load_now=True, sync=True)
        holder = "i-ta" if a.cache.get_quietly("m-mtls") else "i-tb"
        other = b if holder == "i-ta" else a
        other.registry_view.wait_for(
            lambda v: v.get("m-mtls") is not None
            and holder in v.get("m-mtls").instance_ids)
        res = other.invoke_model("m-mtls", PORT.fake.PREDICT_METHOD, b"x", [])
        assert res.payload.startswith(b"m-mtls:") and res.served_by == holder
        ep = servers[0].endpoint
        md = [("mm-model-id", "m-mtls")]
        plain = grpc.insecure_channel(ep)
        with pytest.raises(grpc.RpcError):
            REF.grpc_defs.raw_method(plain, PORT.fake.PREDICT_METHOD)(
                b"x", metadata=md, timeout=5)
        plain.close()
        ref_mtls = REF.tls.TlsConfig(
            cert_pem=tls.cert_pem, key_pem=tls.key_pem, ca_pem=tls.ca_pem,
            require_client_auth=True, override_authority="localhost")
        ch = REF.tls.secure_channel(ep, ref_mtls)
        assert REF.grpc_defs.raw_method(ch, PORT.fake.PREDICT_METHOD)(
            b"x", metadata=md, timeout=20).startswith(b"m-mtls:")
        ch.close()
        # Server-only TLS on the client side: no client certificate.
        ch = REF.tls.secure_channel(ep, REF.tls.TlsConfig(
            cert_pem=tls.cert_pem, key_pem=tls.key_pem, ca_pem=tls.ca_pem,
            override_authority="localhost"))
        with pytest.raises(grpc.RpcError):
            REF.grpc_defs.raw_method(ch, PORT.fake.PREDICT_METHOD)(
                b"x", metadata=md, timeout=5)
        ch.close()
    finally:
        for s in servers:
            s.stop(0)
        for inst in insts:
            inst.shutdown()
        for rt in rts:
            rt.stop(0)
        channels.close()
        kv.close()


def test_tls_config_guards_match_reference(tls, tmp_path):
    for pkg in (PORT, REF):
        bad = pkg.tls.TlsConfig(cert_pem=tls.cert_pem, key_pem=tls.key_pem,
                                require_client_auth=True)
        with pytest.raises(ValueError):
            bad.server_credentials()
        with pytest.raises(ValueError):
            pkg.api.make_grpc_peer_call(pkg.api.PeerChannels(), tls=tls)
    (tmp_path / "c.pem").write_bytes(tls.cert_pem)
    (tmp_path / "k.pem").write_bytes(tls.key_pem)
    loaded = PORT.tls.TlsConfig.from_files(str(tmp_path / "c.pem"),
                                           str(tmp_path / "k.pem"),
                                           str(tmp_path / "c.pem"), True)
    assert loaded.ca_pem == tls.cert_pem and loaded.require_client_auth
    assert loaded.server_hostname("h") == "h"
    assert tls.server_hostname("h") == "localhost"


# -- the slice as a whole ------------------------------------------------------


# The model runtime's method name, the same in both packages.
PREDICT_METHOD = "/mmtpu.models.JaxPredictor/Predict"


def _slice_answers(pkg, loader, requests) -> dict:
    """Register through pod 0's API and predict at pod 1 over gRPC (a
    forward, or a load there), one request at a time."""
    c = Cluster(pkg, n=2, loader=loader)
    ch, stub = api_stub(pkg, c[0].server.endpoint)
    try:
        for mid, mtype, path, _ in requests:
            stub.RegisterModel(pkg.apb.RegisterModelRequest(
                model_id=mid, info=pkg.apb.ModelInfo(model_type=mtype,
                                                     model_path=path)))
        out = {}
        for k, (mid, _, _, payload) in enumerate(requests):
            out[k] = client_call(pkg, c[1], mid, payload,
                                 method=PREDICT_METHOD)
        return out
    finally:
        ch.close()
        c.close()



def test_slice_serves_what_the_reference_serves_over_grpc():
    from modelmesh_tpu.models.server import InProcessJaxLoader
    from modelmesh_tpu.models.server import PREDICT_METHOD as REF_METHOD
    from modelmesh_tpu_torch.models.server import (
        PREDICT_METHOD as PORT_METHOD,
        InProcessTorchLoader,
    )
    from tests.test_torch_instance import FORWARD_TOL, _slice_payloads

    assert PORT_METHOD == REF_METHOD == PREDICT_METHOD
    requests = _slice_payloads()
    port = _slice_answers(PORT, lambda: InProcessTorchLoader(
        capacity_bytes=64 << 20, device="cpu"), requests)
    ref = _slice_answers(REF, lambda: InProcessJaxLoader(
        capacity_bytes=64 << 20), requests)
    assert sorted(port) == sorted(ref) == list(range(len(requests)))
    for k, (mid, mtype, _, _) in enumerate(requests):
        got = np.frombuffer(port[k], np.float32)
        want = np.frombuffer(ref[k], np.float32)
        rtol, atol = FORWARD_TOL[mtype]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol * np.abs(want).max())
