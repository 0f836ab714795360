"""The port's launcher (``modelmesh_tpu_torch/serving/main.py``), the KV
servers' and the migrator's command lines, and the cuBLAS import-order
rule, on the CPU.

- **``build_store``** for ``memory://``, ``mesh://``, ``etcd://`` and
  ``zookeeper://`` (the port's clients against the port's servers), and
  **``build_loader``** for ``torch`` (``InProcessTorchLoader`` on the
  device given), ``fake`` and ``sidecar:``; unknown values and the
  reference's ``jax`` raise with the reference's wording and the port's
  choices.
- **``main`` at startup**, in a fresh interpreter: ``--runtime jax``,
  ``--strategy jax`` and the reference's ``xla``/``pallas`` in
  ``MM_SOLVER_SPARSE_IMPL``/``MM_SOLVER_LSE_IMPL`` are refused before a
  pod starts; ``--device`` defaults to ``cuda:0`` and raises on a host
  without CUDA unless ``--device cpu`` is given, while a greedy pod over
  the fake runtime touches no device.
- **``tests/test_multiprocess_cluster.py`` on the port** (``mirror``):
  pods as separate processes (``python -m
  modelmesh_tpu_torch.serving.main --runtime fake``) over ``mesh://``,
  ``etcd://`` and ``zookeeper://``: ``READY``, Predict over gRPC, a vmodel
  rollover, SIGTERM migration, and a shared ``--frontdoor-port``.
- **A mixed fleet:** a reference pod and a port pod on one port
  ``mesh://`` server, each serving the other's forwards, then the
  reference pod's copies migrating to the port pod on SIGTERM.
- **A torch pod** (``--runtime torch --strategy torch --device cpu``,
  through ``chip_smoke.cluster_pod``, the card phase's child): its
  answers are a direct ``TorchModelStore(device="cpu")``'s within
  ``chip_smoke.MODEL_TOL``, and as leader it publishes a plan it holds.
- **``python -m modelmesh_tpu_torch.kv.migrate``** against a ``mesh://``
  server moves the same keys as the reference's command against the
  reference's server; the ``mesh://`` and etcd servers' own commands
  serve.
- **The import-order rule**, in subprocesses: with CUDA reported up
  before the port's import, ``TorchModelStore(device="cuda")`` raises
  before any allocation unless ``CUBLAS_WORKSPACE_CONFIG=:0:0`` was set
  first; the launcher's package ``__init__`` runs before any ``torch``
  import.

Children run with ``OMP_NUM_THREADS=1`` and ``MM_LOG_LEVEL=WARNING``,
and every one is reaped in ``finally``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import grpc
import numpy as np
import pytest

import chip_smoke as cs
from tests.test_torch_instance import SLICE_SPECS
from tests.test_torch_kv_migrate import _registry, _write
from tests.test_torch_kv_remote import mirror

REPO = Path(__file__).resolve().parent.parent
CHILD_ENV = {"OMP_NUM_THREADS": "1", "MM_LOG_LEVEL": "WARNING"}
START_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def cheap_children():
    """Every child this module starts inherits one intra-op thread and
    warnings-only logs (the mirrored cases start theirs from os.environ)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in CHILD_ENV.items():
            mp.setenv(k, v)
        yield


MIRRORED = mirror("test_multiprocess_cluster", globals())


def test_mirror_holds_every_reference_class():
    assert sorted(MIRRORED) == ["TestMultiProcess", "TestSharedFrontDoor"]


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), **CHILD_ENV)
    env.update(extra)
    return env


def _spawn(module: str, *args, env=None) -> tuple[subprocess.Popen, str]:
    """``python -m module args``; returns the process and the address of
    its ``READY`` line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env or _env())
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("READY "):
            return proc, line.split(" ", 1)[1].strip()
        if not line and proc.poll() is not None:
            break
    proc.kill()
    proc.wait(30)
    raise RuntimeError(f"{module} {args} never became ready")


def _reap(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


# -- build_store / build_loader ------------------------------------------------


def test_build_store_every_scheme():
    from modelmesh_tpu_torch.kv.etcd import EtcdKV
    from modelmesh_tpu_torch.kv.etcd_server import start_etcd_server
    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.kv.service import RemoteKV, start_kv_server
    from modelmesh_tpu_torch.kv.zk_server import ZkWireServer
    from modelmesh_tpu_torch.kv.zookeeper import ZookeeperKV
    from modelmesh_tpu_torch.serving.main import build_store

    backing = [InMemoryKV(sweep_interval_s=0.05) for _ in range(2)]
    mesh, mesh_port, _ = start_kv_server(store=backing[0])
    etcd, etcd_port, _ = start_etcd_server(store=backing[1])
    zk = ZkWireServer().start()
    stores = []
    try:
        for uri, cls in (("memory://", InMemoryKV),
                         (f"mesh://127.0.0.1:{mesh_port}", RemoteKV),
                         (f"etcd://127.0.0.1:{etcd_port}", EtcdKV),
                         (f"zookeeper://127.0.0.1:{zk.port}", ZookeeperKV)):
            store = build_store(uri)
            stores.append(store)
            assert type(store) is cls, uri
            assert store.put("k/a", b"v").version == 1
            assert store.get("k/a").value == b"v"
        with pytest.raises(ValueError, match="unknown kv scheme 'redis'"):
            build_store("redis://x")
    finally:
        for store in stores:
            store.close()
        mesh.stop(0)
        etcd.stop(0)
        zk.stop()
        for b in backing:
            b.close()


def test_build_loader_runtimes():
    from modelmesh_tpu.serving.main import build_loader as ref_build_loader
    from modelmesh_tpu_torch.models.server import InProcessTorchLoader
    from modelmesh_tpu_torch.runtime.sidecar import SidecarRuntime
    from modelmesh_tpu_torch.serving.main import build_loader

    loader = build_loader("torch", 8, device="cpu")
    assert type(loader) is InProcessTorchLoader
    assert str(loader.store.device) == "cpu"
    assert loader.store.capacity_bytes == 8 << 20
    fake = build_loader("fake", 8)
    try:
        assert type(fake) is SidecarRuntime
        assert fake.startup().capacity_bytes == 8 << 20
    finally:
        fake._embedded_runtime_server.stop(0)
    assert type(build_loader("sidecar:127.0.0.1:1", 8)) is SidecarRuntime
    for bad in ("jax", "tpu"):
        with pytest.raises(ValueError) as port_err:
            build_loader(bad, 8)
        assert "(torch | fake | sidecar:host:port" in str(port_err.value)
        with pytest.raises(ValueError) as ref_err:
            ref_build_loader("tpu", 8)
        # The reference's wording with the port's choices.
        assert str(port_err.value).replace("torch |", "jax |").replace(
            repr(bad), "'tpu'") == str(ref_err.value)


# -- main() at startup ---------------------------------------------------------

STARTUP_PROBE = r"""
import json, os, sys
import modelmesh_tpu_torch.models.server as model_server
import modelmesh_tpu_torch.placement.torch_engine as engine
import torch
from modelmesh_tpu_torch.serving.main import main

class Stop(Exception):
    pass

def attempt(argv, env=None, cuda=None):
    saved = dict(os.environ)
    os.environ.update(env or {})
    real_avail = torch.cuda.is_available
    if cuda is not None:
        torch.cuda.is_available = lambda: cuda
    try:
        main(argv)
    except SystemExit as e:
        return ["SystemExit", str(e.code)]
    except BaseException as e:
        return [type(e).__name__, str(e)]
    finally:
        torch.cuda.is_available = real_avail
        os.environ.clear()
        os.environ.update(saved)
    return ["returned", ""]

def stop_at(cls):
    def init(self, *args, device=None, **kwargs):
        raise Stop(f"{cls.__name__} device={device}")
    return init

base = ["--kv", "memory://", "--capacity-mb", "8"]
out = {
    "runtime_jax": attempt(base + ["--runtime", "jax"]),
    "strategy_jax": attempt(base + ["--runtime", "fake", "--strategy", "jax"]),
    "lse_xla": attempt(base + ["--runtime", "fake", "--strategy", "torch",
                               "--device", "cpu"],
                       {"MM_SOLVER_LSE_IMPL": "xla"}),
    "sparse_pallas_greedy": attempt(base + ["--runtime", "fake"],
                                    {"MM_SOLVER_SPARSE_IMPL": "pallas"}),
    "lse_cuda_on_cpu": attempt(base + ["--runtime", "fake", "--strategy",
                                       "shadow", "--device", "cpu"],
                               {"MM_SOLVER_LSE_IMPL": "cuda"}),
    "torch_runtime_no_cuda": attempt(base + ["--runtime", "torch"],
                                     cuda=False),
    "torch_strategy_no_cuda": attempt(base + ["--runtime", "fake",
                                              "--strategy", "torch"],
                                      cuda=False),
}
model_server.InProcessTorchLoader.__init__ = stop_at(
    model_server.InProcessTorchLoader)
out["torch_runtime_default"] = attempt(base + ["--runtime", "torch"],
                                       cuda=True)
out["torch_runtime_cpu"] = attempt(base + ["--runtime", "torch", "--device",
                                           "cpu"], cuda=False)
engine.TorchPlacementStrategy.__init__ = stop_at(
    engine.TorchPlacementStrategy)
out["torch_strategy_default"] = attempt(base + ["--runtime", "fake",
                                                "--strategy", "torch"],
                                        cuda=True)
out["cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(out))
"""


def test_main_refuses_bad_choices_and_resolves_the_device_at_startup():
    out = subprocess.run(
        [sys.executable, "-c", STARTUP_PROBE], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["runtime_jax"] == [
        "ValueError", "unknown runtime 'jax' (torch | fake | "
        "sidecar:host:port | sidecar:unix:///path.sock)"]
    assert got["strategy_jax"] == ["SystemExit", "2"]
    assert got["lse_xla"] == [
        "ValueError", "MM_SOLVER_LSE_IMPL='xla' (expected auto | cuda)"]
    assert got["sparse_pallas_greedy"] == [
        "ValueError", "MM_SOLVER_SPARSE_IMPL='pallas' (expected auto | cuda)"]
    assert got["lse_cuda_on_cpu"] == [
        "ValueError",
        "MM_SOLVER_LSE_IMPL='cuda' needs the problem on a CUDA device"]
    for key in ("torch_runtime_no_cuda", "torch_strategy_no_cuda"):
        assert got[key][0] == "RuntimeError", (key, got[key])
        assert "no CUDA device found" in got[key][1]
    assert got["torch_runtime_default"] == [
        "Stop", "InProcessTorchLoader device=cuda:0"]
    assert got["torch_runtime_cpu"] == [
        "Stop", "InProcessTorchLoader device=cpu"]
    assert got["torch_strategy_default"] == [
        "Stop", "TorchPlacementStrategy device=cuda:0"]
    # Resolving the default touched no CUDA state.
    assert got["cuda_initialized"] is False


# -- the import-order rule -----------------------------------------------------

IMPORT_ORDER_PROBE = r"""
import json, os, sys
import torch
torch.cuda.is_initialized = lambda: True   # as if a CUDA call came first
import modelmesh_tpu_torch
from modelmesh_tpu_torch.models.server import TorchModelStore
try:
    TorchModelStore(1 << 20, device="cuda")
except RuntimeError as e:
    out = ["RuntimeError", str(e)]
except Exception as e:
    out = [type(e).__name__, str(e)]
else:
    out = ["constructed", ""]
try:
    TorchModelStore(1 << 20, device="cpu")
    cpu = "constructed"
except Exception as e:
    cpu = type(e).__name__
print(json.dumps({"cuda": out, "cpu": cpu,
                  "up": modelmesh_tpu_torch.CUDA_UP_AT_IMPORT,
                  "preset": modelmesh_tpu_torch.CUBLAS_SET_AT_IMPORT,
                  "env": os.environ["CUBLAS_WORKSPACE_CONFIG"]}))
"""


@pytest.mark.parametrize("preset", [None, ":4096:8", ":0:0"])
def test_cuda_store_refused_when_cuda_came_before_the_port(preset):
    """CUDA reported up before ``import modelmesh_tpu_torch``: a CUDA
    model store raises in its constructor, naming the fix, unless the
    variable was ":0:0" first; a CPU store is unaffected."""
    env = {k: v for k, v in _env().items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    if preset is not None:
        env["CUBLAS_WORKSPACE_CONFIG"] = preset
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ORDER_PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["up"] is True and got["cpu"] == "constructed"
    assert got["preset"] is (preset == ":0:0")
    assert got["env"] == (preset or ":0:0")
    refused = got["cuda"][0] == "RuntimeError" and (
        "import modelmesh_tpu_torch first" in got["cuda"][1]
        and "CUBLAS_WORKSPACE_CONFIG=:0:0 before the first CUDA call"
        in got["cuda"][1])
    if preset == ":0:0":
        assert got["cuda"] == ["constructed", ""], got
    else:
        assert refused, got


def test_store_accepted_when_the_port_came_first():
    """The port imported before CUDA's first call: no refusal, whatever
    the variable (the default sets it)."""
    probe = (
        "import json, torch, modelmesh_tpu_torch\n"
        "from modelmesh_tpu_torch import device\n"
        "torch.cuda.is_initialized = lambda: True\n"
        "device.check_cublas_import_order('cuda')\n"
        "print(json.dumps([modelmesh_tpu_torch.CUDA_UP_AT_IMPORT]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False]


LAUNCH_ORDER_PROBE = r"""
import importlib.abc, json, os, runpy, sys
seen = []

class Watch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "torch" and not seen:
            seen.append({"port_imported": "modelmesh_tpu_torch" in sys.modules,
                         "cublas": os.environ.get("CUBLAS_WORKSPACE_CONFIG")})
        return None

sys.meta_path.insert(0, Watch())
os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
sys.argv = ["main"] + sys.argv[1:]
try:
    runpy.run_module("modelmesh_tpu_torch.serving.main", run_name="__main__",
                     alter_sys=True)
except BaseException as e:
    outcome = type(e).__name__
else:
    outcome = "returned"
print(json.dumps({"torch": seen, "outcome": outcome,
                  "port_imported": "modelmesh_tpu_torch" in sys.modules}))
"""


@pytest.mark.parametrize("argv", [
    ["--help"],
    # Reaches the device module (torch), then fails on the knob.
    ["--kv", "memory://", "--runtime", "fake", "--strategy", "torch",
     "--device", "cpu"],
])
def test_launcher_runs_the_package_init_before_any_torch_import(argv):
    """``python -m modelmesh_tpu_torch.serving.main`` imports the package
    (its ``__init__`` sets the cuBLAS variable) before ``torch``: the
    launcher itself sets nothing."""
    out = subprocess.run(
        [sys.executable, "-c", LAUNCH_ORDER_PROBE, *argv], cwd=REPO,
        env=_env(MM_SOLVER_LSE_IMPL="xla"), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port_imported"]
    if argv == ["--help"]:
        assert got["outcome"] == "SystemExit"
        assert all(x["port_imported"] for x in got["torch"])
    else:
        assert got["outcome"] == "ValueError"
        assert got["torch"] == [{"port_imported": True, "cublas": ":0:0"}]
    src = (REPO / "modelmesh_tpu_torch" / "serving" / "main.py").read_text()
    assert "CUBLAS_WORKSPACE_CONFIG" not in src


# -- a mixed fleet: a reference pod and a port pod on one port server ----------


def test_mixed_fleet_serves_each_others_forwards():
    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.kv.service import start_kv_server
    from modelmesh_tpu_torch.proto import mesh_api_pb2 as apb
    from modelmesh_tpu_torch.runtime import grpc_defs
    from modelmesh_tpu_torch.runtime.fake import PREDICT_METHOD

    backing = InMemoryKV(sweep_interval_s=0.05)
    server, port, _ = start_kv_server(store=backing)
    procs, channels = [], []
    try:
        pods = {}
        for pkg in ("modelmesh_tpu", "modelmesh_tpu_torch"):
            proc, ep = _spawn(
                f"{pkg}.serving.main", "--kv", f"mesh://127.0.0.1:{port}",
                "--instance-id", pkg, "--runtime", "fake",
                "--capacity-mb", "64", "--load-timeout-s", "20")
            procs.append(proc)
            ch = grpc.insecure_channel(ep)
            channels.append(ch)
            pods[pkg] = (proc, ch, grpc_defs.make_stub(
                ch, grpc_defs.API_SERVICE, grpc_defs.API_METHODS))

        def predict(pkg, mid):
            out, call = grpc_defs.raw_method(pods[pkg][1], PREDICT_METHOD) \
                .with_call(b"x", metadata=[("mm-model-id", mid)], timeout=30)
            assert out.startswith(mid.encode() + b":"), out
            md = dict(call.trailing_metadata() or ())
            return md["mm-served-by"]

        holders = {}
        for k in range(8):
            pkg = list(pods)[k % 2]
            mid = f"mix-{k}"
            st = pods[pkg][2].RegisterModel(apb.RegisterModelRequest(
                model_id=mid, info=apb.ModelInfo(
                    model_type="example", model_path=f"mem://{mid}"),
                load_now=True, sync=True), timeout=60)
            assert st.status == apb.LOADED
            holders[mid] = predict(pkg, mid)
            if set(holders.values()) == set(pods):
                break
        assert set(holders.values()) == set(pods), holders
        # Every model through both pods: each pod forwards to the other,
        # records and the internal wire shared across the packages.
        forwards = set()
        for mid, holder in holders.items():
            for entry in pods:
                assert predict(entry, mid) == holder
                if entry != holder:
                    forwards.add((entry, holder))
        assert forwards == {("modelmesh_tpu", "modelmesh_tpu_torch"),
                            ("modelmesh_tpu_torch", "modelmesh_tpu")}
        # The reference pod drains on SIGTERM; the port pod serves its
        # models.
        ref_proc = pods["modelmesh_tpu"][0]
        ref_proc.send_signal(signal.SIGTERM)
        assert ref_proc.wait(60) == 0
        deadline = time.monotonic() + 30
        for mid in holders:
            while True:
                try:
                    assert predict("modelmesh_tpu_torch", mid) == \
                        "modelmesh_tpu_torch"
                    break
                except (grpc.RpcError, AssertionError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
        port_proc = pods["modelmesh_tpu_torch"][0]
        port_proc.send_signal(signal.SIGTERM)
        assert port_proc.wait(60) == 0
    finally:
        for ch in channels:
            ch.close()
        _reap(procs)
        server.stop(0)
        backing.close()


# -- a torch pod on the host ---------------------------------------------------


def test_torch_pod_answers_like_the_store_and_publishes_a_plan(
        monkeypatch, tmp_path):
    from modelmesh_tpu_torch.kv.memory import InMemoryKV
    from modelmesh_tpu_torch.kv.service import RemoteKV, start_kv_server
    from modelmesh_tpu_torch.models.server import TorchModelStore
    from modelmesh_tpu_torch.placement import plan_sync
    from modelmesh_tpu_torch.placement.torch_engine import GlobalPlan

    monkeypatch.setattr(cs, "CLUSTER_POD_ARGS", ("--device", "cpu"))
    ops = cs.server_ops()
    backing = InMemoryKV(sweep_interval_s=0.05)
    server, port, _ = start_kv_server(store=backing)
    kv = RemoteKV(f"127.0.0.1:{port}")
    pod = None
    try:
        pod = cs.ClusterPod(ops, f"mesh://127.0.0.1:{port}", "torch-0", 64,
                            str(tmp_path), _env())
        pod.wait_ready(START_S)
        models = [(f"t-{k}", spec) for k, spec in enumerate(SLICE_SPECS)]
        for mid, (mtype, path) in models:
            st = pod.api.RegisterModel(ops.apb.RegisterModelRequest(
                model_id=mid, info=ops.apb.ModelInfo(
                    model_type=mtype, model_path=path)), timeout=60)
            assert st.model_id == mid
        ref = TorchModelStore(1 << 30, device="cpu")
        for k, (mid, (mtype, path)) in enumerate(models):
            ref.load(mid, mtype, path)
            x = cs.model_input(ref._models[mid], 1, k).tobytes()
            row = cs.server_call(ops, pod, mid, x)
            assert row["error"] is None, row
            want = np.frombuffer(ref.predict_batch([(mid, x)])[0],
                                 np.float32)
            cs.check_close(np.frombuffer(row["payload"], np.float32), want,
                           cs.MODEL_TOL[mtype], mid)

        def generation():
            got = kv.get(plan_sync.plan_key(cs.CLUSTER_PREFIX))
            return GlobalPlan.from_bytes(got.value).generation if got else 0

        deadline = time.monotonic() + 30
        while generation() < 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert generation() >= 1
        published = kv.get(plan_sync.plan_key(cs.CLUSTER_PREFIX)).value
        assert pod.terminate() == 0
        res = pod.result()
        assert res["loader_devices"] == ["cpu"]
        assert res["strategy_devices"] == ["cpu"]
        ticks = [t for t in res["ticks"] if t["published"]]
        assert ticks and all(t["solver_path"] == "dense" for t in ticks)
        last = next(t for t in reversed(ticks)
                    if t["digest"] == cs._digest(published))
        # The pod held the plan it published.
        assert (last["generation"], last["digest"]) in {
            (g, d) for _, g, d in res["plans"]}
    finally:
        if pod is not None:
            pod.kill()
        kv.close()
        server.stop(0)
        backing.close()


# -- the other command lines ---------------------------------------------------


def test_migrate_command_against_mesh_server_matches_reference():
    import modelmesh_tpu.kv.memory as ref_memory
    import modelmesh_tpu.kv.service as ref_service
    import modelmesh_tpu.kv.table as ref_table
    import modelmesh_tpu.records as ref_records
    import modelmesh_tpu_torch.kv.memory as port_memory
    import modelmesh_tpu_torch.kv.service as port_service
    import modelmesh_tpu_torch.kv.table as port_table
    import modelmesh_tpu_torch.records as port_records

    registry = _registry(5, n=40)
    got = {}
    for name, memory, service, table, records in (
            ("modelmesh_tpu", ref_memory, ref_service, ref_table,
             ref_records),
            ("modelmesh_tpu_torch", port_memory, port_service, port_table,
             port_records)):
        kv = memory.InMemoryKV(sweep_interval_s=3600.0)
        server, port, _ = service.start_kv_server(store=kv)
        try:
            pkg = type("pkg", (), {"table": table, "records": records})
            _write(pkg, kv, registry, 128)
            out = subprocess.run(
                [sys.executable, "-m", f"{name}.kv.migrate", "--kv",
                 f"mesh://127.0.0.1:{port}", "--prefix", "mm"],
                cwd=REPO, env=_env(), capture_output=True, text=True,
                timeout=120)
            assert out.returncode == 0, out.stderr[-3000:]
            got[name] = (out.stdout.strip(),
                         {x.key: x.value for x in kv.range("mm/registry/")})
        finally:
            server.stop(0)
            kv.close()
    flat = sum(flat for _, flat, _ in registry)
    assert got["modelmesh_tpu_torch"][0] == \
        f"migrated {flat} flat registry keys"
    assert got["modelmesh_tpu_torch"] == got["modelmesh_tpu"]


def test_kv_server_commands_serve():
    from modelmesh_tpu_torch.kv.etcd import EtcdKV
    from modelmesh_tpu_torch.kv.service import RemoteKV

    procs = []
    try:
        proc, addr = _spawn("modelmesh_tpu_torch.kv.etcd_server",
                            "--port", "0")
        procs.append(proc)
        client = EtcdKV(addr)
        try:
            assert client.put("e/k", b"1").version == 1
            assert client.get("e/k").value == b"1"
        finally:
            client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        from cluster_util import free_port

        port = free_port()
        mesh = subprocess.Popen(
            [sys.executable, "-m", "modelmesh_tpu_torch.kv.service",
             "--port", str(port)], cwd=REPO, env=_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs.append(mesh)
        client = RemoteKV(f"127.0.0.1:{port}")
        try:
            deadline = time.monotonic() + START_S
            while True:
                try:
                    assert client.put("m/k", b"2").version == 1
                    break
                except grpc.RpcError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            assert client.get("m/k").value == b"2"
        finally:
            client.close()
    finally:
        _reap(procs)


LAUNCHER_KNOBS = ["MM_KV_URI", "MM_LOG_LEVEL", "MM_TYPE_CONSTRAINTS",
                  "MM_PAYLOAD_PROCESSORS", "MM_PER_MODEL_METRICS", "MM_ZONE",
                  "MM_LABELS", "MM_ETCD_MAX_VALUE_BYTES"]


@pytest.mark.parametrize("name", LAUNCHER_KNOBS)
def test_launcher_and_kv_knobs_are_the_references(name, monkeypatch):
    from modelmesh_tpu.utils import envs as ref_envs
    from modelmesh_tpu_torch.utils import envs

    port, ref = envs.REGISTRY[name], ref_envs.REGISTRY[name]
    assert (port.kind, port.default, port.help, port.consumer) == (
        ref.kind, ref.default, ref.help, ref.consumer)
    monkeypatch.setenv(name, " a, b ,,c ")
    assert envs.get(name) == ref_envs.get(name)
    assert envs.get_list(name) == ref_envs.get_list(name) == ["a", "b", "c"]


SHUTDOWN_PROBE = r"""
import json, os, signal, sys, threading, time
from modelmesh_tpu_torch.serving import main as launcher
from modelmesh_tpu_torch.serving import tasks as tasks_mod

events = []
real_init = tasks_mod.BackgroundTasks.__init__

def init(self, instance, config=None):
    real_init(self, instance, tasks_mod.TaskConfig(
        publish_interval_s=60.0, janitor_interval_s=60.0,
        rate_interval_s=60.0, reaper_interval_s=0.05, jitter_frac=0.0))

def slow_tick(self):
    events.append("tick-start")
    os.kill(os.getpid(), signal.SIGTERM)   # SIGTERM lands mid-tick
    time.sleep(1.0)
    events.append("tick-end")

tasks_mod.BackgroundTasks.__init__ = init
tasks_mod.BackgroundTasks._reaper_tick = slow_tick
launcher.main(["--kv", "memory://", "--runtime", "fake",
               "--capacity-mb", "8"])
events.append("main-returned")
print(json.dumps(events))
"""


def test_shutdown_waits_for_a_task_tick_in_flight():
    """SIGTERM during a reaper tick: ``main`` returns after the tick ends
    (a tick left running on the card aborts the process at exit)."""
    out = subprocess.run(
        [sys.executable, "-c", SHUTDOWN_PROBE], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    events = json.loads(out.stdout.strip().splitlines()[-1])
    assert events[:3] == ["tick-start", "tick-end", "main-returned"], events
