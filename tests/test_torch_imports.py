"""Import hygiene of the PyTorch/CUDA port: every module of
``modelmesh_tpu_torch`` and ``chip_smoke`` import without loading ``jax``
or anything of the JAX package, and without building or loading a kernel
or the native splicer.
Checked in a fresh interpreter, since this test process imports both."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
import modelmesh_tpu_torch
names = ["modelmesh_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(
        modelmesh_tpu_torch.__path__, "modelmesh_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
from modelmesh_tpu_torch.native import proto_splicer
from modelmesh_tpu_torch.ops import _build
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "modelmesh_tpu"
    or m.startswith("modelmesh_tpu.")
)
print(json.dumps({"modules": names, "leaked": leaked,
                  "libs": sorted(_build._libs),
                  "splicer": [proto_splicer._lib is None,
                              proto_splicer.backend]}))
"""


INSTANCE_MODULES = [
    "utils.pool", "serving.rate", "serving.errors", "cache", "cache.lru",
    "observability", "observability.metrics", "observability.tracing",
    "observability.flightrec", "observability.slo", "serving.admission",
    "serving.entry", "serving.batching", "transfer", "transfer.protocol",
    "transfer.manager", "kv.migrate", "serving.instance", "reconfig.drain",
]

# The serving pod's surfaces: the rest of the runtime, protocol and
# observability modules, the pod's lifecycle, the background tasks with
# the autoscaler, vmodels and the gRPC API.
SERVER_MODULES = [
    "runtime", "runtime.grpc_defs", "runtime.fake", "runtime.sidecar",
    "proto", "proto.mesh_api_pb2", "proto.mesh_internal_pb2",
    "proto.mesh_transfer_pb2", "kv", "kv.config", "observability.logctx",
    "observability.payloads", "serving.dataplane", "native",
    "native.proto_splicer", "serving.tls", "serving.health",
    "serving.bootstrap", "serving.dynamic", "autoscale",
    "autoscale.forecast", "autoscale.controller", "serving.tasks",
    "serving.vmodels", "serving.api",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["modules"]) >= 14, got["modules"]
    assert {"modelmesh_tpu_torch.parallel.moe",
            "modelmesh_tpu_torch.placement.refresh_loop"} <= set(
                got["modules"])
    # The serving instance's slice: the instance and every module it
    # imports, beside the rest.
    assert {f"modelmesh_tpu_torch.{m}" for m in INSTANCE_MODULES} <= set(
        got["modules"])
    # The serving pod's slice.
    assert {f"modelmesh_tpu_torch.{m}" for m in SERVER_MODULES} <= set(
        got["modules"])
    assert got["leaked"] == []
    assert got["libs"] == []
    # Importing the splicer builds nothing: it is built at first use.
    assert got["splicer"] == [True, "python"]


def test_chip_smoke_refuses_without_cuda():
    """No CUDA device: a non-zero exit and no result line."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (the script and nothing else) it cannot run."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes()
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_mesh_modules_import_neither_jax_nor_the_jax_package():
    """The mesh and the sharded solver are in the walk above; in a fresh
    interpreter they load no jax and start no thread."""
    probe = (
        "import json, sys, threading\n"
        "import modelmesh_tpu_torch.parallel.mesh as m\n"
        "import modelmesh_tpu_torch.parallel.sharded_solver\n"
        "print(json.dumps({'jax': sorted(k for k in sys.modules if "
        "k == 'jax' or k.startswith('jax.') or k == 'modelmesh_tpu' or "
        "k.startswith('modelmesh_tpu.')), "
        "'threads': threading.active_count()}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "threads": 1}


@pytest.mark.parametrize("preset", [None, ":4096:8"])
def test_import_sets_cublas_workspace_default(preset):
    """Importing the port turns cuBLAS's workspace off (no split-K, so a
    row's products do not depend on its batch), unless the caller chose
    a workspace."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    env["PYTHONPATH"] = str(REPO)
    if preset is not None:
        env["CUBLAS_WORKSPACE_CONFIG"] = preset
    out = subprocess.run(
        [sys.executable, "-c",
         "import os, modelmesh_tpu_torch; "
         "print(os.environ['CUBLAS_WORKSPACE_CONFIG'])"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (preset or ":0:0")
