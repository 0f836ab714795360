"""The port's own copy of the JAX package's ``serving/bootstrap.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Instance bootstrap helpers: static registration, preStop hook, diagnostics.

- StaticModelRegistration (reference StaticModelRegistration.java:57):
  register models/vmodels declared in env-var JSON at startup and verify
  they load.
- PreStopServer (reference RuntimeContainersPreStopServer, port 8090): an
  HTTP hook the runtime container's preStop probe blocks on until shutdown
  migration has finished, so k8s doesn't kill the model server while models
  are still being handed off.
- debug_dump: the state-dump diagnostic facility (reference "secret"
  ***LOGCACHE***/***GETSTATE*** ids, ModelMesh.java:3248-3253, 5552-5608)
  — full local cache + cluster placement state as JSON, reachable through
  GetModelStatus with the reserved id ``***STATE***``.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
from typing import Optional

from modelmesh_tpu_torch.cache.lru import now_ms
from modelmesh_tpu_torch.utils import envs
from modelmesh_tpu_torch.runtime.spi import ModelInfo
from modelmesh_tpu_torch.serving.errors import ReadOnlyModeError
from modelmesh_tpu_torch.serving.instance import ModelMeshInstance

log = logging.getLogger(__name__)

STATE_DUMP_ID = "***STATE***"
# The reference's reserved diagnostic ids (ModelMesh.java:3248-3253) are
# accepted as aliases so migrated runbooks keep working.
STATE_DUMP_ALIASES = frozenset(
    {STATE_DUMP_ID, "***GETSTATE***", "***LOGCACHE***"}
)
STATIC_MODELS_ENV = "MM_STATIC_MODELS"


def register_static_models(
    instance: ModelMeshInstance,
    vmodels=None,
    config_json: Optional[str] = None,
    verify: bool = True,
) -> list[str]:
    """Register models/vmodels from JSON (env MM_STATIC_MODELS by default).

    {"models": [{"modelId": "m1", "type": "mlp", "path": "mlp://in=8"}],
     "vmodels": [{"vModelId": "alias", "targetModelId": "m1",
                  "type": "mlp", "path": "..."}]}
    Returns the list of registered model ids; raises RuntimeError if
    ``verify`` and any declared model fails to load.
    """
    text = (
        config_json if config_json is not None
        else envs.get(STATIC_MODELS_ENV) or ""
    )
    if not text.strip():
        return []
    cfg = json.loads(text)
    registered: list[str] = []
    failed: list[str] = []
    for spec in cfg.get("models", ()):  # concrete models
        mid = spec["modelId"]
        info = ModelInfo(
            model_type=spec.get("type", ""),
            model_path=spec.get("path", ""),
            model_key=spec.get("key", ""),
        )
        try:
            instance.register_model(mid, info, load_now=True, sync=verify)
        except ReadOnlyModeError as e:
            # KV-migration read-only: the registration will arrive with
            # the store copy — a crash-looping pod would defeat "serving
            # continues" for the whole migration window.
            log.warning("static model %s skipped: %s", mid, e)
            continue
        registered.append(mid)
        if verify and instance.get_status(mid)[0] != "LOADED":
            failed.append(mid)
    for spec in cfg.get("vmodels", ()):
        if vmodels is None:
            raise RuntimeError("static vmodels declared but vmodels disabled")
        from modelmesh_tpu_torch.proto import mesh_api_pb2 as apb

        req = apb.SetVModelRequest(
            vmodel_id=spec["vModelId"],
            target_model_id=spec["targetModelId"],
            info=apb.ModelInfo(
                model_type=spec.get("type", ""),
                model_path=spec.get("path", ""),
                model_key=spec.get("key", ""),
            ),
            auto_delete_target=spec.get("autoDeleteTarget", True),
            load_now=True,
            sync=verify,
            owner=spec.get("owner", ""),
        )
        vmodels.set_vmodel(req, _AbortRaiser(), lambda mid: None)
        registered.append(spec["targetModelId"])
    if failed:
        raise RuntimeError(f"static models failed to load: {failed}")
    return registered


class _AbortRaiser:
    """Minimal grpc-context stand-in for internal vmodel calls."""

    def abort(self, code, details):
        raise RuntimeError(f"{code}: {details}")


def debug_dump(instance: ModelMeshInstance) -> dict:
    """Full cache + cluster placement state (the ***STATE*** dump)."""
    cache_entries = [
        {
            "modelId": mid,
            "state": ce.state.value,
            "weightUnits": ce.weight_units,
            "lastUsed": ts,
            "inflight": ce.inflight,
            "totalInvocations": ce.total_invocations,
            "error": ce.error,
        }
        for mid, ce, ts in instance.cache.descending_items()
    ]
    instances = [
        {
            "instanceId": iid,
            "capacityUnits": rec.capacity_units,
            "usedUnits": rec.used_units,
            "modelCount": rec.model_count,
            "rpm": rec.req_per_minute,
            "lruTs": rec.lru_ts,
            "shuttingDown": rec.shutting_down,
            "endpoint": rec.endpoint,
            "zone": rec.zone,
            "labels": list(rec.labels),
        }
        for iid, rec in instance.instances_view.items()
    ]
    registry = [
        {
            "modelId": mid,
            "type": mr.model_type,
            "loaded": dict(mr.instance_ids),
            "loading": dict(mr.loading_instances),
            "failures": {k: v[1] for k, v in mr.load_failures.items()},
            "refCount": mr.ref_count,
            "sizeUnits": mr.size_units,
        }
        for mid, mr in instance.registry.items()
    ]
    return {
        "instanceId": instance.instance_id,
        "now": now_ms(),
        "isLeader": instance.is_leader,
        "shuttingDown": instance.shutting_down,
        "cache": {
            "capacityUnits": instance.cache.capacity,
            "usedUnits": instance.cache.weight,
            "pendingUnloadUnits": instance.unload_tracker.pending_units,
            "entries": cache_entries,
        },
        "cluster": instances,
        "registry": registry,
        # Windowed SLO attainment per tracked class (observability/slo.py)
        # — the operator's "are we meeting objectives RIGHT NOW" read.
        "slo": {
            cls: {
                "requests": s.requests,
                "availability": round(s.availability, 5),
                "p99Ms": round(s.p99_ms, 1),
                "attained": s.attained,
                "burnRate": round(s.burn_rate, 3),
                "violations": s.violations,
            }
            for cls, s in (
                (c, instance.slo.attainment(c))
                for c in instance.slo.classes()
            )
        },
        # Shadow-mode evaluation report, when the strategy runs one
        # (placement/shadow.py): agreement rates + recent divergences.
        **(
            {"shadow": instance.strategy.shadow_stats()}
            if hasattr(instance.strategy, "shadow_stats")
            else {}
        ),
    }


class PreStopServer:
    """Lifecycle HTTP endpoints: preStop hook + kubelet probes.

    - GET /prestop — blocks until migration completes (k8s preStop hook).
    - GET /ready — 200 only when the ReadinessGate passes: not shutting
      down, cluster view synced, and (until first-ready LATCHES, reference
      reportReady) no peer draining — holds a rolling update at not-yet-
      ready pods while migrations are in flight without 503ing established
      pods (reference isReady(), ModelMesh.java:1310-1331).
    - GET /live — 200 while the process serves HTTP at all.
    """

    def __init__(self, instance: ModelMeshInstance, port: int = 8090,
                 max_wait_s: float = 120.0):
        from modelmesh_tpu_torch.serving.health import ReadinessGate

        self.instance = instance
        self.migrated = threading.Event()
        self.gate = ReadinessGate(instance)
        inst = self.instance
        migrated = self.migrated
        gate = self.gate

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib API
                path = self.path.rstrip("/")
                if path == "/live":
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"live\n")
                    return
                if path == "/ready":
                    ok, reason = gate.is_ready()
                    self.send_response(200 if ok else 503)
                    self.end_headers()
                    self.wfile.write(reason.encode() + b"\n")
                    return
                if path != "/prestop":
                    self.send_response(404)
                    self.end_headers()
                    return
                if not inst.shutting_down:
                    # The hook firing IS the shutdown signal.
                    threading.Thread(
                        target=self._migrate, daemon=True
                    ).start()
                migrated.wait(max_wait_s)
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"migrated\n")

            def _migrate(self):
                try:
                    inst.pre_shutdown()
                finally:
                    migrated.set()

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, name="prestop", daemon=True
        ).start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
