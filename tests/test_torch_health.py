"""The port's pod lifecycle surfaces (``modelmesh_tpu_torch/serving/
health.py``, ``bootstrap.py``, ``dynamic.py`` and ``kv/config.py``)
against the JAX package's, on the CPU.

- **``BootstrapProbation``** under each package's ``VirtualClock``: the
  reference's unit cases on the port, its knobs, and one scripted run of
  outcomes and clock moves whose aborts equal the reference's.
- **``ReadinessGate``**: ``tests/test_health.py``'s cluster cases (the
  latch while a peer drains, local shutdown) on a port cluster.
- **``PreStopServer``**: ``/live``, ``/ready`` (200, then 503 once
  shutting down), an unknown path's 404, and ``/prestop``, which drains
  the pod's copies to a survivor before it answers.
- **``DynamicConfig`` and ``ServingConfigBinder``**:
  ``tests/test_dynamic_config.py``'s cases (the scale-up threshold, the
  per-invocation log flag, ``disable``) on a port cluster, and the typed
  getters and listener calls beside the reference's.
- **``register_static_models``** (models and vmodels from JSON or the
  ``MM_STATIC_MODELS`` knob, the failure cases) and **``debug_dump``**:
  the same fleet in both packages, the registered ids, registry and dump
  compared (bound ports and clock stamps by presence).
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request

import pytest

from tests.test_torch_api import INFO, PORT, REF, Cluster, wait_for

METHOD = PORT.fake.PREDICT_METHOD


def _wait(pred, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# -- bootstrap probation -------------------------------------------------------


@pytest.fixture()
def vclock():
    clock = PORT.clock.VirtualClock()
    prev = PORT.clock.install(clock)
    yield clock
    PORT.clock.install(prev)
    clock.close()


class TestProbationUnit:
    def test_aborts_after_n_failures_without_success(self, vclock):
        calls = []
        p = PORT.health.BootstrapProbation(window_s=60, max_failures=3,
                                           abort_fn=calls.append)
        p.record_failure("m1", "boom")
        p.record_failure("m2", "boom")
        assert not calls
        p.record_failure("m3", "boom")
        assert len(calls) == 1 and "poisoned" in calls[0]

    def test_success_disarms(self, vclock):
        calls = []
        p = PORT.health.BootstrapProbation(window_s=60, max_failures=2,
                                           abort_fn=calls.append)
        p.record_failure("m1", "boom")
        p.record_success()
        for i in range(5):
            p.record_failure(f"m{i}", "boom")
        assert not calls

    def test_window_expiry_disarms(self, vclock):
        calls = []
        p = PORT.health.BootstrapProbation(window_s=10, max_failures=1,
                                           abort_fn=calls.append)
        vclock.advance(10_001)
        p.record_failure("m1", "boom")
        assert not calls

    def test_reset_window_rearms(self, vclock):
        calls = []
        p = PORT.health.BootstrapProbation(window_s=10, max_failures=1,
                                           abort_fn=calls.append)
        vclock.advance(9_000)
        p.reset_window()
        vclock.advance(9_000)
        p.record_failure("m1", "boom")
        assert len(calls) == 1

    def test_from_env_disable(self, monkeypatch):
        assert PORT.health.BootstrapProbation.from_env().window_s == 360
        monkeypatch.setenv("MM_PROBATION_S", "0")
        assert PORT.health.BootstrapProbation.from_env() is None
        monkeypatch.setenv("MM_PROBATION_S", "120")
        monkeypatch.setenv("MM_PROBATION_FAILURES", "5")
        p = PORT.health.BootstrapProbation.from_env()
        assert p.window_s == 120 and p.max_failures == 5


def _probation_script(pkg) -> list:
    clock = pkg.clock.VirtualClock()
    prev = pkg.clock.install(clock)
    calls = []
    try:
        for window_s, max_failures, steps in (
                (30, 3, ["f", "f", 5_000, "f", "f"]),
                (30, 2, ["f", 31_000, "f", "f"]),
                (30, 0, ["f"]),
                (60, 3, ["f", "s", "f", "f", "f"]),
                (20, 2, [19_000, "reset", 19_000, "f", "f"])):
            p = pkg.health.BootstrapProbation(
                window_s=window_s, max_failures=max_failures,
                abort_fn=calls.append)
            for k, step in enumerate(steps):
                if step == "f":
                    p.record_failure(f"m{k}", "boom")
                elif step == "s":
                    p.record_success()
                elif step == "reset":
                    p.reset_window()
                else:
                    clock.advance(step)
            calls.append(("end", p.max_failures))
        return calls
    finally:
        pkg.clock.install(prev)
        clock.close()


def test_probation_script_matches_reference():
    port = _probation_script(PORT)
    assert port == _probation_script(REF)
    assert sum(isinstance(c, str) for c in port) == 4


# -- readiness -----------------------------------------------------------------


class TestReadinessGateCluster:
    def test_unready_pods_hold_while_peer_drains_then_recover(self):
        c = Cluster(PORT, n=3)
        try:
            latched = PORT.health.ReadinessGate(c[0].instance)
            ok, reason = latched.is_ready()
            assert ok, reason
            fresh = PORT.health.ReadinessGate(c[1].instance)
            draining = c[2].instance
            draining.shutting_down = True
            draining.publish_instance_record(force=True)
            assert _wait(lambda: any(
                rec.shutting_down
                for iid, rec in c[1].instance.instances_view.items()
                if iid != c[1].instance.instance_id))
            assert not fresh.is_ready()[0]
            assert "draining" in fresh.is_ready()[1]
            assert latched.is_ready()[0], "latched gate must not flip"
            own = PORT.health.ReadinessGate(draining)
            assert own.is_ready() == (False, "shutting down")
            c[2].stop()
            assert _wait(lambda: fresh.is_ready()[0], timeout=15)
            assert "latched" in fresh.is_ready()[1]
        finally:
            c.close()

    def test_latch_does_not_mask_local_shutdown(self):
        c = Cluster(PORT, n=1)
        try:
            g = PORT.health.ReadinessGate(c[0].instance)
            assert g.is_ready()[0]
            c[0].instance.shutting_down = True
            assert g.is_ready() == (False, "shutting down")
            c[0].instance.shutting_down = False
        finally:
            c.close()


# -- the preStop server --------------------------------------------------------


def _get(url: str):
    try:
        r = urllib.request.urlopen(url, timeout=30)
        return r.status, r.read().strip()
    except urllib.error.HTTPError as e:
        return e.code, e.read().strip()


def test_prestop_server_endpoints_and_drain():
    c = Cluster(PORT, n=2)
    srv = None
    try:
        inst = c[0].instance
        inst.register_model("m-pre", INFO)
        inst.invoke_model("m-pre", METHOD, b"x", [])
        assert c.pod_with_copy("m-pre") is c[0]
        srv = PORT.bootstrap.PreStopServer(inst, port=0, max_wait_s=30)
        base = f"http://127.0.0.1:{srv.port}"
        assert _get(f"{base}/live") == (200, b"live")
        assert _get(f"{base}/ready") == (200, b"ok")
        assert _get(f"{base}/ready/") == (200, b"ok (latched)")
        assert _get(f"{base}/nope")[0] == 404
        # The hook drains: the copy moves to the survivor before it answers.
        assert _get(f"{base}/prestop") == (200, b"migrated")
        assert srv.migrated.is_set() and inst.shutting_down
        assert _get(f"{base}/ready") == (503, b"shutting down")
        mr = c[1].instance.registry.get("m-pre")
        assert "i-1" in mr.instance_ids and "i-0" not in mr.instance_ids
    finally:
        if srv is not None:
            srv.close()
        c.close()


# -- dynamic config ------------------------------------------------------------


def _config_script(pkg) -> list:
    kv = pkg.memory.InMemoryKV(sweep_interval_s=3600.0)
    try:
        kv.put("mm/config/preset", b"7")
        cfg = pkg.kvconfig.DynamicConfig(kv, "mm/config")
        seen = []
        cfg.add_listener(lambda k, v: seen.append((k, v)))
        cfg.add_listener(lambda k, v: 1 / 0)  # a failing listener is isolated
        out = [cfg.prefix, cfg.get("preset")]
        for key, value in (("a", "12"), ("b", "1.5"), ("c", "Yes"),
                           ("d", "junk"), ("a", "13")):
            cfg.set(key, value)
        kv.delete("mm/config/b")
        wait_for(lambda: len(seen) == 6, "the config watch")
        out += [cfg.get_int("a", 0), cfg.get_int("d", -1),
                cfg.get_float("b", 9.0), cfg.get_float("a", 0.0),
                cfg.get_bool("c", False), cfg.get_bool("d", True),
                cfg.get_bool("zz", True), cfg.get("zz", "dflt"), seen]
        cfg.close()
        return out
    finally:
        kv.close()


def test_dynamic_config_matches_reference():
    port = _config_script(PORT)
    assert port == _config_script(REF)
    assert port[:2] == ["mm/config/", "7"]
    assert port[2:10] == [13, -1, 9.0, 13.0, True, False, True, "dflt"]


class TestScaleUpThresholdLive:
    def test_rate_task_scales_at_new_threshold_without_restart(self):
        c = Cluster(PORT, n=2)
        binder = None
        try:
            inst = c[0].instance
            tasks = PORT.tasks.BackgroundTasks(inst, PORT.tasks.TaskConfig())
            binder = PORT.dynamic.ServingConfigBinder(
                c.kv, inst.config.kv_prefix, inst, tasks.config)
            assert tasks.config.scale_up_rpm == 2000
            inst.register_model("dyn-m", PORT.spi.ModelInfo("example"))
            for _ in range(6):
                inst.invoke_model("dyn-m", METHOD, b"x", [])
            tasks._rate_tick()
            assert len(inst.registry.get("dyn-m").all_placements) == 1
            binder.config.set("scaleup_rpm_threshold", "1")
            assert _wait(lambda: tasks.config.scale_up_rpm == 1)
            for _ in range(6):
                inst.invoke_model("dyn-m", METHOD, b"x", [])
            tasks._rate_tick()
            assert _wait(lambda: len(
                inst.registry.get("dyn-m").all_placements) >= 2)
            # A threshold below 1 is refused; deleting the key restores
            # the default.
            binder.config.set("scaleup_rpm_threshold", "0")
            time.sleep(0.2)
            assert tasks.config.scale_up_rpm == 1
            c.kv.delete(f"{inst.config.kv_prefix}/config/"
                        "scaleup_rpm_threshold")
            assert _wait(lambda: tasks.config.scale_up_rpm == 2000)
        finally:
            if binder is not None:
                binder.close()
            c.close()


class TestLogEachInvocation:
    def test_flag_applies_live_and_logs(self, caplog):
        c = Cluster(PORT, n=1)
        binder = None
        try:
            inst = c[0].instance
            tasks = PORT.tasks.BackgroundTasks(inst, PORT.tasks.TaskConfig())
            binder = PORT.dynamic.ServingConfigBinder(
                c.kv, inst.config.kv_prefix, inst, tasks.config)
            inst.register_model("log-m", PORT.spi.ModelInfo("example"))
            assert inst.log_each_invocation is False
            binder.config.set("log_each_invocation", "true")
            assert _wait(lambda: inst.log_each_invocation)
            with caplog.at_level(logging.INFO,
                                 "modelmesh_tpu_torch.serving.instance"):
                inst.invoke_model("log-m", METHOD, b"x", [])
            assert any("invoke model=log-m" in r.message
                       for r in caplog.records)
            binder.config.set("log_each_invocation", "false")
            assert _wait(lambda: not inst.log_each_invocation)
        finally:
            if binder is not None:
                binder.close()
            c.close()


class TestDisableDrain:
    def test_disabled_instance_refused_for_placement_then_restored(self):
        c = Cluster(PORT, n=2)
        binders = []
        try:
            for pod in c.pods:
                tasks = PORT.tasks.BackgroundTasks(pod.instance,
                                                   PORT.tasks.TaskConfig())
                binders.append(PORT.dynamic.ServingConfigBinder(
                    c.kv, pod.instance.config.kv_prefix, pod.instance,
                    tasks.config))
            target, other = c[0].instance, c[1].instance
            binders[0].config.set("disable", target.instance_id)
            assert _wait(lambda: target.disabled)
            assert _wait(lambda: any(
                rec.disabled for iid, rec in other.instances_view.items()
                if iid == target.instance_id))
            target.register_model("drain-m", PORT.spi.ModelInfo("example"))
            out = target.invoke_model("drain-m", METHOD, b"x", [])
            assert out.payload.startswith(b"drain-m:")
            assert list(target.registry.get("drain-m").instance_ids) == [
                other.instance_id]
            binders[0].config.set("disable", "")
            assert _wait(lambda: not target.disabled)
            target.register_model("drain-m2", PORT.spi.ModelInfo("example"))
            target.invoke_model("drain-m2", METHOD, b"x", [])
            assert target.registry.get("drain-m2").instance_ids
            # "*" disables every instance.
            binders[1].config.set("disable", "*")
            assert _wait(lambda: target.disabled and other.disabled)
        finally:
            for b in binders:
                b.close()
            c.close()


# -- static registration and the state dump -----------------------------------

STATIC = json.dumps({
    "models": [{"modelId": "s-1", "type": "example", "path": "mem://s1"},
               {"modelId": "s-2", "type": "example", "path": "mem://s2",
                "key": "k2"}],
    "vmodels": [{"vModelId": "s-alias", "targetModelId": "s-3",
                 "type": "example", "path": "mem://s3"}],
})

# Dump and registry fields that carry a bound port or a clock stamp.
_STAMPED = {"now", "lastUsed", "lruTs", "endpoint", "loaded", "loading",
            "rpm", "p99Ms", "last_used", "instance_ids", "host_instances",
            "loading_instances", "last_unload_ms"}


def _scrub(doc):
    if isinstance(doc, dict):
        if "load_failures" in doc:  # (stamp, message) per instance
            doc = dict(doc, load_failures={
                iid: msg for iid, (_, msg) in doc["load_failures"].items()})
        return {k: ("<stamp>" if k in _STAMPED and v else _scrub(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


def _static_script(pkg, monkeypatch) -> dict:
    c = Cluster(pkg, n=2)
    try:
        inst = c[0].instance
        out = {}
        out["from_json"] = pkg.bootstrap.register_static_models(
            inst, c[0].vmodels, config_json=STATIC)
        monkeypatch.setenv("MM_STATIC_MODELS", json.dumps(
            {"models": [{"modelId": "s-env", "type": "example"}]}))
        out["from_env"] = pkg.bootstrap.register_static_models(inst)
        monkeypatch.delenv("MM_STATIC_MODELS")
        out["empty"] = pkg.bootstrap.register_static_models(inst)
        for name, cfg, vm in (
                ("no_vmodels", STATIC, None),
                ("failed", json.dumps({"models": [
                    {"modelId": "fail-load-s", "type": "example"}]}),
                 c[0].vmodels)):
            try:
                pkg.bootstrap.register_static_models(inst, vm,
                                                     config_json=cfg)
                out[name] = None
            except Exception as e:  # noqa: BLE001 — the outcome compared
                out[name] = (type(e).__name__, str(e))
        out["unverified"] = pkg.bootstrap.register_static_models(
            inst, config_json=json.dumps({"models": [
                {"modelId": "s-lazy", "type": "example"}]}), verify=False)
        wait_for(lambda: not inst.registry.get("s-lazy").loading_instances
                 and inst.registry.get("s-lazy").instance_ids,
                 "the unverified load")
        inst.invoke_model("s-1", METHOD, b"d", [])
        for pod in c.pods:
            pod.instance.publish_instance_record(force=True)
        wait_for(lambda: all(
            {m: r.version for m, r in p.instance.registry_view.items()}
            == {m: r.version for m, r in inst.registry.items()}
            for p in c.pods), "the views")
        dump = pkg.bootstrap.debug_dump(inst)
        dump["cache"]["entries"].sort(key=lambda e: e["modelId"])
        out["dump"] = _scrub(dump)
        out["registry"] = _scrub({
            mid: json.loads(mr.to_bytes()) for mid, mr in
            inst.registry.items()})
        # The same dump through the API's reserved diagnostic ids.
        import grpc

        ch = grpc.insecure_channel(c[0].server.endpoint)
        try:
            stub = pkg.grpc_defs.make_stub(ch, pkg.grpc_defs.API_SERVICE,
                                           pkg.grpc_defs.API_METHODS)
            got = []
            for mid in sorted(pkg.bootstrap.STATE_DUMP_ALIASES):
                st = stub.GetModelStatus(pkg.apb.GetModelStatusRequest(
                    model_id=mid), timeout=20)
                got.append((st.model_id, sorted(json.loads(st.errors[0]))))
            out["aliases"] = got
        finally:
            ch.close()
        return out
    finally:
        c.close()


def test_static_models_and_debug_dump_match_reference(monkeypatch):
    port = _static_script(PORT, monkeypatch)
    ref = _static_script(REF, monkeypatch)
    assert port == ref
    assert port["from_json"] == ["s-1", "s-2", "s-3"]
    assert port["from_env"] == ["s-env"] and port["empty"] == []
    assert port["no_vmodels"][0] == "RuntimeError"
    assert "vmodels disabled" in port["no_vmodels"][1]
    assert port["failed"][0] == "ModelLoadException"
    assert "fail-load-s" in port["failed"][1]
    assert {e["modelId"] for e in port["dump"]["cache"]["entries"]} >= {
        "s-1", "s-2"}
    assert port["aliases"][0][0] == "***STATE***"
