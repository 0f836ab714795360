"""The port's autoscale subsystem (``modelmesh_tpu_torch/autoscale/``:
``DemandForecaster``, ``AutoscaleController``) against the JAX package's,
on the CPU.

- **The forecaster:** ``tests/test_autoscale.py``'s ``TestForecaster`` on
  the port, and on seeded rate series (ramps, decays, diurnal shapes,
  several models, a map bounded small enough to evict) every output of
  the port's forecaster exactly equal to the reference's.
- **The controller:** ``TestScaleUp``, ``TestScaleDown``, ``TestPrewarm``,
  ``TestAuthorityGating`` and ``TestRateLeakRegression`` of
  ``tests/test_autoscale.py``, each script run in both packages. The port
  has no ``sim/``, so the fleet is built directly: three instances under
  the package's own installed ``VirtualClock``, each in front of a copy of
  the simulator's streaming loader (``SimLoader``'s load, stream and
  count semantics), peers called directly. Burn is injected through each
  instance's own ``SloTracker``, ticks are driven by hand, and every
  script's decision logs (``AutoscaleController.decisions``, virtual
  timestamps included) must equal the reference controller's.
"""

from __future__ import annotations

import json
import time as _wall
import zlib

import numpy as np
import pytest

from tests.test_torch_api import PORT, REF

SPEC = "hot:p99<100ms;default:p99<10000ms"


# -- the fleet -----------------------------------------------------------------


def _sim_loader(pkg):
    """``modelmesh_tpu/sim/harness.py::SimLoader`` on ``pkg``'s SPI: no
    load delay, deterministic sizes, weight streaming by chunk counts."""
    spi = pkg.spi
    import threading

    class SimLoader(spi.ModelLoader):
        transfer_chunks = 8

        def __init__(self, capacity_bytes=64 << 20,
                     default_size_bytes=8 << 20):
            self.capacity_bytes = capacity_bytes
            self.default_size_bytes = default_size_bytes
            self.loaded_models: dict = {}
            self.load_count = 0
            self.stream_load_count = 0
            self.unload_count = 0
            self._lock = threading.Lock()

        def startup(self):
            return spi.LocalInstanceParams(
                capacity_bytes=self.capacity_bytes, load_concurrency=8,
                load_timeout_ms=30_000)

        def load(self, model_id, info):
            size = self._size_for(model_id)
            with self._lock:
                self.loaded_models[model_id] = size
                self.load_count += 1
            return spi.LoadedModel(handle=model_id, size_bytes=size)

        def predict_size(self, model_id, info):
            return self._size_for(model_id)

        def model_size(self, model_id, handle):
            with self._lock:
                return self.loaded_models.get(model_id, 0)

        def unload(self, model_id):
            with self._lock:
                self.loaded_models.pop(model_id, None)
                self.unload_count += 1

        def is_loaded(self, model_id):
            with self._lock:
                return model_id in self.loaded_models

        def _size_for(self, model_id):
            h = zlib.crc32(model_id.encode()) % 1000
            return int(self.default_size_bytes * (0.5 + h / 1000.0))

        @property
        def supports_weight_streaming(self):
            return True

        def export_weights(self, model_id, handle):
            with self._lock:
                if model_id not in self.loaded_models:
                    return None
            n = self.transfer_chunks
            return (spi.WeightChunk(seq=i, payload=f"{model_id}:{i}".encode(),
                                    layer=i, last=i == n - 1)
                    for i in range(n))

        def load_from_stream(self, model_id, info, chunks,
                             partial_ready=None):
            size = self._size_for(model_id)
            seen = sum(1 for _ in chunks)
            if seen == 0:
                raise spi.ModelLoadException(f"{model_id}: empty stream")
            with self._lock:
                self.loaded_models[model_id] = size
                self.stream_load_count += 1
            return spi.LoadedModel(handle=model_id, size_bytes=size)

    return SimLoader()


class SimPod:
    def __init__(self, instance, loader):
        self.instance = instance
        self.loader = loader

    @property
    def iid(self):
        return self.instance.instance_id


class Fleet:
    """Three instances with direct-call peers under ``pkg``'s installed
    virtual clock; elections closed, leadership set by hand."""

    def __init__(self, pkg, n=3):
        self.pkg = pkg
        self.kv = pkg.memory.InMemoryKV(sweep_interval_s=1.0)
        self.pods: list[SimPod] = []
        for i in range(n):
            loader = _sim_loader(pkg)
            inst = pkg.instance.ModelMeshInstance(
                self.kv, loader, pkg.instance.InstanceConfig(
                    instance_id=f"sim-{i}", endpoint=f"sim-{i}",
                    load_timeout_s=20, space_wait_s=5.0, min_churn_age_ms=0,
                    trace_sample=1, slo_spec=SPEC, slo_window_ms=10_000),
                peer_call=self._peer_call, peer_fetch=self._peer_fetch,
                runtime_call=self._runtime_call)
            self.pods.append(SimPod(inst, loader))
        for pod in self.pods:
            pod.instance.instances_view.wait_for(lambda v: len(v) >= n,
                                                 timeout=10)
        for pod in self.pods:
            pod.instance._election.close()

    def by_id(self, iid):
        return next(p for p in self.pods if p.iid == iid)

    def _peer_call(self, endpoint, model_id, method, payload, headers, ctx):
        pod = self.by_id(endpoint)
        result = pod.instance.invoke_model(model_id, method, payload,
                                           headers, ctx, sync=True)
        result.feedback = pod.instance.load_feedback()
        return result

    def _peer_fetch(self, endpoint, model_id, chunk_index, fingerprint):
        return self.by_id(endpoint).instance.handle_weight_fetch(
            model_id, chunk_index, fingerprint)

    def _runtime_call(self, ce, method, payload, headers, cancel_event=None):
        for pod in self.pods:
            if pod.instance.cache.get_quietly(ce.model_id) is ce:
                if not pod.loader.is_loaded(ce.model_id):
                    raise self.pkg.errors.ModelNotHereError(pod.iid,
                                                            ce.model_id)
                return f"{ce.model_id}:sim".encode()
        raise self.pkg.errors.ModelNotHereError("?", ce.model_id)

    def register(self, model_id, model_type="sim"):
        self.pods[0].instance.register_model(
            model_id, self.pkg.spi.ModelInfo(model_type, f"mem://{model_id}"))

    def close(self):
        for pod in self.pods:
            try:
                pod.instance.shutdown()
            except Exception:  # noqa: BLE001 — teardown
                pass
        self.kv.close()


def _wait_real(pred, timeout=5.0, step=0.01):
    deadline = _wall.monotonic() + timeout
    while not pred():
        if _wall.monotonic() > deadline:
            return False
        _wall.sleep(step)
    return True


def _in_both(script):
    """Run ``script(pkg, fleet, clock)`` in a fresh fleet of each package
    under its own virtual clock; the results must be equal."""
    results = {}
    for pkg in (REF, PORT):
        clock = pkg.clock.VirtualClock()
        prev = pkg.clock.install(clock)
        fleet = Fleet(pkg)
        try:
            results[pkg.root] = script(pkg, fleet, clock)
        finally:
            fleet.close()
            pkg.clock.install(prev)
            clock.close()
    assert results["modelmesh_tpu_torch"] == results["modelmesh_tpu"]
    return results["modelmesh_tpu_torch"]


def _load_copy(pkg, pod, model_id, exclude=None):
    pod.instance.ensure_loaded(model_id, sync=False, exclude=exclude)
    assert _wait_real(lambda: (
        (ce := pod.instance.cache.get_quietly(model_id)) is not None
        and ce.state is pkg.entry.EntryState.ACTIVE
    )), f"{model_id} did not activate on {pod.iid}"


def _load_here(pkg, pod, model_id):
    """A copy onto exactly this pod (the LOAD_LOCAL_ONLY hop)."""
    RC = pkg.instance.RoutingContext
    pod.instance.invoke_model(model_id, None, b"", [],
                              RC(hop=RC.LOAD_LOCAL_ONLY), sync=True)
    ce = pod.instance.cache.get_quietly(model_id)
    assert ce is not None and ce.state is pkg.entry.EntryState.ACTIVE


def _cfg(pkg, **kw):
    kw.setdefault("prewarm", False)
    kw.setdefault("min_burn_samples", 3)
    return pkg.controller.AutoscaleConfig(**kw)


def _burn(inst, n=6, latency_ms=5_000.0):
    for _ in range(n):
        inst.slo.record("hot", latency_ms, True)


def _calm(inst, n=6):
    for _ in range(n):
        inst.slo.record("hot", 10.0, True)


def _decisions(ctrl):
    return [dict(d) for d in ctrl.decisions]


# -- the forecaster ------------------------------------------------------------


def _forecaster_script(pkg, clock, seed: int) -> list:
    rng = np.random.default_rng(seed)
    f = pkg.forecast.DemandForecaster(fast_tau_s=60.0, slow_tau_s=600.0,
                                      diurnal_alpha=0.3 + 0.1 * (seed % 3))
    now = clock.now_ms()
    out = []
    models = [f"m{k}" for k in range(8)]
    for step in range(120):
        now += int(rng.integers(1_000, 3_600_000))
        for mid in rng.choice(models, size=3, replace=False):
            shape = int(mid[1:]) % 4
            if shape == 0:
                rate = float(step) * 3.0
            elif shape == 1:
                rate = 500.0 * np.exp(-step / 20.0)
            elif shape == 2:
                rate = 400.0 if (now // 3_600_000) % 24 in (3, 4) else 2.0
            else:
                rate = float(rng.gamma(2.0, 30.0))
            f.observe(str(mid), rate, now_ms=now)
        if step % 5 == 0:
            f.drop(models[step % len(models)])
        out.append((
            sorted(f.tracked()),
            [(m, f.rate(m), f.forecast(m, h, now_ms=now))
             for m in sorted(f.tracked()) for h in (10.0, 60.0, 3_600.0)],
            f.trending(min_rate=1.0, ratio=1.2, now_ms=now),
            f.trending(min_rate=5.0, ratio=1.5, horizon_s=300.0,
                       now_ms=now),
            [m in f for m in models],
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forecaster_outputs_equal_the_references(seed):
    results = {}
    for pkg in (REF, PORT):
        clock = pkg.clock.VirtualClock()
        prev = pkg.clock.install(clock)
        try:
            with pytest.MonkeyPatch.context() as mp:
                # A small bound, so the script also evicts.
                mp.setattr(pkg.forecast, "MAX_MODELS", 6)
                results[pkg.root] = _forecaster_script(pkg, clock, seed)
        finally:
            pkg.clock.install(prev)
            clock.close()
    assert results["modelmesh_tpu_torch"] == results["modelmesh_tpu"]
    assert any(step[2] for step in results["modelmesh_tpu"])


class TestForecaster:
    def _clock(self):
        clock = PORT.clock.VirtualClock()
        return clock, PORT.clock.install(clock)

    def test_ramp_is_trending_and_projected(self):
        clock, prev = self._clock()
        try:
            f = PORT.forecast.DemandForecaster(fast_tau_s=60.0,
                                               slow_tau_s=600.0)
            now = clock.now_ms()
            for k in range(10):
                f.observe("m", 10.0, now_ms=now + k * 10_000)
            assert f.trending(min_rate=1.0, now_ms=now + 100_000) == []
            for k in range(6):
                f.observe("m", 200.0, now_ms=now + 100_000 + k * 20_000)
            t = now + 220_000
            assert f.trending(min_rate=1.0, ratio=1.5, now_ms=t) == ["m"]
            assert f.forecast("m", 60.0, now_ms=t) > f.rate("m")
        finally:
            PORT.clock.install(prev)
            clock.close()

    def test_diurnal_phase_floors_the_forecast(self):
        clock, prev = self._clock()
        try:
            DF = PORT.forecast.DemandForecaster
            f = DF(fast_tau_s=60.0, slow_tau_s=600.0)
            base = clock.now_ms()
            spike_hour = DF._hour(base + 3_600_000)
            for day in range(2):
                day_ms = base + day * 24 * 3_600_000
                for h in range(24):
                    t = day_ms + h * 3_600_000
                    rate = 500.0 if DF._hour(t) == spike_hour else 1.0
                    f.observe("d", rate, now_ms=t)
            t = base + 2 * 24 * 3_600_000
            assert f.forecast("d", 10.0, now_ms=t) < 100.0
            assert f.forecast("d", 3_600.0, now_ms=t) >= 400.0
        finally:
            PORT.clock.install(prev)
            clock.close()

    def test_trending_orders_hottest_first_and_is_deterministic(self):
        clock, prev = self._clock()
        try:
            f = PORT.forecast.DemandForecaster(fast_tau_s=60.0,
                                               slow_tau_s=600.0)
            now = clock.now_ms()
            for mid, rate in (("a", 50.0), ("b", 500.0)):
                f.observe(mid, 0.0, now_ms=now)
                f.observe(mid, rate, now_ms=now + 30_000)
            assert f.trending(now_ms=now + 30_000) == ["b", "a"]
        finally:
            PORT.clock.install(prev)
            clock.close()


# -- reactive scale-up ---------------------------------------------------------


class TestScaleUp:
    def test_burning_class_gets_copies_before_breach_clears(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = True
            fleet.register("m-up", "hot")
            _load_copy(pkg, pod, "m-up")
            inst.registry_view.wait_for(
                lambda v: (r := v.get("m-up")) is not None and r.instance_ids)
            ctrl = pkg.controller.AutoscaleController(inst, _cfg(pkg))
            _burn(inst)
            ctrl.tick()
            assert _wait_real(
                lambda: len(inst.registry.get("m-up").instance_ids) >= 2)
            assert any(e["kind"] == "autoscale-up"
                       for e in inst.flightrec.dump())
            return _decisions(ctrl)

        ups = [d for d in _in_both(script) if d["kind"] == "autoscale-up"]
        assert ups and ups[0]["model"] == "m-up"
        assert ups[0]["slo_class"] == "hot" and ups[0]["burn"] >= 1.0

    def test_flash_burn_doubles_capped_at_the_fleet(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = True
            fleet.register("m-dub", "hot")
            _load_copy(pkg, pod, "m-dub")
            _load_here(pkg, fleet.pods[1], "m-dub")
            assert _wait_real(
                lambda: len(inst.registry.get("m-dub").instance_ids) == 2)
            inst.registry_view.wait_for(
                lambda v: (r := v.get("m-dub")) is not None
                and len(r.instance_ids) == 2)
            ctrl = pkg.controller.AutoscaleController(inst, _cfg(pkg))
            _burn(inst)
            ctrl.tick()
            assert _wait_real(
                lambda: len(inst.registry.get("m-dub").instance_ids) == 3)
            return _decisions(ctrl)

        ups = [d for d in _in_both(script) if d["kind"] == "autoscale-up"]
        assert ups and ups[0]["copies"] == 2 and ups[0]["adds"] == 1, ups

    def test_calm_class_never_scales(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = True
            fleet.register("m-calm", "hot")
            _load_copy(pkg, pod, "m-calm")
            ctrl = pkg.controller.AutoscaleController(inst, _cfg(pkg))
            _calm(inst)
            ctrl.tick()
            return (_decisions(ctrl),
                    len(inst.registry.get("m-calm").instance_ids))

        assert _in_both(script) == ([], 1)

    def test_non_leader_never_scales_up(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = False
            fleet.register("m-nl", "hot")
            _load_copy(pkg, pod, "m-nl")
            ctrl = pkg.controller.AutoscaleController(inst, _cfg(pkg))
            _burn(inst)
            ctrl.tick()
            return (_decisions(ctrl),
                    len(inst.registry.get("m-nl").instance_ids))

        decisions, copies = _in_both(script)
        assert not any(d["kind"] == "autoscale-up" for d in decisions)
        assert copies == 1

    def test_holddown_suppresses_readds_until_landed_or_expired(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = True
            fleet.register("m-hold", "hot")
            _load_copy(pkg, pod, "m-hold")
            inst.registry_view.wait_for(
                lambda v: (r := v.get("m-hold")) is not None
                and r.instance_ids)
            calls = []
            real_ensure = inst.ensure_loaded
            inst.ensure_loaded = lambda *a, **k: calls.append(k)
            counts = []
            try:
                ctrl = pkg.controller.AutoscaleController(
                    inst, _cfg(pkg, holddown_ms=60_000))
                _burn(inst)
                ctrl.tick()
                counts.append(len(calls))
                _burn(inst)
                ctrl.tick()
                counts.append(len(calls))
                clock.advance(61_000)
                _burn(inst)
                ctrl.tick()
                counts.append(len(calls))
            finally:
                inst.ensure_loaded = real_ensure
            return counts, calls, _decisions(ctrl)

        counts, calls, _ = _in_both(script)
        assert counts == [1, 1, 2]

    def test_copy_cap_bounds_the_add(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            inst.is_leader = True
            fleet.register("m-cap", "hot")
            _load_copy(pkg, pod, "m-cap")
            ctrl = pkg.controller.AutoscaleController(
                inst, _cfg(pkg, max_copies=1))
            _burn(inst)
            ctrl.tick()
            return (_decisions(ctrl),
                    len(inst.registry.get("m-cap").instance_ids))

        assert _in_both(script) == ([], 1)


# -- reversible scale-down -----------------------------------------------------


def _two_copies(pkg, fleet, model_id):
    fleet.register(model_id, "hot")
    _load_copy(pkg, fleet.pods[0], model_id)
    inst0 = fleet.pods[0].instance
    _load_here(pkg, fleet.pods[1], model_id)
    assert _wait_real(
        lambda: len(inst0.registry.get(model_id).instance_ids) == 2)
    mr = inst0.registry.get(model_id)
    shedder_id = max(mr.instance_ids.items(),
                     key=lambda kv: (kv[1], kv[0]))[0]
    shedder = fleet.by_id(shedder_id)
    shedder.instance.registry_view.wait_for(
        lambda v: (r := v.get(model_id)) is not None
        and len(r.instance_ids) == 2)
    return shedder


class TestScaleDown:
    def test_surplus_copy_demotes_to_host_tier_and_rewarms(self):
        def script(pkg, fleet, clock):
            shedder = _two_copies(pkg, fleet, "m-down")
            inst = shedder.instance
            ctrl = pkg.controller.AutoscaleController(
                inst, _cfg(pkg, surplus_min_age_ms=0, idle_ticks_down=1))
            ctrl.tick()
            assert inst.cache.get_quietly("m-down") is None
            assert inst.host_tier.peek("m-down") is not None
            mr = inst.registry.get("m-down")
            assert inst.instance_id not in mr.instance_ids
            assert inst.instance_id in mr.host_instances
            store_loads = shedder.loader.load_count
            streams = shedder.loader.stream_load_count
            _load_here(pkg, shedder, "m-down")
            assert shedder.loader.stream_load_count == streams + 1
            assert shedder.loader.load_count == store_loads
            return shedder.iid, _decisions(ctrl)

        _, decisions = _in_both(script)
        downs = [d for d in decisions if d["kind"] == "autoscale-down"]
        assert downs and downs[0]["model"] == "m-down"

    def test_min_age_antithrash_blocks_the_shed(self):
        def script(pkg, fleet, clock):
            shedder = _two_copies(pkg, fleet, "m-young")
            ctrl = pkg.controller.AutoscaleController(
                shedder.instance,
                _cfg(pkg, surplus_min_age_ms=10**9, idle_ticks_down=1))
            ctrl.tick()
            return (_decisions(ctrl),
                    shedder.instance.cache.get_quietly("m-young") is None)

        assert _in_both(script) == ([], False)

    def test_burning_class_blocks_the_shed(self):
        def script(pkg, fleet, clock):
            shedder = _two_copies(pkg, fleet, "m-press")
            inst = shedder.instance
            ctrl = pkg.controller.AutoscaleController(
                inst, _cfg(pkg, surplus_min_age_ms=0, idle_ticks_down=1))
            _burn(inst)
            ctrl.tick()
            return (_decisions(ctrl),
                    inst.cache.get_quietly("m-press") is None)

        decisions, gone = _in_both(script)
        assert not any(d["kind"] == "autoscale-down" for d in decisions)
        assert not gone

    def test_capacity_valve_sheds_without_calm(self):
        def script(pkg, fleet, clock):
            shedder = _two_copies(pkg, fleet, "m-full")
            inst = shedder.instance
            ctrl = pkg.controller.AutoscaleController(
                inst, _cfg(pkg, surplus_min_age_ms=0, idle_ticks_down=10**6))
            _burn(inst)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(pkg.tasks, "cluster_fullness",
                           lambda i, t=None: 1.0)
                ctrl.tick()
            assert inst.cache.get_quietly("m-full") is None
            assert inst.host_tier.peek("m-full") is not None
            return _decisions(ctrl)

        downs = [d for d in _in_both(script) if d["kind"] == "autoscale-down"]
        assert downs and downs[0]["reason"] == "full"

    def test_in_flight_add_blocks_the_shed(self):
        def script(pkg, fleet, clock):
            shedder = _two_copies(pkg, fleet, "m-adding")
            inst = shedder.instance

            def claim(cur):
                cur.claim_loading("sim-elsewhere")
                return cur

            inst.registry.update_or_create("m-adding", claim)
            inst.registry_view.wait_for(
                lambda v: (r := v.get("m-adding")) is not None
                and r.loading_instances)
            ctrl = pkg.controller.AutoscaleController(
                inst, _cfg(pkg, surplus_min_age_ms=0, idle_ticks_down=1))
            ctrl.tick()
            return (_decisions(ctrl),
                    inst.cache.get_quietly("m-adding") is None)

        decisions, gone = _in_both(script)
        assert not any(d["kind"] == "autoscale-down" for d in decisions)
        assert not gone

    def test_sole_ready_copy_is_never_shed(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            fleet.register("m-sole", "hot")
            _load_copy(pkg, pod, "m-sole")
            ctrl = pkg.controller.AutoscaleController(
                pod.instance,
                _cfg(pkg, surplus_min_age_ms=0, idle_ticks_down=1))
            ctrl.tick()
            return (_decisions(ctrl),
                    pod.instance.cache.get_quietly("m-sole") is None)

        assert _in_both(script) == ([], False)


# -- predictive pre-warming ----------------------------------------------------


class TestPrewarm:
    def test_leader_plan_prewarm_targets_stage_host_snapshots(self):
        def script(pkg, fleet, clock):
            leader = fleet.pods[0]
            inst = leader.instance
            inst.is_leader = True
            fleet.register("m-pre", "hot")
            _load_copy(pkg, leader, "m-pre")
            for p in fleet.pods:
                p.instance.registry_view.wait_for(
                    lambda v: (r := v.get("m-pre")) is not None
                    and r.instance_ids)
            cfg = pkg.controller.AutoscaleConfig(
                prewarm=True, prewarm_min_rate=1.0, prewarm_ratio=1.2,
                min_burn_samples=3)
            ctrl = pkg.controller.AutoscaleController(inst, cfg)
            ctrl.tick()
            inst._model_rate("m-pre").record(500)
            clock.advance(2_000)
            ctrl.tick()
            clock.advance(2_000)
            ctrl.tick()
            kv = inst.store.get(
                pkg.controller.prewarm_plan_key(inst.config.kv_prefix))
            plan = json.loads(kv.value.decode())
            assert plan.get("m-pre"), plan
            target = fleet.by_id(plan["m-pre"][0])
            t_inst = target.instance
            t_ctrl = pkg.controller.AutoscaleController(t_inst, cfg)
            store_loads = target.loader.load_count
            t_ctrl.tick()
            assert _wait_real(
                lambda: t_inst.host_tier.peek("m-pre") is not None)
            assert target.loader.load_count == store_loads
            assert _wait_real(lambda: any(
                d["kind"] == "autoscale-prewarmed" for d in t_ctrl.decisions))
            assert _wait_real(lambda: t_inst.instance_id
                              in inst.registry.get("m-pre").host_instances)
            streams = target.loader.stream_load_count
            _load_here(pkg, target, "m-pre")
            assert target.loader.stream_load_count == streams + 1
            assert target.loader.load_count == store_loads
            return plan, _decisions(ctrl), _decisions(t_ctrl)

        plan, lead, target = _in_both(script)
        assert any(d["kind"] == "autoscale-prewarm-plan" for d in lead)
        assert [d["kind"] for d in target] == ["autoscale-prewarmed"]

    def test_uncovered_model_without_holder_is_not_planned(self):
        def script(pkg, fleet, clock):
            inst = fleet.pods[0].instance
            inst.is_leader = True
            fleet.register("m-cold", "hot")
            cfg = pkg.controller.AutoscaleConfig(
                prewarm=True, prewarm_min_rate=0.5, prewarm_ratio=1.1)
            ctrl = pkg.controller.AutoscaleController(inst, cfg)
            ctrl.tick()
            inst._model_rate("m-cold").record(500)
            clock.advance(2_000)
            ctrl.tick()
            kv = inst.store.get(
                pkg.controller.prewarm_plan_key(inst.config.kv_prefix))
            plan = {} if kv is None else json.loads(kv.value.decode())
            return plan, _decisions(ctrl)

        plan, _ = _in_both(script)
        assert "m-cold" not in plan


# -- scaling-authority gating (MM_AUTOSCALE) -----------------------------------


class TestAuthorityGating:
    def test_default_mode_is_legacy_with_no_controller(self):
        def script(pkg, fleet, clock):
            tasks = pkg.tasks.BackgroundTasks(fleet.pods[0].instance)
            return tasks.config.autoscale_mode, tasks.autoscaler is None

        assert _in_both(script) == ("legacy", True)

    def test_exactly_one_scaling_task_per_mode(self):
        def script(pkg, fleet, clock):
            out = {}
            for mode in ("legacy", "burn", "off"):
                tasks = pkg.tasks.BackgroundTasks(
                    fleet.pods[0].instance,
                    pkg.tasks.TaskConfig(autoscale_mode=mode))
                try:
                    tasks.start()
                    out[mode] = (sorted(t.name.split("-")[1]
                                        for t in tasks._threads),
                                 tasks.autoscaler is not None)
                finally:
                    tasks.stop()
            return out

        out = _in_both(script)
        assert out["legacy"] == (["janitor", "publisher", "rate", "reaper"],
                                 False)
        assert out["burn"] == (["autoscale", "janitor", "publisher",
                                "reaper"], True)
        assert out["off"] == (["janitor", "publisher", "reaper"], False)

    def test_burn_controller_inherits_the_task_configs_bounds(self):
        def script(pkg, fleet, clock):
            shared = pkg.controller.AutoscaleConfig(prewarm=False)
            tasks = pkg.tasks.BackgroundTasks(
                fleet.pods[0].instance, pkg.tasks.TaskConfig(
                    autoscale_mode="burn", max_copies=3, scale_up_rpm=77,
                    autoscale=shared))
            pinned = pkg.tasks.BackgroundTasks(
                fleet.pods[0].instance, pkg.tasks.TaskConfig(
                    autoscale_mode="burn", max_copies=3,
                    autoscale=pkg.controller.AutoscaleConfig(
                        prewarm=False, max_copies=5)))
            cfg = tasks.autoscaler.cfg
            return (cfg.max_copies, cfg.scale_up_rpm, shared.max_copies,
                    pinned.autoscaler.cfg.max_copies)

        assert _in_both(script) == (3, 77, 8, 5)

    def test_janitor_scale_down_only_under_legacy(self):
        def script(pkg, fleet, clock):
            out = {}
            for mode in ("legacy", "burn", "off"):
                tasks = pkg.tasks.BackgroundTasks(
                    fleet.pods[0].instance,
                    pkg.tasks.TaskConfig(autoscale_mode=mode))
                calls = []
                tasks._maybe_scale_down = lambda: calls.append(1)
                tasks._janitor_tick()
                out[mode] = len(calls)
            return out

        assert _in_both(script) == {"legacy": 1, "burn": 0, "off": 0}

    def test_junk_mode_raises(self, monkeypatch):
        for pkg in (PORT, REF):
            with pytest.raises(ValueError):
                pkg.tasks.TaskConfig(autoscale_mode="junk")
        monkeypatch.setenv("MM_AUTOSCALE", "off")
        assert PORT.tasks.TaskConfig().autoscale_mode == "off"
        monkeypatch.setenv("MM_AUTOSCALE_BURN_UP", "0.75")
        monkeypatch.setenv("MM_AUTOSCALE_HOLDDOWN_MS", "123")
        monkeypatch.setenv("MM_AUTOSCALE_PREWARM", "0")
        got = [vars(pkg.controller.AutoscaleConfig()) for pkg in (PORT, REF)]
        assert got[0] == got[1]
        assert got[0]["burn_up"] == 0.75 and got[0]["holddown_ms"] == 123
        assert got[0]["prewarm"] is False


# -- rate-tracker residual state (delete -> re-register) -----------------------


class TestRateLeakRegression:
    MIN_AGE = 5_000

    def _tasks(self, pkg, pod):
        return pkg.tasks.BackgroundTasks(pod.instance, pkg.tasks.TaskConfig(
            autoscale_mode="legacy", second_copy_min_age_ms=self.MIN_AGE,
            second_copy_max_age_ms=10**9))

    def test_reregistered_model_does_not_inherit_prev_use(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            tasks = self._tasks(pkg, pod)
            fleet.register("m-flap", "hot")
            _load_copy(pkg, pod, "m-flap")
            inst.invoke_model("m-flap", "/sim/Predict", b"x", [])
            tasks._rate_tick()
            assert "m-flap" in tasks._prev_use
            assert inst.unregister_model("m-flap")
            assert _wait_real(lambda: inst.cache.get_quietly("m-flap")
                              is None)
            fleet.register("m-flap", "hot")
            _load_copy(pkg, pod, "m-flap")
            clock.advance(self.MIN_AGE + 1_000)
            inst.invoke_model("m-flap", "/sim/Predict", b"x", [])
            adds = []
            tasks._add_copy = lambda mid, mr: adds.append(mid)
            tasks._rate_tick()
            return adds

        assert _in_both(script) == []

    def test_same_incarnation_used_again_still_scales(self):
        def script(pkg, fleet, clock):
            pod = fleet.pods[0]
            inst = pod.instance
            tasks = self._tasks(pkg, pod)
            fleet.register("m-keep", "hot")
            _load_copy(pkg, pod, "m-keep")
            inst.invoke_model("m-keep", "/sim/Predict", b"x", [])
            tasks._rate_tick()
            clock.advance(self.MIN_AGE + 1_000)
            inst.invoke_model("m-keep", "/sim/Predict", b"x", [])
            adds = []
            tasks._add_copy = lambda mid, mr: adds.append(mid)
            tasks._rate_tick()
            return adds

        assert _in_both(script) == ["m-keep"]


def test_shared_scaling_helpers_match_reference():
    """``cluster_fullness``, ``surplus_shed_eligible`` and
    ``elected_shedder`` on one fleet state, in both packages."""
    def script(pkg, fleet, clock):
        shedder = _two_copies(pkg, fleet, "m-help")
        inst = shedder.instance
        mr = inst.registry_view.get("m-help")
        now = clock.now_ms()
        return (pkg.tasks.cluster_fullness(inst),
                pkg.tasks.cluster_fullness(inst, "hot"),
                pkg.tasks.elected_shedder(mr) == shedder.iid,
                [pkg.tasks.surplus_shed_eligible(inst, "m-help", mr, now,
                                                 age, 2000)
                 for age in (0, 10**9)],
                pkg.tasks.surplus_shed_eligible(
                    fleet.pods[2].instance, "m-help", mr, now, 0, 2000))

    full, full_hot, elected, eligible, other = _in_both(script)
    assert 0 < full < 1 and elected and eligible == [True, False]
    assert other is False
