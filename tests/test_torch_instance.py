"""The port's serving instance (``modelmesh_tpu_torch/serving/
instance.py``) against the JAX package's, on the CPU.

- **Scripted fleets.** A fleet of 3 and a fleet of 1 run in both
  packages, on each package's own ``InMemoryKV``, each pod in front of its
  package's copy of one stub loader (``tests/test_load_pipeline.py``'s
  shape: sizes from the model path, synthetic failures, unloads behind a
  gate) with peers called directly. The 3-pod script: register, status,
  a miss that loads, a forward, a local hit, a chained fan-out, an
  unregister, a pod's ``pre_shutdown`` (the drain to survivors). The
  1-pod script: loads to capacity, a touch, an eviction, a space wait
  behind a gated unload, a load failure, its exclusion, and its expiry
  (the expiry knob set to 0, which it reads on each call).
  Compared: every invoke result (payload, ``served_by``, status) and
  raised error, the entry states, the eviction order, the loads and
  unloads, and the final KV store. The reference runs twice: a record
  field whose value differs between its own two runs moves with thread
  timing or the wall clock, and is compared by presence only; every
  other field is compared by value (``TIMING_FIELDS`` names the ones
  that may move).
- **The slice as a whole.** A port instance in front of
  ``InProcessTorchLoader(device="cpu")`` and a reference instance in
  front of ``InProcessJaxLoader`` register the same family specs at small
  widths and answer the same seeded payloads through ``invoke_model``
  with the batcher engaged (the port from four client threads, so that
  batches form, the reference from one): outputs within
  ``tests/test_torch_models.py``'s ``FORWARD_TOL``.
- **Plan-driven placement.** A port fleet whose leader runs the port's
  ``reaper_plan_step`` on ``TorchPlacementStrategy(device="cpu")``: every
  follower adopts the plan, and each cache miss loads where the adopted
  plan says.
- **Capacity units.** For every family spec the chip smoke serves, the
  port loader's ``predict_size``/``model_size`` through the port's
  ``bytes_to_units`` give the units ``InProcessJaxLoader`` gives through
  the reference's (the reference model's parameter shapes and dtypes by
  ``jax.eval_shape``, its sizes by the reference's own accounting).
"""

import contextlib
import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import modelmesh_tpu.kv.memory as ref_memory
import modelmesh_tpu.runtime.spi as ref_spi
import modelmesh_tpu.serving.entry as ref_entry
import modelmesh_tpu.serving.errors as ref_errors
import modelmesh_tpu.serving.instance as ref_instance
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.kv.memory as port_memory
import modelmesh_tpu_torch.runtime.spi as port_spi
import modelmesh_tpu_torch.serving.entry as port_entry
import modelmesh_tpu_torch.serving.errors as port_errors
import modelmesh_tpu_torch.serving.instance as port_instance
import modelmesh_tpu_torch.utils.clock as port_clock
from modelmesh_tpu.models import families as jf
from modelmesh_tpu.models.server import InProcessJaxLoader
from modelmesh_tpu_torch.models import families as tf
from modelmesh_tpu_torch.models.server import InProcessTorchLoader
from modelmesh_tpu_torch.placement import plan_sync
from modelmesh_tpu_torch.placement.torch_engine import TorchPlacementStrategy
from modelmesh_tpu_torch.serving.tasks import reaper_plan_step

REF = types.SimpleNamespace(memory=ref_memory, spi=ref_spi, entry=ref_entry,
                            errors=ref_errors, instance=ref_instance,
                            clock=ref_clock)
PORT = types.SimpleNamespace(memory=port_memory, spi=port_spi,
                             entry=port_entry, errors=port_errors,
                             instance=port_instance, clock=port_clock)
UNIT = 8 * 1024
WAIT_S = 20.0
# Record fields whose values the reference's own two runs give
# differently: wall-clock stamps (load, use and failure times, the
# instance's start and LRU stamps) and the failure message's time. They
# are compared by presence; any other field that moved would fail.
TIMING_FIELDS = {"instance_ids", "loading_instances", "load_failures",
                 "host_instances", "last_used", "last_unload_ms",
                 "start_ts", "lru_ts", "req_per_minute"}


def _wait(pred, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# -- the scripted fleets -------------------------------------------------------


def _stub_loader(pkg, capacity_units: int):
    """The stub loader on ``pkg``'s SPI: a model's size is the ``u=`` of
    its path in cache units; ids in ``fail`` fail to load; unloads wait
    on ``unload_gate``."""
    spi = pkg.spi

    class StubLoader(spi.ModelLoader):
        def __init__(self):
            self.lock = threading.Lock()
            self.loads: list = []
            self.unloads: list = []
            self.fail: set = set()
            self.unload_gate = threading.Event()
            self.unload_gate.set()

        def startup(self):
            return spi.LocalInstanceParams(
                capacity_bytes=capacity_units * UNIT, load_timeout_ms=10_000)

        @staticmethod
        def _bytes(info) -> int:
            return int(info.model_path.rsplit("u=", 1)[1]) * UNIT

        def load(self, model_id, info):
            if model_id in self.fail:
                raise spi.ModelLoadException(
                    f"synthetic failure of {model_id}")
            with self.lock:
                self.loads.append(model_id)
            return spi.LoadedModel(handle=model_id,
                                   size_bytes=self._bytes(info))

        def predict_size(self, model_id, info):
            return self._bytes(info)

        def unload(self, model_id):
            assert self.unload_gate.wait(WAIT_S)
            with self.lock:
                self.unloads.append(model_id)

        @property
        def requires_unload(self):
            return True

    return StubLoader()


def _fleet(pkg, n, kv, loaders):
    """Pods i-0.. with direct-call peers (``tests/test_load_pipeline.py``'s
    ``_instance``/``_fleet``); the runtime call answers the model id and
    the payload."""
    by_endpoint: dict = {}

    def peer_call(endpoint, model_id, method, payload, headers, ctx):
        inst = by_endpoint.get(endpoint)
        if inst is None:
            raise pkg.errors.ServiceUnavailableError(endpoint)
        return inst.invoke_model(model_id, method, payload, headers, ctx,
                                 sync=True)

    insts = []
    try:
        for i in range(n):
            inst = pkg.instance.ModelMeshInstance(
                kv, loaders[i],
                pkg.instance.InstanceConfig(
                    instance_id=f"i-{i}", endpoint=f"ep-{i}",
                    load_timeout_s=10, min_churn_age_ms=0,
                    publish_coalesce_ms=0, load_fastpath=True),
                peer_call=peer_call,
                runtime_call=(lambda ce, method, payload, headers,
                              cancel_event=None:
                              ce.model_id.encode() + b"|" + payload))
            by_endpoint[inst.config.endpoint] = inst
            insts.append(inst)
        for inst in insts:
            inst.instances_view.wait_for(lambda v: len(v) >= n,
                                         timeout=WAIT_S)
    except BaseException:
        for inst in insts:
            inst.shutdown()
        raise
    return insts


def _sync_views(insts) -> None:
    """Every live pod's watch-fed views hold what the KV holds: each
    registry record at its KV version, and the live instances. Requests
    route from these views, so a step that follows a registry write
    waits here first."""
    live = [i for i in insts if not i.shutting_down]

    def synced():
        kv_records = {mid: mr.version for mid, mr in live[0].registry.items()}
        kv_insts = {iid for iid, _ in live[0].instances.items()}
        for inst in live:
            view = {mid: mr.version for mid, mr in inst.registry_view.items()}
            if view != kv_records:
                return False
            if {iid for iid, _ in inst.instances_view.items()} != kv_insts:
                return False
        return True

    _wait(synced, "the pods' views catching up with the KV")


def _invoke(insts, inst, model_id: str, payload: bytes):
    """One request at ``inst`` once the views hold the KV's state."""
    _sync_views(insts)
    return _result(lambda: inst.invoke_model(model_id, "predict", payload,
                                             []))


def _result(fn):
    try:
        r = fn()
    except Exception as e:  # noqa: BLE001 — the outcome compared
        return ("error", type(e).__name__, str(e))
    return ("ok", r.payload, r.served_by, r.status)


def _states(insts) -> dict:
    return {inst.instance_id: sorted(
        (mid, ce.state.name) for mid, ce, _ in inst.cache.descending_items())
        for inst in insts if not inst.shutting_down}


def _quiesce(insts) -> None:
    """No load, unload or cleanup in flight; the registry agrees with the
    caches; then every live pod publishes its record once more."""
    live = [i for i in insts if not i.shutting_down]

    def settled():
        for inst in live:
            if inst._unload_pool.pending or inst._cleanup_pool.pending:
                return False
        for mid, mr in live[0].registry.items():
            holders = {i.instance_id for i in live
                       if (ce := i.cache.get_quietly(mid)) is not None
                       and ce.state.name == "ACTIVE"}
            if set(mr.instance_ids) != holders or mr.loading_instances:
                return False
        return True

    _wait(settled, "the fleet settling")
    for inst in live:
        inst.publish_instance_record(force=True)
    _sync_views(insts)


def _store(kv) -> dict:
    return {x.key: x.value for x in kv.range("")}


def _info(pkg, units: int):
    return pkg.spi.ModelInfo("stub", f"mem://u={units}")


def _routing(pkg, insts, loaders) -> dict:
    a, b, c = insts
    out: dict = {}
    for mid, u in (("m-a", 1), ("m-b", 1), ("m-c", 2), ("m-d", 1)):
        a.register_model(mid, _info(pkg, u))
    out["status0"] = [a.get_status(m)[0]
                      for m in ("m-a", "m-b", "m-c", "m-z")]
    out["miss"] = _invoke(insts, a, "m-a", b"1")
    holder = out["miss"][2]
    by_id = {i.instance_id: i for i in insts}
    other = next(i for i in insts if i.instance_id != holder)
    out["forward"] = _invoke(insts, other, "m-a", b"2")
    out["local"] = _invoke(insts, by_id[holder], "m-a", b"3")
    # The chained fan-out: a copy here, two more claimed at once.
    out["chain"] = a.ensure_loaded("m-b", sync=True, chain=2)
    _wait(lambda: len(a.registry.get("m-b").instance_ids) == 3,
          "the fan-out's copies")
    out["m-c"] = _invoke(insts, b, "m-c", b"4")
    out["unregistered"] = a.unregister_model("m-c")
    _wait(lambda: all(i.cache.get_quietly("m-c") is None for i in insts),
          "every copy of m-c dropping")
    out["gone"] = _invoke(insts, b, "m-c", b"5")
    out["m-d"] = _invoke(insts, c, "m-d", b"6")
    _quiesce(insts)
    out["states_before_drain"] = _states(insts)
    # The pod holding m-d drains: its copies move to survivors first.
    drained = by_id[out["m-d"][2]]
    drained.pre_shutdown()
    out["drained"] = drained.instance_id
    _quiesce(insts)
    out["after_drain"] = _invoke(insts, a, "m-d", b"7")
    _quiesce(insts)
    out["status1"] = [a.get_status(m)[0]
                      for m in ("m-a", "m-b", "m-c", "m-d")]
    out["states"] = _states(insts)
    out["loads"] = [sorted(ld.loads) for ld in loaders]
    out["unloads"] = [sorted(ld.unloads) for ld in loaders]
    return out


@contextlib.contextmanager
def _env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _next_ms(pkg) -> None:
    """Wait for the clock's next millisecond: the cache orders entries
    by last-use stamps in ms (insertion order breaks ties), so a touch
    that must count as newer waits for the stamp to move."""
    now = pkg.clock.now_ms()
    _wait(lambda: pkg.clock.now_ms() > now, "the next millisecond")


def _evictions(inst) -> list:
    return [e["model"] for e in inst.flightrec.dump()
            if e["kind"] == "state" and e.get("to") == "removed"]


def _lifecycle(pkg, insts, loaders) -> dict:
    a, ld = insts[0], loaders[0]
    out: dict = {}
    for k, u in enumerate((1, 1, 1, 1, 2, 1)):
        a.register_model(f"e-{k}", _info(pkg, u))
    a.register_model("e-bad", _info(pkg, 1))
    out["fill"] = []
    for k in range(4):
        _next_ms(pkg)
        out["fill"].append(_invoke(insts, a, f"e-{k}", b"f"))
    _next_ms(pkg)
    out["touch"] = _invoke(insts, a, "e-0", b"t")
    _next_ms(pkg)
    # e-4 (2 units) into a full cache: the two least recently used go.
    out["evicting_load"] = _invoke(insts, a, "e-4", b"g")
    _wait(lambda: len(ld.unloads) == 2, "the evicted copies unloading")
    _next_ms(pkg)
    _sync_views(insts)
    # Space wait: the next eviction's unload is held; e-5's load waits in
    # WAITING until the unload frees its units.
    ld.unload_gate.clear()
    got: dict = {}
    th = threading.Thread(target=lambda: got.update(r=_result(
        lambda: a.invoke_model("e-5", "predict", b"h", []))))
    th.start()
    _wait(lambda: (ce := a.cache.get_quietly("e-5")) is not None
          and ce.state.name == "WAITING", "e-5 waiting for space")
    out["waiting"] = a.cache.get_quietly("e-5").state.name
    ld.unload_gate.set()
    th.join(WAIT_S)
    out["after_wait"] = got["r"]
    # A failed load, the exclusion while it is recorded, and its expiry.
    ld.fail.add("e-bad")
    out["failed"] = _invoke(insts, a, "e-bad", b"")
    # The failure reaches the record after the waiter is woken.
    _wait(lambda: "i-0" in a.registry.get("e-bad").load_failures,
          "the failure's record")
    status, mr = a.get_status("e-bad")
    out["failed_status"] = (status, sorted(mr.load_failures))
    ld.fail.clear()
    # Inside the expiry window (the 15 min default) the failed pod stays
    # excluded; with the expiry at 0 (read per call) the failure has
    # expired and the load goes ahead.
    out["excluded"] = _invoke(insts, a, "e-bad", b"x")
    with _env("MM_LOAD_FAILURE_EXPIRY_MS", "0"):
        out["expired"] = _invoke(insts, a, "e-bad", b"y")
    _quiesce(insts)
    out["evictions"] = _evictions(a)
    out["states"] = _states(insts)
    out["loads"] = [list(ld.loads)]
    out["unloads"] = [list(ld.unloads)]
    return out


def _run_fleet(pkg, n, capacity_units, scenario):
    kv = pkg.memory.InMemoryKV(sweep_interval_s=3600.0)
    loaders = [_stub_loader(pkg, capacity_units) for _ in range(n)]
    insts = []
    try:
        insts = _fleet(pkg, n, kv, loaders)
        out = scenario(pkg, insts, loaders)
        out["store"] = _store(kv)
        return out
    finally:
        for inst in insts:
            inst.shutdown()
        kv.close()


def _fields(store: dict) -> dict:
    """key -> {field path: value}; a dict field keyed by instance ids
    contributes one path per id."""
    out = {}
    for key, raw in store.items():
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = raw.decode("latin-1")
        flat: dict = {}

        def walk(v, path):
            if isinstance(v, dict) and v:
                for k, x in v.items():
                    walk(x, path + (k,))
            else:
                flat[path] = v if not isinstance(v, list) else tuple(v)

        walk(doc, ())
        out[key] = flat
    return out


def _compare_stores(ref1: dict, ref2: dict, port: dict) -> set:
    """The port's store against the reference's: the same keys, the same
    field paths, and equal values wherever the reference's two runs
    agree. Returns the field names that moved between those runs."""
    f1, f2, fp = _fields(ref1), _fields(ref2), _fields(port)
    assert sorted(f1) == sorted(f2) == sorted(fp)
    moved = set()
    for key in f1:
        assert sorted(f1[key]) == sorted(f2[key]) == sorted(fp[key]), key
        for path, v in f1[key].items():
            if f2[key][path] != v:
                moved.add(path[0] if path else key)
                continue
            assert fp[key][path] == v, (key, path, fp[key][path], v)
    return moved


def _scripted(n, capacity_units, scenario):
    ref1 = _run_fleet(REF, n, capacity_units, scenario)
    ref2 = _run_fleet(REF, n, capacity_units, scenario)
    port = _run_fleet(PORT, n, capacity_units, scenario)
    moved = _compare_stores(ref1.pop("store"), ref2.pop("store"),
                            port.pop("store"))
    assert moved <= TIMING_FIELDS, moved - TIMING_FIELDS
    assert ref1 == ref2
    assert port == ref1
    return port


def test_scripted_fleet_of_three_matches_reference():
    out = _scripted(3, 6, _routing)
    assert out["status0"] == ["NOT_LOADED"] * 3 + ["NOT_FOUND"]
    holder = out["miss"][2]
    assert out["miss"][:2] == ("ok", b"m-a|1")
    assert out["forward"] == ("ok", b"m-a|2", holder, out["forward"][3])
    assert out["local"][2] == holder
    assert out["gone"][0] == "error"
    assert out["drained"] not in out["states"]
    assert out["status1"] == ["LOADED", "LOADED", "NOT_FOUND", "LOADED"]


def test_scripted_fleet_of_one_matches_reference():
    out = _scripted(1, 4, _lifecycle)
    assert out["evictions"][:2] == ["e-1", "e-2"]
    assert out["waiting"] == "WAITING" and out["after_wait"][0] == "ok"
    assert out["failed"][0] == "error"
    assert out["failed_status"][1] == ["i-0"]
    assert out["excluded"][0] == "error"
    assert out["expired"][:2] == ("ok", b"e-bad|y")


# -- the slice as a whole ------------------------------------------------------

SLICE_SPECS = [
    ("mlp", "mlp://in=16,hidden=32,out=4,depth=2"),
    ("linear", "linear://in=16,out=4"),
    ("conv", "conv://size=8,chans=2,width=4,depth=2,classes=3"),
    ("embedding", "embedding://vocab=64,dim=8,bag=5,items=6"),
    ("transformer", "transformer://vocab=64,d=32,layers=1,heads=2,seq=8"),
]
# tests/test_torch_models.py's FORWARD_TOL: (rtol, atol / max|ref|).
FORWARD_TOL = {"mlp": (1e-5, 1e-5), "linear": (1e-5, 1e-5),
               "conv": (1e-2, 1e-2), "embedding": (1e-2, 1e-2),
               "transformer": (1e-2, 1e-2)}


def _slice_payloads() -> list:
    """(model id, family, path, payload): one model of each spec and a
    second mlp (a fused group on the port), two seeded one-row payloads
    each."""
    rng = np.random.default_rng(14)
    out = []
    for mtype, path in SLICE_SPECS:
        model = tf.build_model("shape", mtype, path, device="cpu")
        for k in range(2 if mtype == "mlp" else 1):
            mid = f"{mtype}-{k}"
            for rows in (1, 1):
                shape = (rows, *model.input_shape)
                if model.input_dtype == np.int32:
                    x = rng.integers(0, 64, size=shape).astype(np.int32)
                else:
                    x = rng.standard_normal(shape).astype(np.float32)
                out.append((mid, mtype, path, x.tobytes()))
    return out


def _serve(pkg, loader, requests, clients: int) -> dict:
    kv = pkg.memory.InMemoryKV(sweep_interval_s=3600.0)
    inst = pkg.instance.ModelMeshInstance(
        kv, loader, pkg.instance.InstanceConfig(
            instance_id="s-0", load_timeout_s=60, min_churn_age_ms=0,
            publish_coalesce_ms=0, batch_max=8))
    try:
        assert inst.batcher is not None
        for mid, mtype, path, _ in requests:
            if inst.registry.get(mid) is None:
                inst.register_model(mid, pkg.spi.ModelInfo(mtype, path))
        out: dict = {}
        todo = list(enumerate(requests * 2))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    k, (mid, _, _, payload) = todo.pop()
                res = inst.invoke_model(mid, "predict", payload, [])
                with lock:
                    out[k] = (res.served_by, res.payload)

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        return out
    finally:
        inst.shutdown()
        kv.close()


def test_slice_serves_what_the_reference_serves():
    requests = _slice_payloads()
    port = _serve(PORT, InProcessTorchLoader(capacity_bytes=64 << 20,
                                             device="cpu"), requests, 4)
    # The reference from one client: each new batch shape would cost a
    # compile, and its answers do not depend on the batch.
    ref = _serve(REF, InProcessJaxLoader(capacity_bytes=64 << 20), requests,
                 1)
    assert sorted(port) == sorted(ref) == list(range(2 * len(requests)))
    for k, (mid, mtype, _, _) in enumerate(requests * 2):
        assert port[k][0] == ref[k][0] == "s-0"
        got = np.frombuffer(port[k][1], np.float32)
        want = np.frombuffer(ref[k][1], np.float32)
        rtol, atol = FORWARD_TOL[mtype]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=atol * np.abs(want).max())


# -- plan-driven placement -----------------------------------------------------


def test_cache_misses_load_where_the_adopted_plan_says():
    kv = port_memory.InMemoryKV(sweep_interval_s=3600.0)
    loaders = [_stub_loader(PORT, 16) for _ in range(3)]
    strategies = [TorchPlacementStrategy(device="cpu") for _ in range(3)]
    by_endpoint: dict = {}

    def peer_call(endpoint, model_id, method, payload, headers, ctx):
        return by_endpoint[endpoint].invoke_model(
            model_id, method, payload, headers, ctx, sync=True)

    insts = []
    try:
        for i in range(3):
            inst = port_instance.ModelMeshInstance(
                kv, loaders[i], port_instance.InstanceConfig(
                    instance_id=f"p-{i}", endpoint=f"ep-{i}",
                    load_timeout_s=10, min_churn_age_ms=0,
                    publish_coalesce_ms=0),
                strategy=strategies[i], peer_call=peer_call,
                runtime_call=(lambda ce, method, payload, headers,
                              cancel_event=None: payload))
            by_endpoint[inst.config.endpoint] = inst
            insts.append(inst)
        for inst in insts:
            assert inst._plan_follower is not None
            inst.instances_view.wait_for(lambda v: len(v) >= 3,
                                         timeout=WAIT_S)
        models = [f"q-{k}" for k in range(12)]
        for k, mid in enumerate(models):
            insts[0].register_model(mid, _info(PORT, 1 + k % 3))
        for inst in insts:
            _wait(lambda inst=inst: len(inst.registry_view) == len(models),
                  "the registry views")
        _wait(lambda: sum(i.is_leader for i in insts) == 1, "a leader")
        leader = next(i for i in insts if i.is_leader)
        step = reaper_plan_step(kv, "mm", leader.strategy, leader.registry,
                                leader.instances_view, leader.model_rpm)
        assert step.plan is not None, step.error
        published = kv.get(plan_sync.plan_key("mm")).value
        _wait(lambda: all(s.plan is not None
                          and s.plan.generation == step.plan.generation
                          for s in strategies), "every pod adopting")
        assert all(s.plan.to_bytes() == published for s in strategies)
        from_plan = 0
        for k, mid in enumerate(models):
            entry = insts[k % 3]
            _sync_views(insts)
            live = {iid for iid, rec in entry.cluster_view().placeable()}
            want = next((iid for iid in step.plan.lookup(mid) or ()
                         if iid in live), None)
            entry.invoke_model(mid, "predict", b"z", [])
            holders = sorted(entry.registry.get(mid).instance_ids)
            if want is not None:
                from_plan += 1
                assert holders == [want], (mid, holders, want)
        assert from_plan >= len(models) * 3 // 4
    finally:
        for inst in insts:
            inst.shutdown()
        kv.close()


# -- capacity units ------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("spec", chip_smoke.MODEL_SPECS + chip_smoke.MOE_SPECS,
                         ids=lambda s: s[1])
def test_capacity_units_match_the_jax_loader(spec):
    mtype, path = spec
    port_ld = InProcessTorchLoader(capacity_bytes=1 << 30, device="cpu")
    jax_ld = InProcessJaxLoader(capacity_bytes=1 << 30)
    pinfo, jinfo = port_spi.ModelInfo(mtype, path), ref_spi.ModelInfo(
        mtype, path)
    assert (port_entry.bytes_to_units(port_ld.predict_size("m", pinfo))
            == ref_entry.bytes_to_units(jax_ld.predict_size("m", jinfo)))
    loaded = port_ld.load("m", pinfo)
    shapes = jax.eval_shape(lambda: jf.build_model("m", mtype, path).params)
    handle = types.SimpleNamespace(
        size_bytes=jf.ServableModel.size_bytes.fget(
            types.SimpleNamespace(params=shapes)))
    port_units = port_entry.bytes_to_units(
        port_ld.model_size("m", loaded.handle))
    assert port_units == port_entry.bytes_to_units(loaded.size_bytes)
    assert port_units == ref_entry.bytes_to_units(
        jax_ld.model_size("m", handle))
