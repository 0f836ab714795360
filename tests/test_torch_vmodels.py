"""The port's virtual models (``modelmesh_tpu_torch/serving/vmodels.py``)
against the JAX package's, on the CPU.

- **``tests/test_vmodels.py``'s cases** on a port cluster over localhost
  gRPC: aliasing, ``update_only``, owner protection, the managed rollover,
  a parked failed transition, ``force``, the force-rollback refcount, the
  promotion and the delete each as one multi-key transaction, and the
  promotion crash injection (a crash before and after the atomic commit).
- **The transactions themselves, across packages:** the same rollover and
  delete in a port cluster and a reference cluster, every ``store.txn``
  recorded: the guarded keys (and whether each guard asserts absence),
  the keys each commit writes or deletes, and the records written, field
  by field with ``TIMING_FIELDS`` by presence (instance records by their
  field names), must be the reference's.
"""

from __future__ import annotations

import json
import time

import grpc
import pytest

from tests.test_torch_api import PORT, REF, Cluster, api_stub
from tests.test_torch_instance import TIMING_FIELDS

apb = PORT.apb
FAIL = PORT.fake.FAIL_LOAD_PREFIX


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(PORT, n=2)
    yield c
    c.close()


@pytest.fixture(scope="module")
def api(cluster):
    ch, stub = api_stub(PORT, cluster[0].server.endpoint)
    yield stub
    ch.close()


def set_vmodel(api, vmid, target, pkg=PORT, **kw):
    return api.SetVModel(pkg.apb.SetVModelRequest(
        vmodel_id=vmid, target_model_id=target,
        info=pkg.apb.ModelInfo(model_type="example", model_path="mem://v"),
        **kw))


def infer_vmodel(cluster, vmid, payload=b"req"):
    ch = grpc.insecure_channel(cluster[1].server.endpoint)
    try:
        return PORT.grpc_defs.raw_method(ch, PORT.fake.PREDICT_METHOD)(
            payload, metadata=[(PORT.grpc_defs.VMODEL_ID_HEADER, vmid)],
            timeout=20)
    finally:
        ch.close()


def _gone(inst, mid, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while inst.registry.get(mid) is not None:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


class TestVModelBasics:
    def test_create_and_infer_via_alias(self, cluster, api):
        st = set_vmodel(api, "alias", "concrete-v1", load_now=True, sync=True)
        assert st.active_model_id == "concrete-v1"
        assert st.transition == apb.VModelStatusInfo.NONE
        assert infer_vmodel(cluster, "alias").startswith(b"concrete-v1:")

    def test_update_only_missing_vmodel(self, api):
        with pytest.raises(grpc.RpcError) as exc:
            set_vmodel(api, "missing-vm", "x", update_only=True)
        assert exc.value.code() == grpc.StatusCode.NOT_FOUND

    def test_owner_protection(self, api):
        set_vmodel(api, "owned", "own-v1", owner="team-a")
        with pytest.raises(grpc.RpcError) as exc:
            set_vmodel(api, "owned", "own-v2", owner="team-b")
        assert exc.value.code() == grpc.StatusCode.ALREADY_EXISTS

    def test_get_status_missing(self, api):
        with pytest.raises(grpc.RpcError) as exc:
            api.GetVModelStatus(apb.GetVModelStatusRequest(
                vmodel_id="ghost-vm"))
        assert exc.value.code() == grpc.StatusCode.NOT_FOUND


class TestTransitions:
    def test_version_rollover_promotes_and_cleans_up(self, cluster, api):
        inst = cluster[0].instance
        set_vmodel(api, "roll", "roll-v1", load_now=True, sync=True,
                   auto_delete_target=True)
        assert infer_vmodel(cluster, "roll").startswith(b"roll-v1:")
        st = set_vmodel(api, "roll", "roll-v2", load_now=True, sync=True,
                        auto_delete_target=True)
        assert st.active_model_id == "roll-v2"
        assert st.transition == apb.VModelStatusInfo.NONE
        assert infer_vmodel(cluster, "roll").startswith(b"roll-v2:")
        assert _gone(inst, "roll-v1")

    def test_failed_transition_parks_and_keeps_serving_active(self, cluster,
                                                               api):
        set_vmodel(api, "stuck", "stuck-v1", load_now=True, sync=True)
        st = set_vmodel(api, "stuck", FAIL + "v2", load_now=True, sync=True)
        assert st.active_model_id == "stuck-v1"
        assert st.transition == apb.VModelStatusInfo.FAILED
        assert infer_vmodel(cluster, "stuck").startswith(b"stuck-v1:")

    def test_concurrent_transition_needs_force(self, cluster, api):
        set_vmodel(api, "forced", "f-v1", load_now=True, sync=True)
        set_vmodel(api, "forced", FAIL + "f2", sync=True)  # parks
        with pytest.raises(grpc.RpcError) as exc:
            set_vmodel(api, "forced", "f-v3")
        assert exc.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        st = set_vmodel(api, "forced", "f-v3", force=True, sync=True)
        assert st.active_model_id == "f-v3"

    def test_force_rollback_does_not_leak_active_ref(self, cluster, api):
        inst = cluster[0].instance
        set_vmodel(api, "rb", "rb-v1", load_now=True, sync=True,
                   auto_delete_target=True)
        set_vmodel(api, "rb", FAIL + "rb2", sync=True)  # parks
        st = set_vmodel(api, "rb", "rb-v1", force=True, sync=True)
        assert st.active_model_id == "rb-v1"
        assert st.transition == apb.VModelStatusInfo.NONE
        assert inst.registry.get("rb-v1").ref_count == 1
        api.DeleteVModel(apb.DeleteVModelRequest(vmodel_id="rb"))
        assert _gone(inst, "rb-v1"), "rollback leaked a ref"

    def test_promotion_is_one_atomic_txn(self, cluster, api):
        inst = cluster[0].instance
        vm = cluster[0].vmodels
        set_vmodel(api, "atomic", "at-v1", load_now=True, sync=True,
                   auto_delete_target=True)
        txns = []
        real_txn = inst.store.txn

        def spy(compares, on_success, on_failure=()):
            txns.append(([c.key for c in compares],
                         [o.key for o in on_success]))
            return real_txn(compares, on_success, on_failure)

        inst.store.txn = spy
        try:
            set_vmodel(api, "atomic", "at-v2", load_now=True, sync=True,
                       auto_delete_target=True)
        finally:
            inst.store.txn = real_txn
        vkey = vm.table.raw_key("atomic")
        mkey = inst.registry.raw_key("at-v1")
        both = [i for i, t in enumerate(txns)
                if vkey in t[1] and mkey in t[1]]
        assert both, f"no single txn wrote both keys: {txns}"
        after = [t for t in txns[both[-1] + 1:] if mkey in t[1]]
        assert not after, f"separate refcount write after the flip: {after}"
        assert inst.registry.get("at-v1") is None
        st = api.GetVModelStatus(apb.GetVModelStatusRequest(
            vmodel_id="atomic"))
        assert st.active_model_id == "at-v2"

    def test_delete_vmodel_releases_refs_in_one_txn(self, cluster, api):
        inst = cluster[0].instance
        vm = cluster[0].vmodels
        set_vmodel(api, "atomic-del", "ad-v1", load_now=True, sync=True,
                   auto_delete_target=True)
        set_vmodel(api, "atomic-del", "ad-v2", load_now=True, sync=True,
                   auto_delete_target=True)
        txns = []
        real_txn = inst.store.txn

        def spy(compares, on_success, on_failure=()):
            txns.append([o.key for o in on_success])
            return real_txn(compares, on_success, on_failure)

        inst.store.txn = spy
        try:
            api.DeleteVModel(apb.DeleteVModelRequest(vmodel_id="atomic-del"))
        finally:
            inst.store.txn = real_txn
        vkey = vm.table.raw_key("atomic-del")
        mkey = inst.registry.raw_key("ad-v2")
        assert any(vkey in t and mkey in t for t in txns), txns
        assert inst.registry.get("ad-v2") is None
        assert vm.table.get("atomic-del") is None

    def test_delete_vmodel_releases_refs(self, cluster, api):
        inst = cluster[0].instance
        set_vmodel(api, "deleteme", "del-v1", load_now=True, sync=True,
                   auto_delete_target=True)
        api.DeleteVModel(apb.DeleteVModelRequest(vmodel_id="deleteme"))
        assert _gone(inst, "del-v1")
        with pytest.raises(grpc.RpcError):
            api.GetVModelStatus(apb.GetVModelStatusRequest(
                vmodel_id="deleteme"))


class TestPromotionCrashInjection:
    @pytest.fixture()
    def standalone(self):
        """One instance and a ``VModelManager`` whose sweeper never runs
        (no background promotion racing the injected crash)."""
        store = PORT.memory.InMemoryKV(sweep_interval_s=0.05)
        server, port, _ = PORT.fake.start_fake_runtime(
            servicer=PORT.fake.FakeRuntimeServicer(capacity_bytes=64 << 20))
        inst = vm = None
        try:
            inst = PORT.instance.ModelMeshInstance(
                store, PORT.sidecar.SidecarRuntime(f"127.0.0.1:{port}",
                                                   startup_timeout_s=10),
                PORT.instance.InstanceConfig(instance_id="vm-crash",
                                             load_timeout_s=10,
                                             min_churn_age_ms=0))
            vm = PORT.vmodels.VModelManager(inst, sweep_interval_s=3600)
            yield inst, vm, PORT.spi.ModelInfo(model_type="example",
                                               model_path="mem://v")
        finally:
            if vm is not None:
                vm.close()
            if inst is not None:
                inst.shutdown()
            server.stop(0)
            store.close()

    @staticmethod
    def _start_transition(inst, vm, info, vmid, v1, v2):
        inst.register_model(v1, info, load_now=True, sync=True)
        vm.table.put(vmid, PORT.records.VModelRecord(active_model=v1,
                                                     target_model=v1))
        vm.bump_ref(v1, +1, auto_delete=True)
        inst.register_model(v2, info)
        vm.bump_ref(v2, +1, auto_delete=True)

        def mut(cur):
            cur.target_model = v2
            return cur

        vm.table.update_or_create(vmid, mut)

    @pytest.mark.parametrize("when", ["before", "after"])
    def test_crash_around_promotion_txn_never_leaks(self, standalone, when):
        inst, vm, info = standalone

        class Boom(RuntimeError):
            pass

        vmid, v1, v2 = f"cr-{when}", f"cr-{when}-v1", f"cr-{when}-v2"
        self._start_transition(inst, vm, info, vmid, v1, v2)
        real_txn = inst.store.txn
        vkey = vm.table.raw_key(vmid)

        def crashing(compares, on_success, on_failure=()):
            if any(c.key == vkey for c in compares):
                if when == "before":
                    raise Boom()
                real_txn(compares, on_success, on_failure)
                raise Boom()
            return real_txn(compares, on_success, on_failure)

        inst.store.txn = crashing
        try:
            with pytest.raises(Boom):
                vm._advance_transition(vmid)
        finally:
            inst.store.txn = real_txn
        vr = vm.table.get(vmid)
        old_mr = inst.registry.get(v1)
        if when == "after":
            assert vr.active_model == v2
            assert old_mr is None, "flip landed without its decrement"
        else:
            assert vr.active_model == v1 and vr.in_transition
            assert old_mr is not None and old_mr.ref_count == 1
            vm._advance_transition(vmid)
            assert vm.table.get(vmid).active_model == v2
            assert inst.registry.get(v1) is None, "refcount leaked"


# -- the transactions, across packages -----------------------------------------


def _decode(key, value):
    """A written record's fields; an instance record (its endpoint is a
    bound port, its stamps wall-clock) by field names only."""
    if value is None:
        return None
    doc = json.loads(value)
    if "/instances/" in key:
        return sorted(doc)
    return {k: (v if k not in TIMING_FIELDS else "<timing>")
            for k, v in doc.items()}


def _txn_script(pkg) -> list:
    """A rollover with auto-delete, then the vmodel's delete; every
    transaction recorded as (guards, writes) with ``created`` marking a
    guard on a key's absence."""
    c = Cluster(pkg, n=1, vmodel_sweep_s=3600)
    ch, stub = api_stub(pkg, c[0].server.endpoint)
    inst = c[0].instance
    txns = []
    real_txn = inst.store.txn

    def spy(compares, on_success, on_failure=()):
        ok, kvs = real_txn(compares, on_success, on_failure)
        txns.append((
            [(cmp.key, "created" if cmp.version == 0 else "exists")
             for cmp in compares],
            [(o.key, _decode(o.key, o.value)) for o in on_success],
            [(o.key, _decode(o.key, o.value)) for o in on_failure], ok))
        return ok, kvs

    try:
        set_vmodel(stub, "tx", "tx-v1", pkg=pkg, load_now=True, sync=True,
                   auto_delete_target=True)
        inst.store.txn = spy
        set_vmodel(stub, "tx", "tx-v2", pkg=pkg, load_now=True, sync=True,
                   auto_delete_target=True)
        set_vmodel(stub, "tx", FAIL + "tx3", pkg=pkg, sync=True)
        set_vmodel(stub, "tx", "tx-v2", pkg=pkg, force=True, sync=True)
        stub.DeleteVModel(pkg.apb.DeleteVModelRequest(vmodel_id="tx"))
        inst.store.txn = real_txn
        return txns
    finally:
        inst.store.txn = real_txn
        ch.close()
        c.close()


def test_promotion_and_delete_transactions_match_reference():
    port = _txn_script(PORT)
    ref = _txn_script(REF)
    assert port == ref
    vkey = "mm/vmodels/tx"
    promotions = [t for t in port if any(k == vkey for k, _ in t[1])
                  and any(k.endswith("tx-v1") for k, _ in t[1])]
    assert promotions, port
