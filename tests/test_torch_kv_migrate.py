"""The port's registry-layout migration (``modelmesh_tpu_torch/kv/
migrate.py``) against the JAX package's, on the CPU.

Each case writes one seeded registry (flat keys, bucketed keys, ids with
slashes) into each package's own ``InMemoryKV`` under its own
``VirtualClock`` (the fence's value carries ``now_ms``), runs the same
migration, and holds the stores' key -> bytes maps and the move counts
equal: the offline move, the fenced live move, and a live move with a
move-on-write writer (a fenced ``BucketedKVTable`` CAS against a record
it read from its flat key) ahead of the migrator. ``MigrationFence``
follows the advertised phases, and the port's instance builds its
registry with the port's fence.
"""

import time
import types

import numpy as np
import pytest

import modelmesh_tpu.kv.memory as ref_memory
import modelmesh_tpu.kv.migrate as ref_migrate
import modelmesh_tpu.kv.table as ref_table
import modelmesh_tpu.records as ref_records
import modelmesh_tpu.utils.clock as ref_clock
import modelmesh_tpu_torch.kv.memory as port_memory
import modelmesh_tpu_torch.kv.migrate as port_migrate
import modelmesh_tpu_torch.kv.table as port_table
import modelmesh_tpu_torch.records as port_records
import modelmesh_tpu_torch.utils.clock as port_clock

REF = types.SimpleNamespace(memory=ref_memory, migrate=ref_migrate,
                            table=ref_table, records=ref_records,
                            clock=ref_clock)
PORT = types.SimpleNamespace(memory=port_memory, migrate=port_migrate,
                             table=port_table, records=port_records,
                             clock=port_clock)
PREFIX = "mm"
REG = "mm/registry/"


def _registry(seed: int, n: int = 60) -> list:
    """(id, flat?, record fields) in a seeded order."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        mid = f"m-{k}" if rng.random() < 0.8 else f"ns/{k}/m"
        out.append((mid, bool(rng.random() < 0.7),
                    {"model_type": "t", "model_path": f"mem://{mid}",
                     "size_units": int(rng.integers(1, 50)),
                     "instance_ids": {f"i-{int(rng.integers(0, 4))}":
                                      int(rng.integers(1, 1 << 40))}}))
    return out


def _write(pkg, kv, registry, n_buckets: int) -> None:
    table = pkg.table.BucketedKVTable(kv, REG, pkg.records.ModelRecord,
                                      n_buckets=n_buckets)
    for mid, flat, fields in registry:
        rec = pkg.records.ModelRecord(**fields)
        key = REG + mid if flat else table.raw_key(mid)
        kv.put(key, rec.to_bytes())


def _store_map(kv) -> dict:
    return {x.key: x.value for x in kv.range("")}


def _run(pkg, registry, n_buckets, how):
    with pkg.clock.installed(pkg.clock.VirtualClock()):
        kv = pkg.memory.InMemoryKV(sweep_interval_s=3600.0)
        try:
            _write(pkg, kv, registry, n_buckets)
            moved = how(pkg, kv)
            return moved, _store_map(kv)
        finally:
            kv.close()


def _both(registry, n_buckets, how):
    ref = _run(REF, registry, n_buckets, how)
    port = _run(PORT, registry, n_buckets, how)
    assert ref == port
    return port


@pytest.mark.parametrize("seed,n_buckets", [(0, 128), (1, 16)])
def test_live_migration_matches_reference(seed, n_buckets):
    registry = _registry(seed)

    def live(pkg, kv):
        return pkg.migrate.migrate_flat_registry_live(
            kv, PREFIX, n_buckets, page_size=7, settle_s=0)

    moved, after = _both(registry, n_buckets, live)
    assert moved == sum(flat for _, flat, _ in registry)
    assert not any(k == REG + mid for k in after for mid, _, _ in registry)
    fence = after[port_migrate.migration_fence_key(PREFIX)]
    assert b'"done"' in fence


@pytest.mark.parametrize("seed", [2, 3])
def test_offline_migration_matches_reference(seed):
    registry = _registry(seed)

    def offline(pkg, kv):
        first = pkg.migrate.migrate_flat_registry(kv, PREFIX, 32,
                                                  page_size=11)
        return first, pkg.migrate.migrate_flat_registry(kv, PREFIX, 32)

    (first, again), _ = _both(registry, 32, offline)
    assert first == sum(flat for _, flat, _ in registry) and again == 0


def test_move_on_write_then_live_migration_matches_reference():
    """With the fence LIVE, a fenced table reads a record from its flat
    key and its CAS moves it; the migrator then moves the rest."""
    registry = _registry(4, n=30)
    flat_ids = [mid for mid, flat, _ in registry if flat]

    def written(pkg, kv):
        pkg.migrate.advertise_phase(kv, PREFIX, pkg.migrate.PHASE_LIVE)
        fence = pkg.migrate.MigrationFence(kv, PREFIX)
        try:
            table = pkg.table.BucketedKVTable(
                kv, REG, pkg.records.ModelRecord, migration_fence=fence)
            assert fence.active
            got = [table.get(mid).size_units for mid in flat_ids[:5]]

            def grow(cur):
                cur.size_units += 1000
                return cur

            for mid in flat_ids[:5]:
                table.update_or_create(mid, grow)
            moved = pkg.migrate.migrate_flat_registry_live(
                kv, PREFIX, 128, settle_s=0)
            # The fence learns DONE from its watch.
            _until(lambda: fence.phase == pkg.migrate.PHASE_DONE)
            return got, moved, fence.phase
        finally:
            fence.close()

    (got, moved, phase), after = _both(registry, 128, written)
    assert moved == len(flat_ids) - 5 and phase == port_migrate.PHASE_DONE
    assert len(got) == 5


def test_fence_follows_phases():
    with port_clock.installed(port_clock.VirtualClock()):
        kv = port_memory.InMemoryKV(sweep_interval_s=3600.0)
        fence = port_migrate.MigrationFence(kv, PREFIX)
        try:
            assert fence.phase is None and not fence.active
            port_migrate.advertise_phase(kv, PREFIX, port_migrate.PHASE_LIVE)
            _until(lambda: fence.active)
            port_migrate.advertise_phase(kv, PREFIX, port_migrate.PHASE_DONE)
            _until(lambda: fence.phase == port_migrate.PHASE_DONE)
            kv.put(fence.key, b"junk")
            _until(lambda: fence.phase is None)
            late = port_migrate.MigrationFence(kv, "mm/")
            assert late.key == fence.key and late.phase is None
            late.close()
        finally:
            fence.close()
            kv.close()
    assert port_migrate.migration_fence_key("mm/") == (
        ref_migrate.migration_fence_key("mm/"))
    assert (port_migrate.PHASE_LIVE, port_migrate.PHASE_DONE) == (
        ref_migrate.PHASE_LIVE, ref_migrate.PHASE_DONE)


def _until(pred, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline
        time.sleep(0.002)


def test_instance_registry_carries_the_ports_fence():
    from modelmesh_tpu_torch.models.server import InProcessTorchLoader
    from modelmesh_tpu_torch.serving.instance import (
        InstanceConfig, ModelMeshInstance,
    )

    kv = port_memory.InMemoryKV(sweep_interval_s=3600.0)
    inst = ModelMeshInstance(
        kv, InProcessTorchLoader(capacity_bytes=1 << 20, device="cpu"),
        InstanceConfig(instance_id="f-0", publish_coalesce_ms=0))
    try:
        assert isinstance(inst.registry, port_table.BucketedKVTable)
        assert isinstance(inst.migration_fence, port_migrate.MigrationFence)
        assert inst.registry.migration_fence is inst.migration_fence
        port_migrate.advertise_phase(kv, PREFIX, port_migrate.PHASE_LIVE)
        _until(lambda: inst.migration_fence.active)
    finally:
        inst.shutdown()
        kv.close()
