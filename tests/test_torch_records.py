"""The port's registry schema (``modelmesh_tpu_torch/records.py`` on the
port's ``kv/table.py::Record``) against the JAX package's, on the CPU.

- The fields: names, order, types and defaults equal, per record class.
- ``to_bytes`` is a wire format a mixed fleet shares: for seeded records
  of every class the two packages' bytes are identical, and each
  package's ``from_bytes`` reads the other's bytes back to an equal
  record (the KV version travels beside the bytes, not in them).
- The record methods give the same outcomes over seeded scripts: the
  return values and the bytes after every step are equal.
"""

import dataclasses
import json

import numpy as np
import pytest

from modelmesh_tpu import records as ref
from modelmesh_tpu.kv import table as ref_table
from modelmesh_tpu_torch import records as port
from modelmesh_tpu_torch.kv import table as port_table
from modelmesh_tpu_torch.utils import clock as port_clock

CLASSES = ("ModelRecord", "InstanceRecord", "VModelRecord")
NOW = 1_700_000_000_000
IDS = [f"i{j}" for j in range(7)] + ["pod-a-b", "x/y", "ü"]


@pytest.mark.parametrize("cls", CLASSES)
def test_fields_match_reference(cls):
    ours = dataclasses.fields(getattr(port, cls))
    theirs = dataclasses.fields(getattr(ref, cls))
    assert [f.name for f in ours] == [f.name for f in theirs]
    for a, b in zip(ours, theirs):
        assert str(a.type) == str(b.type), a.name
        assert a.default == b.default, a.name
        if a.default_factory is not dataclasses.MISSING:
            assert a.default_factory() == b.default_factory(), a.name
    assert issubclass(getattr(port, cls), port_table.Record)


def test_module_constants_and_clock_reexport():
    for name in ("LOAD_FAILURE_EXPIRY_MS", "MAX_LOAD_FAILURES",
                 "MAX_LOAD_LOCATIONS"):
        assert getattr(port, name) == getattr(ref, name)
    assert (port.ModelRecord.LAST_USED_PERSIST_STALENESS_MS
            == ref.ModelRecord.LAST_USED_PERSIST_STALENESS_MS)
    assert port.now_ms is port_clock.now_ms
    assert port.failure_expiry_ms() == ref.failure_expiry_ms()


def _ids(rng, k):
    return [IDS[int(i)] for i in rng.choice(len(IDS), k, replace=False)]


def _random_fields(cls: str, rng) -> dict:
    """Every field of ``cls`` drawn from ``rng`` (the reference's
    types)."""
    if cls == "ModelRecord":
        ts = lambda: int(rng.integers(0, 2**41))  # noqa: E731
        return {
            "model_type": f"t{rng.integers(0, 9)}",
            "model_path": f"s3://b/{rng.integers(0, 99)}",
            "model_key": "" if rng.random() < 0.5 else '{"k": "é\\n"}',
            "instance_ids": {i: ts() for i in _ids(rng, rng.integers(0, 4))},
            "loading_instances": {i: ts() for i in
                                  _ids(rng, rng.integers(0, 3))},
            "host_instances": {i: ts() for i in _ids(rng, rng.integers(0, 3))},
            "load_failures": {i: [ts(), f"err {i}"] for i in
                              _ids(rng, rng.integers(0, 3))},
            "ref_count": int(rng.integers(0, 4)),
            "auto_delete": bool(rng.random() < 0.5),
            "size_units": int(rng.integers(0, 10_000)),
            "last_used": ts(), "last_unload_ms": ts(),
            "shard_count": int(rng.integers(0, 4)),
            "shard_instances": {i: int(rng.integers(0, 4)) for i in
                                _ids(rng, rng.integers(0, 4))},
            "group_epoch": int(rng.integers(0, 9)),
        }
    if cls == "InstanceRecord":
        return {
            "start_ts": int(rng.integers(0, 2**41)),
            "lru_ts": int(rng.integers(0, 2**41)),
            "model_count": int(rng.integers(0, 500)),
            "capacity_units": int(rng.integers(0, 100_000)),
            "used_units": int(rng.integers(0, 100_000)),
            "loading_threads": int(rng.integers(0, 8)),
            "loading_in_progress": int(rng.integers(0, 8)),
            "req_per_minute": int(rng.integers(0, 5000)),
            "shutting_down": bool(rng.random() < 0.2),
            "disabled": bool(rng.random() < 0.2),
            "draining": bool(rng.random() < 0.2),
            "endpoint": f"10.0.0.{rng.integers(0, 255)}:8080",
            "location": f"node-{rng.integers(0, 9)}",
            "zone": f"z{rng.integers(0, 3)}",
            "labels": [f"l{k}" for k in rng.choice(5, rng.integers(0, 4),
                                                    replace=False)],
            "instance_version": f"v1.{rng.integers(0, 12)}",
        }
    return {
        "owner": f"o{rng.integers(0, 9)}",
        "active_model": f"m{rng.integers(0, 9)}",
        "target_model": "" if rng.random() < 0.3 else f"m{rng.integers(0, 9)}",
        "target_load_failed": bool(rng.random() < 0.5),
    }


@pytest.mark.parametrize("cls", CLASSES)
@pytest.mark.parametrize("seed", range(4))
def test_to_bytes_identical_and_read_across(cls, seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        fields = _random_fields(cls, rng)
        version = int(rng.integers(0, 99))
        a = getattr(ref, cls)(**fields, version=version)
        b = getattr(port, cls)(**json.loads(json.dumps(fields)),
                               version=version)
        assert b.to_bytes() == a.to_bytes()
        # Each package reads the other's bytes; the version rides apart.
        back = getattr(port, cls).from_bytes(a.to_bytes(), 7)
        assert dataclasses.asdict(back) == dict(
            dataclasses.asdict(a), version=7)
        back = getattr(ref, cls).from_bytes(b.to_bytes(), 9)
        assert dataclasses.asdict(back) == dict(
            dataclasses.asdict(b), version=9)
        # Defaults too: an empty record and one read from "{}".
        assert getattr(port, cls)().to_bytes() == getattr(ref, cls)().to_bytes()
        assert (getattr(port, cls).from_bytes(b"{}", 1).to_bytes()
                == getattr(ref, cls).from_bytes(b"{}", 1).to_bytes())


def test_from_bytes_drops_unknown_fields_like_reference():
    data = json.dumps({"zone": "a", "from_a_newer_peer": [1, 2]}).encode()
    a = ref.InstanceRecord.from_bytes(data, 3)
    b = port.InstanceRecord.from_bytes(data, 3)
    assert b.to_bytes() == a.to_bytes() and b.version == a.version == 3


def test_record_base_matches_reference():
    assert port_table.Record.version == ref_table.Record.version == 0
    assert (port_table.BUCKET_SEG.pattern == ref_table.BUCKET_SEG.pattern)


def _model_script(rng, steps: int):
    """A seeded list of (method, args) over ModelRecord's mutators and
    queries, with explicit timestamps (no clock read)."""
    ops = []
    t = NOW
    for _ in range(steps):
        t += int(rng.integers(0, 400_000))
        iid = IDS[int(rng.integers(0, len(IDS)))]
        k = int(rng.integers(0, 17))
        if k == 0:
            ops.append(("claim_loading", (iid, t)))
        elif k == 1:
            ops.append(("promote_loaded", (iid, t)))
        elif k == 2:
            ops.append(("promote_partial", (iid, t)))
        elif k == 3:
            ops.append(("remove_instance", (iid,)))
        elif k == 4:
            count = int(rng.integers(1, 4))
            members = _ids(rng, int(rng.integers(1, 5)))
            ops.append(("begin_shard_group",
                        ({m: int(rng.integers(0, count)) for m in members},
                         count, t)))
        elif k == 5:
            ops.append(("claim_host_copy", (iid, t)))
        elif k == 6:
            ops.append(("drop_host_copy", (iid,)))
        elif k == 7:
            ops.append(("add_load_failure",
                        (iid, "x" * int(rng.integers(0, 700)), t)))
        elif k == 8:
            ops.append(("expire_load_failures",
                        (t, int(rng.integers(0, 20 * 60_000)))))
        elif k == 9:
            ops.append(("active_failures", (t,)))
        elif k == 10:
            ops.append(("failed_on", (iid, t)))
        elif k == 11:
            ops.append(("load_exhausted", (t,)))
        elif k == 12:
            ops.append(("placed_on", (iid,)))
        elif k == 13:
            ops.append(("shard_index_of", (iid,)))
        elif k == 14:
            ops.append(("missing_shards", ()))
        elif k == 15:
            ops.append(("should_persist_last_used",
                        (t + int(rng.integers(0, 8 * 3600_000)),)))
        else:
            ops.append(("active_failure_count", (t,)))
    return ops


def _norm(v):
    return sorted(v) if isinstance(v, set) else v


@pytest.mark.parametrize("seed", range(6))
def test_model_record_methods_match_reference(seed, monkeypatch):
    # failure_expiry_ms() reads the knob live, in each package's registry.
    monkeypatch.setenv("MM_LOAD_FAILURE_EXPIRY_MS", str(10 * 60_000))
    rng = np.random.default_rng(100 + seed)
    a, b = ref.ModelRecord(model_type="t"), port.ModelRecord(model_type="t")
    for name, args in _model_script(rng, 300):
        ra, rb = getattr(a, name)(*args), getattr(b, name)(*args)
        assert _norm(rb) == _norm(ra), (name, args)
        assert b.to_bytes() == a.to_bytes(), (name, args)
        for prop in ("group_complete", "all_placements", "copy_count"):
            assert _norm(getattr(b, prop)) == _norm(getattr(a, prop)), prop


@pytest.mark.parametrize("seed", range(3))
def test_instance_and_vmodel_properties_match_reference(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(50):
        f = _random_fields("InstanceRecord", rng)
        if rng.random() < 0.2:
            f["capacity_units"] = 0
        if rng.random() < 0.2:
            f["lru_ts"] = 0
        a, b = ref.InstanceRecord(**f), port.InstanceRecord(**f)
        assert b.free_units == a.free_units
        assert b.full_fraction == a.full_fraction
        assert b.placement_sort_key() == a.placement_sort_key()
        v = _random_fields("VModelRecord", rng)
        assert (port.VModelRecord(**v).in_transition
                == ref.VModelRecord(**v).in_transition)
