"""The port's KV wire protocols against the JAX package's, on the CPU.

- **The reference's own cases on the port** (``mirror`` from
  ``tests/test_torch_kv_remote.py``): ``tests/test_etcd_wire.py`` (the
  etcd v3 wire server: pagination, atomic deletes, the compaction floor,
  txn compares, lease races, watch ordering, progress notifies,
  fragmentation, partitions), ``test_zk_wire.py`` (the ZooKeeper jute
  wire server) and ``test_zookeeper.py`` (``ZookeeperKV`` against it,
  and the etcd and ZooKeeper fail-fast cases under a serving instance).
- **``kv/jute.py``:** the primitives and every record (``Stat``,
  ``ConnectRequest``, ``ConnectResponse``, ``WatcherEvent``,
  ``MultiHeader``, the ACL vector, the frame) encoded by each package
  from seeded values are equal byte for byte and decode to equal fields
  in the other.
- **The generated modules:** ``proto/mesh_kv_pb2.py`` and
  ``proto/etcd_rpc_pb2.py`` are byte for byte the reference's, and their
  messages cross between the packages' modules.
"""

from __future__ import annotations

import dataclasses
import filecmp
import io
import re
from pathlib import Path

import numpy as np
import pytest

import modelmesh_tpu.kv.jute as ref_jute
import modelmesh_tpu_torch.kv.jute as port_jute
from tests.test_torch_kv_remote import mirror

REPO = Path(__file__).resolve().parent.parent

MIRRORED = {
    ref_test: mirror(ref_test, globals())
    for ref_test in ("test_etcd_wire", "test_zk_wire", "test_zookeeper")
}


def test_mirrors_hold_every_reference_class():
    for ref_test, names in MIRRORED.items():
        src = (REPO / "tests" / f"{ref_test}.py").read_text()
        want = re.findall(r"^class (Test\w+)", src, re.M)
        assert sorted(names) == sorted(want), ref_test


# -- jute ----------------------------------------------------------------------


def test_jute_constants_match_reference():
    def consts(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, int)}

    assert consts(port_jute) == consts(ref_jute)
    assert len(consts(port_jute)) > 20


def _i32(rng):
    return int(rng.integers(-(1 << 31), 1 << 31))


def _i64(rng):
    return int(rng.integers(-(1 << 63), (1 << 63) - 1, dtype=np.int64))


def _bytes(rng, n=None):
    n = int(rng.integers(0, 24)) if n is None else n
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def _text(rng):
    alphabet = "abz/_-.09é✓"
    return "".join(alphabet[int(i)]
                   for i in rng.integers(0, len(alphabet),
                                         int(rng.integers(0, 16))))


def _primitives(seed):
    """A seeded list of (writer method, value)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(40):
        k = int(rng.integers(0, 5))
        if k == 0:
            out.append(("int32", _i32(rng)))
        elif k == 1:
            out.append(("int64", _i64(rng)))
        elif k == 2:
            out.append(("boolean", bool(rng.integers(0, 2))))
        elif k == 3:
            out.append(("string", _text(rng)))
        else:
            out.append(("buffer", None if rng.random() < 0.2
                        else _bytes(rng)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_jute_primitives_cross_packages(seed):
    items = _primitives(seed)
    encoded = {}
    for name, mod in (("ref", ref_jute), ("port", port_jute)):
        w = mod.Writer()
        for method, value in items:
            getattr(w, method)(value)
        encoded[name] = w.getvalue()
    assert encoded["port"] == encoded["ref"]
    for name, mod in (("ref", ref_jute), ("port", port_jute)):
        other = encoded["port" if name == "ref" else "ref"]
        r = mod.Reader(other)
        got = [getattr(r, method)() for method, _ in items]
        # A null buffer reads back empty, in both packages.
        assert got == [b"" if m == "buffer" and v is None else v
                       for m, v in items]
        assert r.remaining() == 0


def _records(mod, seed):
    rng = np.random.default_rng(seed)
    return [
        mod.Stat(*[(_i64 if f.type == "int" and f.name.endswith(
            ("zxid", "time", "owner")) else _i32)(rng)
            for f in dataclasses.fields(mod.Stat)]),
        mod.ConnectRequest(protocol_version=_i32(rng),
                           last_zxid_seen=_i64(rng), timeout_ms=_i32(rng),
                           session_id=_i64(rng), passwd=_bytes(rng, 16),
                           read_only=bool(rng.integers(0, 2))),
        mod.ConnectResponse(protocol_version=_i32(rng),
                            timeout_ms=_i32(rng), session_id=_i64(rng),
                            passwd=_bytes(rng, 16),
                            read_only=bool(rng.integers(0, 2))),
        mod.WatcherEvent(type=_i32(rng), state=_i32(rng), path=_text(rng)),
        mod.MultiHeader(type=_i32(rng), done=bool(rng.integers(0, 2)),
                        err=_i32(rng)),
    ]


def _encode(mod, rec) -> bytes:
    if hasattr(rec, "encode"):
        return rec.encode()
    w = mod.Writer()
    rec.write(w)
    return w.getvalue()


def _decode(mod, cls_name, data):
    cls = getattr(mod, cls_name)
    if hasattr(cls, "decode"):
        return cls.decode(data)
    r = mod.Reader(data)
    out = cls.read(r)
    assert r.remaining() == 0
    return out


@pytest.mark.parametrize("seed", range(4))
def test_jute_records_cross_packages(seed):
    refs = _records(ref_jute, seed)
    ports = _records(port_jute, seed)
    for ref_rec, port_rec in zip(refs, ports, strict=True):
        name = type(ref_rec).__name__
        assert dataclasses.astuple(port_rec) == dataclasses.astuple(ref_rec)
        data = _encode(ref_jute, ref_rec)
        assert _encode(port_jute, port_rec) == data, name
        assert dataclasses.astuple(_decode(port_jute, name, data)) == \
            dataclasses.astuple(ref_rec), name
        assert dataclasses.astuple(
            _decode(ref_jute, name, _encode(port_jute, port_rec))) == \
            dataclasses.astuple(port_rec), name
    # The ACL vector and the frame.
    wr, wp = ref_jute.Writer(), port_jute.Writer()
    ref_jute.write_acl_vector(wr)
    port_jute.write_acl_vector(wp)
    assert wp.getvalue() == wr.getvalue()
    port_jute.read_acl_vector(port_jute.Reader(wr.getvalue()))
    payload = _encode(port_jute, ports[0])
    assert port_jute.frame(payload) == ref_jute.frame(payload)

    class _Sock:
        def __init__(self, data):
            self._buf = io.BytesIO(data)

        def recv(self, n):
            return self._buf.read(min(n, 3))  # short reads

    assert port_jute.read_frame(_Sock(ref_jute.frame(payload))) == payload
    assert ref_jute.read_frame(_Sock(port_jute.frame(payload))) == payload


def test_jute_rejects_what_the_reference_rejects():
    for mod in (ref_jute, port_jute):
        with pytest.raises(mod.JuteError):
            mod.Reader(b"\x00\x00").int32()
        with pytest.raises(mod.JuteError):
            mod.Reader(b"\x00\x00\x00\x09abc").buffer()

        class _Sock:
            def recv(self, n):
                return b"\xff\xff\xff\xff"[:n]

        with pytest.raises(mod.JuteError):
            mod.read_frame(_Sock())


# -- generated modules ---------------------------------------------------------


@pytest.mark.parametrize("name", ["mesh_kv_pb2", "etcd_rpc_pb2"])
def test_kv_pb2_modules_are_the_references_byte_for_byte(name):
    assert filecmp.cmp(REPO / "modelmesh_tpu" / "proto" / f"{name}.py",
                       REPO / "modelmesh_tpu_torch" / "proto" / f"{name}.py",
                       shallow=False)
    import modelmesh_tpu_torch.proto as port_proto

    assert name in port_proto.__all__


def test_kv_messages_cross_packages():
    import modelmesh_tpu.proto.etcd_rpc_pb2 as ref_epb
    import modelmesh_tpu.proto.mesh_kv_pb2 as ref_kpb
    import modelmesh_tpu_torch.proto.etcd_rpc_pb2 as port_epb
    import modelmesh_tpu_torch.proto.mesh_kv_pb2 as port_kpb

    for ref_mod, port_mod in ((ref_epb, port_epb), (ref_kpb, port_kpb)):
        names = sorted(ref_mod.DESCRIPTOR.message_types_by_name)
        assert names == sorted(port_mod.DESCRIPTOR.message_types_by_name)
        assert (port_mod.DESCRIPTOR.serialized_pb
                == ref_mod.DESCRIPTOR.serialized_pb)
    msg = ref_epb.TxnRequest(
        compare=[ref_epb.Compare(key=b"k", version=3,
                                 target=ref_epb.Compare.VERSION)],
        success=[ref_epb.RequestOp(request_put=ref_epb.PutRequest(
            key=b"k", value=b"\x00v", lease=7))],
        failure=[ref_epb.RequestOp(request_range=ref_epb.RangeRequest(
            key=b"a", range_end=b"b", limit=4))])
    back = port_epb.TxnRequest.FromString(msg.SerializeToString())
    assert back.SerializeToString() == msg.SerializeToString()
    assert back.success[0].request_put.lease == 7
    kmsg = port_kpb.WatchBatch(events=[port_kpb.WatchEvent(
        kv=port_kpb.KeyValue(key="a", value=b"1", version=2))])
    kback = ref_kpb.WatchBatch.FromString(kmsg.SerializeToString())
    assert kback.SerializeToString() == kmsg.SerializeToString()
