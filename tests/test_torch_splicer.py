"""The port's protobuf splicer (``modelmesh_tpu_torch/native/
proto_splicer.py`` and its own ``splicer.cc``) against the JAX
package's, on the CPU.

- **``tests/test_splicer.py``'s cases** on the port, on both backends:
  the native scanner (built with ``g++`` at first use into the port's
  git-ignored ``native/_build/``) and the pure-Python path; the prebuilt
  library loads without a toolchain, also when its source looks newer.
- **Bytes across packages:** on those cases and on seeded random messages
  (nested submessages, every wire type, long and empty strings, absent
  and malformed paths), ``extract_id`` and ``splice_id`` of the port's two
  backends give what the reference's gives, byte for byte, or raise the
  same exception type.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from modelmesh_tpu.native import proto_splicer as ref_splicer
from modelmesh_tpu_torch.native import proto_splicer
from tests.test_torch_api import PORT

apb, ipb = PORT.apb, PORT.ipb


def roundtrip_msgs():
    m1 = apb.RegisterModelRequest(
        model_id="the-model",
        info=apb.ModelInfo(model_type="classifier", model_path="gs://p"),
        load_now=True)
    m2 = ipb.ForwardRequest(model_id="fwd-model", payload=b"\x01\x02" * 50)
    return m1, m2


@pytest.fixture(params=["python", "native"])
def splicer(request, monkeypatch):
    if request.param == "python":
        monkeypatch.setattr(proto_splicer, "_lib", False)
    else:
        assert proto_splicer._ensure_native(), "no native splicer"
    return proto_splicer


class TestExtract:
    def test_top_level_string(self, splicer):
        m1, m2 = roundtrip_msgs()
        assert splicer.extract_id(m1.SerializeToString(), (1,)) == "the-model"
        assert splicer.extract_id(m2.SerializeToString(), (1,)) == "fwd-model"

    def test_nested_path(self, splicer):
        m1, _ = roundtrip_msgs()
        data = m1.SerializeToString()
        assert splicer.extract_id(data, (2, 1)) == "classifier"
        assert splicer.extract_id(data, (2, 2)) == "gs://p"

    def test_absent_field(self, splicer):
        m1, _ = roundtrip_msgs()
        assert splicer.extract_id(m1.SerializeToString(), (9,)) is None
        assert splicer.extract_id(m1.SerializeToString(), (2, 9)) is None

    def test_malformed_raises(self, splicer):
        with pytest.raises(ValueError):
            splicer.extract_id(b"\x0a\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff",
                               (1,))

    def test_overflow_length_varint_no_hang(self, splicer):
        evil = (b"\x12" + b"\xf5\xff\xff\xff\xff\xff\xff\xff\xff\x01"
                + b"\x00" * 4)
        with pytest.raises(ValueError):
            splicer.extract_id(evil, (1,))


class TestSplice:
    def test_top_level_replace(self, splicer):
        m1, _ = roundtrip_msgs()
        out = splicer.splice_id(m1.SerializeToString(), (1,),
                                "replacement-id")
        parsed = apb.RegisterModelRequest.FromString(out)
        assert parsed.model_id == "replacement-id"
        assert parsed.info.model_type == "classifier"
        assert parsed.load_now is True

    def test_nested_replace(self, splicer):
        m1, _ = roundtrip_msgs()
        out = splicer.splice_id(m1.SerializeToString(), (2, 1), "new-type")
        parsed = apb.RegisterModelRequest.FromString(out)
        assert parsed.info.model_type == "new-type"
        assert parsed.model_id == "the-model"

    def test_varint_width_growth(self, splicer):
        m = apb.RegisterModelRequest(model_id="m",
                                     info=apb.ModelInfo(model_type="t" * 100))
        out = splicer.splice_id(m.SerializeToString(), (2, 1), "x" * 200)
        parsed = apb.RegisterModelRequest.FromString(out)
        assert parsed.info.model_type == "x" * 200
        assert parsed.model_id == "m"

    def test_shrinking_replace(self, splicer):
        m = apb.RegisterModelRequest(model_id="m",
                                     info=apb.ModelInfo(model_type="y" * 300))
        out = splicer.splice_id(m.SerializeToString(), (2, 1), "z")
        assert apb.RegisterModelRequest.FromString(out).info.model_type == "z"

    def test_append_missing_top_level(self, splicer):
        m = apb.RegisterModelRequest(load_now=True)
        out = splicer.splice_id(m.SerializeToString(), (1,), "added")
        parsed = apb.RegisterModelRequest.FromString(out)
        assert parsed.model_id == "added" and parsed.load_now is True

    def test_missing_nested_raises(self, splicer):
        m = apb.RegisterModelRequest(model_id="m")
        with pytest.raises(KeyError):
            splicer.splice_id(m.SerializeToString(), (2, 1), "x")


class TestBackends:
    def test_native_builds_and_agrees_with_python(self):
        assert proto_splicer._ensure_native()
        m1, _ = roundtrip_msgs()
        data = m1.SerializeToString()
        assert (proto_splicer._find_path(data, (2, 1))
                == proto_splicer._find_path_py(data, (2, 1)))
        assert proto_splicer.backend == "native"

    def test_builds_into_the_ports_own_tree(self):
        root = os.path.dirname(os.path.dirname(proto_splicer._HERE))
        assert os.path.relpath(proto_splicer._SO_PATH, root) == os.path.join(
            "modelmesh_tpu_torch", "native", "_build", "libmmsplicer.so")
        assert proto_splicer._SRC != ref_splicer._SRC


def _run_without_toolchain(assert_msg):
    code = (
        "import os; os.environ['PATH']=''\n"
        "from modelmesh_tpu_torch.native import proto_splicer as ps\n"
        f"assert ps._ensure_native(), {assert_msg!r}\n"
        "assert ps.backend == 'native', ps.backend\n"
        "print('NATIVE-OK')\n"
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=60, env={k: v for k, v in os.environ.items() if k != "PATH"})


class TestPrebuilt:
    def test_prebuilt_so_loads_without_toolchain(self):
        assert proto_splicer._ensure_native()
        out = _run_without_toolchain("prebuilt .so did not load")
        assert out.returncode == 0, out.stderr
        assert "NATIVE-OK" in out.stdout

    def test_stale_looking_prebuilt_still_loads_without_toolchain(self):
        assert proto_splicer._ensure_native()
        src_mtime = os.path.getmtime(proto_splicer._SRC)
        os.utime(proto_splicer._SO_PATH, (src_mtime - 3600, src_mtime - 3600))
        try:
            out = _run_without_toolchain("stale prebuilt did not load")
            assert out.returncode == 0, out.stderr
            assert "NATIVE-OK" in out.stdout
        finally:
            now = time.time()
            os.utime(proto_splicer._SO_PATH, (now, now))


# -- bytes across packages -----------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _random_message(rng, depth: int) -> tuple[bytes, list]:
    """Wire-format bytes with random fields, and the paths of the string
    fields in them (nested ones through length-delimited submessages)."""
    out = bytearray()
    paths = []
    for _ in range(int(rng.integers(0, 6))):
        field = int(rng.integers(1, 9))
        kind = int(rng.integers(0, 5))
        if kind == 0:
            out += _varint(field << 3) + _varint(int(rng.integers(0, 2**40)))
        elif kind == 1:
            out += _varint(field << 3 | 1) + rng.bytes(8)
        elif kind == 2:
            out += _varint(field << 3 | 5) + rng.bytes(4)
        elif kind == 3 or depth == 0:
            n = int(rng.choice([0, 1, 5, 127, 128, 300]))
            s = "".join(chr(int(c)) for c in rng.integers(97, 123, size=n))
            out += _varint(field << 3 | 2) + _varint(n) + s.encode()
            paths.append((field,))
        else:
            inner, inner_paths = _random_message(rng, depth - 1)
            out += _varint(field << 3 | 2) + _varint(len(inner)) + inner
            paths += [(field,) + p for p in inner_paths]
    return bytes(out), paths


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return ("raise", type(e).__name__)


def _backends(monkeypatch):
    """(package, backend, module, call): the port's native and Python
    paths, and the reference's Python path. The reference's native
    library is left alone: loading it may rebuild it in the JAX package's
    tree, where its own tests load it (they hold it to its Python
    path)."""
    assert proto_splicer._ensure_native()

    def native(fn):
        return fn()

    def python(mod):
        def run(fn):
            with monkeypatch.context() as mp:
                mp.setattr(mod, "_lib", False)
                return fn()
        return run

    return [("port", "native", proto_splicer, native),
            ("port", "python", proto_splicer, python(proto_splicer)),
            ("ref", "python", ref_splicer, python(ref_splicer))]


def _cases(seed: int) -> list:
    rng = np.random.default_rng(seed)
    m1, m2 = roundtrip_msgs()
    cases = [(m1.SerializeToString(), [(1,), (2, 1), (2, 2), (9,), (2, 9),
                                       (3,)]),
             (m2.SerializeToString(), [(1,), (3,), (5, 1)]),
             (b"\x0a\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff", [(1,)]),
             (b"\x12\xf5\xff\xff\xff\xff\xff\xff\xff\xff\x01" + b"\0" * 4,
              [(1,), (2, 1)])]
    for _ in range(40):
        data, paths = _random_message(rng, 3)
        extra = [(int(rng.integers(1, 9)),),
                 (int(rng.integers(1, 9)), int(rng.integers(1, 9)))]
        if data and rng.random() < 0.2:
            data = data[: int(rng.integers(0, len(data)))]  # truncated
        cases.append((data, paths + extra))
    return cases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bytes_match_the_references_on_both_backends(seed, monkeypatch):
    results = {}
    for pkg_name, backend, mod, run in _backends(monkeypatch):
        got = []
        for data, paths in _cases(seed):
            for path in paths:
                got.append(run(lambda: _outcome(
                    lambda: mod.extract_id(data, path))))
                for new_id in ("", "n", "x" * 130):
                    got.append(run(lambda: _outcome(
                        lambda: mod.splice_id(data, path, new_id))))
        results[(pkg_name, backend)] = got
    want = results[("ref", "python")]
    assert any(r[0] == "ok" and isinstance(r[1], bytes) for r in want)
    assert any(r[0] == "raise" for r in want)
    for key, got in results.items():
        assert got == want, key
