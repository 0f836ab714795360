"""The port's own copy of the JAX package's ``native/proto_splicer.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

Model-id extraction/splicing on serialized protobuf bytes.

Python front-end over the C++ scanner (splicer.cc, built on demand) with a
pure-Python fallback. Capability parity with the reference's ProtoSplicer
(ProtoSplicer.java: extractId :29, spliceId; used at ModelMeshApi.java:689
and SidecarModelMesh.java:481): given a field path like ``(1,)`` or
``(2, 1)`` (nested), read the UTF-8 string there, or replace it —
re-encoding the varint lengths of every enclosing message.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

log = logging.getLogger(__name__)

_HERE = os.path.dirname(__file__)
_BUILD_DIR = os.path.join(_HERE, "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libmmsplicer.so")
_SRC = os.path.join(_HERE, "splicer.cc")

_lib = None
_lib_lock = threading.Lock()
backend = "python"


def _ensure_native():
    """Compile + load the native scanner once; None if unavailable."""
    global _lib, backend
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            if not os.path.exists(_SO_PATH) or (
                os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)
            ):
                try:
                    os.makedirs(_BUILD_DIR, exist_ok=True)
                    subprocess.run(
                        ["g++", "-O2", "-shared", "-fPIC", "-o", _SO_PATH,
                         _SRC],
                        check=True, capture_output=True, timeout=120,
                    )
                except (FileNotFoundError, PermissionError):
                    # No toolchain / read-only install (the container ships
                    # a prebuilt .so and no g++): a stale-looking prebuilt
                    # is still the native scanner — load it rather than
                    # silently dropping to the slow Python fallback. A
                    # genuine COMPILE failure (CalledProcessError) must NOT
                    # be swallowed here: loading a stale .so over edited
                    # source would silently diverge native from Python.
                    if not os.path.exists(_SO_PATH):
                        raise
                    log.info(
                        "splicer rebuild unavailable; loading prebuilt %s",
                        _SO_PATH,
                    )
            lib = ctypes.CDLL(_SO_PATH)
            lib.mm_find_path.restype = ctypes.c_int
            lib.mm_find_path.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            _lib = lib
            backend = "native"
        except Exception as e:  # noqa: BLE001 — fallback is fine
            log.warning("native splicer unavailable (%s); using python", e)
            _lib = False
        return _lib


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data) or shift > 63:
            raise ValueError("malformed varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _find_path_py(data: bytes, path: Sequence[int]) -> Optional[list]:
    """[(len_varint_off, payload_off, payload_len)] per level, or None."""
    begin, end = 0, len(data)
    out = []
    for want in path:
        pos = begin
        found = False
        while pos < end:
            key, pos = _read_varint(data, pos)
            field, wire = key >> 3, key & 7
            if field == want and wire == 2:
                len_off = pos
                flen, pos = _read_varint(data, pos)
                if pos + flen > end:
                    raise ValueError("malformed length")
                out.append((len_off, pos, flen))
                begin, end = pos, pos + flen
                found = True
                break
            if wire == 0:
                _, pos = _read_varint(data, pos)
            elif wire == 1:
                pos += 8
            elif wire == 2:
                flen, pos = _read_varint(data, pos)
                pos += flen
            elif wire == 5:
                pos += 4
            else:
                raise ValueError(f"unsupported wire type {wire}")
            if pos > end:
                raise ValueError("field overruns message")
        if not found:
            return None
    return out


def _find_path(data: bytes, path: Sequence[int]) -> Optional[list]:
    lib = _ensure_native()
    if not lib:
        return _find_path_py(data, path)
    cpath = (ctypes.c_uint32 * len(path))(*path)
    out = (ctypes.c_size_t * (3 * len(path)))()
    rc = lib.mm_find_path(data, len(data), cpath, len(path), out)
    if rc == -1:
        return None
    if rc != 0:
        raise ValueError("malformed protobuf")
    return [
        (out[3 * i], out[3 * i + 1], out[3 * i + 2])
        for i in range(len(path))
    ]


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def extract_id(data: bytes, path: Sequence[int]) -> Optional[str]:
    """Read the UTF-8 string field at ``path``; None if absent."""
    levels = _find_path(data, path)
    if levels is None:
        return None
    _, off, ln = levels[-1]
    return data[off: off + ln].decode("utf-8", errors="replace")

def splice_id(data: bytes, path: Sequence[int], new_id: str) -> bytes:
    """Replace the string at ``path``, re-encoding enclosing lengths.

    Raises KeyError if the field is absent (callers fall back to appending
    a fresh field only for top-level paths — matching reference behavior of
    requiring the field to exist for nested paths).
    """
    levels = _find_path(data, path)
    new_bytes = new_id.encode()
    if levels is None:
        if len(path) == 1:
            # Append the field (tag + len + payload) at the end.
            tag = _write_varint((path[0] << 3) | 2)
            return data + tag + _write_varint(len(new_bytes)) + new_bytes
        raise KeyError(f"field path {tuple(path)} not present")
    # Compute new lengths innermost-first: the byte delta propagating
    # outward includes both the payload change AND any change in the WIDTH
    # of inner length varints (e.g. 127 -> 128 widens the varint by a byte).
    delta = len(new_bytes) - levels[-1][2]
    new_len_varints: list[bytes] = []
    for len_off, payload_off, payload_len in reversed(levels):
        nb = _write_varint(payload_len + delta)
        delta += len(nb) - (payload_off - len_off)
        new_len_varints.append(nb)
    new_len_varints.reverse()
    # Assemble top-down: preserve bytes between levels (tags + siblings).
    result = bytearray()
    cursor = 0
    for (len_off, payload_off, _payload_len), nb in zip(levels, new_len_varints):
        result += data[cursor:len_off]
        result += nb
        cursor = payload_off
    result += new_bytes                          # innermost payload
    cursor = levels[-1][1] + levels[-1][2]
    result += data[cursor:]                      # trailing siblings
    return bytes(result)
