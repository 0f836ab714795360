"""Builds, checks and launches the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``modelmesh_tpu_torch/_build/`` (git-ignored), the
first time a wrapper needs it, and is bound with ``ctypes``. The library
name carries a digest of the source and the flags, so an edited source
rebuilds and a stale library is never loaded. Sources build in parallel
(one ``nvcc`` each, all started together). ``check_operands`` and
``launch`` are what every kernel wrapper does around a launch.

Nothing here runs at import time: this module is imported on hosts with
no CUDA toolkit, where only the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the kernels' selection key must round exactly as
# PyTorch's own CUDA log does. --fmad=false keeps nvcc from contracting a
# multiply and an add into one differently rounded FMA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint

# C signature of every exported function, by library.
SIGNATURES: dict[str, dict[str, list]] = {
    "masked_sparse": {
        "mm_masked_row_min": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
        "mm_select_candidates": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P,
        ],
        "mm_select_max_cols": [],
        "mm_gumbel_err_blocks": [],
        "mm_gumbel_err": [_P, _P],
        "mm_masked_row_matvec": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
        "mm_masked_col_matvec": [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P,
        ],
        "mm_masked_sinkhorn_step": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P,
        ],
        "mm_col_combine": [_P, _P, _I, _I, _P],
    },
    "lse": {
        "mm_row_lse_partial": [_P, _P, _P, _P, _I, _I, _F, _P],
        "mm_col_lse_partial": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
        "mm_lse_sinkhorn_step": [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P,
        ],
        "mm_lse_col_combine": [_P, _P, _P, _P, _I, _I, _P],
    },
    "implied_load": {
        "mm_implied_load": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _I,
                            _I, _P],
        "mm_load_combine": [_P, _P, _I, _I, _P],
    },
    "threefry": {
        "mm_threefry": [_P, _U, _U, _L, _I, _P],
        "mm_threefry_normal": [_P, _P, _U, _U, _L, _I, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  #: guarded-by: _lock
# Bound functions by (library, function), filled at first launch: a launch
# takes no lock once its library is loaded.
_fns: dict[tuple[str, str], object] = {}
# Serializes the wrappers' launch counts: the shards of a mesh launch from
# threads of their own.
_count_lock = threading.Lock()
# Per-library compiler output (ptxas register/spill report) and seconds
# spent building, from the last build in this process.
build_log: dict[str, str] = {}  #: guarded-by: _lock
build_seconds: dict[str, float] = {}  #: guarded-by: _lock


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (on PATH or under /usr/local/cuda): the CUDA "
        "kernels cannot be built on this host"
    )


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _build_locked(names) -> None:
    """Compile every library in ``names`` that has no up-to-date build,
    all ``nvcc`` processes running at once."""
    todo = []
    for name in names:
        src, out = _target(name)
        if not out.exists():
            todo.append((name, src, out))
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all() -> None:
    """Build (if needed) and load every library, the builds in parallel."""
    with _lock:
        _build_locked(SIGNATURES)
        for name in SIGNATURES:
            _load_locked(name)


def _load_locked(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        _build_locked([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built at first use."""
    with _lock:
        return _load_locked(name)


def check_cpu(*tensors) -> None:
    """Operands of a plain version: on the CPU, like the cost matrix."""
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"C is on the CPU but an operand is on {t.device}")


def check_vectors(C, rows=(), cols=()) -> tuple[int, int]:
    """Each ``(name, tensor, dtype)`` of ``rows`` (``cols``) a vector of
    that dtype and 2-D C's row (column) count, on C's device. Returns
    (n, m)."""
    if C.dim() != 2:
        raise TypeError(f"C must be 2-D (got {C.dim()}-D)")
    n, m = C.shape
    want = [(name, t, dtype, n) for name, t, dtype in rows]
    want += [(name, t, dtype, m) for name, t, dtype in cols]
    for name, t, dtype, size in want:
        if t.dtype != dtype or t.shape != (size,):
            raise TypeError(
                f"{name} must be {dtype}[{size}] (got {t.dtype}"
                f"{list(t.shape)})"
            )
        if t.device != C.device:
            raise ValueError(f"{name} is on {t.device}, C on {C.device}")
    return n, m


def check_operands(C, rows=(), cols=()) -> tuple[int, int]:
    """What a kernel takes: C a contiguous 2-D bf16 tensor, and each
    ``(name, tensor, dtype)`` of ``rows`` (``cols``) a contiguous vector of
    that dtype and C's row (column) count, all on C's device. Returns
    (n, m)."""
    if C.dim() != 2 or C.dtype != torch.bfloat16:
        raise TypeError(
            f"C must be a 2-D bf16 tensor (got {C.dtype}, {C.dim()}-D)"
        )
    n, m = check_vectors(C, rows, cols)
    for name, t in [("C", C)] + [(r[0], r[1]) for r in (*rows, *cols)]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n, m


def check_cuda(C, rows=(), cols=()) -> tuple[int, int]:
    """``check_operands`` for a launch: C must be on a CUDA device."""
    if C.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {C.device}")
    return check_operands(C, rows, cols)


def count_launch(table: dict, name: str) -> None:
    """``table[name] += 1`` under a lock (a wrapper's launch count)."""
    with _count_lock:
        table[name] += 1


def current_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(lib_name: str, fn_name: str, device, *args) -> None:
    """Call ``fn_name`` of library ``lib_name`` on the current stream of
    ``device``; raises when the launch was refused. The host's current
    device is switched only when it is another: a kernel launches on the
    current device."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        fn = _fns.setdefault((lib_name, fn_name),
                             getattr(load_library(lib_name), fn_name))
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        err = fn(*args, current_stream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, current_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed (CUDA error {err})")
