#!/usr/bin/env python3
"""The normal kernel's f32 arithmetic against its plain version, on a host
without a CUDA toolkit.

    python3 tools/threefry_host_check.py [--cxx g++]

Compiles the device functions of ``modelmesh_tpu_torch/csrc/threefry.cu``
(the hash, ``fma_once``, ``logf_xla``, ``log1p_xla``, ``erf_inv_xla``)
with a host C++ compiler, each round-to-nearest intrinsic the kernel
calls (``__fadd_rn``, ``__dmul_rn``, ...) defined as the plain IEEE
operation and contraction off (``-ffp-contract=off``), and the f32 normal
kernel's per-element body around them. Then holds its results against
``random.normal_of_bits`` on every f32 uniform (the 2**23 values of the
draw's top 23 bits) and against ``random.normal`` on seeded draws, bit
for bit. Prints one JSON object; exits non-zero on a difference.

The card's own check is ``chip_smoke.py``'s phase ``weight_draw``; this
one shows before a chip run that the kernel's f32 route follows the plain
version's arithmetic step for step.
"""

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from modelmesh_tpu_torch import random as prng  # noqa: E402

SOURCE = ROOT / "modelmesh_tpu_torch" / "csrc" / "threefry.cu"
PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int r) {
  r &= 31;
  return r ? (hi << r) | (lo >> (32 - r)) : hi;
}
static inline float __int_as_float(int v) { float f; memcpy(&f, &v, 4); return f; }
static inline float __uint_as_float(uint32_t v) { float f; memcpy(&f, &v, 4); return f; }
static inline int __float_as_int(float f) { int v; memcpy(&v, &f, 4); return v; }
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
static inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
static inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
static inline double __dsqrt_rn(double a) { return std::sqrt(a); }
static inline float __double2float_rn(double a) { return (float)a; }
"""
# The f32 branch of normal_kernel's loop body, over given bits.
BODY = r"""
static inline float normal_f32(uint32_t bits) {
  const float lo = __uint_as_float(0xBF7FFFFFu);
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(lo, fma_once(f, __fsub_rn(1.0f, lo), lo));
  return __fmul_rn(erf_inv_xla(u), F32(1.4142135623730951));
}
extern "C" void of_bits(const uint32_t* bits, long long n, float* out) {
  for (long long i = 0; i < n; ++i) out[i] = normal_f32(bits[i]);
}
extern "C" void draw(uint32_t k0, uint32_t k1, long long n, float* out) {
  for (long long i = 0; i < n; ++i) {
    out[i] = normal_f32(threefry_bits(
        k0, k1, (uint32_t)((unsigned long long)i >> 32), (uint32_t)i));
  }
}
"""


def build(cxx: str, workdir: Path) -> ctypes.CDLL:
    import subprocess

    src = SOURCE.read_text()
    hash_fns = src[src.index("__device__ __forceinline__ uint32_t rotl"):
                   src.index("template <bool kGumbel>")]
    normal_fns = src[src.index("// -- the normal draw"):
                     src.index("template <bool kF32>")]
    cpp = workdir / "threefry_host.cpp"
    cpp.write_text(PRELUDE + hash_fns + normal_fns + BODY)
    lib = workdir / "libthreefry_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", str(lib), str(cpp)],
                   check=True)
    out = ctypes.CDLL(str(lib))
    out.of_bits.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_void_p]
    out.draw.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                         ctypes.c_void_p]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cxx", default="g++")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(args.cxx, Path(tmp))
        differ, step = 0, 1 << 20
        for start in range(0, 1 << 23, step):
            bits = (np.arange(start, start + step, dtype=np.uint32)
                    << np.uint32(9))
            got = np.empty(step, np.float32)
            lib.of_bits(bits.ctypes.data, step, got.ctypes.data)
            want = prng.normal_of_bits(
                torch.from_numpy(bits.astype(np.int64)),
                torch.float32).numpy()
            differ += int((got.view(np.uint32)
                           != want.view(np.uint32)).sum())
        draws = {}
        for seed in (0, 7, 2**31 - 1):
            key = prng.PRNGKey(seed)
            k0, k1 = prng._words(key)
            n = 1 << 18
            got = np.empty(n, np.float32)
            lib.draw(k0, k1, n, got.ctypes.data)
            want = prng.normal(key, (n,), torch.float32,
                               device="cpu").numpy()
            draws[seed] = int((got.view(np.uint32)
                               != want.view(np.uint32)).sum())
    print(json.dumps({"uniforms": 1 << 23, "uniforms_differ": differ,
                      "seeded_draws": 1 << 18, "draws_differ": draws}))
    return 0 if differ == 0 and not any(draws.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
