// JAX's threefry draw for Hopper (sm_90a): random bits, Gumbel(0, 1) noise
// and normal model weights.
//
//   bits[i] = y0 ^ y1,  (y0, y1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//   u[i]    = max(tiny, (float(bits[i] >> 9 | 0x3F800000) - 1) * 1 + tiny)
//   g[i]    = -log(-log(u[i]))
//
// over the flat row-major index i of an [N, M] block: what
// jax.random.gumbel(jax.random.PRNGKey(seed), (N, M)) draws with
// jax_threefry_partitionable on (its default), bit for bit.
//
// Replaces the dense tier's noise in modelmesh_tpu/ops/auction.py::
// gumbel_perturb (impl="threefry", line 337): XLA's threefry, not a Pallas
// kernel. The port's plain version (modelmesh_tpu_torch/random.py) runs
// ~160 int64 elementwise passes over the block; at the dense tier's
// [131072, 1024] that is tens of GB of device traffic.
//
// Bound. The function writes N*M floats once and reads nothing: 537 MB at
// [131072, 1024], 0.16 ms at the H100 SXM's 3.35 TB/s. Each element costs
// ~77 32-bit integer operations (20 rounds of add, rotate, xor; 6 key
// injections; the uniform's shift and or) and two logf. Its 45 rotates,
// XORs and shifts issue on the 64 INT32 lanes a SM alone, its 32 adds on
// those or on the FMA lanes (as IMAD): at least ~0.36 ms of integer issue
// at that shape, so the kernel is bound by its operations, not its bytes.
//
// Design: one thread per element, a grid-stride loop, 32-bit unsigned
// arithmetic (the rotations are funnel shifts), stores coalesced. The
// uniform's scale is 1 - tiny, which rounds to 1.0f, so its multiply is
// exact and the kernel adds tiny alone; with --fmad=false and no fast math
// the two logf round as PyTorch's CUDA log does, so the kernel equals the
// plain version on the card bit for bit. mode 0 writes the 32 bits (as
// int32), mode 1 the Gumbel values.
//
// The normal draw (mm_threefry_normal): jax.random.normal(key, shape,
// dtype), sqrt(2) * erf_inv(u) over u uniform in (nextafter(-1, 0), 1),
// for the model families' bf16 weights and the MoE router's f32 ones.
// Replaces modelmesh_tpu/models/families.py's and parallel/moe.py's
// jax.random.normal (XLA's threefry on the accelerator, not a Pallas
// kernel), which the port drew on the host before.
//
//   bf16: a bf16 uniform keeps the top 7 bits of the draw's low byte
//         ((bits >> 1) & 0x7F), so it takes 128 values; the wrapper hands
//         the kernel the plain version's 128 results (computed on the host
//         once a process) and the kernel looks its element up. Exact by
//         construction, and the kernel is left with the hash: ~77 integer
//         operations an element (the index's shift and mask in place of
//         the uniform's) against 2 bytes written, bound by its operations
//         (25.5M elements: at least 0.069 ms against 15 us of writes).
//   f32:  the plain version's arithmetic step for step: XLA's erf_inv (M.
//         Giles' polynomial) over XLA's CPU log1p and logf, each of their
//         multiply-adds an f64 product and sum rounded once to f32, the
//         square root taken in f64 and rounded; every f32 step an explicit
//         round-to-nearest intrinsic, so nothing contracts or reorders.
//
// Layout and counters are the bits' (the flat index kept in 64 bits, so
// the counter's high word is right at any size). mode 0 writes bf16 (as
// uint16), mode 1 f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

template <bool kGumbel>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(uint32_t k0, uint32_t k1, long long total,
                void* __restrict__ out) {
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const uint32_t bits = threefry_bits(
        k0, k1, static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32),
        static_cast<uint32_t>(i));
    if (kGumbel) {
      const float tiny = 1.17549435e-38f;  // FLT_MIN
      const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                                1.0f);
      const float u = fmaxf(tiny, __fadd_rn(f, tiny));
      static_cast<float*>(out)[i] = -logf(-logf(u));
    } else {
      static_cast<uint32_t*>(out)[i] = bits;
    }
  }
}


// -- the normal draw ---------------------------------------------------------

// A float constant as PyTorch rounds a Python float (an f64) to f32.
#define F32(v) static_cast<float>(v)

// f32 a * b + c rounded once: the product of two f32 values is exact in
// f64 (random.py's _fma).
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// XLA's CPU f32 log (Cephes' logf with the multiply-adds its compiler
// fuses): random.py's _logf.
__device__ float logf_xla(float v) {
  const float tiny = 1.17549435e-38f;  // FLT_MIN
  const int bits = __float_as_int(v > tiny ? v : tiny);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x7FFFFF) | 0x3F000000);  // [0.5, 1)
  const bool low = m < F32(0.707106781186547524);
  const float xm = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fmul_rn(xm, xm);
  const float x3 = __fmul_rn(z, xm);
  const float y1 = fma_once(fma_once(xm, F32(7.0376836292e-2),
                                     F32(-1.1514610310e-1)),
                            xm, F32(1.1676998740e-1));
  const float y2 = fma_once(fma_once(xm, F32(-1.2420140846e-1),
                                     F32(1.4249322787e-1)),
                            xm, F32(-1.6668057665e-1));
  const float y3 = fma_once(fma_once(xm, F32(2.0000714765e-1),
                                     F32(-2.4999993993e-1)),
                            xm, F32(3.3333331174e-1));
  float y = fma_once(fma_once(y1, x3, y2), x3, y3);
  y = fma_once(y, x3, __fmul_rn(e, F32(-2.12194440e-4)));
  float r = fma_once(e, F32(0.693359375),
                     __fadd_rn(__fsub_rn(xm, __fmul_rn(z, 0.5f)), y));
  if (!(v > 0.0f)) r = __int_as_float(0x7FC00000);  // NaN
  if (v == __int_as_float(0x7F800000)) r = v;       // inf
  if (v == 0.0f) r = __uint_as_float(0xFF800000u);  // -inf
  return r;
}

// XLA's CPU f32 log1p: Cephes' rational form below sqrt(2) - 1, else
// logf(1 + x) (random.py's _log1p_f32).
__device__ float log1p_xla(float x) {
  const float x2 = __fmul_rn(x, x);
  float num = F32(4.5270000862445199635215e-5);
  num = fma_once(num, x, F32(4.9854102823193375972212e-1));
  num = fma_once(num, x, F32(6.5787325942061044846969e0));
  num = fma_once(num, x, F32(2.9911919328553073277375e1));
  num = fma_once(num, x, F32(6.0949667980987787057556e1));
  num = fma_once(num, x, F32(5.7112963590585538103336e1));
  num = fma_once(num, x, F32(2.0039553499201281259648e1));
  float den = 1.0f;
  den = fma_once(den, x, F32(1.5062909083469192043167e1));
  den = fma_once(den, x, F32(8.3047565967967209469434e1));
  den = fma_once(den, x, F32(2.2176239823732856465394e2));
  den = fma_once(den, x, F32(3.0909872225312059774938e2));
  den = fma_once(den, x, F32(2.1642788614495947685003e2));
  den = fma_once(den, x, F32(6.0118660497603843919306e1));
  if (fabsf(x) < F32(0.41421356237309504880)) {
    return __fadd_rn(x, fma_once(x2, -0.5f,
                                 __fmul_rn(__fmul_rn(x, x2),
                                           __fdiv_rn(num, den))));
  }
  return logf_xla(__fadd_rn(x, 1.0f));
}

// XLA's f32 erf_inv (random.py's _erf_inv_f32).
__device__ float erf_inv_xla(float x) {
  const float lo_c[9] = {
      F32(2.81022636e-08), F32(3.43273939e-07), F32(-3.5233877e-06),
      F32(-4.39150654e-06), F32(0.00021858087), F32(-0.00125372503),
      F32(-0.00417768164), F32(0.246640727), F32(1.50140941)};
  const float hi_c[9] = {
      F32(-0.000200214257), F32(0.000100950558), F32(0.00134934322),
      F32(-0.00367342844), F32(0.00573950773), F32(-0.0076224613),
      F32(0.00943887047), F32(1.00167406), F32(2.83297682)};
  float w = -log1p_xla(__fmul_rn(-x, x));
  const bool low = w < 5.0f;
  w = low ? __fsub_rn(w, 2.5f)
          : __fsub_rn(__double2float_rn(__dsqrt_rn(static_cast<double>(w))),
                      3.0f);
  float p = low ? lo_c[0] : hi_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma_once(p, w, low ? lo_c[i] : hi_c[i]);
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7F800000));
  return __fmul_rn(p, x);
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads)
normal_kernel(uint32_t k0, uint32_t k1, long long total,
              const uint16_t* __restrict__ table, void* __restrict__ out) {
  __shared__ uint16_t s_table[128];
  if (!kF32) {
    for (int t = threadIdx.x; t < 128; t += blockDim.x) s_table[t] = table[t];
    __syncthreads();
  }
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const uint32_t bits = threefry_bits(
        k0, k1, static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32),
        static_cast<uint32_t>(i));
    if (kF32) {
      // u = max(lo, f64(f) * f64(hi - lo) + f64(lo) rounded to f32), lo =
      // nextafter(-1, 0), hi = 1 (random.py's uniform in f32).
      const float lo = __uint_as_float(0xBF7FFFFFu);  // -(1 - 2^-24)
      const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                                1.0f);
      const float u = fmaxf(lo, fma_once(f, __fsub_rn(1.0f, lo), lo));
      static_cast<float*>(out)[i] =
          __fmul_rn(erf_inv_xla(u), F32(1.4142135623730951));
    } else {
      static_cast<uint16_t*>(out)[i] = s_table[(bits >> 1) & 0x7Fu];
    }
  }
}

#undef F32

}  // namespace

extern "C" {

// out: int32[total] (mode 0, the bits) or f32[total] (mode 1, Gumbel).
int mm_threefry(void* out, unsigned int k0, unsigned int k1, long long total,
                int mode, cudaStream_t stream) {
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  if (mode == 1) {
    threefry_kernel<true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        k0, k1, total, out);
  } else {
    threefry_kernel<false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        k0, k1, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: bf16[total] as uint16 (mode 0; table: the 128 results of the
// plain version, uint16 on the card) or f32[total] (mode 1; table unused).
int mm_threefry_normal(void* out, const void* table, unsigned int k0,
                       unsigned int k1, long long total, int mode,
                       cudaStream_t stream) {
  if (total <= 0) return 0;
  if (mode == 0 && table == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  const uint16_t* tab = static_cast<const uint16_t*>(table);
  if (mode == 1) {
    normal_kernel<true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        k0, k1, total, tab, out);
  } else {
    normal_kernel<false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        k0, k1, total, tab, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
