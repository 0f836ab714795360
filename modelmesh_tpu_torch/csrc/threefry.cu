// JAX's threefry draw for Hopper (sm_90a): random bits and Gumbel(0, 1) noise.
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
// injections; the uniform's shift and or) and two logf: ~0.62 ms of the
// card's integer issue at that shape (64 INT32 lanes per SM), so the
// kernel is bound by its operations, not its bytes.
//
// Design: one thread per element, a grid-stride loop, 32-bit unsigned
// arithmetic (the rotations are funnel shifts), stores coalesced. The
// uniform's scale is 1 - tiny, which rounds to 1.0f, so its multiply is
// exact and the kernel adds tiny alone; with --fmad=false and no fast math
// the two logf round as PyTorch's CUDA log does, so the kernel equals the
// plain version on the card bit for bit. mode 0 writes the 32 bits (as
// int32), mode 1 the Gumbel values.

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

}  // extern "C"
