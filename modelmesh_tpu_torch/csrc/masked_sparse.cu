// Fused candidate-mask kernels of the sparse placement solve, for Hopper
// (sm_90a). Three kernels share one selection-key function:
//
//   rowmin[n] = min_m { C[n, m] : key(n, m) <= thresh[n] }
//   r[n]      = sum_m [key <= thresh] * exp((rowmin[n] - C[n, m]) / eps) * v[m]
//   c[m]      = sum_n [key <= thresh] * exp((rowmin[n] - C[n, m]) / eps) * u[n]
//
// key(n, m) = f32(C[n, m]) - tau * gumbel(n, m), where the Gumbel draw is the
// murmur3 counter hash of (row state x_row[n], column m). Neither the mask nor
// the scaled kernel P = exp((rowmin - C) / eps) * mask ever exists in device
// memory: each kernel streams the cost matrix once and recomputes membership
// and the exponent in registers.
//
// Replaces the Pallas TPU kernels of modelmesh_tpu/ops/pallas_sparse.py:
//   row_kernel<false>              <- masked_row_min (_row_min_kernel,
//                                     _tile_key)
//   row_kernel<true>               <- masked_row_matvec (_row_matvec_kernel)
//   col_partial/col_reduce_kernel  <- masked_col_matvec (_col_matvec_kernel)
//
// Bound. Each launch must read C once (N*M*2 bytes in bf16) plus O(N + M)
// f32/u32 vectors: 268.4 MB at the 131072 x 1024 tier, about 80 us at the
// H100 SXM's 3.35 TB/s. Per element the kernels also spend one hash (two
// 32-bit multiplies, xors and shifts), two logf and, for the products, one
// expf, so the instruction rate sits close to the byte rate. The design
// keeps to the byte bound by reading C exactly once per launch with no
// padded copy (ragged edges are bounds-checked), 16-byte vector loads on
// the row kernels, and no materialized [N, M] intermediate.
//
// Determinism. Reductions run in a fixed order: the row kernels reduce one
// row per warp (lane-strided partials, then an xor-shuffle tree), and the
// column product is two passes (per-chunk partials to a scratch buffer,
// then a fixed-order sum over chunks). No float atomics.
//
// Bitwise mask parity. The key must equal, bit for bit, the key that
// modelmesh_tpu_torch.ops.cuda_sparse.selection_key computes with PyTorch
// ops on the same card, because the row thresholds come from that
// computation. So: build without fast math and with --fmad=false, use
// logf/expf (what PyTorch's own CUDA log/exp call), and spell the
// arithmetic with round-to-nearest intrinsics that cannot be contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads per block, every kernel
constexpr int kColTile = 256;   // rows staged in shared memory per step

// murmur3 finalizer: op for op the one in ops/auction.py::hash_gumbel_at.
__device__ __forceinline__ uint32_t fmix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

// Noisy selection key of one entry. The column counter is uint32 before the
// multiply, so the >> 8 below is a logical shift.
__device__ __forceinline__ float selection_key(float c, uint32_t xr,
                                               uint32_t col, float tau,
                                               int noised) {
  if (!noised) return c;
  const uint32_t x = fmix32(xr ^ (col * 0x85EBCA6Bu));
  float u = __fmul_rn(__uint2float_rn(x >> 8), 1.0f / 16777216.0f);
  u = fmaxf(u, 1e-7f);
  const float g = -logf(-logf(u));
  return __fsub_rn(c, __fmul_rn(tau, g));
}

__device__ __forceinline__ float shifted_exp(float rm, float c, float eps) {
  return expf(__fdiv_rn(__fsub_rn(rm, c), eps));
}

// One warp per row. kMatvec = false: masked min of C; true: masked
// shifted-exp product with v.
template <bool kMatvec>
__global__ void __launch_bounds__(kThreads)
row_kernel(const __nv_bfloat16* __restrict__ C,
           const float* __restrict__ thresh,
           const uint32_t* __restrict__ x_row,
           const float* __restrict__ rowmin, const float* __restrict__ v,
           float* __restrict__ out, int n, int m, float eps, float tau,
           int noised, int vec_ok) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
  const float th = thresh[row];
  const uint32_t xr = x_row[row];
  const float rm = kMatvec ? rowmin[row] : 0.0f;
  float acc = kMatvec ? 0.0f : INFINITY;

  auto visit = [&](float c, int col) {
    if (selection_key(c, xr, static_cast<uint32_t>(col), tau, noised) <= th) {
      if (kMatvec) {
        acc = __fadd_rn(acc, __fmul_rn(shifted_exp(rm, c, eps), v[col]));
      } else {
        acc = fminf(acc, c);
      }
    }
  };

  if (vec_ok) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const int chunks = m / kVec;
    for (int j = lane; j < chunks; j += 32) {
      const uint4 raw = __ldg(p4 + j);
      const auto* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        visit(__bfloat162float(vals[t]), j * kVec + t);
      }
    }
  } else {
    for (int col = lane; col < m; col += 32) {
      visit(__bfloat162float(p[col]), col);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, acc, off);
    acc = kMatvec ? __fadd_rn(acc, other) : fminf(acc, other);
  }
  if (lane == 0) out[row] = acc;
}

// Column product, pass 1: block (x, y) covers kThreads columns and the
// rows of chunk y; each thread walks its column down the chunk (a warp's
// loads are contiguous along the row) and writes one partial.
__global__ void __launch_bounds__(kThreads)
col_partial_kernel(const __nv_bfloat16* __restrict__ C,
                   const float* __restrict__ thresh,
                   const uint32_t* __restrict__ x_row,
                   const float* __restrict__ rowmin,
                   const float* __restrict__ u, float* __restrict__ partial,
                   int n, int m, int rows_per_chunk, float eps, float tau,
                   int noised) {
  __shared__ float s_th[kColTile];
  __shared__ uint32_t s_xr[kColTile];
  __shared__ float s_rm[kColTile];
  __shared__ float s_u[kColTile];
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const bool active = col < m;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  float acc = 0.0f;
  for (int t0 = r0; t0 < r1; t0 += kColTile) {
    const int rows = min(kColTile, r1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      s_th[i] = thresh[t0 + i];
      s_xr[i] = x_row[t0 + i];
      s_rm[i] = rowmin[t0 + i];
      s_u[i] = u[t0 + i];
    }
    __syncthreads();
    if (active) {
      const __nv_bfloat16* p = C + static_cast<size_t>(t0) * m + col;
      for (int i = 0; i < rows; ++i, p += m) {
        const float c = __bfloat162float(*p);
        if (selection_key(c, s_xr[i], static_cast<uint32_t>(col), tau,
                          noised) <= s_th[i]) {
          acc = __fadd_rn(acc,
                          __fmul_rn(shifted_exp(s_rm[i], c, eps), s_u[i]));
        }
      }
    }
  }
  if (active) partial[static_cast<size_t>(blockIdx.y) * m + col] = acc;
}

// Column product, pass 2: fixed-order sum of the chunk partials.
__global__ void __launch_bounds__(kThreads)
col_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int chunks, int m) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    acc = __fadd_rn(acc, partial[static_cast<size_t>(k) * m + col]);
  }
  out[col] = acc;
}

// Rows start on 16-byte boundaries: take the vector loads.
int vec_ok(const void* C, int m) {
  return (m % 8 == 0) && (reinterpret_cast<uintptr_t>(C) % 16 == 0);
}

template <bool kMatvec>
int launch_row(const void* C, const void* thresh, const void* x_row,
               const void* rowmin, const void* v, void* out, int n, int m,
               float eps, float tau, int noised, cudaStream_t stream) {
  const int blocks = static_cast<int>((static_cast<long long>(n) * 32 +
                                       kThreads - 1) / kThreads);
  row_kernel<kMatvec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(thresh),
      static_cast<const uint32_t*>(x_row), static_cast<const float*>(rowmin),
      static_cast<const float*>(v), static_cast<float*>(out), n, m, eps, tau,
      noised, vec_ok(C, m));
  return static_cast<int>(cudaGetLastError());
}

int launch_col(const void* C, const void* thresh, const void* x_row,
               const void* rowmin, const void* u, void* partial, void* out,
               int n, int m, int rows_per_chunk, float eps, float tau,
               int noised, cudaStream_t stream) {
  const int chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid((m + kThreads - 1) / kThreads, chunks);
  col_partial_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(thresh),
      static_cast<const uint32_t*>(x_row), static_cast<const float*>(rowmin),
      static_cast<const float*>(u), static_cast<float*>(partial), n, m,
      rows_per_chunk, eps, tau, noised);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  col_reduce_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), chunks, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. C is bf16[n, m] row-major; x_row
// holds uint32 bits; the wrapper checks shapes, dtypes and contiguity, and
// allocates `out` and the column scratch (`partial`,
// f32[ceil(n / rows_per_chunk), m]). Each returns the cudaGetLastError()
// code after its launches (0 = launched).
extern "C" {

int mm_masked_row_min(const void* C, const void* thresh, const void* x_row,
                      void* out, int n, int m, float tau, int noised,
                      void* stream) {
  return launch_row<false>(C, thresh, x_row, nullptr, nullptr, out, n, m,
                           1.0f, tau, noised,
                           static_cast<cudaStream_t>(stream));
}

int mm_masked_row_matvec(const void* C, const void* thresh,
                         const void* x_row, const void* rowmin, const void* v,
                         void* out, int n, int m, float eps, float tau,
                         int noised, void* stream) {
  return launch_row<true>(C, thresh, x_row, rowmin, v, out, n, m, eps, tau,
                          noised, static_cast<cudaStream_t>(stream));
}

int mm_masked_col_matvec(const void* C, const void* thresh,
                         const void* x_row, const void* rowmin, const void* u,
                         void* partial, void* out, int n, int m,
                         int rows_per_chunk, float eps, float tau, int noised,
                         void* stream) {
  return launch_col(C, thresh, x_row, rowmin, u, partial, out, n, m,
                    rows_per_chunk, eps, tau, noised,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
