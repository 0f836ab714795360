// Fused potential-shifted log-sum-exp partials of the dense Sinkhorn, for
// Hopper (sm_90a). Two kernels, one per reduction axis:
//
//   row: z[n, m] = (g[m] - C[n, m]) / eps, reduced over m -> (mx[n], s[n])
//   col: z[n, m] = (f[n] - C[n, m]) / eps, reduced over n -> (mx[m], s[m])
//
// with mx the maximum of z and s = sum exp(z - mx), so that
// LSE = log(max(s, 1e-30)) + mx. Partials over disjoint slices combine as
//
//   M = max(m1, m2);  s = s1 * exp(m1 - M) + s2 * exp(m2 - M)
//
// which is how the kernels reduce internally and how a sharded solver
// combines ranks. Neither z nor an f32 copy of C ever exists in device
// memory: each launch streams the bf16 cost matrix once.
//
// Replaces the Pallas TPU kernels of modelmesh_tpu/ops/pallas_lse.py:
//   row_lse_kernel                        <- row_lse_partial (_partial_kernel,
//                                            axis=1)
//   col_partial_kernel/col_combine_kernel <- col_lse_partial (_partial_kernel,
//                                            axis=0)
//
// Bound. Each launch must read C once (N*M*2 bytes) plus the shift vector
// and write two f32 vectors: 268.4 MB at the 131072 x 1024 tier, about
// 80 us at the H100 SXM's 3.35 TB/s. Per element the kernels spend one
// subtract, one division, a max, one expf and an add: six f32 operations
// by the data sheet's count, about 12 us at 67 TFLOP/s, so the bound is
// bytes. The IEEE division and expf are several instructions each, so
// the instruction stream is several times that count. The design reads C
// exactly once with no padded copy (ragged edges are bounds-checked; the
// Pallas path pads C to 256 x 512 tiles), 16-byte vector loads on the row
// kernel and 4-byte bf16x2 loads on the column kernel (a warp reads 128
// contiguous bytes per row).
//
// The Pallas kernel carries the column accumulator across a sequential row
// grid in VMEM. Blocks run in parallel here, so the column reduction is two
// passes: per-chunk partials (ROWS_PER_CHUNK rows each) to an f32 scratch
// the wrapper allocates, then a fixed-order combine over the chunks. No
// float atomics: both kernels are deterministic.
//
// Numerics. z is computed as a division, as the XLA reference (_row_lse)
// and the plain PyTorch versions spell it (Pallas multiplies by 1/eps).
// Built without fast math, so expf is the one PyTorch's CUDA exp calls.
// Two empty partials (m = -inf on both sides) combine to s = 0, not NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kColTile = 256;  // row shifts staged in shared memory per step
constexpr int kCombineCols = 32;   // columns per combine block
constexpr int kCombineLanes = 16;  // chunk walkers per column

// exp(a - mx) for a <= mx, with an empty partial (a = -inf) giving 0 even
// when mx is -inf too.
__device__ __forceinline__ float exp_below(float a, float mx) {
  return a == -INFINITY ? 0.0f : expf(__fsub_rn(a, mx));
}

// (m, s) <- (m, s) combined with (m2, s2); one expf.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  if (m2 > m) {
    s = __fadd_rn(__fmul_rn(s, exp_below(m, m2)), s2);
    m = m2;
  } else {
    s = __fadd_rn(s, __fmul_rn(s2, exp_below(m2, m)));
  }
}

__device__ __forceinline__ float shifted(float shift, float c, float eps) {
  return __fdiv_rn(__fsub_rn(shift, c), eps);
}

// One warp per row; each lane folds groups of 8 columns into its (m, s),
// then the lanes combine in a fixed xor-shuffle tree.
__global__ void __launch_bounds__(kThreads)
row_lse_kernel(const __nv_bfloat16* __restrict__ C,
               const float* __restrict__ g, float* __restrict__ m_out,
               float* __restrict__ s_out, int n, int m, float eps,
               int vec_ok) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
  float mx = -INFINITY;
  float s = 0.0f;

  if (vec_ok) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int chunks = m / kVec;
    for (int j = lane; j < chunks; j += 32) {
      const uint4 raw = __ldg(p4 + j);
      const auto* c = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float4 ga = __ldg(g4 + 2 * j);
      const float4 gb = __ldg(g4 + 2 * j + 1);
      const float gv[kVec] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      float z[kVec];
      float zmax = -INFINITY;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        z[t] = shifted(gv[t], __bfloat162float(c[t]), eps);
        zmax = fmaxf(zmax, z[t]);
      }
      float part = 0.0f;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        part = __fadd_rn(part, exp_below(z[t], zmax));
      }
      combine(mx, s, zmax, part);
    }
  } else {
    for (int col = lane; col < m; col += 32) {
      combine(mx, s, shifted(g[col], __bfloat162float(p[col]), eps), 1.0f);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(mx, s, m2, s2);
  }
  if (lane == 0) {
    m_out[row] = mx;
    s_out[row] = s;
  }
}

// Column reduction, pass 1: block (x, y) covers 2 * kThreads columns and the
// rows of chunk y; each thread walks two adjacent columns down the chunk
// (one bf16x2 load per row when rows are 4-byte aligned) and writes one
// partial per column.
__global__ void __launch_bounds__(kThreads)
col_partial_kernel(const __nv_bfloat16* __restrict__ C,
                   const float* __restrict__ f, float* __restrict__ m_part,
                   float* __restrict__ s_part, int n, int m,
                   int rows_per_chunk, float eps, int pair_ok) {
  __shared__ float s_f[kColTile];
  const int c0 = 2 * (blockIdx.x * kThreads + threadIdx.x);
  const bool has0 = c0 < m;
  const bool has1 = c0 + 1 < m;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  float m0 = -INFINITY, s0 = 0.0f, m1 = -INFINITY, s1 = 0.0f;
  for (int t0 = r0; t0 < r1; t0 += kColTile) {
    const int rows = min(kColTile, r1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += kThreads) s_f[i] = f[t0 + i];
    __syncthreads();
    if (!has0) continue;
    const __nv_bfloat16* p = C + static_cast<size_t>(t0) * m + c0;
#pragma unroll 4
    for (int i = 0; i < rows; ++i, p += m) {
      float ca, cb = 0.0f;
      if (pair_ok) {
        const __nv_bfloat162 v =
            __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
        ca = __low2float(v);
        cb = __high2float(v);
      } else {
        ca = __bfloat162float(p[0]);
        if (has1) cb = __bfloat162float(p[1]);
      }
      const float fr = s_f[i];
      combine(m0, s0, shifted(fr, ca, eps), 1.0f);
      if (has1) combine(m1, s1, shifted(fr, cb, eps), 1.0f);
    }
  }
  const size_t base = static_cast<size_t>(blockIdx.y) * m + c0;
  if (has0) {
    m_part[base] = m0;
    s_part[base] = s0;
  }
  if (has1) {
    m_part[base + 1] = m1;
    s_part[base + 1] = s1;
  }
}

// Column reduction, pass 2: block (kCombineCols, kCombineLanes) covers
// kCombineCols columns; lane y of a column combines chunks y, y +
// kCombineLanes, ... (a warp reads one chunk row's columns contiguously),
// then lane 0 combines the lanes' pairs in lane order. Fixed order, so
// deterministic; splitting the chunk walk keeps it from being one long
// latency-bound loop per column.
__global__ void __launch_bounds__(kCombineCols * kCombineLanes)
col_combine_kernel(const float* __restrict__ m_part,
                   const float* __restrict__ s_part, float* __restrict__ m_out,
                   float* __restrict__ s_out, int chunks, int m) {
  __shared__ float s_m[kCombineLanes][kCombineCols];
  __shared__ float s_s[kCombineLanes][kCombineCols];
  const int col = blockIdx.x * kCombineCols + threadIdx.x;
  float mx = -INFINITY;
  float s = 0.0f;
  if (col < m) {
    for (int k = threadIdx.y; k < chunks; k += kCombineLanes) {
      const size_t at = static_cast<size_t>(k) * m + col;
      combine(mx, s, m_part[at], s_part[at]);
    }
  }
  s_m[threadIdx.y][threadIdx.x] = mx;
  s_s[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= m) return;
  for (int y = 1; y < kCombineLanes; ++y) {
    combine(mx, s, s_m[y][threadIdx.x], s_s[y][threadIdx.x]);
  }
  m_out[col] = mx;
  s_out[col] = s;
}

}  // namespace

// Plain C interface, bound with ctypes. C is bf16[n, m] row-major; the
// wrapper checks shapes, dtypes and contiguity, and allocates the outputs
// and the column scratch (m_part, s_part: f32[ceil(n / rows_per_chunk), m]).
// Each returns the cudaGetLastError() code after its launches (0 =
// launched).
extern "C" {

int mm_row_lse_partial(const void* C, const void* g, void* m_out, void* s_out,
                       int n, int m, float eps, void* stream) {
  const int vec_ok = (m % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(C) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * 32 + kThreads - 1) / kThreads);
  row_lse_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(g),
      static_cast<float*>(m_out), static_cast<float*>(s_out), n, m, eps,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}

int mm_col_lse_partial(const void* C, const void* f, void* m_part,
                       void* s_part, void* m_out, void* s_out, int n, int m,
                       int rows_per_chunk, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pair_ok =
      (m % 2 == 0) && (reinterpret_cast<uintptr_t>(C) % 4 == 0);
  const int chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid((m + 2 * kThreads - 1) / (2 * kThreads), chunks);
  col_partial_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(f),
      static_cast<float*>(m_part), static_cast<float*>(s_part), n, m,
      rows_per_chunk, eps, pair_ok);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  col_combine_kernel<<<(m + kCombineCols - 1) / kCombineCols,
                       dim3(kCombineCols, kCombineLanes), 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(s_part),
      static_cast<float*>(m_out), static_cast<float*>(s_out), chunks, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
