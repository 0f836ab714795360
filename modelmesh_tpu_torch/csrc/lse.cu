// Fused potential-shifted log-sum-exp partials of the dense Sinkhorn, for
// Hopper (sm_90a). Three functions over the bf16 cost matrix C:
//
//   row:  z[n, m] = (g[m] - C[n, m]) * inv_eps, over m -> (mx[n], s[n])
//   col:  z[n, m] = (f[n] - C[n, m]) * inv_eps, over n -> (mx[m], s[m])
//   step: one Sinkhorn iteration's pair in one pass over C: the row
//         reduction of g, f[n] = eps * (log_a[n] - LSE_n), then the column
//         reduction of that f
//
// with mx the maximum of z and s = sum exp(z - mx), so that
// LSE = log(max(s, 1e-30)) + mx. Partials over disjoint slices combine as
//
//   M = max(m1, m2);  s = s1 * exp(m1 - M) + s2 * exp(m2 - M)
//
// which is how the kernels reduce internally and how a sharded solver
// combines ranks. Neither z nor an f32 copy of C ever exists in device
// memory: each launch streams C once.
//
// Replaces the Pallas TPU kernels of modelmesh_tpu/ops/pallas_lse.py:
//   dense_row_kernel                   <- row_lse_partial (_partial_kernel,
//                                         axis=1)
//   dense_col_kernel<false> + combine  <- col_lse_partial (_partial_kernel,
//                                         axis=0)
//   dense_col_kernel<true> + combine   <- row_lse_partial, then
//                                         col_lse_partial, of one dense
//                                         Sinkhorn iteration
//
// Bound. A pass must read C once (N * M * 2 bytes): 268.4 MB at the
// 131072 x 1024 tier, about 80 us at the H100 SXM's 3.35 TB/s. By the data
// sheet's count the f32 work is a few operations per element, far under
// that; but non-fast-math expf is about eight instructions, so a reduction
// issues some fifteen instructions per element and the fused step some
// thirty: at the tier that is 60-140 us of instruction issue on 132 SMs,
// the same order as the bytes. (On the H100 the fused pass takes about 2.8x
// the byte bound whatever the load staging or occupancy: it is bound by
// instruction issue; PERF.md.) The design therefore spends as few
// instructions per element as it can and keeps enough loads in flight to
// stay near the byte bound:
//
// - z is a subtract and a multiply by inv_eps, never an IEEE division.
// - Layout. A row group of `lanes` lanes owns a row (lanes = 32 at 1024
//   columns; 16, 8 or 4 at narrower widths, so that a warp holds 2-8 rows
//   at once and at least 3/4 of its lanes hold data at the dense tier's
//   padded widths 64, 96, 128, ...). Lane i of a group loads chunks i,
//   i + lanes, ... of the row: kSlots (2-4) 16-byte loads of 8 bf16 each.
//   The column kernels issue the next rows' loads before the current
//   row's arithmetic (a cp.async ring in shared memory), so 2 x kSlots
//   loads per lane are in flight while it computes.
// - Row side: per chunk the max of its 8 z, the sum of exp(z - max), one
//   combine into the lane's (mx, s) (one expf per element); then the lanes
//   of the group combine in a fixed xor-shuffle order.
// - Column side: lane i owns the same columns for every row its group
//   walks, so its column partials stay in registers (kSlots x 8 x 2
//   floats). Each element folds into its column's (m, s) with one expf and
//   no branch (fold below).
// - The fused step (dense_col_kernel<true>): f[n] needs only row n, so the
//   group that has just reduced row n computes f[n] and folds the same
//   registers into its column partials at once. C is read once per
//   iteration instead of twice. g (at most 4 KB) sits in shared memory.
//
// Column reduction across rows. The Pallas kernel carries the column
// accumulator across a sequential row grid in VMEM; blocks here run in
// parallel. Each block covers a fixed number of rows (the wrapper's
// constant, so the combine order does not depend on the card); every lane
// of every warp writes its column partials to shared memory, the block's
// threads combine them in (warp, group) order and write one partial row to
// an f32 scratch, and col_combine_kernel combines the block rows in a fixed
// order. No float atomics: every kernel is deterministic. The column-only
// kernel takes C wider than 1024 columns as equal slabs of at most 1024
// columns, one per grid.x; the row-only kernel walks such slabs along the
// row.
//
// Ragged or unaligned C (width not a multiple of 8, or rows not 16-byte
// aligned) takes the same kernels with bounds-checked scalar loads.
//
// Numerics. z is __fmul_rn(__fsub_rn(shift, c), inv_eps) with inv_eps =
// 1.0f / eps formed on the host in f32: what PyTorch's CUDA division by a
// scalar computes (it multiplies by opmath_t(1) / b), so a kernel's z is bit
// for bit the card's plain z. f is eps * (log_a - (log(max(s, 1e-30)) +
// mx)) in the operation order of those PyTorch ops. Built without fast math
// and with --fmad=false, so expf and logf are the ones PyTorch's CUDA exp
// and log call and no multiply-add is contracted. On the same (C, g) and
// width, the fused step's row side and dense_row_kernel run the same
// arithmetic in the same order, as do its column side and
// dense_col_kernel<false> given the same f. Two empty partials (m = -inf on
// both sides) combine to s = 0, not NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, row and column kernels
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;             // bf16 per 16-byte chunk
constexpr int kMaxSlots = 4;        // 16-byte loads per lane per row
constexpr int kSlabChunks = 32 * kMaxSlots;  // 128 chunks: 1024 columns
constexpr int kRing = 3;            // column kernels: row iterations staged
constexpr int kRowBlockRows = 64;   // rows per block of the row kernel
constexpr int kCombineCols = 32;    // columns per combine block
constexpr int kCombineLanes = 16;   // chunk walkers per column
constexpr float kTiny = 1e-30f;     // floor of s before the log

// (m, s) <- (m, s) combined with (m2, s2); one expf, no branch (the lanes
// of a warp may disagree on which side is larger). The exponent is -inf
// when the smaller side is empty (m = -inf), so an empty partial adds 0
// even when both are empty.
__device__ __forceinline__ void combine(float& m, float& s, float m2,
                                        float s2) {
  const bool up = m2 > m;
  const float lo = up ? m : m2;
  const float hi = up ? m2 : m;
  const float e = expf(lo == -INFINITY ? -INFINITY : __fsub_rn(lo, hi));
  s = up ? __fadd_rn(__fmul_rn(s, e), s2) : __fadd_rn(s, __fmul_rn(s2, e));
  m = hi;
}

// combine(m, s, z, 1) for a finite z, bit for bit, in fewer instructions:
// exp(-|z - m|) is the exponent on either side (negation is exact), and is
// 0 while the partial is empty (m = -inf).
__device__ __forceinline__ void fold(float& m, float& s, float z) {
  const float e = expf(-fabsf(__fsub_rn(z, m)));
  const bool up = z > m;
  s = up ? __fadd_rn(__fmul_rn(s, e), 1.0f) : __fadd_rn(s, e);
  m = up ? z : m;
}

__device__ __forceinline__ float shifted(float shift, float c, float inv_eps) {
  return __fmul_rn(__fsub_rn(shift, c), inv_eps);
}

// Element t (0-7) of a chunk of 8 bf16: the conversion to f32 is exact.
__device__ __forceinline__ float elem(const uint4& q, int t) {
  const uint32_t w = t < 2 ? q.x : t < 4 ? q.y : t < 6 ? q.z : q.w;
  return __uint_as_float((t & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// Chunk j of a row (columns 8 j .. 8 j + 7), zero past column m: one
// 16-byte load when rows are 16-byte aligned, else bounds-checked scalars.
template <bool kAligned>
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* row, int j,
                                            int m) {
  if (kAligned) return __ldg(reinterpret_cast<const uint4*>(row) + j);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    const int col = j * kVec + t;
    if (col < m) {
      w[t >> 1] |= static_cast<uint32_t>(__ldg(h + col)) << (16 * (t & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Folds chunk j of a row into the lane's row partial (mx, s): the max of
// its z, their rescaled sum, then one combine. Columns past m (ragged C)
// take z = -inf; a chunk holds at least one column below m.
template <bool kAligned>
__device__ __forceinline__ void row_chunk(float& mx, float& s, const uint4& q,
                                          const float (&gv)[kVec], int j,
                                          int m, float inv_eps) {
  float z[kVec];
  float zmax = -INFINITY;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    z[t] = shifted(gv[t], elem(q, t), inv_eps);
    if (!kAligned && j * kVec + t >= m) z[t] = -INFINITY;
    zmax = fmaxf(zmax, z[t]);
  }
  float part = 0.0f;
#pragma unroll
  for (int t = 0; t < kVec; ++t) {
    part = __fadd_rn(part, expf(__fsub_rn(z[t], zmax)));
  }
  combine(mx, s, zmax, zmax == -INFINITY ? 0.0f : part);
}

// The row partials of a group's `lanes` lanes combined in a fixed
// xor-shuffle order; every lane of the group ends with the same bits
// (combine is commutative).
__device__ __forceinline__ void group_combine(float& mx, float& s, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(mx, s, m2, s2);
  }
}

// What a launch needs. A slab is `per` chunks of a row (slab k: chunks
// k * per ...); `lanes` lanes (4, 8, 16 or 32) own a row and each loads up
// to kSlots chunks of it, lanes * kSlots >= per.
struct LseArgs {
  const __nv_bfloat16* C;
  const float* g;      // row side: the column shifts
  const float* f;      // column-only: the row shifts
  const float* log_a;  // fused: log of the row masses
  float* f_out;        // fused: f
  float* m_row;        // row-only: (mx, s) per row
  float* s_row;
  float* m_part;       // column kernels: block partials, f32[blocks, m]
  float* s_part;
  int n, m;
  int per;             // chunks per slab
  int slabs;
  int lanes;
  int rows_per_block;  // a multiple of kWarps * 8
  float eps, inv_eps;
};

// cp.async (global -> shared, bypassing registers) and its groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The rows a warp walks: block b covers rows_per_block rows, warp w of it
// the contiguous run [w0, w1) of rows_per_block / kWarps; iteration i of a
// group takes row w0 + i * groups + grp.
struct WarpRows {
  int w0, w1, iters;
};

__device__ __forceinline__ WarpRows warp_rows(const LseArgs& a, int block,
                                              int warp, int groups) {
  const int per_warp = a.rows_per_block / kWarps;
  WarpRows r;
  r.w0 = block * a.rows_per_block + warp * per_warp;
  r.w1 = min(a.n, r.w0 + per_warp);
  r.iters = r.w1 > r.w0 ? (r.w1 - r.w0 + groups - 1) / groups : 0;
  return r;
}

// Kernel 4: row partials. Each group of `lanes` lanes takes one row at a
// time and walks its slabs; per slab each lane issues its kSlots (2-4)
// 16-byte loads before any arithmetic. Blocks hold kRowBlockRows rows
// (the row partials need no block combine, so blocks can be small and
// many: 192 at the wide path's 12288 rows). g comes through the
// read-only cache. (A register double buffer of the next slab's loads
// measured no faster on the H100 and took 72 registers against 50.)
template <int kSlots, bool kAligned>
__global__ void __launch_bounds__(kThreads)
dense_row_kernel(const LseArgs a) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = a.lanes;
  const int groups = 32 / lanes;
  const int grp = lane / lanes;
  const int li = lane & (lanes - 1);
  const int chunks = (a.m + kVec - 1) / kVec;
  const WarpRows wr = warp_rows(a, blockIdx.x, warp, groups);

  for (int i = 0; i < wr.iters; ++i) {
    const int row = wr.w0 + i * groups + grp;
    const bool live = row < wr.w1;
    const __nv_bfloat16* p = a.C + static_cast<size_t>(live ? row : 0) * a.m;
    float mx = -INFINITY;
    float s = 0.0f;
    for (int sl = 0; sl < a.slabs; ++sl) {
      uint4 q[kSlots];
      int js[kSlots];  // the lane's chunks of the slab, -1 where none
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int jl = li + lanes * k;
        js[k] = (live && jl < a.per && sl * a.per + jl < chunks)
                    ? sl * a.per + jl
                    : -1;
        q[k] = js[k] >= 0 ? load_chunk<kAligned>(p, js[k], a.m)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = js[k];
        if (j < 0) continue;
        float gv[kVec];
        if (kAligned) {
          const float4* g4 = reinterpret_cast<const float4*>(a.g);
          const float4 ga = __ldg(g4 + 2 * j);
          const float4 gb = __ldg(g4 + 2 * j + 1);
          gv[0] = ga.x; gv[1] = ga.y; gv[2] = ga.z; gv[3] = ga.w;
          gv[4] = gb.x; gv[5] = gb.y; gv[6] = gb.z; gv[7] = gb.w;
        } else {
#pragma unroll
          for (int t = 0; t < kVec; ++t) {
            const int col = j * kVec + t;
            gv[t] = col < a.m ? __ldg(a.g + col) : 0.0f;
          }
        }
        row_chunk<kAligned>(mx, s, q[k], gv, j, a.m, a.inv_eps);
      }
    }
    group_combine(mx, s, lanes);
    if (live && li == 0) {
      a.m_row[row] = mx;
      a.s_row[row] = s;
    }
  }
}

// Kernel 5 (kFused = false) and one Sinkhorn iteration's kernels 4 + 5
// (kFused = true): column partials of slab blockIdx.x over the rows of
// block blockIdx.y, rows walked as in dense_row_kernel. Per row the column
// shift is f[row] (column-only) or, fused, f[row] = eps * (log_a[row] -
// LSE_row) from the row side just run on the same registers.
//
// Loads. The column partials take most of a lane's registers, so rows are
// staged in shared memory, not in a second register buffer: each lane
// copies its own chunks of row iteration i + kRing - 1 with cp.async into
// its slots of a kRing-deep ring while it works on iteration i, so 2 x
// kSlots 16-byte loads per lane are in flight during the arithmetic. Only
// the lane that copied a chunk reads it, so its own cp.async.wait_group
// orders them. Ragged or unaligned C, which 16-byte copies cannot take,
// loads each row into registers as it comes.
//
// Dynamic shared memory: (fused) g as f32[per * 8]; then the ring,
// uint4[kRing][kSlots][kThreads], which after the row walk holds every
// lane's column partials, m then s, f32[kWarps][32 / lanes][lanes * kSlots
// * 8] each.
template <bool kFused, int kSlots, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
dense_col_kernel(const LseArgs a) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = a.lanes;
  const int groups = 32 / lanes;
  const int grp = lane / lanes;
  const int li = lane & (lanes - 1);
  const int chunks = (a.m + kVec - 1) / kVec;
  const WarpRows wr = warp_rows(a, blockIdx.y, warp, groups);
  const int j0 = blockIdx.x * a.per;  // the slab's first chunk
  const int cap = lanes * kSlots * kVec;  // columns a group covers
  float* s_g = reinterpret_cast<float*>(smem4);
  float* s_work = s_g + (kFused ? a.per * kVec : 0);
  uint4* ring = reinterpret_cast<uint4*>(s_work);
  float* s_m = s_work;
  float* s_s = s_m + kWarps * groups * cap;

  int js[kSlots];  // the lane's chunks of the slab, -1 where none
  float cm[kSlots][kVec], cs[kSlots][kVec];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int jl = li + lanes * k;
    js[k] = (jl < a.per && j0 + jl < chunks) ? j0 + jl : -1;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      cm[k][t] = -INFINITY;
      cs[k][t] = 0.0f;
    }
  }

  auto ring_at = [&](int i, int k) -> uint4* {
    return ring + ((i % kRing) * kSlots + k) * kThreads + threadIdx.x;
  };
  auto prefetch = [&](int i) {  // one commit group per iteration
    const int row = wr.w0 + i * groups + grp;
    if (i < wr.iters && row < wr.w1) {
      const __nv_bfloat16* p = a.C + static_cast<size_t>(row) * a.m;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (js[k] >= 0) cp_async16(ring_at(i, k), p + js[k] * kVec);
      }
    }
    cp_async_commit();
  };
  if (kAligned) {
#pragma unroll
    for (int i = 0; i < kRing - 1; ++i) prefetch(i);
  }

  if (kFused) {  // one slab: the whole row
    for (int i = threadIdx.x; i < a.per * kVec; i += kThreads) {
      s_g[i] = i < a.m ? __ldg(a.g + i) : 0.0f;
    }
    __syncthreads();
  }

  for (int i = 0; i < wr.iters; ++i) {
    const int row = wr.w0 + i * groups + grp;
    const bool live = row < wr.w1;
    uint4 q[kSlots];
    if (kAligned) {
      prefetch(i + kRing - 1);
      cp_async_wait<kRing - 1>();
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        q[k] = (live && js[k] >= 0) ? *ring_at(i, k)
                                    : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const __nv_bfloat16* p =
          a.C + static_cast<size_t>(live ? row : 0) * a.m;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        q[k] = (live && js[k] >= 0) ? load_chunk<false>(p, js[k], a.m)
                                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float fr;
    if (kFused) {
      float mx = -INFINITY;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (!live || js[k] < 0) continue;
        const float4* g4 = reinterpret_cast<const float4*>(s_g) + 2 * js[k];
        const float4 ga = g4[0];
        const float4 gb = g4[1];
        const float gv[kVec] = {ga.x, ga.y, ga.z, ga.w,
                                gb.x, gb.y, gb.z, gb.w};
        row_chunk<kAligned>(mx, s, q[k], gv, js[k], a.m, a.inv_eps);
      }
      group_combine(mx, s, lanes);
      const float la = live ? __ldg(a.log_a + row) : 0.0f;
      const float lse = __fadd_rn(logf(fmaxf(s, kTiny)), mx);
      fr = __fmul_rn(a.eps, __fsub_rn(la, lse));
      if (live && li == 0) a.f_out[row] = fr;
    } else {
      fr = live ? __ldg(a.f + row) : 0.0f;
    }
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (js[k] < 0) continue;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        if (!kAligned && js[k] * kVec + t >= a.m) continue;
        fold(cm[k][t], cs[k][t], shifted(fr, elem(q[k], t), a.inv_eps));
      }
    }
  }

  // Every lane's partials to shared memory (over the ring, once every warp
  // is done with it), then the block's threads combine them per column in
  // (warp, group) order: one partial row.
  cp_async_wait<0>();
  __syncthreads();
  const int slot = warp * groups + grp;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int col = (li + lanes * k) * kVec;
    float4* pm = reinterpret_cast<float4*>(s_m + slot * cap + col);
    float4* ps = reinterpret_cast<float4*>(s_s + slot * cap + col);
    pm[0] = make_float4(cm[k][0], cm[k][1], cm[k][2], cm[k][3]);
    pm[1] = make_float4(cm[k][4], cm[k][5], cm[k][6], cm[k][7]);
    ps[0] = make_float4(cs[k][0], cs[k][1], cs[k][2], cs[k][3]);
    ps[1] = make_float4(cs[k][4], cs[k][5], cs[k][6], cs[k][7]);
  }
  __syncthreads();
  const int c0 = j0 * kVec;
  const int width = min(a.per * kVec, a.m - c0);
  const size_t out = static_cast<size_t>(blockIdx.y) * a.m + c0;
  for (int c = threadIdx.x; c < width; c += kThreads) {
    // Slab column c is at offset c of every group's area (its chunk c / 8
    // is slot k of lane li with li + lanes * k = c / 8).
    float mx = s_m[c];
    float s = s_s[c];
    for (int w = 1; w < kWarps * groups; ++w) {
      combine(mx, s, s_m[w * cap + c], s_s[w * cap + c]);
    }
    a.m_part[out + c] = mx;
    a.s_part[out + c] = s;
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

// Lanes per row and loads per lane for a slab of `per` chunks: the
// smallest cover, so at least 3/4 of the lanes hold data at every padded
// width of the dense tier (64, 96, 128, 192, 256, 384, 512, 768, 1024).
void pick_layout(int per, int& lanes, int& slots) {
  static const int kLayouts[][2] = {{4, 2},  {4, 3},  {8, 2}, {16, 2},
                                    {32, 2}, {32, 3}, {32, 4}};
  for (const auto& l : kLayouts) {
    if (l[0] * l[1] >= per) {
      lanes = l[0];
      slots = l[1];
      return;
    }
  }
  lanes = 32;
  slots = kMaxSlots;
}

// Splits a row of m columns into equal slabs of at most kSlabChunks chunks
// and picks their layout; ragged or unaligned C takes 32 lanes x 4 loads.
void plan(LseArgs& a, bool aligned, int& slots) {
  const int chunks = (a.m + kVec - 1) / kVec;
  a.slabs = chunks > 0 ? (chunks + kSlabChunks - 1) / kSlabChunks : 1;
  a.per = chunks > 0 ? (chunks + a.slabs - 1) / a.slabs : 1;
  if (aligned) {
    pick_layout(a.per, a.lanes, slots);
  } else {
    a.lanes = 32;
    slots = kMaxSlots;
  }
}

bool rows_ok(int rows_per_block) {
  return rows_per_block > 0 && rows_per_block % (kWarps * 8) == 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kSlots, bool kAligned>
int launch_row(const LseArgs& a, cudaStream_t st) {
  const int blocks = (a.n + a.rows_per_block - 1) / a.rows_per_block;
  dense_row_kernel<kSlots, kAligned><<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFused, int kSlots, bool kAligned>
int launch_col(const LseArgs& a, cudaStream_t st) {
  // Shared memory at the widest layout of kSlots loads (32 lanes a row).
  constexpr int kMaxBytes = 2 * kWarps * 32 * kSlots * kVec * 4 +
                            (kFused ? kSlabChunks * kVec * 4 : 0);
  // Per launch: the attribute is the current device's, and a mesh
  // launches on several devices.
  const cudaError_t attr = cudaFuncSetAttribute(
      dense_col_kernel<kFused, kSlots, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int groups = 32 / a.lanes;
  const int smem = 4 * (2 * kWarps * groups * a.lanes * kSlots * kVec +
                        (kFused ? a.per * kVec : 0));
  const dim3 grid(a.slabs, (a.n + a.rows_per_block - 1) / a.rows_per_block);
  dense_col_kernel<kFused, kSlots, kAligned><<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The fixed-order combine of `chunks` block partials (f32[chunks, m] each)
// into (m_out, s_out).
int launch_combine(const float* m_part, const float* s_part, float* m_out,
                   float* s_out, int chunks, int m, cudaStream_t st) {
  col_combine_kernel<<<(m + kCombineCols - 1) / kCombineCols,
                       dim3(kCombineCols, kCombineLanes), 0, st>>>(
      m_part, s_part, m_out, s_out, chunks, m);
  return static_cast<int>(cudaGetLastError());
}

// The column kernel of `slots` loads per lane, then, unless m_out is null,
// the combine of its block partials.
template <bool kFused>
int run_col(const LseArgs& a, int slots, bool aligned, float* m_out,
            float* s_out, cudaStream_t st) {
  int err;
  if (!aligned) {
    err = launch_col<kFused, kMaxSlots, false>(a, st);
  } else if (slots == 2) {
    err = launch_col<kFused, 2, true>(a, st);
  } else if (slots == 3) {
    err = launch_col<kFused, 3, true>(a, st);
  } else {
    err = launch_col<kFused, 4, true>(a, st);
  }
  if (err != 0 || m_out == nullptr) return err;
  return launch_combine(a.m_part, a.s_part, m_out, s_out,
                        (a.n + a.rows_per_block - 1) / a.rows_per_block, a.m,
                        st);
}

}  // namespace

// Plain C interface, bound with ctypes. C is bf16[n, m] row-major; the
// wrapper checks shapes, dtypes and contiguity, allocates the outputs and
// the column scratch (m_part, s_part: f32[ceil(n / rows_per_block), m];
// rows_per_block a multiple of 64), and passes inv_eps = 1 / eps as f32.
// Each returns the cudaGetLastError() code after its launches (0 =
// launched), or cudaErrorInvalidValue for operands the kernels do not take.
// The column passes take a null m_out to stop after the pass and leave the
// block partials in (m_part, s_part), for a combine over the partials of
// several row blocks (mm_lse_col_combine: each block's partials in order).
extern "C" {

int mm_row_lse_partial(const void* C, const void* g, void* m_out, void* s_out,
                       int n, int m, float inv_eps, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  LseArgs a{};
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.g = static_cast<const float*>(g);
  a.m_row = static_cast<float*>(m_out);
  a.s_row = static_cast<float*>(s_out);
  a.n = n;
  a.m = m;
  a.rows_per_block = kRowBlockRows;
  a.inv_eps = inv_eps;
  const bool aligned = m % kVec == 0 && aligned16(C) && aligned16(g);
  int slots;
  plan(a, aligned, slots);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned) return launch_row<kMaxSlots, false>(a, st);
  if (slots == 2) return launch_row<2, true>(a, st);
  if (slots == 3) return launch_row<3, true>(a, st);
  return launch_row<4, true>(a, st);
}

int mm_col_lse_partial(const void* C, const void* f, void* m_part,
                       void* s_part, void* m_out, void* s_out, int n, int m,
                       int rows_per_block, float inv_eps, void* stream) {
  if (n <= 0 || m <= 0 || !rows_ok(rows_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LseArgs a{};
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.f = static_cast<const float*>(f);
  a.m_part = static_cast<float*>(m_part);
  a.s_part = static_cast<float*>(s_part);
  a.n = n;
  a.m = m;
  a.rows_per_block = rows_per_block;
  a.inv_eps = inv_eps;
  const bool aligned = m % kVec == 0 && aligned16(C);
  int slots;
  plan(a, aligned, slots);
  return run_col<false>(a, slots, aligned, static_cast<float*>(m_out),
                        static_cast<float*>(s_out),
                        static_cast<cudaStream_t>(stream));
}

// One Sinkhorn iteration's LSE passes: f = eps * (log_a - row LSE of g)
// into f_out (f32[n]), and the column (m, s) of that f into m_out/s_out
// (f32[m]), through the block partials. At most 1024 columns.
int mm_lse_sinkhorn_step(const void* C, const void* g, const void* log_a,
                         void* f_out, void* m_part, void* s_part, void* m_out,
                         void* s_out, int n, int m, int rows_per_block,
                         float eps, float inv_eps, void* stream) {
  if (n <= 0 || m <= 0 || m > kSlabChunks * kVec ||
      !rows_ok(rows_per_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LseArgs a{};
  a.C = static_cast<const __nv_bfloat16*>(C);
  a.g = static_cast<const float*>(g);
  a.log_a = static_cast<const float*>(log_a);
  a.f_out = static_cast<float*>(f_out);
  a.m_part = static_cast<float*>(m_part);
  a.s_part = static_cast<float*>(s_part);
  a.n = n;
  a.m = m;
  a.rows_per_block = rows_per_block;
  a.eps = eps;
  a.inv_eps = inv_eps;
  const bool aligned = m % kVec == 0 && aligned16(C);
  int slots;
  plan(a, aligned, slots);
  return run_col<true>(a, slots, aligned, static_cast<float*>(m_out),
                       static_cast<float*>(s_out),
                       static_cast<cudaStream_t>(stream));
}

// (m_out, s_out)[col] = the fixed-order combine of the (m, s) partials
// 0..chunks at col: the column passes' combine, over partials gathered from
// several row blocks.
int mm_lse_col_combine(const void* m_part, const void* s_part, void* m_out,
                       void* s_out, int chunks, int m, void* stream) {
  if (chunks < 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_combine(static_cast<const float*>(m_part),
                        static_cast<const float*>(s_part),
                        static_cast<float*>(m_out), static_cast<float*>(s_out),
                        chunks, m, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
