// Candidate-mask kernels of the sparse Sinkhorn, for Hopper (sm_90a).
//
//   rowmin[n] = min_m { C[n, m] : key(n, m) <= thresh[n] }, and bits(n, m)
//   r[n]      = sum_m bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * v[m]
//   c[m]      = sum_n bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * u[n]
//
// key(n, m) = f32(C[n, m]) - tau * gumbel(n, m), where the Gumbel draw is the
// murmur3 counter hash of (row state x_row[n], column m). Within one solve C,
// thresh, x_row and rowmin never change, so the mask is evaluated once:
// select_kernel<true> picks each row's K smallest keys (the top-K gather),
// takes the K-th as thresh, the row minimum of C under it, and writes the
// mask as bits, int32[n, ceil(m / 32)] with bit j of word w standing for column
// 32 w + j (bits past m are zero). Every later pass reads the bits and C;
// neither a bool mask nor the scaled kernel P = exp((rowmin - C) / eps) *
// mask ever exists in device memory.
//
// Replaces the Pallas TPU kernels of modelmesh_tpu/ops/pallas_sparse.py:
//   select_kernel<false>        <- masked_row_min (_row_min_kernel, _tile_key)
//   select_kernel<true>         <- masked_row_min with the top-K gather of
//                                  modelmesh_tpu/ops/sparse.py::
//                                  topk_candidates in the same pass
//   row_matvec_kernel           <- masked_row_matvec (_row_matvec_kernel)
//   col_kernel<false>, combine  <- masked_col_matvec (_col_matvec_kernel)
//   col_kernel<true>, combine   <- masked_row_matvec + masked_col_matvec of
//                                  one Sinkhorn iteration, in one pass
//
// Bound. Each pass must read C once (n * m * 2 bytes in bf16) and the bits
// (n * m / 8 bytes): 285 MB at the 131072 x 1024 tier, about 85 us at the
// H100 SXM's 3.35 TB/s. select_kernel is bound by instruction issue: it
// spends a hash and a fast double log on every entry, and the exact double
// log (two non-fast-math logf) only on the few near the threshold (the
// guard band, above the kernel). The bit-reading kernels spend a bit test per
// entry, and the division and expf only on candidates (about K / m of the
// entries, 2.3% at the tier), so they are bound by bytes as long as enough
// of them are in flight and no lane waits on another's candidates.
//
// The fused pass (col_kernel<true>). u[n] = row_mass[n] / max(r[n], 1e-30)
// depends only on row n, so the warp that has just reduced r[n] applies
// u[n] to the same row while it still holds it: one pass over C per
// Sinkhorn iteration instead of two. That needs the whole row in one warp:
// kSlab = 1024 columns (4 16-byte loads per lane). The limit is the widest
// slab at which a warp's f32 column sums (4 KB) and its ring of kRing row
// tiles (2.1 KB each) leave room for two 8-warp blocks per SM in the 227 KB
// of shared memory (104 KB a block), and at which the register stage's two
// row buffers take 32 of a lane's registers; a wider slab halves the warps
// per SM. Above that width the caller runs row_matvec_kernel and
// col_kernel<false> back to back; col_kernel<false> walks wider rows slab
// by slab.
//
// Column kernels. Lanes own columns for loading (lane L loads chunks L,
// L + 32, L + 64, L + 96 of the slab, 8 columns each, and their 4 mask
// bytes) and warps own row ranges (rows_per_block / kWarps rows each). Per
// row the warp compacts its candidates (a prefix sum of the lanes' set-bit
// counts, then each lane writes its candidates' C and column to a 32-slot
// list in shared memory), so each lane runs the division and expf about
// once per row rather than the whole warp stepping through its busiest
// lane's bits. A candidate's column is known only at run time, so the
// column sums live in the warp's own f32 slab in shared memory, not in
// registers; a row's candidates have distinct columns, so the lanes never
// collide. The warps of a block then sum their slabs in warp order into
// one partial per block, and col_combine_kernel sums the block partials,
// 16 lanes per column in a fixed order. The grid follows from (n, m) alone,
// so the summation order does not depend on the card. No float atomics.
//
// Staging of C for the column kernels: a kRing-deep ring of row tiles per
// warp in shared memory filled by cp.async, which needs 16-byte rows; the
// register double buffer (the next row's loads in flight during the current
// row's math) was 1.4-1.5x slower on the H100 there (PERF.md), so it stages
// only ragged or unaligned C, which 16-byte copies cannot take.
//
// row_matvec_kernel keeps one warp per row (any width, and the marginal
// gates need only r); each lane loops over its own set bits with __ffs.
//
// Bitwise mask parity. The key must equal, bit for bit, the key that
// modelmesh_tpu_torch.ops.cuda_sparse.selection_key computes with PyTorch
// ops on the same card, because the plain route's thresholds come from that
// computation. So: build without fast math and with --fmad=false, use
// logf/expf (what PyTorch's own CUDA log/exp call), and spell the
// arithmetic with round-to-nearest intrinsics that cannot be contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;              // threads per block, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                    // bf16 per 16-byte load
constexpr int kLoads = 4;                  // 16-byte loads per lane per slab
constexpr int kSlabChunks = 32 * kLoads;   // 16-byte chunks per slab row
constexpr int kSlab = kSlabChunks * kVec;  // 1024 columns per slab
constexpr int kSlabWords = kSlab / 32;     // mask words per slab row
constexpr int kRing = 4;                   // ring tiles per warp: 3 rows ahead
constexpr int kTileBytes = kSlab * 2 + kSlabWords * 4;  // one ring row
constexpr int kCombineCols = 32;           // columns per combine block
constexpr int kCombineLanes = 16;          // partial walkers per column
constexpr float kRFloor = 1e-30f;          // clamp of r (sparse._TINY)
// Guard band of the candidate selection (see select_kernel): the bound on
// |gumbel_exact - g'| (g' = -ln 2 gumbel_fast_log2) over every draw the
// hash can give, which mm_gumbel_err checks exhaustively; the relative
// slack for the roundings of both keys; the series cut of
// gumbel_fast_log2; ln 2.
constexpr float kGumbelErr = 1e-4f;
constexpr float kRoundRel = 9.5367431640625e-07f;  // 2^-20
constexpr float kSeriesCut = 0.00390625f;          // 2^-8
constexpr float kLn2 = 0.693147182f;
constexpr float kMinV = 1.67772162f;     // f32(1e-7) * 2^24: u's clamp
// The selection kernel's shared memory: a block's budget (8 warps of
// 1024-column rows take 50.4 KB of it), the most a block may take, the
// widest row it takes (member columns are uint16; one warp then takes
// 100 KB), and the blocks of the exhaustive draw check.
constexpr int kSelectBlockSmem = 112 * 1024;
constexpr int kMaxBlockSmem = 232448;
constexpr int kSelectMaxCols = 16384;
constexpr int kErrBlocks = 2048;

// murmur3 finalizer: op for op the one in ops/auction.py::hash_gumbel_at.
__device__ __forceinline__ uint32_t fmix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

// The hash draw's uniform: the top 24 bits, clamped to 1e-7 (0 would blow
// up the outer log).
__device__ __forceinline__ float uniform_of(uint32_t x) {
  const float u = __fmul_rn(__uint2float_rn(x >> 8), 1.0f / 16777216.0f);
  return fmaxf(u, 1e-7f);
}

// Hash bits of entry (row state xr, column col). The column counter is
// uint32 before the multiply, so the >> 8 of uniform_of is a logical shift.
__device__ __forceinline__ uint32_t entry_bits(uint32_t xr, uint32_t col) {
  return fmix32(xr ^ (col * 0x85EBCA6Bu));
}

// The exact Gumbel draw: op for op ops/auction.py::gumbel_from_bits.
__device__ __forceinline__ float gumbel_exact(uint32_t x) {
  return -logf(-logf(uniform_of(x)));
}

// log2 by the SFU. Its inputs here are never subnormal (u >= 1e-7,
// t >= 5.9e-8), so flushing them to zero changes nothing and spares the
// subnormal fix-up of the non-ftz form.
__device__ __forceinline__ float lg2_fast(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The fast route of the same draw, as L = log2(t) with t = -log(u), so
// that g' = -ln 2 * L is within kGumbelErr of gumbel_exact (see the guard
// band note above select_kernel). v = u * 2^24 is the hash's top 24 bits,
// clamped as u is. Where s = 1 - u <= kSeriesCut (exact there), -log(u) is
// as small as 6e-8 and the fast log's absolute error would swamp it, so
// t = s + s^2 / 2 there (the rest is under s^2 / 3 relative, 5.1e-6 at the
// cut). Elsewhere t = -ln 2 log2(u), taken on u, not as 24 - log2(v): the
// fast log's error grows with the size of its result.
__device__ __forceinline__ float gumbel_fast_log2(uint32_t x) {
  const float v = fmaxf(__uint2float_rn(x >> 8), kMinV);
  const float s = __fmaf_rn(v, -1.0f / 16777216.0f, 1.0f);
  const float t =
      s <= kSeriesCut
          ? __fmaf_rn(s, __fmul_rn(0.5f, s), s)
          : __fmul_rn(lg2_fast(__fmul_rn(v, 1.0f / 16777216.0f)), -kLn2);
  return lg2_fast(t);
}

// Noisy selection key of one entry, bit for bit the key that
// ops/cuda_sparse.py::selection_key computes with PyTorch ops.
__device__ __forceinline__ float selection_key(float c, uint32_t xr,
                                               uint32_t col, float tau,
                                               int noised) {
  if (!noised) return c;
  return __fsub_rn(c, __fmul_rn(tau, gumbel_exact(entry_bits(xr, col))));
}

// The same key by the fast draw, c - tau g' = c + (tau ln 2) L in one
// rounding (tau_ln2 = fl(tau * ln 2)): within band(|c|) of selection_key.
__device__ __forceinline__ float fast_key(float c, uint32_t xr, uint32_t col,
                                          float tau_ln2) {
  return __fmaf_rn(tau_ln2, gumbel_fast_log2(entry_bits(xr, col)), c);
}

// Half-width of the guard band for entries with |C| <= cabs.
__device__ __forceinline__ float band(float cabs, float atau) {
  return __fadd_rn(__fmul_rn(atau, kGumbelErr),
                   __fmul_rn(kRoundRel,
                             __fadd_rn(cabs, __fmul_rn(35.0f, atau))));
}

__device__ __forceinline__ float shifted_exp(float rm, float c, float eps) {
  return expf(__fdiv_rn(__fsub_rn(rm, c), eps));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

// Chunk j of a row (its columns 8 j .. 8 j + 7), zero past column m: one
// 16-byte load when rows are 16-byte aligned, else bounds-checked scalars.
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* row, int j,
                                            int m, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row) + j);
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

// One lane's share of a slab row held in registers: chunk k of the group
// is chunk j0 + lane + 32 k of the row, and bit 8 k + t of `bits` is the
// mask bit of its column t.
struct Group {
  uint4 q[kLoads];
  uint32_t bits;
};

__device__ __forceinline__ Group load_group(const __nv_bfloat16* row,
                                            const uint8_t* brow, int j0,
                                            int lane, int nchunks, int m,
                                            int vec) {
  Group g;
  g.bits = 0u;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int j = j0 + lane + 32 * k;
    if (j < nchunks) {
      g.q[k] = load_chunk(row, j, m, vec);
      g.bits |= static_cast<uint32_t>(__ldg(brow + j)) << (8 * k);
    } else {
      g.q[k] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  return g;
}

// C at bit b of a group, by selects (an indexed register array would go to
// local memory).
__device__ __forceinline__ float group_elem(const Group& g, int b) {
  const int k = b >> 3;
  const uint4 lo = (k & 1) ? g.q[1] : g.q[0];
  const uint4 hi = (k & 1) ? g.q[3] : g.q[2];
  const uint4 q = (k & 2) ? hi : lo;
  const int w = (b & 7) >> 1;
  const uint32_t a = (w & 1) ? q.y : q.x;
  const uint32_t z = (w & 1) ? q.w : q.z;
  const uint32_t word = (w & 2) ? z : a;
  return bf16_bits_to_float((b & 1) ? (word >> 16) : (word & 0xFFFFu));
}

// Slab-local column of bit b of lane `lane`.
__device__ __forceinline__ int slab_col(int lane, int b) {
  return (lane + 32 * (b >> 3)) * kVec + (b & 7);
}

// Calls f(b) for each set bit b of `bits`, in ascending order.
template <class F>
__device__ __forceinline__ void for_each_bit(uint32_t bits, F f) {
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1u;
    f(b);
  }
}

// Exclusive prefix sum of x over the warp's lanes; total = the sum.
__device__ __forceinline__ int warp_excl_scan(int x, int lane, int& total) {
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  total = __shfl_sync(0xffffffffu, incl, 31);
  return incl - x;
}

// Floats of select_kernel<true>'s shared memory per warp (stride a
// multiple of 32): key' (then the exact keys), the member columns as
// uint16, the mask words (a multiple of 4 floats) and 8 floats of padding
// for the ranking's unrolled reads.
__host__ __device__ __forceinline__ int select_warp_floats(int stride) {
  return stride + stride / 2 + (((stride / 32) + 3) & ~3) + 8;
}

// Ascending bitonic sort of one float per lane across the warp.
__device__ __forceinline__ float warp_sort(float v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool up = (lane & k) == 0;
      const bool low = (lane & j) == 0;
      v = (low == up) ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return v;
}

// Ascending bitonic sort of 64 floats across the warp, two a lane: element
// lane is a, element 32 + lane is b.
__device__ __forceinline__ void warp_sort64(float& a, float& b, int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k = 64: a and b are partners, ascending
        const float lo = fminf(a, b);
        b = fmaxf(a, b);
        a = lo;
      } else {
        const float oa = __shfl_xor_sync(0xffffffffu, a, j);
        const float ob = __shfl_xor_sync(0xffffffffu, b, j);
        const bool low = (lane & j) == 0;
        const bool up_a = (lane & k) == 0;
        const bool up_b = ((lane + 32) & k) == 0;
        a = (low == up_a) ? fminf(a, oa) : fmaxf(a, oa);
        b = (low == up_b) ? fminf(b, ob) : fmaxf(b, ob);
      }
    }
  }
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// Kernel 1: the candidate selection, one warp per row.
//
// kSelect = true (select_candidates): the row's K smallest keys in
// ascending order, ties to the lower column (jax.lax.top_k's order on
// -key), thresh = the K-th key, and, as masked_row_min defines them, the
// row minimum of C over {key <= thresh} and that mask as bits. One pass over
// C replaces the PyTorch-op key, the full-row sort and the second pass of
// the unfused route.
// kSelect = false (masked_row_min): thresh is given; rowmin and the bits.
//
// The guard band. The mask and the selection must equal, bit for bit, the
// ones PyTorch ops compute from the exact key fl(c - fl(tau * g)), g =
// -logf(-logf(u)) (selection_key), so the exact key decides every entry,
// but it is computed only where the decision is close. Every entry first
// gets key' = fl(c + fl(tau ln 2) L) from the fast draw's L = log2(t),
// g' = -ln 2 L (gumbel_fast_log2, fast_key). Bound: u takes at most 2^24
// values, and mm_gumbel_err checks on the card that |g - g'| <= E =
// kGumbelErr over all of them (the f32 product it forms for g' is within
// 2^-24 |g'| of g', inside the band's slack). |g| < 16.7 for
// every u, so |tau g| < 17 |tau|; the exact key's two roundings, the
// rounding of tau ln 2 and key''s one rounding are each within 2^-24 of
// their results:
//   |key - key'| <= |tau| E + 2^-23 (|c| + 35 |tau|) + (terms in E 2^-23)
//                <  band(|c|) = |tau| E + 2^-20 (|c| + 35 |tau|),
// with room left for the roundings of the comparisons against it (2^-24
// of their operands).
// kSelect = false: key' - thresh <= -band -> in; > band -> out; otherwise
// the exact key decides.
// kSelect = true, with d = band(max |c| of the row):
//   1. every key' of the row goes to shared memory; each lane keeps the two
//      smallest of its own entries, and U = the K-th smallest of those 64
//      (a bitonic sort across the warp; K <= 64, else U = +inf). K distinct
//      entries have key' <= U, so the true K-th key T <= U + d, and every
//      entry with key <= T has key' <= U + 2 d <= fl(U + 3 d): the members;
//   2. the members are compacted in column order (K + 2 a row at the tier
//      on average, so nearly always at most 32; any count up to M on
//      tie-heavy rows) and their exact keys computed. Up to 32: one a lane,
//      sorted by (key, column) across the warp; more: each member ranked
//      by (key, column) against the others. Ranks below K give idx, rank
//      K - 1 gives T;
//   3. in the mask: the members with key <= T (every non-member has
//      key > T); rowmin over them.
// Without noise key' = key = c and d = 0.
// Signed zeros: a key of -0.0 ties +0.0 here, while torch.sort on the card
// orders -0.0 first. It needs c = -0.0 and tau * g = +0.0, which the solve
// never produces.
//
// Layout. kSelect = false needs no shared memory and writes the bits by
// the vector path one byte per 16-byte chunk (8 columns, little-endian
// within the int32 words), by the scalar path one __ballot_sync per word.
// kSelect = true: per warp, f32 key'[stride] (past 32 members the exact
// keys overwrite it), the member columns as uint16 (m <= kSelectMaxCols),
// and the row's mask words, built with shared-memory atomicOr (integer: the
// result does not depend on the order): 6.2 KB a warp at 1024 columns, so
// four 8-warp blocks fit an SM.
template <bool kSelect>
__global__ void __launch_bounds__(kThreads)
select_kernel(const __nv_bfloat16* __restrict__ C,
              const uint32_t* __restrict__ x_row,
              const float* __restrict__ thresh_in,
              float* __restrict__ rowmin_out, uint8_t* __restrict__ bits,
              float* __restrict__ thresh_out, int64_t* __restrict__ idx_out,
              int* __restrict__ exact_out, int n, int m, int words, int k,
              int stride, float tau, int noised, int vec) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= n) return;  // whole warps leave together; no block barrier
  const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
  uint8_t* brow = bits + static_cast<size_t>(row) * words * 4;
  const uint32_t xr = x_row[row];
  const float atau = fabsf(tau);
  const float tau_ln2 = __fmul_rn(tau, kLn2);

  if constexpr (!kSelect) {
    const float th = thresh_in[row];
    const float base = band(0.0f, atau);
    float acc = INFINITY;
    auto in_mask = [&](float c, int col) {
      bool in;
      if (!noised) {
        in = c <= th;
      } else {
        const uint32_t ucol = static_cast<uint32_t>(col);
        const float diff = __fsub_rn(fast_key(c, xr, ucol, tau_ln2), th);
        const float d = __fmaf_rn(kRoundRel, fabsf(c), base);  // band(|c|)
        if (diff <= -d) {
          in = true;
        } else if (diff > d) {
          in = false;
        } else {
          in = selection_key(c, xr, ucol, tau, 1) <= th;
        }
      }
      if (in) acc = fminf(acc, c);
      return in;
    };
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      const int chunks = m / kVec;
      for (int j = lane; j < words * 4; j += 32) {
        uint32_t byte = 0u;
        if (j < chunks) {
          const uint4 raw = __ldg(p4 + j);
          const auto* vals = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int t = 0; t < kVec; ++t) {
            if (in_mask(__bfloat162float(vals[t]), j * kVec + t)) {
              byte |= 1u << t;
            }
          }
        }
        brow[j] = static_cast<uint8_t>(byte);
      }
    } else {
      uint32_t* wrow = reinterpret_cast<uint32_t*>(brow);
      for (int c0 = 0; c0 < m; c0 += 32) {
        const int col = c0 + lane;
        const bool in = col < m && in_mask(__bfloat162float(p[col]), col);
        const uint32_t word = __ballot_sync(0xffffffffu, in);
        if (lane == 0) wrow[c0 / 32] = word;
      }
    }
    acc = warp_min(acc);
    if (lane == 0) rowmin_out[row] = acc;
  } else {
    extern __shared__ float4 smem4[];
    float* skey = reinterpret_cast<float*>(smem4) +
                  static_cast<size_t>(warp) * select_warp_floats(stride);
    float* ekey = skey;  // the exact keys, once the members are known
    uint16_t* lcol = reinterpret_cast<uint16_t*>(skey + stride);
    uint32_t* sw = reinterpret_cast<uint32_t*>(skey + stride + stride / 2);

    // 1. key' of every entry; each lane's two smallest; max |c|.
    float m1 = INFINITY;
    float m2 = INFINITY;
    float cmax = 0.0f;
    auto visit = [&](float c, int col) {
      const float kf =
          noised ? fast_key(c, xr, static_cast<uint32_t>(col), tau_ln2) : c;
      m2 = fminf(m2, fmaxf(m1, kf));
      m1 = fminf(m1, kf);
      cmax = fmaxf(cmax, fabsf(c));
      return kf;
    };
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      const int chunks = m / kVec;
      for (int j0 = 0; j0 < chunks; j0 += kSlabChunks) {
        uint4 q[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int j = j0 + lane + 32 * i;
          q[i] = j < chunks ? __ldg(p4 + j) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int j = j0 + lane + 32 * i;
          if (j < chunks) {
            const uint32_t w[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
            float kk[kVec];
#pragma unroll
            for (int t = 0; t < kVec; ++t) {
              const uint32_t h = (t & 1) ? (w[t >> 1] >> 16)
                                         : (w[t >> 1] & 0xFFFFu);
              kk[t] = visit(bf16_bits_to_float(h), j * kVec + t);
            }
            float4* dst = reinterpret_cast<float4*>(skey + j * kVec);
            dst[0] = make_float4(kk[0], kk[1], kk[2], kk[3]);
            dst[1] = make_float4(kk[4], kk[5], kk[6], kk[7]);
          }
        }
      }
    } else {
      for (int col = lane; col < m; col += 32) {
        skey[col] = visit(__bfloat162float(p[col]), col);
      }
    }
    float upper = INFINITY;
    if (k <= 64) {
      warp_sort64(m1, m2, lane);
      upper = __shfl_sync(0xffffffffu, (k - 1) < 32 ? m1 : m2, (k - 1) & 31);
    }
    const float d = noised ? band(warp_max(cmax), atau) : 0.0f;
    const float thr = __fadd_rn(upper, __fmul_rn(3.0f, d));
    __syncwarp();

    // 2. The members in column order: two rounds of 256 columns (8 a lane)
    // at a time, their counts packed into one scan.
    auto member_bits = [&](int col0) {
      uint32_t mb = 0u;
      if (col0 < m) {
        const float4 a = *reinterpret_cast<const float4*>(skey + col0);
        const float4 b = *reinterpret_cast<const float4*>(skey + col0 + 4);
        const float kk[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          if (col0 + t < m && kk[t] <= thr) mb |= 1u << t;
        }
      }
      return mb;
    };
    int members = 0;
    for (int c0 = 0; c0 < m; c0 += 64 * kVec) {
      const int col0 = c0 + lane * kVec;
      const int col1 = col0 + 32 * kVec;
      const uint32_t mb0 = member_bits(col0);
      const uint32_t mb1 = member_bits(col1);
      int total;
      const int excl =
          warp_excl_scan(__popc(mb0) | (__popc(mb1) << 16), lane, total);
      const int total0 = total & 0xFFFF;
      int pos = members + (excl & 0xFFFF);
      for_each_bit(mb0, [&](int t) {
        lcol[pos++] = static_cast<uint16_t>(col0 + t);
      });
      pos = members + total0 + (excl >> 16);
      for_each_bit(mb1, [&](int t) {
        lcol[pos++] = static_cast<uint16_t>(col1 + t);
      });
      members += total0 + (total >> 16);
    }
    __syncwarp();  // every key' is read before an exact key overwrites it
    for (int w = lane; w < words; w += 32) sw[w] = 0u;

    float th;
    float acc = INFINITY;
    if (members <= 32) {
      // One member a lane: its exact key, then a bitonic sort of
      // (key, column) across the warp; lane r then holds rank r.
      int col = 0x7FFFFFFF;
      float key = INFINITY;
      float c = INFINITY;
      if (lane < members) {
        col = lcol[lane];
        c = __bfloat162float(p[col]);
        key = selection_key(c, xr, static_cast<uint32_t>(col), tau, noised);
      }
      float skey_r = key;
      int scol = col;
#pragma unroll
      for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
        for (int j = kk >> 1; j > 0; j >>= 1) {
          const float ok = __shfl_xor_sync(0xffffffffu, skey_r, j);
          const int oc = __shfl_xor_sync(0xffffffffu, scol, j);
          const bool other_less = ok < skey_r || (ok == skey_r && oc < scol);
          const bool keep_min = ((lane & j) == 0) == ((lane & kk) == 0);
          if (keep_min == other_less) {
            skey_r = ok;
            scol = oc;
          }
        }
      }
      if (lane < k) idx_out[static_cast<size_t>(row) * k + lane] = scol;
      th = __shfl_sync(0xffffffffu, skey_r, k - 1);
      __syncwarp();
      if (lane < members && key <= th) {
        atomicOr(sw + (col >> 5), 1u << (col & 31));
        acc = c;
      }
    } else {
      // Any count up to M: exact keys in shared memory, each member
      // ranked by (key, column) against the others (the list is in column
      // order; the reads run up to 7 past the members, inside the warp's
      // own area).
      for (int i = lane; i < members; i += 32) {
        const int col = lcol[i];
        ekey[i] = selection_key(__bfloat162float(p[col]), xr,
                                static_cast<uint32_t>(col), tau, noised);
      }
      __syncwarp();
      float t_lane = 0.0f;
      bool found = false;
      for (int i = lane; i < members; i += 32) {
        const float ki = ekey[i];
        int r = 0;
        for (int j0 = 0; j0 < members && r < k; j0 += 8) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int j = j0 + t;
            const float kj = ekey[j];
            r += (j < members && (kj < ki || (kj == ki && j < i))) ? 1 : 0;
          }
        }
        if (r < k) {
          idx_out[static_cast<size_t>(row) * k + r] = lcol[i];
          if (r == k - 1) {
            t_lane = ki;
            found = true;
          }
        }
      }
      const unsigned who = __ballot_sync(0xffffffffu, found);
      th = __shfl_sync(0xffffffffu, t_lane, who ? __ffs(who) - 1 : 0);
      for (int i = lane; i < members; i += 32) {
        if (ekey[i] <= th) {
          const int col = lcol[i];
          atomicOr(sw + (col >> 5), 1u << (col & 31));
          acc = fminf(acc, __bfloat162float(p[col]));
        }
      }
    }

    // 3. The mask words and rowmin.
    __syncwarp();
    uint32_t* wrow = reinterpret_cast<uint32_t*>(brow);
    for (int w = lane; w < words; w += 32) wrow[w] = sw[w];
    acc = warp_min(acc);
    if (lane == 0) {
      rowmin_out[row] = acc;
      thresh_out[row] = th;
      if (exact_out) exact_out[row] = members;
    }
  }
}

// |gumbel_exact - g'| over all 2^24 uniforms the hash can give
// (x = v << 8): block b writes its largest to out[1 + b] (a NaN
// propagates), and block 0 writes kGumbelErr to out[0].
__global__ void __launch_bounds__(kThreads)
gumbel_err_kernel(float* __restrict__ out) {
  __shared__ float s_err[kWarps];
  float e = 0.0f;
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < (1u << 24);
       v += gridDim.x * kThreads) {
    const uint32_t x = v << 8;
    const float g_fast = __fmul_rn(-kLn2, gumbel_fast_log2(x));
    const float diff = fabsf(__fsub_rn(gumbel_exact(x), g_fast));
    e = (diff > e || diff != diff) ? diff : e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, e, off);
    e = (o > e || o != o) ? o : e;
  }
  if ((threadIdx.x & 31) == 0) s_err[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      e = (s_err[w] > e || s_err[w] != s_err[w]) ? s_err[w] : e;
    }
    out[1 + blockIdx.x] = e;
    if (blockIdx.x == 0) out[0] = kGumbelErr;
  }
}

// Kernel 2, row product only: one warp per row, any width. Each lane takes
// 4 chunks at a time with their 4 mask bytes, and runs the division and
// expf only on its set bits, in column order; then a fixed xor-shuffle
// tree.
__global__ void __launch_bounds__(kThreads)
row_matvec_kernel(const __nv_bfloat16* __restrict__ C,
                  const uint8_t* __restrict__ bits,
                  const float* __restrict__ rowmin,
                  const float* __restrict__ v, float* __restrict__ out, int n,
                  int m, int words, float eps, int vec) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
  const uint8_t* brow = bits + static_cast<size_t>(row) * words * 4;
  const int nchunks = (m + kVec - 1) / kVec;
  const float rm = rowmin[row];
  float acc = 0.0f;
  for (int j0 = 0; j0 < nchunks; j0 += kSlabChunks) {
    const Group g = load_group(p, brow, j0, lane, nchunks, m, vec);
    const float* vs = v + j0 * kVec;
    for_each_bit(g.bits, [&](int b) {
      acc = __fadd_rn(acc, __fmul_rn(shifted_exp(rm, group_elem(g, b), eps),
                                     __ldg(vs + slab_col(lane, b))));
    });
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

// One round of a row's compacted candidates: C and its slab column.
struct CandList {
  float c[32];
  int col[32];
};

// Writes the lane's candidates of round [base, base + 32) to the list: the
// lane's k-th set bit (ascending) is candidate excl + k.
template <class Elem>
__device__ __forceinline__ void fill_round(CandList& list, uint32_t mbits,
                                           int excl, int base, int lane,
                                           Elem elem) {
  if (excl >= base + 32 || excl + __popc(mbits) <= base) return;
  int k = excl;
  for_each_bit(mbits, [&](int b) {
    if (k >= base && k < base + 32) {
      list.c[k - base] = elem(b);
      list.col[k - base] = slab_col(lane, b);
    }
    ++k;
  });
}

// cp.async (global -> shared, bypassing registers) and its groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Kernels 3 and 2 + 3 fused. Block b covers rows [b * rows_per_block, ...),
// warp w of it rows_per_block / kWarps of them; the slab loop walks the
// columns kSlab at a time (kFused: one slab, m <= kSlab). Per row:
//   column only (kFused = false): acc[col] += p * u[row] on set bits;
//   fused: r = max(sum p * v[col], 1e-30) over the row's set bits (warp
//   sum), r_out[row] = r, u = row_mass[row] / r (IEEE division, as the
//   PyTorch op), then acc[col] += p * u on the same set bits.
// Dynamic shared memory: kWarps column slabs of f32, kWarps candidate
// lists, then (kRingStage) kWarps x kRing row tiles of kTileBytes.
template <bool kFused, bool kRingStage>
__global__ void __launch_bounds__(kThreads)
col_kernel(const __nv_bfloat16* __restrict__ C,
           const uint8_t* __restrict__ bits,
           const float* __restrict__ rowmin, const float* __restrict__ w,
           const float* __restrict__ row_mass, float* __restrict__ r_out,
           float* __restrict__ partial, int n, int m, int words,
           int rows_per_block, float eps) {
  extern __shared__ float4 smem4[];
  float* s_acc = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc = s_acc + warp * kSlab;
  const int per_warp = rows_per_block / kWarps;
  const int r0 = blockIdx.x * rows_per_block + warp * per_warp;
  const int r1 = min(n, r0 + per_warp);
  const int nchunks = (m + kVec - 1) / kVec;
  const size_t row_bytes = static_cast<size_t>(words) * 4;
  CandList& list =
      reinterpret_cast<CandList*>(s_acc + kWarps * kSlab)[warp];
  uint8_t* ring =
      reinterpret_cast<uint8_t*>(s_acc + kWarps * kSlab) +
      kWarps * sizeof(CandList) + warp * kRing * kTileBytes;

  for (int s0 = 0; s0 < m; s0 += kSlab) {
    const int j0 = s0 / kVec;
    for (int i = lane; i < kSlab; i += 32) acc[i] = 0.0f;
    __syncwarp();

    // Work of one row, given the lane's mask bits and C at its bit b
    // (elem). The row's candidates are compacted across the warp, 32 per
    // round, so each lane runs the division and expf about once per row
    // instead of the warp waiting on its busiest lane.
    auto visit_row = [&](int row, uint32_t mbits, auto elem) {
      int total;
      const int excl = warp_excl_scan(__popc(mbits), lane, total);
      const float rm = __ldg(rowmin + row);
      float u;
      if constexpr (kFused) {
        float rl = 0.0f;
        float p_kept = 0.0f;
        int col_kept = -1;
        for (int base = 0; base < total; base += 32) {
          fill_round(list, mbits, excl, base, lane, elem);
          __syncwarp();
          if (base + lane < total) {
            col_kept = list.col[lane];
            p_kept = shifted_exp(rm, list.c[lane], eps);
            rl = __fadd_rn(rl, __fmul_rn(p_kept, __ldg(w + col_kept)));
          }
          __syncwarp();
        }
        rl = warp_sum(rl);
        const float r = rl < kRFloor ? kRFloor : rl;
        if (lane == 0) r_out[row] = r;
        u = __fdiv_rn(__ldg(row_mass + row), r);
        if (total <= 32) {  // one round: p is still in its lane
          if (col_kept >= 0) {
            acc[col_kept] = __fadd_rn(acc[col_kept], __fmul_rn(p_kept, u));
          }
          return;
        }
      } else {
        u = __ldg(w + row);
      }
      for (int base = 0; base < total; base += 32) {
        fill_round(list, mbits, excl, base, lane, elem);
        __syncwarp();
        if (base + lane < total) {
          const int col = list.col[lane];
          acc[col] = __fadd_rn(
              acc[col], __fmul_rn(shifted_exp(rm, list.c[lane], eps), u));
        }
        __syncwarp();
      }
    };

    if constexpr (!kRingStage) {  // ragged or unaligned C: scalar loads
      if (r0 < r1) {
        const __nv_bfloat16* p = C + static_cast<size_t>(r0) * m;
        const uint8_t* bp = bits + static_cast<size_t>(r0) * row_bytes;
        Group cur = load_group(p, bp, j0, lane, nchunks, m, 0);
        for (int row = r0; row < r1; ++row) {
          Group nxt = cur;
          if (row + 1 < r1) {
            p += m;
            bp += row_bytes;
            nxt = load_group(p, bp, j0, lane, nchunks, m, 0);
          }
          visit_row(row, cur.bits,
                    [&](int b) { return group_elem(cur, b); });
          cur = nxt;
        }
      }
    } else {
      // Row r0 + i goes to tile i % kRing; kRing - 1 rows ahead in flight.
      auto prefetch = [&](int i) {
        const int row = r0 + i;
        if (row < r1) {
          uint8_t* tile = ring + (i % kRing) * kTileBytes;
          const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
#pragma unroll
          for (int k = 0; k < kLoads; ++k) {
            const int j = lane + 32 * k;
            if (j0 + j < nchunks) {
              cp_async16(tile + j * 16, p + (j0 + j) * kVec);
            }
          }
          uint32_t* tw = reinterpret_cast<uint32_t*>(tile + kSlab * 2);
          const int word = s0 / 32 + lane;
          const uint8_t* bp = bits + static_cast<size_t>(row) * row_bytes;
          if (word < words) {
            cp_async4(tw + lane, bp + static_cast<size_t>(word) * 4);
          } else {
            tw[lane] = 0u;
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int i = 0; i < kRing - 1; ++i) prefetch(i);
      for (int i = 0; r0 + i < r1; ++i) {
        prefetch(i + kRing - 1);
        cp_async_wait<kRing - 1>();
        __syncwarp();
        const uint8_t* tile = ring + (i % kRing) * kTileBytes;
        const auto* tc = reinterpret_cast<const unsigned short*>(tile);
        const uint8_t* tb = tile + kSlab * 2;
        const uint32_t mbits =
            static_cast<uint32_t>(tb[lane]) |
            (static_cast<uint32_t>(tb[lane + 32]) << 8) |
            (static_cast<uint32_t>(tb[lane + 64]) << 16) |
            (static_cast<uint32_t>(tb[lane + 96]) << 24);
        visit_row(r0 + i, mbits, [&](int b) {
          return bf16_bits_to_float(tc[slab_col(lane, b)]);
        });
        __syncwarp();
      }
      cp_async_wait<0>();
    }

    // The block's partial of this slab: the warps' slabs summed in warp
    // order.
    __syncthreads();
    for (int i = threadIdx.x; i < kSlab && s0 + i < m; i += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        sum = __fadd_rn(sum, s_acc[k * kSlab + i]);
      }
      partial[static_cast<size_t>(blockIdx.x) * m + s0 + i] = sum;
    }
    __syncthreads();
  }
}

// Column product, pass 2: block (kCombineCols, kCombineLanes) covers
// kCombineCols columns; lane y of a column sums block partials y, y +
// kCombineLanes, ... (a warp reads one partial row's columns contiguously),
// then lane 0 sums the lanes' sums in lane order. Fixed order.
__global__ void __launch_bounds__(kCombineCols * kCombineLanes)
col_combine_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int parts, int m) {
  __shared__ float s_sum[kCombineLanes][kCombineCols];
  const int col = blockIdx.x * kCombineCols + threadIdx.x;
  float s = 0.0f;
  if (col < m) {
    for (int k = threadIdx.y; k < parts; k += kCombineLanes) {
      s = __fadd_rn(s, partial[static_cast<size_t>(k) * m + col]);
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= m) return;
  for (int y = 1; y < kCombineLanes; ++y) {
    s = __fadd_rn(s, s_sum[y][threadIdx.x]);
  }
  out[col] = s;
}

// Rows start on 16-byte boundaries: take the vector loads.
int vec_ok(const void* C, int m) {
  return (m % 8 == 0) && (reinterpret_cast<uintptr_t>(C) % 16 == 0);
}

int words_of(int m) { return (m + 31) / 32; }

int warp_blocks(int n) {
  return static_cast<int>((static_cast<long long>(n) * 32 + kThreads - 1) /
                          kThreads);
}

template <bool kFused, bool kRingStage>
int launch_col_kernel(const void* C, const void* bits, const void* rowmin,
                      const void* w, const void* row_mass, void* r_out,
                      void* partial, int n, int m, int rows_per_block,
                      float eps, cudaStream_t stream) {
  const int smem = kWarps * (kSlab * 4 + static_cast<int>(sizeof(CandList))) +
                   (kRingStage ? kWarps * kRing * kTileBytes : 0);
  static const cudaError_t attr = cudaFuncSetAttribute(
      col_kernel<kFused, kRingStage>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  col_kernel<kFused, kRingStage><<<blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const uint8_t*>(bits),
      static_cast<const float*>(rowmin), static_cast<const float*>(w),
      static_cast<const float*>(row_mass), static_cast<float*>(r_out),
      static_cast<float*>(partial), n, m, words_of(m), rows_per_block, eps);
  return static_cast<int>(cudaGetLastError());
}

// The column pass (kFused: the fused pass) and the combine of its block
// partials. The ring stage takes 16-byte rows; ragged or unaligned C takes
// the register stage.
template <bool kFused>
int launch_col(const void* C, const void* bits, const void* rowmin,
               const void* w, const void* row_mass, void* r_out,
               void* partial, void* out, int n, int m, int rows_per_block,
               float eps, cudaStream_t stream) {
  if (rows_per_block <= 0 || rows_per_block % kWarps != 0 ||
      (kFused && m > kSlab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err =
      vec_ok(C, m)
          ? launch_col_kernel<kFused, true>(C, bits, rowmin, w, row_mass,
                                            r_out, partial, n, m,
                                            rows_per_block, eps, stream)
          : launch_col_kernel<kFused, false>(C, bits, rowmin, w, row_mass,
                                             r_out, partial, n, m,
                                             rows_per_block, eps, stream);
  if (err != 0) return err;
  const int parts = (n + rows_per_block - 1) / rows_per_block;
  col_combine_kernel<<<(m + kCombineCols - 1) / kCombineCols,
                       dim3(kCombineCols, kCombineLanes), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), parts, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes. C is bf16[n, m] row-major; x_row
// holds uint32 bits; bits is int32[n, ceil(m / 32)]. The wrapper checks
// shapes, dtypes and contiguity, and allocates the outputs and the column
// scratch (`partial`, f32[ceil(n / rows_per_block), m]); rows_per_block is
// a multiple of 8. Each returns the cudaGetLastError() code after its launches (0 = launched).
extern "C" {

int mm_masked_row_min(const void* C, const void* thresh, const void* x_row,
                      void* out, void* bits, int n, int m, float tau,
                      int noised, void* stream) {
  select_kernel<false><<<warp_blocks(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(C),
      static_cast<const uint32_t*>(x_row), static_cast<const float*>(thresh),
      static_cast<float*>(out), static_cast<uint8_t*>(bits), nullptr,
      nullptr, nullptr, n, m, words_of(m), 0, 0, tau, noised, vec_ok(C, m));
  return static_cast<int>(cudaGetLastError());
}

// idx is int64[n, k] (1 <= k <= m), thresh and rowmin f32[n], bits
// int32[n, ceil(m / 32)], exact (may be null) int32[n]: the members of each
// row, whose exact keys were computed. m <= mm_select_max_cols().
int mm_select_candidates(const void* C, const void* x_row, void* idx,
                         void* thresh, void* rowmin, void* bits, void* exact,
                         int n, int m, int k, float tau, int noised,
                         void* stream) {
  if (k < 1 || k > m || m > kSelectMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stride = (m + 31) / 32 * 32;
  const int warp_bytes = select_warp_floats(stride) * 4;
  const int warps =
      std::max(1, std::min(kWarps, kSelectBlockSmem / warp_bytes));
  static const cudaError_t attr = cudaFuncSetAttribute(
      select_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBlockSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  select_kernel<true><<<(n + warps - 1) / warps, warps * 32,
                        warps * warp_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(C),
      static_cast<const uint32_t*>(x_row), nullptr,
      static_cast<float*>(rowmin), static_cast<uint8_t*>(bits),
      static_cast<float*>(thresh), static_cast<int64_t*>(idx),
      static_cast<int*>(exact), n, m, words_of(m), k, stride, tau, noised,
      vec_ok(C, m));
  return static_cast<int>(cudaGetLastError());
}

int mm_select_max_cols() { return kSelectMaxCols; }

// The guard band's draw bound: out[0] = kGumbelErr, the constant the
// kernels were built with; out[1 + b] = block b's largest |g - g'|, b <
// mm_gumbel_err_blocks().
int mm_gumbel_err_blocks() { return kErrBlocks; }

int mm_gumbel_err(void* out, void* stream) {
  gumbel_err_kernel<<<kErrBlocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int mm_masked_row_matvec(const void* C, const void* bits, const void* rowmin,
                         const void* v, void* out, int n, int m, float eps,
                         void* stream) {
  row_matvec_kernel<<<warp_blocks(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const uint8_t*>(bits),
      static_cast<const float*>(rowmin), static_cast<const float*>(v),
      static_cast<float*>(out), n, m, words_of(m), eps, vec_ok(C, m));
  return static_cast<int>(cudaGetLastError());
}

int mm_masked_col_matvec(const void* C, const void* bits, const void* rowmin,
                         const void* u, void* partial, void* out, int n,
                         int m, int rows_per_block, float eps,
                         void* stream) {
  return launch_col<false>(C, bits, rowmin, u, nullptr, nullptr, partial,
                           out, n, m, rows_per_block, eps,
                           static_cast<cudaStream_t>(stream));
}

int mm_masked_sinkhorn_step(const void* C, const void* bits,
                            const void* rowmin, const void* v,
                            const void* row_mass, void* r_out, void* partial,
                            void* c_out, int n, int m, int rows_per_block,
                            float eps, void* stream) {
  return launch_col<true>(C, bits, rowmin, v, row_mass, r_out, partial,
                          c_out, n, m, rows_per_block, eps,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
