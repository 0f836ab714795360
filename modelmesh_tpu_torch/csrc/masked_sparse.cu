// Candidate-mask kernels of the sparse Sinkhorn, for Hopper (sm_90a).
//
//   rowmin[n] = min_m { C[n, m] : key(n, m) <= thresh[n] }, and bits(n, m)
//   r[n]      = sum_m bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * v[m]
//   c[m]      = sum_n bit(n, m) * exp((rowmin[n] - C[n, m]) / eps) * u[n]
//
// key(n, m) = f32(C[n, m]) - tau * gumbel(n, m), where the Gumbel draw is the
// murmur3 counter hash of (row state x_row[n], column m). Within one solve C,
// thresh, x_row and rowmin never change, so the mask is evaluated once:
// row_min_kernel computes every key, the row minimum, and writes the mask as
// bits, int32[n, ceil(m / 32)] with bit j of word w standing for column
// 32 w + j (bits past m are zero). Every later pass reads the bits and C;
// neither a bool mask nor the scaled kernel P = exp((rowmin - C) / eps) *
// mask ever exists in device memory.
//
// Replaces the Pallas TPU kernels of modelmesh_tpu/ops/pallas_sparse.py:
//   row_min_kernel              <- masked_row_min (_row_min_kernel, _tile_key)
//   row_matvec_kernel           <- masked_row_matvec (_row_matvec_kernel)
//   col_kernel<false>, combine  <- masked_col_matvec (_col_matvec_kernel)
//   col_kernel<true>, combine   <- masked_row_matvec + masked_col_matvec of
//                                  one Sinkhorn iteration, in one pass
//
// Bound. Each pass must read C once (n * m * 2 bytes in bf16) and the bits
// (n * m / 8 bytes): 285 MB at the 131072 x 1024 tier, about 85 us at the
// H100 SXM's 3.35 TB/s. row_min_kernel spends a hash, two logf and a
// compare on every entry. The bit-reading kernels spend a bit test per
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
// ops on the same card, because the row thresholds come from that
// computation. So: build without fast math and with --fmad=false, use
// logf/expf (what PyTorch's own CUDA log/exp call), and spell the
// arithmetic with round-to-nearest intrinsics that cannot be contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// Kernel 1: one warp per row; masked min of C, and the mask as bits.
// Vector path: lane j's 16-byte chunk is byte j of the row's bits (its
// 8 columns' bits, little-endian within the int32 words), stored as one
// byte; the bytes past the last chunk are written zero. Scalar path: one
// __ballot_sync per 32 columns is one word.
__global__ void __launch_bounds__(kThreads)
row_min_kernel(const __nv_bfloat16* __restrict__ C,
               const float* __restrict__ thresh,
               const uint32_t* __restrict__ x_row, float* __restrict__ out,
               uint8_t* __restrict__ bits, int n, int m, int words,
               float tau, int noised, int vec) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // whole warps leave together
  const __nv_bfloat16* p = C + static_cast<size_t>(row) * m;
  uint8_t* brow = bits + static_cast<size_t>(row) * words * 4;
  const float th = thresh[row];
  const uint32_t xr = x_row[row];
  float acc = INFINITY;

  auto in_mask = [&](float c, int col) {
    const bool in =
        selection_key(c, xr, static_cast<uint32_t>(col), tau, noised) <= th;
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
          if (in_mask(__bfloat162float(vals[t]), j * kVec + t)) byte |= 1u << t;
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

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = fminf(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) out[row] = acc;
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
  row_min_kernel<<<warp_blocks(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(thresh),
      static_cast<const uint32_t*>(x_row), static_cast<float*>(out),
      static_cast<uint8_t*>(bits), n, m, words_of(m), tau, noised,
      vec_ok(C, m));
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
