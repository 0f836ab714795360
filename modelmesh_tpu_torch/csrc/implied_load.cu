// Implied load of the auction's assignment, for Hopper (sm_90a).
//
//   load[m] = sum_{n, k} sizes[n] * valid[n, k] * [idx[n, k] == m]
//
// idx is int64[N, S] and valid bool[N, S], both with unit column stride and
// any row stride (the sparse auction passes the first nsel slots of its
// [N, 8] selection as a view), sizes f32[N], load f32[M].
//
// Replaces the TPU-only path modelmesh_tpu/ops/auction.py::
// _implied_load_fused: a chunked one-hot compare-reduce, O(N S M) compares,
// which the TPU takes because its scatter-add serializes on duplicate
// indices. On Hopper those compares would cost about what PyTorch's
// index_add_ costs, and index_add_ sums with float atomics, so the load and
// every placement that follows from it change from run to run.
//
// Bound. The function must read idx (8 bytes per entry), valid (1) and
// sizes (4 per row) and write M floats: about 10 MB at [131072, 8] -> 1024,
// some 3 us at the H100 SXM's 3.35 TB/s.
//
// Design: a histogram per warp, summed in a fixed order, no float atomics.
// Block b takes entries [b * block_entries, ...) in row-major order (the
// wrapper's constant), warp w of it block_entries / 8 of those, 32 at a
// time. Per step the lanes that hold the same instance are grouped with
// __match_any_sync; the group's lowest lane sums the group's weights in
// lane order and adds that sum to the warp's f32 bin in shared memory, so
// each bin has one writer per step.
// The block's warps' histograms are then summed in warp order into one
// partial per block, and load_combine_kernel sums the block partials in a
// fixed order (the pattern of masked_sparse.cu's col_combine_kernel). The
// grid follows from (N, S, M) alone, so the summation order does not depend
// on the card. Instances are walked kSlab at a time, so any M fits the
// 4 KB per-warp histogram.
//
// Sums of integer sizes below 2^24 are exact in f32 in any order, so there
// the kernel equals the plain one-hot version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 1024;                       // instances per histogram
constexpr int kCombineCols = 32;
constexpr int kCombineLanes = 16;

__global__ void __launch_bounds__(kThreads)
load_partial_kernel(const int64_t* __restrict__ idx,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ sizes,
                    float* __restrict__ partial, long long total, int s,
                    long long idx_stride, long long valid_stride, int m,
                    int warp_entries) {
  __shared__ float s_hist[kWarps][kSlab];
  __shared__ float s_w[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* hist = s_hist[warp];
  const long long w0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * warp_entries;

  for (int s0 = 0; s0 < m; s0 += kSlab) {
    for (int i = lane; i < kSlab; i += 32) hist[i] = 0.0f;
    __syncwarp();
    for (int step = 0; step < warp_entries; step += 32) {
      const long long e = w0 + step + lane;
      float w = 0.0f;
      int slot = kSlab + lane;  // out of this slab: a group of its own
      if (e < total) {
        const long long row = e / s;
        const int k = static_cast<int>(e - row * s);
        const long long id = __ldg(idx + row * idx_stride + k);
        if (id >= s0 && id < s0 + kSlab && id < m) {
          slot = static_cast<int>(id - s0);
          w = __fmul_rn(__ldg(sizes + row),
                        __ldg(valid + row * valid_stride + k) ? 1.0f : 0.0f);
        }
      }
      s_w[warp][lane] = w;
      __syncwarp();
      const unsigned group = __match_any_sync(0xffffffffu, slot);
      if (slot < kSlab && lane == __ffs(group) - 1) {
        float sum = 0.0f;
        for (unsigned g = group; g; g &= g - 1u) {
          sum = __fadd_rn(sum, s_w[warp][__ffs(g) - 1]);
        }
        hist[slot] = __fadd_rn(hist[slot], sum);
      }
      __syncwarp();
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kSlab && s0 + i < m; i += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum = __fadd_rn(sum, s_hist[k][i]);
      partial[static_cast<size_t>(blockIdx.x) * m + s0 + i] = sum;
    }
    __syncthreads();
  }
}

// Block (kCombineCols, kCombineLanes) covers kCombineCols instances; lane y
// of an instance sums block partials y, y + kCombineLanes, ..., then lane 0
// sums the lanes' sums in lane order. Fixed order.
__global__ void __launch_bounds__(kCombineCols * kCombineLanes)
load_combine_kernel(const float* __restrict__ partial,
                    float* __restrict__ out, int parts, int m) {
  __shared__ float s_sum[kCombineLanes][kCombineCols];
  const int col = blockIdx.x * kCombineCols + threadIdx.x;
  float acc = 0.0f;
  if (col < m) {
    for (int k = threadIdx.y; k < parts; k += kCombineLanes) {
      acc = __fadd_rn(acc, partial[static_cast<size_t>(k) * m + col]);
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || col >= m) return;
  for (int y = 1; y < kCombineLanes; ++y) {
    acc = __fadd_rn(acc, s_sum[y][threadIdx.x]);
  }
  out[col] = acc;
}

}  // namespace

// Plain C interface, bound with ctypes. The wrapper checks dtypes, shapes
// and strides, and allocates the output and the block partials
// (f32[ceil(n * s / block_entries), m]; block_entries a multiple of 256).
// Returns the cudaGetLastError() code after the launches (0 = launched).
extern "C" {

int mm_implied_load(const void* idx, const void* valid, const void* sizes,
                    void* partial, void* out, int n, int s,
                    long long idx_stride, long long valid_stride, int m,
                    int block_entries, void* stream) {
  const long long total = static_cast<long long>(n) * s;
  if (total <= 0 || m <= 0 || block_entries <= 0 ||
      block_entries % kThreads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks =
      static_cast<int>((total + block_entries - 1) / block_entries);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  load_partial_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const int64_t*>(idx), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(sizes), static_cast<float*>(partial), total,
      s, idx_stride, valid_stride, m, block_entries / kWarps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  load_combine_kernel<<<(m + kCombineCols - 1) / kCombineCols,
                        dim3(kCombineCols, kCombineLanes), 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
