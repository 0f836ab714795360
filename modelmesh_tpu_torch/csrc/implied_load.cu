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
// some 3 us at the H100 SXM's 3.35 TB/s. Memory-bound: two f32 operations
// per entry are 0.03 us at 67 TFLOP/s.
//
// Design: one launch, a histogram per warp, every sum in a fixed order and
// no float atomics.
// - Grid. Block b takes rows [b * kRows, (b + 1) * kRows), its entries in
//   row-major order, 32 a step: thread t the entries t, t + kThreads, ...
//   (warp w steps w, w + kWarps, ...). ceil(N / kRows) blocks: a function
//   of N alone, never of the card. A block of 16 warps an SM: the tier's
//   128 blocks run in one wave. Blocks of 512 rows and 8 warps, two an SM,
//   took 0.6 us longer at [131072, 8] and wrote twice the partials
//   (PERF.md).
// - Loads in flight. A thread issues its 2 S entries' idx, valid and sizes
//   loads (16 at S = 8; larger S in rounds of kPerThread) before it uses
//   any: registers, no dependent loads, the row and offsets stepped by
//   additions; it zeroes its warp's histogram while they land.
//   Neighbouring lanes read neighbouring entries, so a warp's idx load is
//   256 contiguous bytes of a contiguous layout (a view's rows are read by
//   their row stride) and its sizes load one sector shared by the lanes of
//   a row. Staging the block's rows in shared memory with 16-byte
//   cp.async copies was measured slower: the histogram steps, not the
//   loads, bound the pass, and the steps then wait on shared memory for
//   the id as well (PERF.md). Not done: 16-byte vector loads of idx (a
//   lane's entries are kThreads apart, so its loads are 8 bytes; a warp's
//   are one 256-byte request all the same), and one sizes load a row:
//   every lane loads its entry's sizes[row], S loads a row, but the lanes
//   of a row load it in one warp instruction at one address, so memory
//   serves it once a row; the extra loads are instructions, not bytes.
// - Histogram steps. A warp adds its entries to its f32 histogram in
//   shared memory in entry order, 32 a step (one per lane). Every lane
//   reads its bin, then adds its weight and tags the bin with its lane
//   number (a byte beside the bin); a ballot of the lanes that read
//   another's number back names the bins two or more lanes share (38% of
//   the steps for random ids over 1,024 instances), and the lowest lane of
//   such a bin adds its members' weights to the value they all read, one
//   after another in lane order (by shuffles), and writes the bin. A first
//   design grouped the lanes with __match_any_sync: 18.2 us at [131072, 8]
//   and still 16.5 us at [12288, 8], 12 blocks (PERF.md). A warp's
//   histogram holds up to kMaxSlab bins (dynamic shared memory, 160 KB
//   with the tags at the most for the block), so every M the auctions
//   use (1,024; 1,536 on the wide fleets) takes one pass; a larger M walks
//   its instances kMaxSlab at a time.
// - Block partial. The block's 16 warp histograms are summed in warp
//   order into f32[M] block partial b (rows ld apart, ld = M rounded up to
//   4): 512 KB at [131072, S] -> 1024 for any S (the earlier two kernels
//   wrote 1 MB there at S = 8 and 640 KB at the 5-slot view).
// - Combine, in the same launch, in two levels. After writing its partial
//   a block takes an integer ticket of its group of kGroup consecutive
//   blocks (one release/acquire atomicAdd after a block barrier); the block
//   that draws the group's last ticket sums the group's partials in index
//   order (16-byte loads from L2), then takes a ticket of the top level,
//   and the block that draws the last of those sums the group sums in
//   group order into the load. A ticket decides only who sums, never the
//   order, and that block resets its counter for the next launch.
// - Sharded route. With no output the launch stops after the block
//   partials; mm_load_combine runs the same two-level sum over the
//   partials of several row blocks concatenated in order, so row blocks of
//   a multiple of kRows rows give the single-device bits.
//
// Sums of integer sizes below 2^24 are exact in f32 in any order, so there
// the kernel equals the plain one-hot version bit for bit; at any sizes it
// equals cuda_load.implied_load_tree, the same order written in PyTorch.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 1024;                            // rows per block
constexpr int kPerThread = 16;  // entries a thread loads at once
constexpr int kMaxSlab = 2048;                         // bins per warp
constexpr int kGroup = 16;                             // partials per group
constexpr int kMaxSmem = kWarps * kMaxSlab * 5;        // 160 KB
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kCombineThreads = 256;

// p[0] + p[stride] + ... + p[(count - 1) * stride], from 0.0 in index
// order; loads 16 at a time ahead of their adds. L2 reads (__ldcg): the
// rows were written by other blocks of the launch.
__device__ float sum_rows(const float* p, int count, long long stride) {
  float sum = 0.0f;
  int j = 0;
  for (; j + 16 <= count; j += 16) {
    float v[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) v[t] = __ldcg(p + (j + t) * stride);
#pragma unroll
    for (int t = 0; t < 16; ++t) sum = __fadd_rn(sum, v[t]);
  }
  for (; j < count; ++j) sum = __fadd_rn(sum, __ldcg(p + j * stride));
  return sum;
}

// sum_rows on four neighbouring instances at once (16-byte loads; p and
// stride 4-aligned): each lane of the float4 is sum_rows of its column.
__device__ float4 sum_rows4(const float* p, int count, long long stride) {
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int j = 0;
  for (; j + 16 <= count; j += 16) {
    float4 v[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      v[t] = __ldcg(reinterpret_cast<const float4*>(p + (j + t) * stride));
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      sum.x = __fadd_rn(sum.x, v[t].x);
      sum.y = __fadd_rn(sum.y, v[t].y);
      sum.z = __fadd_rn(sum.z, v[t].z);
      sum.w = __fadd_rn(sum.w, v[t].w);
    }
  }
  for (; j < count; ++j) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p + j * stride));
    sum.x = __fadd_rn(sum.x, v.x);
    sum.y = __fadd_rn(sum.y, v.y);
    sum.z = __fadd_rn(sum.z, v.z);
    sum.w = __fadd_rn(sum.w, v.w);
  }
  return sum;
}

// The last thread block to arrive at `*counter` (of `arrivals`) gets true,
// with every block's writes before its arrival visible to it; it resets
// the counter. Called by every thread of the block: the block barrier
// orders its threads' writes before thread 0's release, and thread 0's
// acquire before the block's reads.
__device__ bool last_to_arrive(int* counter, int arrivals) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<int, cuda::thread_scope_device> ticket(*counter);
    const bool last =
        ticket.fetch_add(1, cuda::memory_order_acq_rel) == arrivals - 1;
    if (last) ticket.store(0, cuda::memory_order_relaxed);
    s_last = last;
  }
  __syncthreads();
  return s_last;
}

// dst[0..m) = the fixed-order sum of `count` rows of `src` (row stride ld,
// 4-aligned), by the whole block.
__device__ void sum_block_rows(const float* src, int count, int ld,
                               float* dst, int m) {
  for (int i = 4 * threadIdx.x; i < m; i += 4 * kThreads) {
    const float4 v = sum_rows4(src + i, count, ld);
    dst[i] = v.x;
    if (i + 1 < m) dst[i + 1] = v.y;
    if (i + 2 < m) dst[i + 2] = v.z;
    if (i + 3 < m) dst[i + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
load_kernel(const int64_t* __restrict__ idx,
            const uint8_t* __restrict__ valid,
            const float* __restrict__ sizes, float* __restrict__ partial,
            float* __restrict__ group_sum, float* __restrict__ out,
            int* __restrict__ tickets, int n, int s, long long idx_stride,
            long long valid_stride, int m, int ld, int slab) {
  extern __shared__ float4 s_raw[];
  float* const s_hist = reinterpret_cast<float*>(s_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* const hist = s_hist + warp * slab;
  uint8_t* const tag =
      reinterpret_cast<uint8_t*>(s_hist + kWarps * slab) + warp * slab;

  // The block's rows [r0, r0 + rows): its entries in row-major order, 32
  // a step; thread t takes entries t, t + kThreads, ... (warp w steps w,
  // w + kWarps, ...), kPerThread at a time.
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        n - r0));
  const int entries = rows * s;
  const int q = kThreads / s;
  const int r = kThreads - q * s;
  const long long istep = q * idx_stride + r;
  const long long vstep = q * valid_stride + r;
  for (int s0 = 0; s0 < m; s0 += slab) {
    const int width = min(slab, m - s0);
    for (int base = 0; base < entries; base += kThreads * kPerThread) {
      // All of this round's loads before any use: registers, no
      // dependent loads; the row, the slot and both offsets stepped by
      // additions.
      int row = (base + threadIdx.x) / s;
      int k = base + threadIdx.x - row * s;
      long long io = (r0 + row) * idx_stride + k;
      long long vo = (r0 + row) * valid_stride + k;
      long long ids[kPerThread];
      float szs[kPerThread];
      uint8_t oks[kPerThread];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        ids[u] = -1;
        szs[u] = 0.0f;
        oks[u] = 0;
        if (base + u * kThreads + threadIdx.x < entries) {
          ids[u] = __ldg(idx + io);
          oks[u] = __ldg(valid + vo);
          szs[u] = __ldg(sizes + r0 + row);
        }
        row += q;
        k += r;
        io += istep;
        vo += vstep;
        if (k >= s) {
          k -= s;
          ++row;
          io += idx_stride - s;
          vo += valid_stride - s;
        }
      }
      if (base == 0) {  // zeroed while the loads land
        float4* const h4 = reinterpret_cast<float4*>(hist);
        for (int i = lane; i < slab / 4; i += 32) {
          h4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncwarp();
      }
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        if (base + u * kThreads + warp * 32 >= entries) break;  // warp-wide
        const long long id = ids[u];
        const bool in = id >= s0 && id < s0 + width;
        const int slot = in ? static_cast<int>(id - s0) : 0;
        const float w = __fmul_rn(szs[u], oks[u] ? 1.0f : 0.0f);
        // Every lane adds at once and tags its bin with its lane; a lane
        // that reads another's tag back shares its bin with that lane.
        float old = 0.0f;
        if (in) old = hist[slot];
        __syncwarp();
        if (in) {
          hist[slot] = __fadd_rn(old, w);
          tag[slot] = static_cast<uint8_t>(lane);
        }
        __syncwarp();
        const unsigned lost = __ballot_sync(kAll, in && tag[slot] != lane);
        if (lost != 0) {
          // A shared bin (any bin a lost lane holds): its lowest lane adds
          // the members' weights to the value they all read, one after
          // another in lane order, and writes the bin over the members'
          // racing adds.
          bool shared = false;
          for (unsigned l = lost; l; l &= l - 1u) {
            shared |= slot == __shfl_sync(kAll, slot, __ffs(l) - 1);
          }
          shared = shared && in;
          bool lowest = shared;
          float sum = old;
          for (unsigned l = __ballot_sync(kAll, shared); l; l &= l - 1u) {
            const int j = __ffs(l) - 1;
            const int slot_j = __shfl_sync(kAll, slot, j);
            const float w_j = __shfl_sync(kAll, w, j);
            if (shared && slot_j == slot) {
              lowest = lowest && j >= lane;
              sum = __fadd_rn(sum, w_j);
            }
          }
          if (lowest) hist[slot] = sum;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // The block partial: the warps' histograms in warp order, four bins a
    // thread.
    const float4* const s4 = reinterpret_cast<const float4*>(s_hist);
    for (int i = threadIdx.x; 4 * i < width; i += kThreads) {
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 v = s4[w * (slab / 4) + i];
        sum.x = __fadd_rn(sum.x, v.x);
        sum.y = __fadd_rn(sum.y, v.y);
        sum.z = __fadd_rn(sum.z, v.z);
        sum.w = __fadd_rn(sum.w, v.w);
      }
      float* const dst =
          partial + static_cast<size_t>(blockIdx.x) * ld + s0 + 4 * i;
      const int left = width - 4 * i;
      dst[0] = sum.x;
      if (left > 1) dst[1] = sum.y;
      if (left > 2) dst[2] = sum.z;
      if (left > 3) dst[3] = sum.w;
    }
    __syncthreads();
  }
  if (out == nullptr) return;  // the sharded route: partials only

  // First level: the last block of each group of kGroup sums the group's
  // partials in index order; second: the last of those sums the groups.
  const int parts = gridDim.x;
  const int groups = (parts + kGroup - 1) / kGroup;
  const int g = blockIdx.x / kGroup;
  const int first = g * kGroup;
  const int count = min(kGroup, parts - first);
  if (!last_to_arrive(tickets + g, count)) return;
  const float* const part_rows = partial + static_cast<size_t>(first) * ld;
  if (groups == 1) {
    sum_block_rows(part_rows, count, ld, out, m);
    return;
  }
  sum_block_rows(part_rows, count, ld,
                 group_sum + static_cast<size_t>(g) * ld, m);
  if (!last_to_arrive(tickets + groups, groups)) return;
  sum_block_rows(group_sum, groups, ld, out, m);
}

// The combine of the sharded route: for each instance, the same two-level
// sum as the launch's (groups of kGroup partials in index order, then the
// groups in order), over partials gathered from several row blocks.
__global__ void __launch_bounds__(kCombineThreads)
load_combine_kernel(const float* __restrict__ partial,
                    float* __restrict__ out, int parts, int m) {
  const int i = blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= m) return;
  const int groups = (parts + kGroup - 1) / kGroup;
  if (groups <= 1) {
    out[i] = sum_rows(partial + i, parts, m);
    return;
  }
  float sum = 0.0f;
  for (int g = 0; g < groups; ++g) {
    const int first = g * kGroup;
    sum = __fadd_rn(sum, sum_rows(partial + static_cast<size_t>(first) * m + i,
                                  min(kGroup, parts - first), m));
  }
  out[i] = sum;
}

// Opts the kernel into more than 48 KB of dynamic shared memory, once per
// device (the attribute is per device).
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(load_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_relaxed);
  }
  return err;
}

}  // namespace

// Plain C interface, bound with ctypes. The wrapper checks dtypes, shapes
// and strides, and owns the memory: the block partials f32[parts, ld]
// (parts = ceil(n / kRows), rows ld >= m apart, ld a multiple
// of 4 with an output), the group sums f32[groups, ld] (groups =
// ceil(parts / kGroup)) and the tickets int32[groups + 1], zero before the
// first launch and left zero by every launch. Returns the
// cudaGetLastError() code after the launch (0 = launched). A null `out`
// stops after the block partials, for a combine over the partials of
// several row blocks (mm_load_combine: each block's partials in order).
extern "C" {

int mm_implied_load(const void* idx, const void* valid, const void* sizes,
                    void* partial, void* group_sum, void* out, void* tickets,
                    int n, int s, long long idx_stride,
                    long long valid_stride, int m, int ld, void* stream) {
  if (n <= 0 || s <= 0 || m <= 0 || idx_stride < s || valid_stride < s ||
      static_cast<long long>(kRows) * s > INT_MAX / 2 || ld < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out != nullptr &&
      (group_sum == nullptr || tickets == nullptr || ld % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int parts = (n + kRows - 1) / kRows;
  const int slab = (((m < kMaxSlab ? m : kMaxSlab) + 3) / 4) * 4;
  const int smem = kWarps * slab * 5;  // f32 bins and a byte tag each
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  load_kernel<<<parts, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(sizes), static_cast<float*>(partial),
      static_cast<float*>(group_sum), static_cast<float*>(out),
      static_cast<int*>(tickets), n, s, idx_stride, valid_stride, m, ld,
      slab);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = the two-level fixed-order sum of partial[0..parts)[i]: the
// combine, over block partials gathered from several row blocks.
int mm_load_combine(const void* partial, void* out, int parts, int m,
                    void* stream) {
  if (parts <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  load_combine_kernel<<<(m + kCombineThreads - 1) / kCombineThreads,
                        kCombineThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), parts, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
