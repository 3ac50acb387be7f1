// partition_rank: every live row's stable rank inside its destination
// bucket, and the row count of each bucket, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:432
// `_partition_rank_kernel` (route `partition_rank`, :509), which
// parallel/shuffle.py `bucket_rows` calls on every shuffle to find where
// each row lands in its send bucket. On the TPU one sequential grid
// walked the rows, computing a block's in-block rank as a strict
// lower-triangular [BLK, BLK] x one-hot [BLK, K] matmul in f32 and
// carrying a running per-bucket base in VMEM from block to block; f32
// kept it exact only below 2^24 rows. Hopper runs blocks in parallel and
// in no order, so the carry becomes a second pass, and the ranks are
// exact int32 at any N:
//
//   1. tile_histogram: one warp per tile of `tile` rows counts the tile's
//      rows per bucket in shared memory (lanes with equal buckets meet
//      in __match_any_sync and their lowest lane adds the group's size),
//      then writes tile_counts[bucket][tile];
//   2. scan_tiles: one block per bucket turns its row of tile counts
//      into the exclusive prefix over tiles (in place) and writes the
//      bucket's total;
//   3. tile_rank: one warp per tile walks its rows in row order, 32 at
//      a time: rank = running[bucket] + the number of lower lanes in the
//      same bucket, and the group's lowest lane advances running[bucket].
//
// Rows that are not ok (or whose bucket is outside [0, K)) get rank -1
// and are not counted. K <= 4096 keeps the running counts in 16 KB of
// shared memory.
//
// Bound: every row's bucket (4 B) and ok flag (1 B) are read once and
// its rank (4 B) written once: 9 B a row, plus 4 B a bucket, no
// arithmetic to speak of, so device-memory bandwidth bounds it (3.35 TB/s
// on an H100 SXM; 5M rows, one shard of the 20M-row taxi path, move 45
// MB, ~13 us). Passes 1 and 3 both read the buckets; the tile counts
// (K * N / tile ints) are small next to them at the main path's K = 4.
// Each lane loads 8 rows' buckets before it works on them, so a warp
// has its loads in flight together.
//
// Contract (checked by the Python wrapper): n >= 1, 1 <= k <= 4096,
// tile a multiple of 256, tile_counts holds k * ceil(n / tile) int32,
// all pointers are device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kChunk = 8;  // rows per lane loaded ahead
constexpr int kScanThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// bucket of row i, or -1 when the row takes no part
__device__ __forceinline__ int bucket_of(const int32_t* __restrict__ dest,
                                         const uint8_t* __restrict__ ok,
                                         int64_t i, int64_t end, int k) {
  if (i >= end || !ok[i]) return -1;
  const int d = dest[i];
  return (d >= 0 && d < k) ? d : -1;
}

__global__ void __launch_bounds__(kWarp)
tile_histogram(const int32_t* __restrict__ dest,
               const uint8_t* __restrict__ ok, int64_t n, int k, int tile,
               int32_t* __restrict__ tile_counts, int64_t n_tiles) {
  extern __shared__ int32_t cnt[];  // [k]
  const int lane = threadIdx.x;
  const int64_t t = blockIdx.x;
  for (int b = lane; b < k; b += kWarp) cnt[b] = 0;
  __syncwarp();
  const int64_t start = t * tile;
  const int64_t end = start + tile < n ? start + tile : n;
  for (int64_t base = start; base < end; base += kWarp * kChunk) {
    int bk[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      bk[j] = bucket_of(dest, ok, base + j * kWarp + lane, end, k);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const unsigned grp = __match_any_sync(kFull, bk[j]);
      if (bk[j] >= 0 && lane == __ffs(grp) - 1) cnt[bk[j]] += __popc(grp);
      __syncwarp();
    }
  }
  for (int b = lane; b < k; b += kWarp)
    tile_counts[(int64_t)b * n_tiles + t] = cnt[b];
}

__global__ void __launch_bounds__(kScanThreads)
scan_tiles(int32_t* __restrict__ tile_counts, int64_t n_tiles,
           int32_t* __restrict__ counts) {
  constexpr int kWarps = kScanThreads / kWarp;
  __shared__ int32_t warp_sums[kWarps];
  int32_t* row = tile_counts + (int64_t)blockIdx.x * n_tiles;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int32_t carry = 0;
  for (int64_t base = 0; base < n_tiles; base += kScanThreads) {
    const int64_t t = base + threadIdx.x;
    const int32_t v = t < n_tiles ? row[t] : 0;
    int32_t x = v;  // inclusive scan inside the warp
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (t < n_tiles) row[t] = carry + before;
    carry += warp_sums[kWarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kWarp)
tile_rank(const int32_t* __restrict__ dest, const uint8_t* __restrict__ ok,
          int64_t n, int k, int tile, const int32_t* __restrict__ tile_base,
          int64_t n_tiles, int32_t* __restrict__ rank) {
  extern __shared__ int32_t running[];  // [k]
  const int lane = threadIdx.x;
  const int64_t t = blockIdx.x;
  for (int b = lane; b < k; b += kWarp)
    running[b] = tile_base[(int64_t)b * n_tiles + t];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int64_t start = t * tile;
  const int64_t end = start + tile < n ? start + tile : n;
  for (int64_t base = start; base < end; base += kWarp * kChunk) {
    int bk[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      bk[j] = bucket_of(dest, ok, base + j * kWarp + lane, end, k);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const unsigned grp = __match_any_sync(kFull, bk[j]);
      const int r = bk[j] >= 0 ? running[bk[j]] + __popc(grp & lower) : -1;
      __syncwarp();
      if (bk[j] >= 0 && lane == __ffs(grp) - 1) running[bk[j]] += __popc(grp);
      __syncwarp();
      const int64_t i = base + j * kWarp + lane;
      if (i < end) rank[i] = r;
    }
  }
}

}  // namespace

// Launch the three passes on `stream`; returns the cudaError_t of the
// first launch that failed (0 = success).
extern "C" int partition_rank_launch(const void* dest, const void* ok,
                                     void* rank, void* counts,
                                     void* tile_counts, int64_t n, int k,
                                     int tile, void* stream) {
  if (n <= 0) return 0;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const size_t smem = (size_t)k * sizeof(int32_t);
  cudaStream_t s = (cudaStream_t)stream;
  tile_histogram<<<(unsigned)n_tiles, kWarp, smem, s>>>(
      (const int32_t*)dest, (const uint8_t*)ok, n, k, tile,
      (int32_t*)tile_counts, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles<<<k, kScanThreads, 0, s>>>((int32_t*)tile_counts, n_tiles,
                                        (int32_t*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_rank<<<(unsigned)n_tiles, kWarp, smem, s>>>(
      (const int32_t*)dest, (const uint8_t*)ok, n, k, tile,
      (const int32_t*)tile_counts, n_tiles, (int32_t*)rank);
  return (int)cudaGetLastError();
}
