// groupby_sum: per-slot f32 sums of masked columns, out[k, c] = sum of
// vals_c[i] over the rows i with codes[i] == k and masks_c[i] set,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:92
// `matmul_groupby_sum` (route `dense_accumulate`, :257), the f32
// accumulate of the dense groupby (relational.py:982) and of the hashed
// groupby (ops/groupby.py:610). On the TPU a sequential grid walked
// 512-row blocks, built a [BLK, K] one-hot of the codes and contracted
// the pre-masked [N, C] value stack against it on the MXU, carrying the
// [C, K] sums in VMEM from block to block. Hopper has no use for the
// one-hot: a row adds its values to its own slot. Blocks run in
// parallel and in no order, so each block keeps a private [C_tile, K]
// histogram in shared memory:
//
//   1. zero the histogram;
//   2. walk the block's rows in a grid-stride loop; a row whose code is
//      in [0, K) adds, for each column whose mask is set, its value (or
//      1.0 for a column given no values: a count) with a shared-memory
//      atomicAdd;
//   3. after __syncthreads, add every nonzero entry into the global
//      [K, C] output with a global atomicAdd.
//
// The grid is the number of blocks that fit on the SMs at once, so there
// are few merges. Codes outside [0, K) add nothing, like the one-hot.
// Every launch is this one kernel: when C columns of K slots do not fit
// the shared memory a block can have (227 KB on an H100), the host entry
// launches it again for the next tile of columns.
//
// The interface is per-column pointers and bool masks, not the
// reference's stacked, pre-masked [N, C] f32 values: the callers' plans
// repeat masks (a count and a sum of one column share one) and mostly
// count (a ones column needs no values at all), so a stack would be
// written and read at 4 B a row a column. Bound: the codes (4 B a row),
// each distinct value column (4 B a row) and each distinct mask (1 B a
// row) read once, the [K, C] output written once; a few additions a
// row, so device-memory bandwidth bounds it (3.35 TB/s on an H100 SXM).
// Contention: at K = 64 every thread of a block adds into the same few
// hundred shared-memory words, yet on an H100 at 2^24 rows the code and
// mask loads alone take ~80% of the kernel's time (PERF.md), so the
// next step is several rows a thread in wider loads, not replicated
// sub-histograms.
//
// Contract (checked by the Python wrapper): n >= 1, 1 <= k <= 4096,
// 1 <= c_total, codes int32 [n], each values pointer f32 [n] or null,
// each mask bool [n], out f32 [k, c_total] zeroed, all device memory on
// the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCols = 16;  // columns of one launch (kernel parameters)

struct ColTile {
  const float* vals[kMaxCols];   // null: the column is all ones
  const uint8_t* masks[kMaxCols];
};

__global__ void __launch_bounds__(kThreads)
groupby_sum_tile(const int32_t* __restrict__ codes, int64_t n, int k,
                 ColTile tile, int c_tile, float* __restrict__ out,
                 int c_total, int c0) {
  extern __shared__ float hist[];  // [c_tile][k]
  // the tile's pointers, staged in shared memory with static indices so
  // the row loop indexes them without a local-memory copy of `tile`
  __shared__ const float* vals[kMaxCols];
  __shared__ const uint8_t* masks[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (threadIdx.x == c) {
      vals[c] = tile.vals[c];
      masks[c] = tile.masks[c];
    }
  }
  const int cells = c_tile * k;
  for (int j = threadIdx.x; j < cells; j += blockDim.x) hist[j] = 0.f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int code = codes[i];
    if ((unsigned)code >= (unsigned)k) continue;
    for (int c = 0; c < c_tile; ++c) {
      if (!masks[c][i]) continue;
      const float v = vals[c] ? vals[c][i] : 1.f;
      atomicAdd(&hist[c * k + code], v);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const float v = hist[j];
    if (v != 0.f) {
      const int c = j / k;
      atomicAdd(&out[(int64_t)(j - c * k) * c_total + c0 + c], v);
    }
  }
}

}  // namespace

// Columns of one launch at k slots (<= c_total), from the shared memory a
// block may opt in to on the current device; or the cudaError_t of a
// failed query, negated.
static int tile_cols(int k, int c_total) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return -(int)err;
  // the kernel's static shared memory (the staged pointers) counts too
  smem_max -= 2 * kMaxCols * (int)sizeof(void*);
  int c_tile = smem_max / (k * (int)sizeof(float));
  if (c_tile > kMaxCols) c_tile = kMaxCols;
  if (c_tile > c_total) c_tile = c_total;
  return c_tile;
}

extern "C" int groupby_sum_tile_cols(int k, int c_total) {
  return tile_cols(k, c_total);
}

// Launch the kernel on `stream` once per tile of columns; `vals` and
// `masks` are host arrays of c_total device pointers. Returns the
// cudaError_t of the first call that failed (0 = success).
extern "C" int groupby_sum_launch(const void* codes, int64_t n, int k,
                                  const void* const* vals,
                                  const void* const* masks, int c_total,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  const int c_tile = tile_cols(k, c_total);
  if (c_tile < 0) return -c_tile;
  if (c_tile < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int per_col = k * (int)sizeof(float);
  const size_t smem = (size_t)c_tile * per_col;
  err = cudaFuncSetAttribute(groupby_sum_tile,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, groupby_sum_tile, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t fit = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < c_total; c0 += c_tile) {
    const int width = c_total - c0 < c_tile ? c_total - c0 : c_tile;
    ColTile tile = {};
    for (int c = 0; c < width; ++c) {
      tile.vals[c] = (const float*)vals[c0 + c];
      tile.masks[c] = (const uint8_t*)masks[c0 + c];
    }
    groupby_sum_tile<<<grid, kThreads, (size_t)width * per_col, s>>>(
        (const int32_t*)codes, n, k, tile, width, (float*)out, c_total, c0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
