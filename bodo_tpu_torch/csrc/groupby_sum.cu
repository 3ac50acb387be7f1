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
// parallel and in no order, so each block keeps private [C_tile, K]
// histograms in shared memory:
//
//   1. zero the histograms;
//   2. walk the block's rows in a grid-stride loop, kRows consecutive
//      rows a thread a step: one 16-byte load of codes per 4 rows, one
//      kRows-byte load per distinct mask and one 16-byte load per 4 rows
//      of each distinct value column, every load of a step issued before
//      its first atomic; then each row whose code is in [0, K) adds, for
//      each column whose mask is set, its value (or 1.0 for a column
//      given no values: a count) with a shared-memory atomicAdd into its
//      lane's copy of the histogram;
//   3. after __syncthreads, sum each cell's copies and add every nonzero
//      sum into the global [K, C] output with a global atomicAdd.
//
// Copies: a block keeps up to 32 copies of its histogram, interleaved
// word by word, and lane l adds into copy l % copies. At 32 copies every
// lane of a warp adds into its own bank, so random codes over a few
// slots no longer serialize the atomics on bank and address conflicts
// (at K = 64, C = 4 one copy took 0.165 ms on an H100, 32 copies 0.101;
// PERF.md). Copies are as many as fit 48 KB; at K = 4096 one.
//
// The column count of a launch is a template parameter, so the tile's
// column pointers are kernel parameters read at constant indices and the
// step's loads sit in registers. Columns that share a mask (a count and a
// sum of one column) or values (a sum and a mean) are found once per
// thread by comparing the pointers; a step loads each distinct array once
// and copies it to the columns that share it, and a column equal to an
// earlier one in both (the dense plan's present count and a count of a
// column without nulls) adds nothing and takes the earlier column's
// sums. Arrays that are views off their alignment (or the ragged end)
// take scalar loads.
//
// The grid is the number of blocks that fit on the SMs at once, so there
// are few merges. Codes outside [0, K) add nothing, like the one-hot.
// Every launch is this one kernel: when C columns of K slots do not fit
// the shared memory a block can have (227 KB on an H100), the host entry
// launches it again for the next tile of columns.
//
// The interface is per-column pointers and bool masks, not the
// reference's stacked, pre-masked [N, C] f32 values: the callers' plans
// repeat masks and mostly count (a ones column needs no values at all),
// so a stack would be written and read at 4 B a row a column. Bound: the
// codes (4 B a row), each distinct value column (4 B a row) and each
// distinct mask (1 B a row) read once, the [K, C] output written once; a
// few additions a row, so device-memory bandwidth bounds it (3.35 TB/s on
// an H100 SXM). One row a thread a step, through a chain of dependent
// loads (code, compare, a mask pointer from shared memory, the mask, the
// value), took 2.8x the bound with every mask unset; 4 rows a thread in
// wide loads take 1.3x.
//
// Contract (checked by the Python wrapper): n >= 1, 1 <= k <= 4096,
// 1 <= c_total, codes int32 [n], each values pointer f32 [n] or null,
// each mask bool [n], out f32 [k, c_total] zeroed, all device memory on
// the current device.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 4;      // consecutive rows a thread takes a step
constexpr int kMaxCols = 16;  // columns of one launch (kernel parameters)
// copies of the histogram a block keeps, interleaved word by word
// (a power of two <= 32): lane l adds into copy l % copies, so at 32
// copies every lane of a warp adds into its own bank; as many as fit
// kCopyBytes of shared memory
constexpr int kMaxCopies = 32;
constexpr int kCopyBytes = 48 * 1024;
static_assert(kRows == 4 || kRows == 8, "a mask word is 4 or 8 bytes");

using MaskWord = typename std::conditional<kRows == 8, unsigned long long,
                                           unsigned>::type;

struct ColTile {
  const float* vals[kMaxCols];   // null: the column is all ones
  const uint8_t* masks[kMaxCols];
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

__device__ __forceinline__ void load_codes(const int32_t* __restrict__ p,
                                           int64_t i, int64_t n, bool vec,
                                           int (&c)[kRows]) {
  if (vec && i + kRows <= n) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(p + i) + q);
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) c[r] = i + r < n ? __ldcs(p + i + r) : -1;
  }
}

__device__ __forceinline__ MaskWord load_mask(const uint8_t* __restrict__ p,
                                              int64_t i, int64_t n,
                                              bool vec) {
  if (vec && i + kRows <= n)
    return __ldcs(reinterpret_cast<const MaskWord*>(p + i));
  MaskWord m = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (i + r < n) m |= (MaskWord)p[i + r] << (8 * r);
  return m;
}

__device__ __forceinline__ void load_vals(const float* __restrict__ p,
                                          int64_t i, int64_t n, bool vec,
                                          float (&v)[kRows]) {
  if (vec && i + kRows <= n) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p + i) + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = i + r < n ? __ldcs(p + i + r) : 0.f;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
groupby_sum_tile(const int32_t* __restrict__ codes, int64_t n, int k,
                 ColTile tile, int copies, float* __restrict__ out,
                 int c_total, int c0) {
  // [C][k][copies]: copy j of cell (c, code) at (c * k + code) * copies + j
  extern __shared__ float hist[];
  for (int j = threadIdx.x; j < C * k * copies; j += blockDim.x)
    hist[j] = 0.f;
  float* mine = hist + (threadIdx.x & (copies - 1));
  // 4-bit field c of msrc / vsrc / dsrc: the first column of the tile
  // with column c's mask / values / both (a column equal to an earlier
  // one adds nothing and takes that column's sums); bit c of mvec / vvec:
  // c's mask / values aligned for the wide loads
  uint64_t msrc = 0, vsrc = 0, dsrc = 0;
  unsigned mvec = 0, vvec = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int m = c, v = c, d = c;
#pragma unroll
    for (int e = c - 1; e >= 0; --e) {
      if (tile.masks[e] == tile.masks[c]) m = e;
      if (tile.vals[e] == tile.vals[c]) v = e;
      if (tile.masks[e] == tile.masks[c] && tile.vals[e] == tile.vals[c])
        d = e;
    }
    msrc |= (uint64_t)m << (4 * c);
    vsrc |= (uint64_t)v << (4 * c);
    dsrc |= (uint64_t)d << (4 * c);
    mvec |= (unsigned)aligned(tile.masks[c], sizeof(MaskWord)) << c;
    vvec |= (unsigned)aligned(tile.vals[c], 16) << c;
  }
  const bool cvec = aligned(codes, 16);
  __syncthreads();

  const int64_t step = (int64_t)gridDim.x * blockDim.x * kRows;
  for (int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kRows;
       i < n; i += step) {
    int code[kRows];
    MaskWord mw[C];
    float v[C][kRows];
    load_codes(codes, i, n, cvec, code);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mw[c] = 0;
      if (((msrc >> (4 * c)) & 15) == c)
        mw[c] = load_mask(tile.masks[c], i, n, (mvec >> c) & 1);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[c][r] = 1.f;
      if (tile.vals[c] && ((vsrc >> (4 * c)) & 15) == c)
        load_vals(tile.vals[c], i, n, (vvec >> c) & 1, v[c]);
    }
#pragma unroll
    for (int c = 1; c < C; ++c) {
      const int m = (msrc >> (4 * c)) & 15, vs = (vsrc >> (4 * c)) & 15;
#pragma unroll
      for (int e = 0; e < c; ++e) {
        if (m == e) mw[c] = mw[e];
        if (vs == e) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[c][r] = v[e][r];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if ((unsigned)code[r] >= (unsigned)k) continue;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (((dsrc >> (4 * c)) & 15) == c && ((mw[c] >> (8 * r)) & 0xffu))
          atomicAdd(&mine[(c * k + code[r]) * copies], v[c][r]);
    }
  }
  __syncthreads();
  // one copy: a thread per cell; else a warp per cell, lane j adding
  // copies j, j + 32, ...
  const int lane = threadIdx.x % 32;
  const bool by_warp = copies > 1;
  const int first = by_warp ? threadIdx.x / 32 : threadIdx.x;
  const int cell_step = by_warp ? blockDim.x / 32 : blockDim.x;
  for (int j = first; j < C * k; j += cell_step) {
    const int c = j / k;
    const int src = (int)((dsrc >> (4 * c)) & 15) * k + (j - c * k);
    float x = 0.f;
    if (by_warp) {
      for (int r = lane; r < copies; r += 32) x += hist[src * copies + r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    } else {
      x = hist[src];
    }
    if ((!by_warp || lane == 0) && x != 0.f)
      atomicAdd(&out[(int64_t)(j - c * k) * c_total + c0 + c], x);
  }
}

// Launch the kernel for C columns: the grid the SMs hold at once, with
// as many histogram copies as kCopyBytes holds (one if only one fits the
// block's shared memory).
template <int C>
cudaError_t launch_tile(const int32_t* codes, int64_t n, int k,
                        const ColTile& tile, float* out, int c_total, int c0,
                        int sms, cudaStream_t s) {
  const int cells = C * k;
  int copies = kMaxCopies;
  while (copies > 1 &&
         (size_t)copies * cells * sizeof(float) > (size_t)kCopyBytes)
    copies /= 2;
  const size_t smem = (size_t)copies * cells * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      groupby_sum_tile<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, groupby_sum_tile<C>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t rows_a_block = (int64_t)kThreads * kRows;
  const int64_t want = (n + rows_a_block - 1) / rows_a_block;
  const int64_t fit = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  groupby_sum_tile<C><<<grid, kThreads, smem, s>>>(
      codes, n, k, tile, copies, out, c_total, c0);
  return cudaGetLastError();
}

using TileLauncher = cudaError_t (*)(const int32_t*, int64_t, int,
                                     const ColTile&, float*, int, int, int,
                                     cudaStream_t);

// kLaunchers[c - 1] launches c columns
const TileLauncher kLaunchers[kMaxCols] = {
    launch_tile<1>,  launch_tile<2>,  launch_tile<3>,  launch_tile<4>,
    launch_tile<5>,  launch_tile<6>,  launch_tile<7>,  launch_tile<8>,
    launch_tile<9>,  launch_tile<10>, launch_tile<11>, launch_tile<12>,
    launch_tile<13>, launch_tile<14>, launch_tile<15>, launch_tile<16>};

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
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < c_total; c0 += c_tile) {
    const int width = c_total - c0 < c_tile ? c_total - c0 : c_tile;
    ColTile tile = {};
    for (int c = 0; c < width; ++c) {
      tile.vals[c] = (const float*)vals[c0 + c];
      tile.masks[c] = (const uint8_t*)masks[c0 + c];
    }
    err = kLaunchers[width - 1]((const int32_t*)codes, n, k, tile,
                                         (float*)out, c_total, c0, sms, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
