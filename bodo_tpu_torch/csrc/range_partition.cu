// range_partition: out[i] = the number of splitters <= pk[i], i.e.
// searchsorted(splitters, pk, side='right') over uint64 keys and sorted
// uint64 splitters, for all shards of a sample-sort pass in one launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:654
// `_range_partition_kernel` (route `range_partition`, :701), the
// destination step of the distributed sample sort (bodo_tpu/ops/sort.py
// :113): each row's partition key goes to the shard whose splitter range
// holds it. The TPU has no 64-bit integer compare in its vector unit, so
// it split keys and splitters into four 16-bit planes held in f32 and
// decided the order plane by plane against every splitter at once (a
// [BLK, n_spl] compare). Hopper compares unsigned 64-bit integers
// directly (never as signed: partition keys with the top bit set, and
// the padding key 0xFFFFFFFFFFFFFFFF, order above every other; a
// duplicated splitter counts once for each copy).
//
// One launch takes up to kMaxShards shards, each a pointer passed as a
// kernel parameter (no copy into one tensor), every shard n keys long,
// and shard j's sorted splitters as row j of a [shards, n_spl] table.
// It writes the shards' destinations one after another into one int32
// column: the concatenation the shuffle takes.
//
// Bound: every key (8 B) is read once and every destination (4 B)
// written once, plus the splitters: 12 B a row, so device memory bounds
// it (3.35 TB/s on an H100 SXM). At the sort's sizes (4 shards of
// 885,504 keys, 3 splitters: 42.5 MB, 12.7 us) the launch is short, so
// what costs is latency: the first key load of a thread waiting behind
// the splitters, one load in flight a thread, one launch a shard. So:
//
//   keys first   a thread owns K consecutive keys of one tile of
//                kThreads * K keys (K = kSmallKeys or kLargeKeys) and
//                issues their loads as 16-byte loads (a key pointer 8
//                bytes off 16-byte alignment reads its first and last key
//                alone) before it touches a splitter; a block that walks
//                several tiles loads the next tile's keys before it
//                decides the current one;
//   splitters    off the critical path. Small form, n_spl <= kSmallMax:
//                every lane of a warp reads the tile's splitter row at
//                the same addresses through the read-only path (one
//                broadcast, then cached) and counts sum_j (spl_j <= x),
//                four splitters a step, the row's tail masked. Large
//                form, up to 4096 splitters: the block stages the tile's
//                row in shared memory after its key loads are issued, as
//                two arrays of 32-bit halves, and each key takes a fixed
//                ceil(log2(n_spl + 1))-step branch-free binary search
//                there, reading a splitter's low half only where the high
//                halves tie; blocks are persistent (kLargeWaves waves)
//                and walk contiguous tiles, so a block stages a row once
//                a shard it meets, not once a tile;
//   stores       K destinations as 16-byte stores at the keys' place in
//                the concatenated column (16-byte aligned: the wrapper
//                allocates it and each launch starts kMaxShards * n
//                destinations in).
// A tile that spans two shards (a shard shorter than a tile, or a shard
// boundary inside it) and the last, partial run of the column go key by
// key, each key with its own shard's row from device memory.
//
// The constants come from workloads/rank_sum_sweep.py (an H100 80GB HBM3
// at 700 W; S = 1 and 4 shards of 2^16 to 2^24 keys, 1 to 4095
// splitters; times against the variant with every constant as here but
// 2 keys a thread in the large form, over launches of 2^20 keys and up):
//   - the small form up to 32 splitters: at 63 splitters the count took
//     1.56-1.94x the search's time; at 7 it ran at 64-91% of the bound
//     from 2^22 keys a launch up;
//   - 8 keys a thread in the small form: 2 took 1.03-1.18x, 4 took
//     0.97-1.05x (1.05x on the sort's pass of 4 x 885,504 keys); 4 in the
//     large form: 0.85-0.96x the time of 2 at 63 splitters, 0.96-1.05x at
//     4095 (8: up to 1.29x at 4095);
//   - 256 threads a block: 512 took 1.00-1.10x in the small form and up
//     to 1.23x at 4095 splitters, 128 took 0.97-1.03x in the small form
//     and up to 1.11x at 4095;
//   - one tile a block in the small form: persistent blocks (kSmallWaves
//     1) took 0.94x on the sort's pass but 1.07-1.12x at 2^24 keys;
//     persistent blocks in the large form: a block a tile (kLargeWaves 0,
//     a row staged a tile) took 1.09-1.35x at 4095 splitters;
//   - the split halves: 64-bit words (kSplitWords 0) took 1.14-1.39x at
//     4095 splitters (0.78-0.94x at 63).

// Contract (checked by the Python wrapper): 1 <= shards <= kMaxShards,
// n >= 1 keys a shard, 0 <= n_spl <= 4096, each splitter row sorted
// ascending as unsigned 64-bit integers, every key pointer 8-byte
// aligned, out 16-byte aligned, all pointers device memory on the
// current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the __ldg overloads name unsigned long long, which uint64_t may not be
using u64 = unsigned long long;

constexpr int kThreads = 256;     // threads a block
constexpr int kSmallKeys = 8;     // consecutive keys a thread a tile, small
constexpr int kLargeKeys = 4;     // and large form
constexpr int kSmallMax = 32;     // the small form's most splitters
constexpr int kSmallWaves = 0;    // 0: one tile a block (no persistence)
constexpr int kLargeWaves = 1;    // resident waves of the large form
// the large form's staged row: 0, 64-bit words; 1, the high and the low
// 32-bit halves in two arrays (a step reads a key's low half only where
// the high halves tie)
constexpr int kSplitWords = 1;
constexpr int kMaxShards = 16;    // shards a launch takes
constexpr int kMaxSplitters = 4096;

static_assert((kSmallKeys == 2 || kSmallKeys % 4 == 0) &&
                  (kLargeKeys == 2 || kLargeKeys % 4 == 0),
              "keys a thread: 2, or a multiple of 4");
static_assert(kMaxShards % 4 == 0, "a launch's output must stay aligned");

struct Shards {
  const u64* p[kMaxShards];
};

// the shard of global key g (shard j holds keys [j n, (j + 1) n)), from
// inv = ceil(2^64 / n) (2^64 - 1 for n = 1): the high product is the
// quotient or one off it
__device__ __forceinline__ int shard_of(int64_t g, int64_t n, u64 inv) {
  int64_t q = (int64_t)__umul64hi((u64)g, inv);
  if (q * n > g)
    --q;
  else if ((q + 1) * n <= g)
    ++q;
  return (int)q;
}

// K keys from kp as 16-byte loads; kp is 8-byte aligned
template <int K>
__device__ __forceinline__ void load_keys(const u64* kp, u64 (&x)[K]) {
  if ((reinterpret_cast<uintptr_t>(kp) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 2) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(kp + q));
      x[q] = v.x;
      x[q + 1] = v.y;
    }
  } else {
    x[0] = __ldg(kp);
#pragma unroll
    for (int q = 1; q + 1 < K; q += 2) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(kp + q));
      x[q] = v.x;
      x[q + 1] = v.y;
    }
    x[K - 1] = __ldg(kp + K - 1);
  }
}

// small form: c[q] = sum_j (row[j] <= x[q]), four splitters a step
template <int K>
__device__ __forceinline__ void count_small(const u64* __restrict__ row,
                                            int n_spl, const u64 (&x)[K],
                                            int (&c)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) c[q] = 0;
#pragma unroll
  for (int j0 = 0; j0 < kSmallMax; j0 += 4) {
    if (j0 >= n_spl) break;
    u64 s[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      s[t] = j0 + t < n_spl ? __ldg(row + j0 + t) : 0ull;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < K; ++q) c[q] += (j0 + t < n_spl) & (s[t] <= x[q]);
  }
}

// large form: c[q] = the number of row[j] <= x[q], by a branch-free
// binary search over the n_spl + 1 answers; kShared: row is in shared
// memory, else in device memory (read-only path)
template <bool kShared, int K>
__device__ __forceinline__ void search(const u64* __restrict__ row,
                                       int n_spl, const u64 (&x)[K],
                                       int (&c)[K]) {
#pragma unroll
  for (int q = 0; q < K; ++q) c[q] = 0;
  for (int len = n_spl + 1; len > 1;) {  // answers c[q] .. c[q] + len - 1
    const int half = len >> 1;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int at = c[q] + half - 1;
      u64 v;
      if constexpr (kShared)
        v = row[at];
      else
        v = __ldg(row + at);
      c[q] = v <= x[q] ? c[q] + half : c[q];
    }
    len -= half;
  }
}

// the large form's search over a row staged as high and low halves
template <int K>
__device__ __forceinline__ void search_split(const uint32_t* hi,
                                             const uint32_t* lo, int n_spl,
                                             const u64 (&x)[K], int (&c)[K]) {
  uint32_t xh[K], xl[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    xh[q] = (uint32_t)(x[q] >> 32);
    xl[q] = (uint32_t)x[q];
    c[q] = 0;
  }
  for (int len = n_spl + 1; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int at = c[q] + half - 1;
      const uint32_t h = hi[at];
      const uint32_t l = h == xh[q] ? lo[at] : 0u;
      const bool le = h < xh[q] || (h == xh[q] && l <= xl[q]);
      c[q] = le ? c[q] + half : c[q];
    }
    len -= half;
  }
}

template <bool kLarge>
__device__ __forceinline__ int count1(const u64* row, int n_spl, u64 key) {
  const u64 x[1] = {key};
  int c[1];
  if constexpr (kLarge)
    search<false>(row, n_spl, x, c);
  else
    count_small(row, n_spl, x, c);
  return c[0];
}

// one thread's run of a tile
struct Run {
  int64_t g0;     // its first key, in the launch's concatenated order
  const u64* kp;  // the key at g0 when the tile lies in one shard
  int sh;         // the tile's first shard
  bool one;       // the tile lies in one shard (tile-uniform)
  bool fast;      // one, and the run holds K keys
};

// the run of thread threadIdx.x in tile t of kThreads * K keys
template <int K>
__device__ __forceinline__ Run run_of(const Shards& pk, int64_t t, int64_t n,
                                      u64 inv, int64_t total) {
  constexpr int64_t kTile = (int64_t)kThreads * K;
  Run r;
  const int64_t first = t * kTile;
  const int64_t span = first + kTile < total ? kTile : total - first;
  r.sh = shard_of(first, n, inv);
  const int64_t at = first - r.sh * n;  // the tile's first key in its shard
  r.one = span <= n - at;
  r.g0 = first + (int64_t)threadIdx.x * K;
  r.fast = r.one && r.g0 + K <= first + span;
  r.kp = pk.p[r.sh] + (r.g0 - r.sh * n);
  return r;
}

template <int K>
__device__ __forceinline__ void store(int32_t* __restrict__ out,
                                      const int (&c)[K]) {
  if constexpr (K == 2) {
    *reinterpret_cast<int2*>(out) = make_int2(c[0], c[1]);
  } else {
#pragma unroll
    for (int q = 0; q < K; q += 4)
      *reinterpret_cast<int4*>(out + q) =
          make_int4(c[q], c[q + 1], c[q + 2], c[q + 3]);
  }
}

// Block b walks the contiguous tiles [t_begin, t_end): `per` tiles, one
// more for the first `extra` blocks (the launch divides the tiles).
template <bool kLarge>
__device__ __forceinline__ void partition(const Shards& pk,
                                          const u64* __restrict__ spl,
                                          int n_spl, int32_t* __restrict__ out,
                                          int64_t n, int s, u64 inv,
                                          int64_t per, int64_t extra) {
  constexpr int K = kLarge ? kLargeKeys : kSmallKeys;
  extern __shared__ u64 staged[];  // large form: one shard's row
  const int64_t total = n * s;
  const int64_t b = blockIdx.x;
  const int64_t t_begin = b * per + (b < extra ? b : extra);
  const int64_t t_end = t_begin + per + (b < extra);
  int staged_shard = -1;
  Run cur = run_of<K>(pk, t_begin, n, inv, total);
  u64 x[K];
  if (cur.fast) load_keys(cur.kp, x);
  for (int64_t t = t_begin; t < t_end; ++t) {
    Run next;
    u64 y[K];
    if (t + 1 < t_end) {  // the next tile's keys go out first
      next = run_of<K>(pk, t + 1, n, inv, total);
      if (next.fast) load_keys(next.kp, y);
    }
    if (kLarge && cur.one && cur.sh != staged_shard) {  // tile-uniform
      __syncthreads();  // the old row is no longer read
      const u64* row = spl + (int64_t)cur.sh * n_spl;
      for (int j = threadIdx.x; j < n_spl; j += kThreads) {
        const u64 v = __ldg(row + j);
        if constexpr (kSplitWords) {
          reinterpret_cast<uint32_t*>(staged)[j] = (uint32_t)(v >> 32);
          reinterpret_cast<uint32_t*>(staged)[n_spl + j] = (uint32_t)v;
        } else {
          staged[j] = v;
        }
      }
      __syncthreads();
      staged_shard = cur.sh;
    }
    if (cur.fast) {
      int c[K];
      if constexpr (kLarge && kSplitWords)
        search_split(reinterpret_cast<const uint32_t*>(staged),
                     reinterpret_cast<const uint32_t*>(staged) + n_spl,
                     n_spl, x, c);
      else if constexpr (kLarge)
        search<true>(staged, n_spl, x, c);
      else
        count_small(spl + (int64_t)cur.sh * n_spl, n_spl, x, c);
      store(out + cur.g0, c);
    } else {
      for (int q = 0; q < K; ++q) {  // key by key, each its own shard
        const int64_t g = cur.g0 + q;
        if (g >= total) break;
        const int sh = shard_of(g, n, inv);
        const u64 key = __ldg(pk.p[sh] + (g - sh * n));
        out[g] = count1<kLarge>(spl + (int64_t)sh * n_spl, n_spl, key);
      }
    }
    if (t + 1 < t_end) {
      cur = next;
#pragma unroll
      for (int q = 0; q < K; ++q) x[q] = y[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
range_partition_small(const __grid_constant__ Shards pk,
                      const u64* __restrict__ spl, int n_spl,
                      int32_t* __restrict__ out, int64_t n, int s, u64 inv,
                      int64_t per, int64_t extra) {
  partition<false>(pk, spl, n_spl, out, n, s, inv, per, extra);
}

__global__ void __launch_bounds__(kThreads)
range_partition_large(const __grid_constant__ Shards pk,
                      const u64* __restrict__ spl, int n_spl,
                      int32_t* __restrict__ out, int64_t n, int s, u64 inv,
                      int64_t per, int64_t extra) {
  partition<true>(pk, spl, n_spl, out, n, s, inv, per, extra);
}

}  // namespace

// 1 when a call with n_spl splitters takes the large form, else 0
extern "C" int range_partition_form(int n_spl) {
  return n_spl > kSmallMax ? 1 : 0;
}

// Launch on `stream` over s shards of n keys each: pks[j] the key pointer
// of shard j, splitters its row of n_spl at splitters + j * n_spl, out
// s * n destinations. Returns the cudaError_t of the launch (0 =
// success).
extern "C" int range_partition_launch(const void* const* pks,
                                      const void* splitters, void* out,
                                      int64_t n, int s, int n_spl,
                                      void* stream) {
  if (n <= 0) return 0;
  if (s < 1 || s > kMaxShards || n_spl < 0 || n_spl > kMaxSplitters)
    return (int)cudaErrorInvalidValue;
  Shards shards = {};
  for (int j = 0; j < s; ++j) shards.p[j] = (const u64*)pks[j];
  const bool large = n_spl > kSmallMax;
  const int64_t tile = (int64_t)kThreads * (large ? kLargeKeys : kSmallKeys);
  const int64_t tiles = (n * s + tile - 1) / tile;
  const size_t smem = large ? (size_t)n_spl * sizeof(u64) : 0;
  auto kernel = large ? range_partition_large : range_partition_small;
  const int waves = large ? kLargeWaves : kSmallWaves;
  int64_t blocks = tiles;
  if (waves > 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t cap = (int64_t)waves * sms * (per_sm > 0 ? per_sm : 1);
    blocks = tiles < cap ? tiles : cap;
  }
  const u64 inv = n == 1 ? ~0ull : ~0ull / (u64)n + 1;  // ceil(2^64 / n)
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      shards, (const u64*)splitters, n_spl, (int32_t*)out, n, s, inv,
      tiles / blocks, tiles % blocks);
  return (int)cudaGetLastError();
}
