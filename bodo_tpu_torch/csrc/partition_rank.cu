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
// in no order, so the carry becomes a single-pass scan with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), one scan per bucket, and the ranks are
// exact int32 at any N < 2^31. One launch a call, each row's bucket and
// ok flag read once.
//
// K <= 8 (the shuffles of up to 8 shards), 8192-row tiles of 512
// threads, as many blocks as the SMs hold, each looping over tiles:
//   1. claim the next tile in row order from a counter in the state (a
//      block's tiles come in row order, and every tile before the one
//      it holds is held or done by a running block, so no tile waits on
//      one that never runs); -1 once every tile is claimed;
//   2. each lane stages 4 consecutive rows a step, 4 steps, into shared
//      memory with cp.async (16 bytes of buckets, 4 of ok flags): the
//      rows are in flight without holding registers;
//   3. each warp counts its rows per bucket (packed 16-bit fields, one
//      __reduce_add_sync per 2 buckets); warp 0 scans the warps and
//      publishes the tile's aggregate as one packed word per 4 buckets
//      (14 bits a bucket);
//   4. the whole block reads the packed aggregates of the 2048 tiles
//      before it (4 a thread, one round trip, no chain through its
//      predecessors' look-backs), and for a tile further along the
//      inclusive prefix of the tile before those; a block reduction
//      gives the tile's exclusive base, and the tile publishes its
//      inclusive prefix per bucket;
//   5. each warp ranks its rows 128 at a time: a lane packs its 4 rows'
//      counts into 8-bit fields of one word per 4 buckets, a warp scan
//      of those words (shuffles) gives the lanes before it, the warp's
//      running counts sit in 16-bit fields of registers; ranks go out in
//      16-byte stores.
// K > 8, 8192-row tiles (at least twice K, so the state of K words a
// tile stays below half a word a row): rows in registers, 32 at a time
// in row order (moved to their lanes by shuffles), lanes of one bucket
// meeting in __match_any_sync, the warps' running counts in 16-bit
// shared memory [8][K]; each tile publishes its aggregate per bucket,
// one thread per bucket looks back one predecessor at a time (for all
// its buckets at once) to the nearest published prefix, and publishes
// its own.
//
// The state (caller's buffer): word 0 the tile counter; for K <= 8 two
// packed aggregate words per tile (generation in the top byte), then K
// prefix words per tile; for K > 8, K words per tile. A prefix word is
// (generation << 32 | flag << 31 | count), the flag set on an inclusive
// prefix (clear on an aggregate). A word whose generation is not this
// call's is not published yet: the caller passes a new generation, 1 to
// 255, each call and zeroes the state when it is allocated and when the
// generation wraps (one clear in 255 calls), so the words of one call
// never pass for those of another. Published words are self-contained
// and read and written with relaxed gpu-scope 64-bit accesses.
//
// Rows that are not ok (or whose bucket is outside [0, K)) get rank -1
// and are not counted.
//
// Bound: every row's bucket (4 B) and ok flag (1 B) are read once and
// its rank (4 B) written once: 9 B a row, plus 4 B a bucket, so
// device-memory bandwidth bounds it (3.35 TB/s on an H100 SXM; 5M rows,
// one shard of the 20M-row taxi path, move 45 MB, ~13 us).
//
// Contract (checked by the Python wrapper): n >= 1, n < 2^31, 1 <= k <=
// 4096, 1 <= gen <= 255 and new for the state since it was zeroed, state
// holds partition_rank_state_words(n, k) words on the stream's device,
// all pointers device memory; dest and ok may be views at any element
// offset (unaligned rows take 4-byte copies or plain loads).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 4096;
constexpr uint64_t kPrefixBit = 1ull << 31;
constexpr int kCounters = 256;  // state words of the tile counters

// the K <= 8 form
constexpr int kThreads = 512;   // threads a block
constexpr int kSteps = 4;       // 128-row steps a warp takes in a tile
constexpr int kSmallK = 8;
constexpr int kAggPer = 4;      // predecessors' aggregates a thread reads
constexpr int kTileRows = kThreads * 4 * kSteps;
constexpr int kAggBits = 14;    // a bucket's count in a packed aggregate
constexpr uint64_t kAggMask = (1ull << kAggBits) - 1;

// the K > 8 form
constexpr int kGenThreads = 256;
constexpr int kGenSteps = 8;
constexpr int kGenWarps = kGenThreads / kWarp;
constexpr int kGenTileRows = kGenThreads * 4 * kGenSteps;
constexpr int kGenPer = kMaxK / kGenThreads;  // buckets a thread looks back
static_assert(kGenTileRows >= 2 * kMaxK, "tile below twice the buckets");
static_assert(kWarp * 4 * kGenSteps * kGenWarps < 65536, "u16 counts");

__device__ __forceinline__ uint64_t ld_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t make_word(uint32_t gen, bool prefix,
                                              int count) {
  return ((uint64_t)gen << 32) | (prefix ? kPrefixBit : 0ull) |
         (uint32_t)count;
}

__device__ __forceinline__ int word_count(uint64_t w) {
  return (int)(w & 0x7fffffffu);
}

// the next tile in row order, or -1 when every tile is claimed: each
// generation counts on its own counter (zeroed with the state), so no
// call resets one
__device__ __forceinline__ int64_t claim(uint64_t* state, uint32_t gen,
                                         int64_t n_tiles) {
  const unsigned c = atomicAdd(reinterpret_cast<unsigned*>(state + gen), 1u);
  return (int64_t)c < n_tiles ? (int64_t)c : -1;
}

// block-wide: claim one tile (the K > 8 form's grid has one block a tile)
__device__ __forceinline__ int64_t claim_tile(uint64_t* state, uint32_t gen,
                                              int64_t n_tiles) {
  __shared__ int64_t tile;
  if (threadIdx.x == 0) tile = claim(state, gen, n_tiles);
  __syncthreads();
  return tile;
}

// rows i0..i0+3: buckets and ok bytes, loads only (no use of a value),
// so a thread issues every step's loads before it waits on one
__device__ __forceinline__ void load4(const int32_t* __restrict__ dest,
                                      const uint8_t* __restrict__ ok,
                                      int64_t i0, int64_t n, bool vd,
                                      bool vo, int4& d, uint32_t& o) {
  if (i0 + 4 <= n) {
    if (vd) {
      d = __ldcs(reinterpret_cast<const int4*>(dest + i0));
    } else {
      d.x = __ldcs(dest + i0);
      d.y = __ldcs(dest + i0 + 1);
      d.z = __ldcs(dest + i0 + 2);
      d.w = __ldcs(dest + i0 + 3);
    }
    if (vo) {
      o = __ldcs(reinterpret_cast<const unsigned*>(ok + i0));
    } else {
      o = (uint32_t)ok[i0] | (uint32_t)ok[i0 + 1] << 8 |
          (uint32_t)ok[i0 + 2] << 16 | (uint32_t)ok[i0 + 3] << 24;
    }
  } else {
    d = make_int4(0, 0, 0, 0);
    o = 0;
    if (i0 < n) { d.x = dest[i0]; o |= (uint32_t)ok[i0]; }
    if (i0 + 1 < n) { d.y = dest[i0 + 1]; o |= (uint32_t)ok[i0 + 1] << 8; }
    if (i0 + 2 < n) { d.z = dest[i0 + 2]; o |= (uint32_t)ok[i0 + 2] << 16; }
  }
}

__device__ __forceinline__ int bucket_of(int d, uint32_t o, int e, int k) {
  return (((o >> (8 * e)) & 0xffu) && (unsigned)d < (unsigned)k) ? d : -1;
}

__device__ __forceinline__ void store4(int32_t* __restrict__ rank,
                                       int64_t i0, int64_t n,
                                       const int (&r)[4]) {
  if (i0 + 4 <= n) {  // rank is the wrapper's own allocation: aligned
    __stcs(reinterpret_cast<int4*>(rank + i0),
           make_int4(r[0], r[1], r[2], r[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e < n) rank[i0 + e] = r[e];
  }
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x,
                                                        int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// 8-bit fields of x (4 buckets) widened to 16-bit fields
__device__ __forceinline__ uint64_t widen(uint32_t x) {
  return (uint64_t)(x & 0xffu) | (uint64_t)(x & 0xff00u) << 8 |
         (uint64_t)(x & 0xff0000u) << 16 | (uint64_t)(x & 0xff000000u) << 24;
}

// spin until the word at p is published in this call (w: its first read):
// its generation sits at bit kPrefixGen (a prefix word) or kPackedGen (a
// packed aggregate); back off so that waiting tiles leave the L2 to the
// others
constexpr int kPrefixGen = 32, kPackedGen = 56;
__device__ __forceinline__ uint64_t wait_published(const uint64_t* p,
                                                   uint64_t w, uint32_t gen,
                                                   int at) {
  unsigned ns = 32;
  while ((uint32_t)(w >> at) != gen) {
    __nanosleep(ns);
    if (ns < 512) ns *= 2;
    w = ld_word(p);
  }
  return w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// rows i0..i0+3 into shared memory: cp.async where the rows are in range
// and aligned (the copies land without passing through registers), plain
// loads for a ragged end or an unaligned view; rows past n are 0
__device__ __forceinline__ void stage4(const int32_t* __restrict__ dest,
                                       const uint8_t* __restrict__ ok,
                                       int64_t i0, int64_t n, bool vd,
                                       bool vo, int32_t* sd, uint8_t* so) {
  if (i0 + 4 <= n) {
    if (vd) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(smem_addr(sd)), "l"(dest + i0) : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     :: "r"(smem_addr(sd + e)), "l"(dest + i0 + e)
                     : "memory");
    }
    if (vo) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   :: "r"(smem_addr(so)), "l"(ok + i0) : "memory");
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) so[e] = ok[i0 + e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sd[e] = i0 + e < n ? dest[i0 + e] : 0;
      so[e] = i0 + e < n ? ok[i0 + e] : 0;
    }
  }
}

template <int kThr, int kS>
__global__ void __launch_bounds__(kThr)
rank_small(const int32_t* __restrict__ dest, const uint8_t* __restrict__ ok,
           int64_t n, int k, uint64_t* __restrict__ state, int64_t n_tiles,
           uint32_t gen, int32_t* __restrict__ rank,
           int32_t* __restrict__ counts) {
  constexpr int kW = kThr / kWarp;
  constexpr int kRowsTile = kThr * 4 * kS;
  static_assert(kW <= kWarp, "one warp scans the warps");
  static_assert(128 * kS < 65536, "16-bit running counts");
  static_assert(kRowsTile <= (int)kAggMask, "a tile's count in kAggBits");
  // the staged tile: kRowsTile buckets, then their ok flags
  extern __shared__ int4 staged[];
  __shared__ int64_t tile;
  // warp totals per bucket, then each warp's base (tile base + warps
  // before it); the tile's aggregate; a block reduction's warp sums
  __shared__ int wsum[kW][kSmallK];
  __shared__ int tile_agg[kSmallK];
  __shared__ int red[kW][kSmallK];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int loc = warp * (128 * kS) + 4 * lane;  // this thread's rows
  int32_t* sd = reinterpret_cast<int32_t*>(staged) + loc;
  uint8_t* so = reinterpret_cast<uint8_t*>(
      reinterpret_cast<int32_t*>(staged) + kRowsTile) + loc;
  uint64_t* words = state + kCounters;
  const bool vd = ((uintptr_t)dest & 15) == 0;
  const bool vo = ((uintptr_t)ok & 3) == 0;

  for (;;) {
    if (threadIdx.x == 0) tile = claim(state, gen, n_tiles);
    __syncthreads();  // also: the last tile's readers are done
    const int64_t t = tile;
    if (t < 0) break;
    const int64_t first = t * (int64_t)kRowsTile + loc;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      stage4(dest, ok, first + 128 * s, n, vd, vo, sd + 128 * s,
             so + 128 * s);
    // a thread reads back only the rows it staged: no barrier needed
    asm volatile("cp.async.wait_all;" ::: "memory");

    // buckets as bytes (0xff: takes no part); this thread's counts in
    // 16-bit fields, buckets 0-3 in lo and 4-7 in hi
    uint32_t bk[kS];
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int4 d = *reinterpret_cast<const int4*>(sd + 128 * s);
      const uint32_t o = *reinterpret_cast<const uint32_t*>(so + 128 * s);
      const int dv[4] = {d.x, d.y, d.z, d.w};
      bk[s] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = bucket_of(dv[e], o, e, k);
        bk[s] |= (uint32_t)(b < 0 ? 0xff : b) << (8 * e);
        if (b >= 0) {
          const uint64_t inc = 1ull << (16 * (b & 3));
          if (b < 4) lo += inc; else hi += inc;
        }
      }
    }
    const uint32_t w0 = __reduce_add_sync(kFull, (uint32_t)lo);
    const uint32_t w1 = __reduce_add_sync(kFull, (uint32_t)(lo >> 32));
    uint32_t w2 = 0, w3 = 0;
    if (k > 4) {
      w2 = __reduce_add_sync(kFull, (uint32_t)hi);
      w3 = __reduce_add_sync(kFull, (uint32_t)(hi >> 32));
    }
    if (lane == 0) {
      const uint32_t ws[4] = {w0, w1, w2, w3};
#pragma unroll
      for (int b = 0; b < kSmallK; ++b)
        wsum[warp][b] = (ws[b >> 1] >> (16 * (b & 1))) & 0xffffu;
    }
    __syncthreads();
    // warp 0: per bucket a scan over the warps, the aggregate published
    // as packed words
    if (warp == 0) {
      const uint64_t tag = (uint64_t)gen << kPackedGen;
      uint64_t a_lo = tag, a_hi = tag;
#pragma unroll
      for (int b = 0; b < kSmallK; ++b) {
        const int v = lane < kW ? wsum[lane][b] : 0;
        const int inc = (int)warp_inclusive_scan((uint32_t)v, lane);
        const int agg = __shfl_sync(kFull, inc, kWarp - 1);
        if (lane < kW) wsum[lane][b] = inc - v;  // the warps before
        if (lane == 0) tile_agg[b] = agg;
        if (b < 4) a_lo |= (uint64_t)agg << (kAggBits * b);
        else a_hi |= (uint64_t)agg << (kAggBits * (b - 4));
      }
      if (lane == 0) st_word(words + 2 * t, a_lo);
      if (lane == 0 && k > 4) st_word(words + 2 * t + 1, a_hi);
    }
    // every thread: kAggPer of the kThr * kAggPer predecessors before t,
    // their aggregates summed; thread b also the prefix of the tile
    // before those, if any
    int part[kSmallK] = {};
    {
      uint64_t alo[kAggPer], ahi[kAggPer];
#pragma unroll
      for (int j = 0; j < kAggPer; ++j) {
        const int64_t q = t - 1 - threadIdx.x - (int64_t)j * kThr;
        alo[j] = ahi[j] = 0;
        if (q >= 0) alo[j] = ld_word(words + 2 * q);
        if (q >= 0 && k > 4) ahi[j] = ld_word(words + 2 * q + 1);
      }
      const int64_t far = t - 1 - (int64_t)kThr * kAggPer;
      const bool reads_far = far >= 0 && (int)threadIdx.x < k;
      const uint64_t* pref =
          words + 2 * n_tiles + (reads_far ? far * k + threadIdx.x : 0);
      uint64_t pw = 0;
      if (reads_far) pw = ld_word(pref);
#pragma unroll
      for (int j = 0; j < kAggPer; ++j) {
        const int64_t q = t - 1 - threadIdx.x - (int64_t)j * kThr;
        if (q < 0) continue;
        alo[j] = wait_published(words + 2 * q, alo[j], gen, kPackedGen);
        if (k > 4)
          ahi[j] = wait_published(words + 2 * q + 1, ahi[j], gen, kPackedGen);
#pragma unroll
        for (int b = 0; b < kSmallK; ++b)
          part[b] += (int)(((b < 4 ? alo[j] : ahi[j]) >>
                            (kAggBits * (b & 3))) & kAggMask);
      }
      if (reads_far) {
        pw = wait_published(pref, pw, gen, kPrefixGen);
#pragma unroll
        for (int b = 0; b < kSmallK; ++b)
          if ((int)threadIdx.x == b) part[b] += word_count(pw);
      }
    }
#pragma unroll
    for (int b = 0; b < kSmallK; ++b) {
      const unsigned x = __reduce_add_sync(kFull, (unsigned)part[b]);
      if (lane == 0) red[warp][b] = (int)x;
    }
    __syncthreads();
    // warp 0: the tile's exclusive base per bucket; lane b publishes
    // bucket b's inclusive prefix
    if (warp == 0) {
      int my = 0;
#pragma unroll
      for (int b = 0; b < kSmallK; ++b) {
        const int excl = (int)__reduce_add_sync(
            kFull, lane < kW ? (unsigned)red[lane][b] : 0u);
        if (lane < kW) wsum[lane][b] += excl;
        if (lane == b) my = excl + tile_agg[b];
      }
      if (lane < k) {
        st_word(words + 2 * n_tiles + t * k + lane, make_word(gen, true, my));
        if (t + 1 == n_tiles) counts[lane] = my;
      }
    }
    __syncthreads();

    // ranks: a warp scan of the lanes' packed counts a step
    uint64_t run_lo = 0, run_hi = 0;  // this warp's earlier steps
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      uint32_t c_lo = 0, c_hi = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t b = (bk[s] >> (8 * e)) & 0xffu;
        if (b < 4) c_lo += 1u << (8 * b);
        else if (b < 8) c_hi += 1u << (8 * (b - 4));
      }
      const uint32_t i_lo = warp_inclusive_scan(c_lo, lane);
      const uint32_t i_hi = k > 4 ? warp_inclusive_scan(c_hi, lane) : 0u;
      uint32_t x_lo = i_lo - c_lo, x_hi = i_hi - c_hi;
      const uint32_t s_lo = __shfl_sync(kFull, i_lo, kWarp - 1);
      const uint32_t s_hi = __shfl_sync(kFull, i_hi, kWarp - 1);
      int rk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t b = (bk[s] >> (8 * e)) & 0xffu;
        if (b == 0xffu) {
          rk[e] = -1;
          continue;
        }
        const int f = b & 3;
        const uint64_t run = b < 4 ? run_lo : run_hi;
        const uint32_t x = b < 4 ? x_lo : x_hi;
        rk[e] = wsum[warp][b] + (int)((run >> (16 * f)) & 0xffffu) +
                (int)((x >> (8 * f)) & 0xffu);
        if (b < 4) x_lo += 1u << (8 * f); else x_hi += 1u << (8 * f);
      }
      store4(rank, first + 128 * s, n, rk);
      run_lo += widen(s_lo);
      run_hi += widen(s_hi);
    }
  }
}

__global__ void __launch_bounds__(kGenThreads)
rank_general(const int32_t* __restrict__ dest,
             const uint8_t* __restrict__ ok, int64_t n, int k,
             uint64_t* __restrict__ state, int64_t n_tiles, uint32_t gen,
             int32_t* __restrict__ rank, int32_t* __restrict__ counts) {
  extern __shared__ int32_t smem[];
  int32_t* base = smem;  // [k]: the tile's exclusive base
  // [kGenWarps][k]: each warp's counts, then the warps before it
  uint16_t* cnt = reinterpret_cast<uint16_t*>(smem + k);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const unsigned lower = (1u << lane) - 1u;
  uint64_t* words = state + kCounters;
  const int64_t t = claim_tile(state, gen, n_tiles);
  const int64_t chunk = t * (int64_t)kGenTileRows + (int64_t)warp * 128 *
                        kGenSteps;
  const bool vd = ((uintptr_t)dest & 15) == 0;
  const bool vo = ((uintptr_t)ok & 3) == 0;

  int4 d[kGenSteps];
  uint32_t o[kGenSteps];
#pragma unroll
  for (int s = 0; s < kGenSteps; ++s)
    load4(dest, ok, chunk + 128 * s + 4 * lane, n, vd, vo, d[s], o[s]);
  for (int j = threadIdx.x; j < kGenWarps * k; j += kGenThreads) cnt[j] = 0;
  __syncthreads();

  // rows in row order, 32 at a time: row 32j + lane of a step is lane
  // 8j + lane / 4's element lane % 4
  uint16_t* mine = cnt + warp * k;
  int tb[kGenSteps][4], lr[kGenSteps][4];
#pragma unroll
  for (int s = 0; s < kGenSteps; ++s) {
    const int b0 = bucket_of(d[s].x, o[s], 0, k);
    const int b1 = bucket_of(d[s].y, o[s], 1, k);
    const int b2 = bucket_of(d[s].z, o[s], 2, k);
    const int b3 = bucket_of(d[s].w, o[s], 3, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int src = 8 * j + (lane >> 2);
      const int x0 = __shfl_sync(kFull, b0, src);
      const int x1 = __shfl_sync(kFull, b1, src);
      const int x2 = __shfl_sync(kFull, b2, src);
      const int x3 = __shfl_sync(kFull, b3, src);
      const int e = lane & 3;
      const int x = e == 0 ? x0 : e == 1 ? x1 : e == 2 ? x2 : x3;
      const unsigned grp = __match_any_sync(kFull, x);
      const int r = x >= 0 ? (int)mine[x] + __popc(grp & lower) : -1;
      __syncwarp();
      if (x >= 0 && lane == __ffs(grp) - 1)
        mine[x] = (uint16_t)(mine[x] + __popc(grp));
      __syncwarp();
      tb[s][j] = x;
      lr[s][j] = r;
    }
  }
  __syncthreads();

  // per bucket, one thread: scan over the warps, publish the aggregate
  int agg[kGenPer], excl[kGenPer];
  unsigned pending = 0;
#pragma unroll
  for (int j = 0; j < kGenPer; ++j) {
    const int b = threadIdx.x + j * kGenThreads;
    agg[j] = excl[j] = 0;
    if (b >= k) continue;
    int run = 0;
    for (int w = 0; w < kGenWarps; ++w) {
      const int c = cnt[w * k + b];
      cnt[w * k + b] = (uint16_t)run;
      run += c;
    }
    agg[j] = run;
    st_word(words + t * k + b, make_word(gen, t == 0, run));
    if (t > 0) pending |= 1u << j;
  }
  // look back one predecessor at a time, all of this thread's buckets
  for (int64_t p = t - 1; pending; --p) {
    uint64_t w[kGenPer];
#pragma unroll
    for (int j = 0; j < kGenPer; ++j)
      if (pending >> j & 1u)
        w[j] = ld_word(words + p * k + threadIdx.x + j * kGenThreads);
#pragma unroll
    for (int j = 0; j < kGenPer; ++j) {
      if (!(pending >> j & 1u)) continue;
      w[j] = wait_published(words + p * k + threadIdx.x + j * kGenThreads,
                            w[j], gen, kPrefixGen);
      excl[j] += word_count(w[j]);
      if (w[j] & kPrefixBit) pending &= ~(1u << j);
    }
  }
#pragma unroll
  for (int j = 0; j < kGenPer; ++j) {
    const int b = threadIdx.x + j * kGenThreads;
    if (b >= k) continue;
    if (t > 0)
      st_word(words + t * k + b, make_word(gen, true, excl[j] + agg[j]));
    if (t + 1 == n_tiles) counts[b] = excl[j] + agg[j];
    base[b] = excl[j];
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < kGenSteps; ++s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = chunk + 128 * s + 32 * j + lane;
      const int x = tb[s][j];
      if (i < n)
        rank[i] = x >= 0 ? base[x] + (int)cnt[warp * k + x] + lr[s][j] : -1;
    }
  }
}

int64_t tile_rows(int k) { return k <= kSmallK ? kTileRows : kGenTileRows; }

}  // namespace

// 64-bit words of state a call at (n, k) needs: a tile counter per
// generation, then for k <= 8 two packed aggregate words a tile, and k
// words a tile
extern "C" int64_t partition_rank_state_words(int64_t n, int k) {
  const int64_t tile = tile_rows(k);
  const int64_t n_tiles = (n + tile - 1) / tile;
  return kCounters + (k <= kSmallK ? 2 * n_tiles : 0) + (int64_t)k * n_tiles;
}

// One launch on `stream`; returns its cudaError_t (0 = success).
extern "C" int partition_rank_launch(const void* dest, const void* ok,
                                     void* rank, void* counts, void* state,
                                     int64_t n, int k, unsigned gen,
                                     void* stream) {
  if (n <= 0) return 0;
  const int64_t n_tiles = (n + tile_rows(k) - 1) / tile_rows(k);
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= kSmallK) {
    // persistent blocks: as many as the SMs hold
    auto kernel = rank_small<kThreads, kSteps>;
    const int smem = kTileRows * 5;  // the staged tile
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    kernel<<<(unsigned)(fit < n_tiles ? fit : n_tiles), kThreads, smem, s>>>(
        (const int32_t*)dest, (const uint8_t*)ok, n, k, (uint64_t*)state,
        n_tiles, gen, (int32_t*)rank, (int32_t*)counts);
  } else {
    const int smem = k * (int)sizeof(int32_t) +
                     kGenWarps * k * (int)sizeof(uint16_t);
    const cudaError_t err = cudaFuncSetAttribute(
        rank_general, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    rank_general<<<(unsigned)n_tiles, kGenThreads, smem, s>>>(
        (const int32_t*)dest, (const uint8_t*)ok, n, k, (uint64_t*)state,
        n_tiles, gen, (int32_t*)rank, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
