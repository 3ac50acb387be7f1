// hybrid_expand: parquet RLE / bit-packed hybrid runs expanded into int32
// values, hand-written for Hopper (sm_90a). One launch expands every
// hybrid stream of a column chunk.
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:536
// `_hybrid_expand_kernel` (reached through `hybrid_expand`, :615, from
// io/device_decode.py's page programs: definition levels, dictionary
// indexes and RLE booleans). The TPU ran it once a page. Here a *segment*
// is one hybrid stream of one page, and one launch takes all the segments
// of a chunk. Segment s (a row of `segs`: out_base, n_out, lo, hi, bw,
// run_lo, run_hi) owns the outputs [out_base, out_base + n_out), the runs
// [run_lo, run_hi) and the page bytes [lo, hi) of the staged buffer. For
// an output index i of segment s:
//   r   = count(starts[run_lo:run_hi] <= i) - 1 + run_lo,
//         clipped to [run_lo, run_hi - 1]
//   out = vals[r]                                  if is_rle[r], vals[r] >= 0
//       = bw bits, little-endian, at bit offset
//         bits[r] + (i - starts[r]) * bw           otherwise (0 if bw = 0)
// read through a window of bytes whose indices are clipped to [lo, hi - 1],
// the page's own bytes, as the JAX package clips them to its page. Starts
// are rebased to the segment's output base and bits to absolute bit
// offsets (int64) in the staged buffer. An output no segment covers, or
// whose segment has no runs, is 0. Duplicate starts (empty runs) resolve
// to the later run.
//
// On the TPU the owning run came from an f32 compare-count against the
// whole run table and the run fields from a one-hot MXU product, exact
// only below 2^24 (its gate: <= 2048 runs, n and nb * 8 below 2^24).
// Here runs are found in int32 and bit offsets are int64, so none of those
// limits carries over.
//
// Bound: bytes. Each output needs the page bytes its value occupies (bw / 8
// bytes, none for an RLE value), its run's fields once per run and 4 bytes
// written: ~5-6 bytes a value at the taxi read's widths, ~6 MB for a chunk
// of 10^6 values, ~2 us at 3.35 TB/s. A page of ~20,000 values is ~0.03 us
// of that, far below a launch's own cost (~3 us), which is why the kernel
// takes a chunk, not a page. What holds it is the work of each thread, not
// bytes: on an H100 80GB HBM3 at 700 W a chunk of 1,060,000 values takes
// ~9 us back to back, 4.6-6.5x its bound, the same at bit widths 2, 8 and
// 17 and at 128 or 256 threads a block; 4 values a thread take 12-18%
// longer (more searches), 16 values 2.5x (a longer dependent chain, fewer
// warps to hide it); workloads/hybrid_expand_sweep.py measures this.
//
// Design: each thread makes kPerThread = 8 consecutive outputs. It finds
// its first output's segment by a binary search over the segment bases
// and its run by one over the segment's run starts, then walks forward:
// the next output's run is the same one or a later one found by a short
// forward scan, so a search costs ~log2(runs) dependent loads per 8
// values instead of per value. Run tables and
// segment rows are a few KB a chunk and stay in L1/L2, read through the
// read-only path (__ldg). A bit-packed value comes from two aligned 4-byte
// words (one 8-byte window) and a shift, where the window lies inside the
// page; at a page's edge each byte is read and clipped. The 8 outputs go
// out as two 16-byte stores, so a warp writes 1 KB contiguously.
//
// Contract (io/device_decode.py and cuda_kernels.hybrid_segments build the
// tables on the host and check it): segment bases nondecreasing and dense
// (out_base[s + 1] = out_base[s] + n_out[s]), starts nondecreasing within
// a segment, 0 <= bw <= 24. The kernel clamps byte windows to the buffer
// and run ranges to the run table, so no table reads or writes out of
// bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kSegFields = 7;  // out_base, n_out, lo, hi, bw, run_lo, run_hi

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Segment {
  int64_t base, end, lo, hi;
  int bw, run_lo, run_hi;
};

__device__ __forceinline__ Segment load_segment(const int64_t* segs, int s,
                                                int64_t nb, int n_runs) {
  const int64_t* row = segs + (int64_t)s * kSegFields;
  Segment g;
  g.base = __ldg(row + 0);
  g.end = g.base + __ldg(row + 1);
  g.lo = clamp64(__ldg(row + 2), 0, nb);
  g.hi = clamp64(__ldg(row + 3), 0, nb);
  g.bw = (int)clamp64(__ldg(row + 4), 0, 24);
  g.run_lo = (int)clamp64(__ldg(row + 5), 0, n_runs);
  g.run_hi = (int)clamp64(__ldg(row + 6), 0, n_runs);
  return g;
}

// the owning run of output i in [g.run_lo, g.run_hi): the upper bound of i
// in the segment's starts, less one, clipped to the segment's runs
__device__ __forceinline__ int find_run(const int32_t* starts,
                                        const Segment& g, int64_t i) {
  int lo = g.run_lo, hi = g.run_hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(starts + mid) <= i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return max(lo - 1, g.run_lo);
}

// bw bits at bit offset bp, bytes clipped to the page window [lo, hi)
__device__ __forceinline__ int32_t unpack(const uint8_t* data, int64_t nb,
                                          const Segment& g, int64_t bp) {
  if (g.hi <= g.lo) return 0;  // no page bytes to read
  const int64_t byte0 = bp >> 3;  // arithmetic: a negative offset clips
  const uint32_t mask = (1u << g.bw) - 1u;
  const uint32_t phase = (uint32_t)(bp & 7);
  if (byte0 >= g.lo && byte0 + 3 < g.hi) {
    // the 4 bytes lie in the page: two aligned words hold them
    const uintptr_t addr = (uintptr_t)(data + byte0);
    const int64_t word0 = byte0 - (int64_t)(addr & 3);
    if (word0 >= 0 && word0 + 8 <= nb) {
      const uint32_t* w = (const uint32_t*)(addr & ~(uintptr_t)3);
      const uint64_t win = ((uint64_t)__ldg(w + 1) << 32) | __ldg(w);
      return (int32_t)((uint32_t)(win >> (8 * (addr & 3) + phase)) & mask);
    }
  }
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k) {
    const int64_t b = clamp64(byte0 + k, g.lo, g.hi - 1);
    w |= (uint32_t)__ldg(data + b) << (8 * k);
  }
  return (int32_t)((w >> phase) & mask);
}

__global__ void __launch_bounds__(kThreads)
hybrid_expand_kernel(const uint8_t* __restrict__ data, int64_t nb,
                     const int64_t* __restrict__ segs, int n_segs,
                     const int32_t* __restrict__ starts,
                     const uint8_t* __restrict__ is_rle,
                     const int32_t* __restrict__ vals,
                     const int64_t* __restrict__ bits, int n_runs,
                     int32_t* __restrict__ out, int64_t n) {
  const int64_t i0 =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kPerThread;
  if (i0 >= n) return;
  // the last segment whose base is <= i0
  int s;
  {
    int lo = 0, hi = n_segs;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(segs + (int64_t)mid * kSegFields) <= i0)
        lo = mid + 1;
      else
        hi = mid;
    }
    s = max(lo - 1, 0);
  }
  Segment g = load_segment(segs, s, nb, n_runs);
  int r = find_run(starts, g, i0);
  int32_t rv = 0, rstart = 0;
  int64_t rbits = 0;
  int loaded = -1;  // the run whose fields rv, rstart, rbits hold
  int32_t v[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = i0 + k;
    v[k] = 0;
    if (i >= n) continue;
    if (i >= g.end) {  // into a later segment (empty ones are skipped)
      bool moved = false;
      while (s + 1 < n_segs &&
             __ldg(segs + (int64_t)(s + 1) * kSegFields) <= i) {
        ++s;
        moved = true;
      }
      if (moved) {
        g = load_segment(segs, s, nb, n_runs);
        r = find_run(starts, g, i);
        loaded = -1;
      }
    }
    if (i < g.base || i >= g.end || g.run_lo >= g.run_hi) continue;
    while (r + 1 < g.run_hi && (int64_t)__ldg(starts + r + 1) <= i) ++r;
    if (r != loaded) {
      rv = __ldg(is_rle + r) ? __ldg(vals + r) : -1;
      rstart = __ldg(starts + r);
      rbits = __ldg(bits + r);
      loaded = r;
    }
    if (rv >= 0)
      v[k] = rv;
    else if (g.bw > 0)
      v[k] = unpack(data, nb, g, rbits + (i - (int64_t)rstart) * g.bw);
  }
  int32_t* o = out + i0;
  if (i0 + kPerThread <= n && ((uintptr_t)o & 15) == 0) {
    reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (i0 + k < n) o[k] = v[k];
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hybrid_expand_segments_launch(
    const void* data, int64_t nb, const void* segs, int n_segs,
    const void* starts, const void* is_rle, const void* vals,
    const void* bits, int n_runs, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  if (n_segs <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kTile - 1) / kTile;
  hybrid_expand_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)data, nb, (const int64_t*)segs, n_segs,
      (const int32_t*)starts, (const uint8_t*)is_rle, (const int32_t*)vals,
      (const int64_t*)bits, n_runs, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
