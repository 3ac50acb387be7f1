// hybrid_expand: parquet RLE / bit-packed hybrid runs expanded into int32
// values, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:536
// `_hybrid_expand_kernel` (reached through `hybrid_expand`, :615, from
// io/device_decode.py's page programs: definition levels, dictionary
// indexes and RLE booleans). For output index i < n:
//   r   = count(starts <= i) - 1, clipped to [0, n_runs - 1]
//   out = vals[r]                                    if is_rle[r]
//       = bw bits, little-endian, at bit offset
//         bits[r] + (i - starts[r]) * bw             otherwise (0 if bw = 0)
// read through a window of ceil((7 + bw) / 8) <= 4 bytes whose byte
// indices are clipped to [0, nb - 1], as the JAX package clips them.
//
// On the TPU the owning run came from an f32 compare-count against the
// whole run table and the run fields from a one-hot MXU product, exact
// only below 2^24 (its gate: <= 2048 runs, n and nb * 8 below 2^24).
// Here the run comes from a binary search over `starts` in int32 and the
// bit offset is int64, so none of those limits carries over: any page
// size and any run count give the same integers as the plain version.
//
// Bound: each output reads its run fields and at most 4 page bytes and
// writes 4 bytes. Per value that is ~4-7 bytes of device memory and a
// ~log2(n_runs)-step search, so the kernel is bound by bytes: a page of
// 20,000 values moves ~100 KB, ~0.03 us at 3.35 TB/s, far below a
// launch's own cost. Design: one thread per output value, a binary
// search over `starts`, then the run fields and a <= 4-byte window of
// page bytes, all read through the read-only path (__ldg). A page's run
// table is a few hundred bytes to a few KB, so the search's loads stay
// in L1.
//
// Contract: starts nondecreasing, which the callers guarantee
// (io/device_decode.py's _parse_hybrid builds them from a running count
// and _pad_runs gives the padding runs a sentinel start past n); the
// Python wrapper checks n_runs >= 1, nb >= 1, 0 <= bw <= 24, dtypes,
// lengths and that all tensors lie on one CUDA device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hybrid_expand_kernel(const uint8_t* __restrict__ data, int64_t nb,
                     const int32_t* __restrict__ starts,
                     const uint8_t* __restrict__ is_rle,
                     const int32_t* __restrict__ vals,
                     const int64_t* __restrict__ bits, int n_runs, int bw,
                     int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // count(starts <= i): the upper bound of i in the nondecreasing starts
  int lo = 0, hi = n_runs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)__ldg(starts + mid) <= i)
      lo = mid + 1;
    else
      hi = mid;
  }
  int r = lo - 1;
  r = r < 0 ? 0 : (r > n_runs - 1 ? n_runs - 1 : r);
  // the RLE value, or -1 for a bit-packed run (run values are never
  // negative, so -1 means "take the unpacked bits", as in the plain
  // version)
  const int32_t rv = __ldg(is_rle + r) ? __ldg(vals + r) : -1;
  int32_t packed = 0;
  if (bw > 0) {
    const int64_t bp =
        __ldg(bits + r) + (i - (int64_t)__ldg(starts + r)) * bw;
    const int64_t byte0 = bp >> 3;
    const int nbytes = (bw + 14) / 8;
    uint32_t w = 0;
    for (int k = 0; k < nbytes; ++k) {
      int64_t b = byte0 + k;
      b = b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b);
      w |= (uint32_t)__ldg(data + b) << (8 * k);
    }
    packed = (int32_t)((w >> (uint32_t)(bp & 7)) & ((1u << bw) - 1u));
  }
  out[i] = rv >= 0 ? rv : packed;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hybrid_expand_launch(const void* data, int64_t nb,
                                    const void* starts, const void* is_rle,
                                    const void* vals, const void* bits,
                                    int n_runs, int bw, void* out, int64_t n,
                                    void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  hybrid_expand_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)data, nb, (const int32_t*)starts,
      (const uint8_t*)is_rle, (const int32_t*)vals, (const int64_t*)bits,
      n_runs, bw, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
