// range_partition: out[i] = the number of splitters <= pk[i], i.e.
// searchsorted(splitters, pk, side='right') over uint64 keys and sorted
// uint64 splitters, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:654
// `_range_partition_kernel` (route `range_partition`, :701), the
// destination step of the distributed sample sort (bodo_tpu/ops/sort.py
// :113): each row's partition key goes to the shard whose splitter range
// holds it. The TPU has no 64-bit integer compare in its vector unit, so
// it split keys and splitters into four 16-bit planes held in f32 and
// decided the order plane by plane against every splitter at once (a
// [BLK, n_spl] compare). Hopper compares unsigned 64-bit integers
// directly, so each thread binary-searches its key over the splitters in
// `unsigned long long` (never as signed: partition keys with the top bit
// set, and the padding key 0xFFFFFFFFFFFFFFFF, order above every other).
//
// Bound: every key (8 B) is read once and every destination (4 B)
// written once, plus the splitters (8 B each): 12 B a row, and at most
// 13 shared-memory compares a row for 4096 splitters, so device-memory
// bandwidth bounds it (3.35 TB/s on an H100 SXM; 5M rows, one shard of
// the 20M-row taxi path, move 60 MB, ~18 us). The splitters (at most
// 4096, 32 KB) are staged in each block's shared memory once; the keys
// stream through a grid-stride loop with coalesced loads and stores.
//
// Contract (checked by the Python wrapper): n >= 1, 0 <= n_spl <= 4096,
// splitters sorted ascending as unsigned 64-bit integers, all pointers
// device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
range_partition_kernel(const unsigned long long* __restrict__ pk,
                       const unsigned long long* __restrict__ splitters,
                       int n_spl, int32_t* __restrict__ out, int64_t n) {
  extern __shared__ unsigned long long spl[];  // [n_spl]
  for (int j = threadIdx.x; j < n_spl; j += blockDim.x) spl[j] = splitters[j];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long x = pk[i];
    int lo = 0, hi = n_spl;  // first splitter > x
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (spl[mid] <= x)
        lo = mid + 1;
      else
        hi = mid;
    }
    out[i] = lo;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int range_partition_launch(const void* pk, const void* splitters,
                                      void* out, int64_t n, int n_spl,
                                      void* stream) {
  if (n <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const int blocks = (int)(want < cap ? want : cap);
  const size_t smem = (size_t)n_spl * sizeof(unsigned long long);
  range_partition_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned long long*)pk, (const unsigned long long*)splitters,
      n_spl, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
