// lut_gather: out[i] = lut[codes[i]] for int32 codes and an int32 LUT of
// at most 4096 slots, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:171
// `_matmul_gather_kernel` (reached through `matmul_gather`, :218), the
// probe lookup of the dense-LUT join. On the TPU the gather was a one-hot
// [BLK, K] x [K, 1] product on the MXU, exact only for values below 2^24.
// Hopper gathers directly, so neither the one-hot nor the 2^24 bound
// carries over.
//
// Bound: the kernel must read every code once (4 B), write every output
// once (4 B) and read the LUT (4 B a slot): 8*N + 4*K bytes, no
// arithmetic to speak of, so it is bound by device memory bandwidth
// (3.35 TB/s on an H100 SXM: 20M codes move ~160 MB, ~48 us).
// Design against that bound: each block stages the LUT (<= 16 KB) in
// shared memory once, so LUT reads never reach device memory; each thread
// then walks a grid-stride loop with coalesced int32 loads of the codes,
// a shared-memory lookup and a coalesced int32 store. The grid is a few
// blocks per SM, enough to keep the loads in flight while the LUT staging
// stays a small share of the traffic. Wider vector loads and cp.async/TMA
// staging are left for a later change.
//
// Contract (checked by the Python wrapper): codes are in [0, k),
// 1 <= k <= 4096, all pointers are device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const int32_t* __restrict__ codes,
                  const int32_t* __restrict__ lut,
                  int32_t* __restrict__ out, int64_t n, int k) {
  extern __shared__ int32_t s_lut[];
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_lut[j] = lut[j];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = s_lut[codes[i]];
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int lut_gather_launch(const void* codes, const void* lut,
                                 void* out, int64_t n, int k, void* stream) {
  if (n <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSm;
  int blocks = (int)(want < cap ? want : cap);
  lut_gather_kernel<<<blocks, kThreads, (size_t)k * sizeof(int32_t),
                      (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const int32_t*)lut, (int32_t*)out, n, k);
  return (int)cudaGetLastError();
}
