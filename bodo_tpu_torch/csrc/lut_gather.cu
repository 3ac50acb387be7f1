// lut_gather: out[i] = lut[codes[i]] for int32 codes and an int32 LUT of
// any size, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:171
// `_matmul_gather_kernel` (reached through `matmul_gather`, :218), the
// probe lookup of the dense-LUT join. On the TPU the gather was a one-hot
// [BLK, K] x [K, 1] product on the MXU, exact only for values below 2^24
// and only for K <= 4096 slots. Hopper gathers directly, so neither the
// one-hot, nor the 2^24 bound, nor the 4096-slot bound carries over: the
// dense join sends every LUT it admits (up to 2^22 slots) here.
//
// Bound: the kernel must read every code once (4 B), write every output
// once (4 B) and read the LUT (4 B a slot): 8*N + 4*K bytes, no
// arithmetic to speak of, so it is bound by device memory bandwidth
// (3.35 TB/s on an H100 SXM: 20M codes move ~160 MB, ~48 us).
// Design against that bound: the LUT is read in place through the
// read-only path (__ldg). The taxi date LUT (182 slots, 728 B) stays in
// L1; the largest LUT the dense join admits (2^22 slots, 16 MB) stays in
// the 50 MB L2, so LUT reads cost cache and not device-memory bandwidth
// either way. Each thread walks a grid-stride loop with coalesced int32
// loads of the codes and a coalesced int32 store. Wider vector loads are
// left for a later change.
//
// Contract (checked by the Python wrapper): codes index the LUT, all
// pointers are device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const int32_t* __restrict__ codes,
                  const int32_t* __restrict__ lut,
                  int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __ldg(lut + codes[i]);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int lut_gather_launch(const void* codes, const void* lut,
                                 void* out, int64_t n, void* stream) {
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
  lut_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const int32_t*)lut, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
