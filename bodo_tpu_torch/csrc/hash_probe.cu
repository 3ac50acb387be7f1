// hash_probe: open-addressing double-hash probe of 64-bit join keys into
// a claim table of T slots, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:299
// `_hash_probe_kernel` (reached through `hash_probe`, :397, from
// ops/hashtable.py `probe_slots`), the probe of the hash join and of the
// hash-gid sort join. For each probe row i with ok[i] it walks
//   p = (h[i] + r * step[i]) & (T - 1),  r = 0 .. max_rounds - 1,
// reads o = owner[p] and stops on an empty slot (o < 0: miss, -1) or on
// an owner whose n_codes key codes all equal the row's (hit: o). A row
// still walking after max_rounds keeps -1 and raises the unresolved flag.
// That is the JAX package's lock-step loop (hashtable.py:248-269).
//
// The TPU kernel compared 64-bit keys on its MXU: it split every code
// into four 16-bit f32 planes and gathered the probed slot's planes with
// a one-hot matmul, which held T to 4096 slots. None of that carries
// over: a Hopper thread compares 64-bit codes directly and reads any slot
// of a table of any power-of-two size.
//
// Bound: device memory. Every row reads ok (1 B) and writes idx (4 B);
// an ok row also streams h and step (16 B) and, once its walk compares
// them, its codes (8 B each). Every round reads one owner entry and, when
// the slot is owned, the owner's codes until one differs: random
// accesses, each a 32-byte sector. The least the card could move is
// every input the walks need read once: the streamed bytes plus the
// owner and code sectors the walks touch, each once. At the star join's
// size (T = 2^24, 5M build rows at load 0.30, ~13.3M live probes of a
// 20M-row capacity) the owner table (64 MB) and the build codes (80 MB)
// exceed the 50 MB L2, so the random reads go to device memory.
// Design against that bound, kept simple: one thread per probe row in a
// grid-stride loop, so the streamed loads and the idx store coalesce;
// each round compares the owner's codes two columns at a time, the loads
// of a step issued together so a round waits on one owner read and one
// code read (a join key is one code column, two when nullable), and
// stops at the first step that differs; the row's own codes are re-read
// per round (at ~1.2 rounds a row a second read is an L1 hit); owner and
// build codes go through the read-only path (__ldg); the grid fills
// every SM with warps, so each SM keeps many independent random reads in
// flight to hide their latency. Sorting probes by slot or prefetching
// the next round's sector is left for a later change.
//
// Contract (checked by the Python wrapper): T is a power of two, owner
// entries are -1 or build rows in [0, bcap), codes are [n_codes, n] and
// [n_codes, bcap] row-major, *flag is zero before the launch, all
// pointers are device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the __ldg overloads name unsigned long long, which uint64_t may not be
using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kChunk = 2;  // code columns compared per step

// every block of the grid resident at once: at most 32 registers a thread
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
hash_probe_kernel(const u64* __restrict__ h, const u64* __restrict__ step,
                  const u64* __restrict__ pcodes,
                  const u64* __restrict__ bcodes,
                  const int32_t* __restrict__ owner,
                  const uint8_t* __restrict__ ok,
                  int32_t* __restrict__ idx, int32_t* __restrict__ flag,
                  int64_t n, int64_t bcap, int n_codes, u64 mask,
                  int max_rounds) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t res = -1;
    if (ok[i]) {
      const u64 hi = h[i], st = step[i];
      bool walking = true;
      for (int r = 0; r < max_rounds; ++r) {
        const u64 p = (hi + (u64)r * st) & mask;
        const int32_t o = __ldg(owner + p);
        if (o < 0) {  // empty slot: miss
          walking = false;
          break;
        }
        // compare kChunk columns at a time: a chunk's loads issue together
        bool eq = true;
        for (int j0 = 0; j0 < n_codes && eq; j0 += kChunk) {
          u64 b[kChunk], c[kChunk];
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            if (j0 + t < n_codes) {
              b[t] = __ldg(bcodes + (j0 + t) * bcap + o);
              c[t] = pcodes[(j0 + t) * n + i];
            }
          }
#pragma unroll
          for (int t = 0; t < kChunk; ++t)
            if (j0 + t < n_codes) eq &= b[t] == c[t];
        }
        if (eq) {  // equal key: hit
          res = o;
          walking = false;
          break;
        }
      }
      if (walking) atomicOr(flag, 1);
    }
    idx[i] = res;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int hash_probe_launch(const void* h, const void* step,
                                 const void* pcodes, const void* bcodes,
                                 const void* owner, const void* ok, void* idx,
                                 void* flag, int64_t n, int64_t bcap,
                                 int n_codes, int64_t T, int max_rounds,
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
  hash_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)h, (const u64*)step, (const u64*)pcodes,
      (const u64*)bcodes, (const int32_t*)owner, (const uint8_t*)ok,
      (int32_t*)idx, (int32_t*)flag, n, bcap, n_codes, (u64)(T - 1),
      max_rounds);
  return (int)cudaGetLastError();
}
