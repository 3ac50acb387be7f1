// hash_probe: open-addressing double-hash probe of 64-bit join keys into
// a claim table of T slots, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel bodo_tpu/ops/pallas_kernels.py:299
// `_hash_probe_kernel` (reached through `hash_probe`, :397, from
// ops/hashtable.py `probe_slots`), the probe of the hash join and of the
// hash-gid sort join. For each probe row i with ok[i] it walks
//   p = (h[i] + r * step[i]) & (T - 1),  r = 0 .. max_rounds - 1,
// and stops on an empty slot (owner[p] < 0: miss, -1) or on a slot whose
// owner's n_codes key codes all equal the row's (hit: the owner). A row
// still walking after max_rounds keeps -1 and raises the unresolved flag.
// That is the JAX package's lock-step loop (hashtable.py:248-269); h and
// step come from the caller, as the TPU kernel takes them.
//
// The TPU kernel builds a slot table once a call (pallas_kernels.py:
// 414-418): one row a slot, the owner and that owner's key, the key split
// into 16-bit planes so that the MXU could gather a probed row with a
// one-hot matmul (which held T to 4096). This kernel keeps the slot table
// and lays its rows out for Hopper's 32-byte sectors instead:
//
//   word 0      the owner (int32, -1 on an empty slot; high half 0)
//   words 1..W  the owner's codes 0 .. W-1 (0 on an empty slot and past
//               n_codes)
//
// with W = 1, 3 or 7 (a 16-, 32- or 64-byte row), the least that holds
// min(n_codes, 7) codes. A join key takes two codes (its null flag and
// its value), so every one-key join has 32-byte rows. A round reads its
// slot's row with 16-byte loads: one sector (two for a 64-byte row),
// where a walk over the owner table and the column-major build codes
// reads 1 + n_codes sectors on a hit. The probe row's codes are read
// once, before its walk. Codes past the seventh are compared from the
// columns.
//
// Three forms, chosen by a fixed rule on (N, T, n_codes) (`form` below),
// never as a reaction to a failure:
//   shared   T * row bytes <= 32 KiB (T <= 1024 for a one-key join):
//            each block builds the slot rows in its shared memory from
//            the owner table and the build columns (L2-resident at that
//            size), then walks them there; one kernel;
//   rows     2 or 3 code columns (32-byte rows: a one-key join), T >=
//            2^24 and 2 * N >= T: a first kernel writes the T slot rows
//            to a scratch buffer of T * 32 bytes that the wrapper
//            allocates for the call (512 MiB at T = 2^24), a second walks
//            them;
//   columns  otherwise: the walk reads owner[p] and, on an owned slot,
//            the owner's codes from the build columns two at a step, and
//            the row's own codes each round.
// The bounds come from workloads/hash_probe_sweep.py (an H100 SXM, 700
// W). The rows cost T-proportional work, the T rows written and each
// owned slot's codes gathered (0.49 ms at T = 2^24, 2 codes), so they pay
// only where the column walk's extra reads go to device memory and many
// rows hit (a hit is where the column walk reads 1 + n_codes sectors):
// at the star join's call (T = 2^24, 2 codes, 20M probe rows, every ok
// row a hit) the rows form took 1.16 ms and the columns form 1.48; on
// the first N rows of that call the columns form won below N = T/2 (0.47
// against 0.70 ms at T/4; 0.92 against 0.91 at T/2). With a third of the
// rows hitting, the columns form won at T = 2^24 with 2 codes (1.21
// against 1.27 ms), 4 codes (1.61 against 1.89: 64-byte rows double the
// build) and one code (0.28 against 0.44), so the rule follows the star
// join, whose probes all hit, and 16- and 64-byte rows stay in shared
// memory. Below 2^24 slots the owner table and the build columns (under
// 100 MB at load 0.5) stay largely in the 50 MB L2, and the columns form
// won in every case measured (T = 2^20 to 2^23 with 1, 2 or 4 codes;
// 0.52 against 0.61 ms at 2^23 with 2 codes).
// The rows are built in every call and never kept: an owner table and
// its build codes are not known to outlive the call, and stale rows
// would be a silent wrong answer.
//
// Bound: device memory. Every row reads ok (1 B) and writes idx (4 B);
// an ok row also reads h and step (16 B) and its codes (8 B each) once.
// A round reads one random slot: at the star join's size (T = 2^24, 5M
// build rows at load 0.30, ~13.3M live probes of a 20M-row capacity) the
// owner table (64 MB), the build codes (80 MB) and the slot rows (512
// MiB) all exceed the 50 MB L2, so each such read is a sector from
// device memory. Column walks were held by those scattered sectors
// (~3.6 an ok row, ~1.3 TB/s of sector traffic); the rows form reads
// ~1.2 an ok row and pays for it with the row build: T rows written,
// the owner table read, and each owned slot's codes gathered. What holds
// both is device memory's rate of scattered reads, not its bandwidth: on
// the star call the walk over the rows takes 0.67 ms for ~15.8M random
// rows and 0.53 GB streamed, the build 0.49 ms (0.23 without its ~10M
// code gathers), one owner read an ok row alone 0.40 ms.
//
// Threads: a grid-stride loop over the probe rows, kWalks rows a thread
// walked together (their round's loads issued before any compare; 2 or
// 4 gained nothing, nor did 128 or 512 threads a block), as many blocks
// as the SMs hold at once; owner, rows and codes go through the
// read-only path (__ldg).
//
// Contract (checked by the Python wrapper): T is a power of two >= 16,
// owner entries are -1 or build rows within every build column, each
// code column is int64 given as a pointer and an element stride,
// 1 <= n_codes <= 64, *flag is zero before the launch, the scratch holds
// hash_probe_scratch_bytes(n, T, n_codes) bytes, 16-byte aligned, and
// every pointer is device memory on the current device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the __ldg overloads name unsigned long long, which uint64_t may not be
using u64 = unsigned long long;

constexpr int kThreads = 256;  // threads a block, every kernel
constexpr int kWalks = 1;      // probe rows a thread walks together
constexpr int kChunk = 2;      // code columns compared a step (columns)
constexpr int kMaxCodes = 64;  // code columns a call takes
constexpr int kMaxInline = 7;  // codes a slot row holds at most
constexpr int64_t kSharedBytes = 32 * 1024;  // the shared form's rows
constexpr int64_t kRowsMinSlots = 1 << 24;   // the rows form's least T
// -1: the rule of `form`; 0, 1 or 2 forces a form (for measurements)
constexpr int kForceForm = -1;

enum Form { kColumns = 0, kShared = 1, kRows = 2 };

// one side's code columns: code j of row i is p[j][i * s[j]]
struct Cols {
  const u64* p[kMaxCodes];
  int64_t s[kMaxCodes];
};

__device__ __forceinline__ u64 code(const Cols& c, int j, int64_t i) {
  return __ldg(c.p[j] + i * c.s[j]);
}

// a slot row of W codes: (W + 1) words of 8 bytes in 16-byte quads
template <int W>
struct Row {
  static constexpr int kQ = (W + 1) / 2;
  uint4 q[kQ];
  __device__ __forceinline__ int32_t owner() const {
    return (int32_t)q[0].x;
  }
  __device__ __forceinline__ u64 word(int w) const {  // w a constant
    const uint4 v = q[w >> 1];
    return (w & 1) ? ((u64)v.w << 32 | v.z) : ((u64)v.y << 32 | v.x);
  }
};

// word wi of the slot row of owner o: the owner (wi = 0), else code
// wi - 1 (0 on an empty slot and past n_codes)
__device__ __forceinline__ u64 row_word(int wi, int32_t o, const Cols& b,
                                        int n_codes) {
  if (wi == 0) return (uint32_t)o;
  return (o >= 0 && wi - 1 < n_codes) ? code(b, wi - 1, o) : 0ull;
}

// 16-byte quad k (words 2k and 2k + 1) of the slot row of owner o
__device__ __forceinline__ uint4 row_quad(int k, int32_t o, const Cols& b,
                                          int n_codes) {
  const u64 lo = row_word(2 * k, o, b, n_codes);
  const u64 hi = row_word(2 * k + 1, o, b, n_codes);
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi,
                    (uint32_t)(hi >> 32));
}

// rows form, first kernel: the T slot rows, one 16-byte quad a thread,
// so that a warp's store covers 512 contiguous bytes of whole sectors
// (a thread storing its whole row covers half of each sector a store)
template <int W>
__global__ void __launch_bounds__(kThreads)
hash_probe_build_rows(const int32_t* __restrict__ owner, Cols b,
                      int n_codes, int64_t T, uint4* __restrict__ rows) {
  constexpr int kQ = Row<W>::kQ;
  const int64_t quads = T * kQ;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < quads; q += stride)
    rows[q] = row_quad((int)(q % kQ), __ldg(owner + q / kQ), b, n_codes);
}

// whether owner o's codes 0 .. min(n_codes, W) - 1 equal `key`, read
// from the build columns kChunk at a step (a step's loads issued
// together), stopping at the first step that differs
template <int W>
__device__ __forceinline__ bool columns_equal(const Cols& bc, int32_t o,
                                              const u64* key, int n_codes) {
  bool eq = true;
#pragma unroll
  for (int j0 = 0; j0 < W; j0 += kChunk) {
    if (!eq || j0 >= n_codes) break;
    u64 b[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      if (j0 + t < W && j0 + t < n_codes) b[t] = code(bc, j0 + t, o);
#pragma unroll
    for (int t = 0; t < kChunk; ++t)
      if (j0 + t < W && j0 + t < n_codes) eq &= b[t] == key[j0 + t];
  }
  return eq;
}

// the walk, in each form: a round reads its slot's row (shared: from
// rows the block built in its shared memory; rows: from `grows`) or, in
// the columns form, the slot's owner and then its codes
template <int W, int kForm>
__global__ void __launch_bounds__(kThreads)
hash_probe_walk(const u64* __restrict__ h, const u64* __restrict__ step,
                Cols pc, Cols bc, const int32_t* __restrict__ owner,
                const uint4* __restrict__ grows,
                const uint8_t* __restrict__ ok, int32_t* __restrict__ idx,
                int32_t* __restrict__ flag, int64_t n, int n_codes,
                int64_t T, int max_rounds) {
  constexpr int kQ = Row<W>::kQ;
  extern __shared__ uint4 srows[];
  const uint4* rows = grows;
  if constexpr (kForm == kShared) {
    // four quads a thread a step, their owner loads issued together
    const int64_t quads = T * kQ;
    for (int64_t q0 = threadIdx.x; q0 < quads; q0 += 4 * blockDim.x) {
      int32_t o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t q = q0 + u * blockDim.x;
        o[u] = q < quads ? __ldg(owner + q / kQ) : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t q = q0 + u * blockDim.x;
        if (q < quads) srows[q] = row_quad((int)(q % kQ), o[u], bc, n_codes);
      }
    }
    __syncthreads();
    rows = srows;
  }
  const u64 mask = (u64)(T - 1);
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += kWalks * threads) {
    u64 hi[kWalks], st[kWalks], key[kWalks][W];
    int32_t res[kWalks];
    bool walking[kWalks];
#pragma unroll
    for (int k = 0; k < kWalks; ++k) {
      const int64_t i = i0 + k * threads;
      res[k] = -1;
      walking[k] = i < n && ok[i];
      hi[k] = walking[k] ? h[i] : 0ull;
      st[k] = walking[k] ? step[i] : 0ull;
#pragma unroll
      for (int j = 0; j < W; ++j)
        key[k][j] = (walking[k] && j < n_codes) ? code(pc, j, i) : 0ull;
    }
    for (int r = 0; r < max_rounds; ++r) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < kWalks; ++k) any |= walking[k];
      if (!any) break;
      Row<W> row[kWalks];
#pragma unroll
      for (int k = 0; k < kWalks; ++k) {
        if (!walking[k]) continue;
        const u64 p = (hi[k] + (u64)r * st[k]) & mask;
        if constexpr (kForm == kColumns) {
          row[k].q[0].x = (uint32_t)__ldg(owner + p);
        } else {
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if constexpr (kForm == kShared)
              row[k].q[q] = rows[p * kQ + q];
            else
              row[k].q[q] = __ldg(rows + p * kQ + q);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kWalks; ++k) {
        if (!walking[k]) continue;
        const int32_t o = row[k].owner();
        if (o < 0) {  // empty slot: miss
          walking[k] = false;
          continue;
        }
        bool eq = true;
        if constexpr (kForm == kColumns) {
          eq = columns_equal<W>(bc, o, key[k], n_codes);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) eq &= row[k].word(j + 1) == key[k][j];
        }
        if constexpr (W == kMaxInline) {  // codes past the row's
          const int64_t i = i0 + k * threads;
          for (int j = W; eq && j < n_codes; ++j)
            eq = code(bc, j, o) == code(pc, j, i);
        }
        if (eq) {  // equal key: hit
          res[k] = o;
          walking[k] = false;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWalks; ++k) {
      const int64_t i = i0 + k * threads;
      if (i < n) {
        if (walking[k]) atomicOr(flag, 1);
        idx[i] = res[k];
      }
    }
  }
}

int inline_codes(int n_codes) {
  return n_codes <= 1 ? 1 : n_codes <= 3 ? 3 : kMaxInline;
}

int64_t row_bytes(int n_codes) { return 8 * (inline_codes(n_codes) + 1); }

// the form of a call: a fixed rule on (N, T, n_codes)
int form(int64_t n, int64_t T, int n_codes) {
  if (kForceForm >= 0) return kForceForm;
  if (T * row_bytes(n_codes) <= kSharedBytes) return kShared;
  const bool rows = inline_codes(n_codes) == 3 && T >= kRowsMinSlots &&
                    2 * n >= T;
  return rows ? kRows : kColumns;
}

struct Call {
  const u64 *h, *step;
  Cols pc, bc;
  const int32_t* owner;
  const uint8_t* ok;
  int32_t *idx, *flag;
  uint4* rows;
  int64_t n, T;
  int n_codes, max_rounds;
};

enum Phase { kBuild = 1, kWalk = 2 };

// the grid of `kernel`: enough blocks for `items` (kThreads * per_thread
// a block), at most as many as the SMs hold at once
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, int64_t items, int per_thread,
                    size_t smem, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t a_block = (int64_t)kThreads * per_thread;
  const int64_t want = (items + a_block - 1) / a_block;
  const int64_t fit = (int64_t)sms * per_sm;
  *grid = (unsigned)(want < fit ? want : fit);
  return cudaSuccess;
}

template <int W>
cudaError_t run(const Call& c, int phases, cudaStream_t s) {
  unsigned grid = 0;
  cudaError_t err = cudaSuccess;
  switch (form(c.n, c.T, c.n_codes)) {
    case kShared: {
      if (!(phases & kWalk)) return cudaSuccess;
      const size_t smem = (size_t)c.T * Row<W>::kQ * sizeof(uint4);
      err = grid_of(hash_probe_walk<W, kShared>, c.n, kWalks, smem, &grid);
      if (err != cudaSuccess) return err;
      hash_probe_walk<W, kShared><<<grid, kThreads, smem, s>>>(
          c.h, c.step, c.pc, c.bc, c.owner, nullptr, c.ok, c.idx, c.flag,
          c.n, c.n_codes, c.T, c.max_rounds);
      return cudaGetLastError();
    }
    case kRows:
      if (c.rows == nullptr) return cudaErrorInvalidValue;
      if (phases & kBuild) {
        err = grid_of(hash_probe_build_rows<W>, c.T * Row<W>::kQ, 1, 0,
                      &grid);
        if (err != cudaSuccess) return err;
        hash_probe_build_rows<W><<<grid, kThreads, 0, s>>>(
            c.owner, c.bc, c.n_codes, c.T, c.rows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
      if (phases & kWalk) {
        err = grid_of(hash_probe_walk<W, kRows>, c.n, kWalks, 0, &grid);
        if (err != cudaSuccess) return err;
        hash_probe_walk<W, kRows><<<grid, kThreads, 0, s>>>(
            c.h, c.step, c.pc, c.bc, c.owner, c.rows, c.ok, c.idx, c.flag,
            c.n, c.n_codes, c.T, c.max_rounds);
        err = cudaGetLastError();
      }
      return err;
    default:
      if (!(phases & kWalk)) return cudaSuccess;
      err = grid_of(hash_probe_walk<W, kColumns>, c.n, kWalks, 0, &grid);
      if (err != cudaSuccess) return err;
      hash_probe_walk<W, kColumns><<<grid, kThreads, 0, s>>>(
          c.h, c.step, c.pc, c.bc, c.owner, nullptr, c.ok, c.idx, c.flag,
          c.n, c.n_codes, c.T, c.max_rounds);
      return cudaGetLastError();
  }
}

int launch(const void* h, const void* step, const void* const* pcols,
           const int64_t* pstrides, const void* const* bcols,
           const int64_t* bstrides, const void* owner, const void* ok,
           void* idx, void* flag, void* scratch, int64_t n, int n_codes,
           int64_t T, int max_rounds, int phases, void* stream) {
  if (n <= 0) return 0;
  if (n_codes < 1 || n_codes > kMaxCodes) return (int)cudaErrorInvalidValue;
  Call c = {};
  c.h = (const u64*)h;
  c.step = (const u64*)step;
  for (int j = 0; j < n_codes; ++j) {
    c.pc.p[j] = (const u64*)pcols[j];
    c.pc.s[j] = pstrides[j];
    c.bc.p[j] = (const u64*)bcols[j];
    c.bc.s[j] = bstrides[j];
  }
  c.owner = (const int32_t*)owner;
  c.ok = (const uint8_t*)ok;
  c.idx = (int32_t*)idx;
  c.flag = (int32_t*)flag;
  c.rows = (uint4*)scratch;
  c.n = n;
  c.T = T;
  c.n_codes = n_codes;
  c.max_rounds = max_rounds;
  cudaStream_t s = (cudaStream_t)stream;
  switch (inline_codes(n_codes)) {
    case 1: return (int)run<1>(c, phases, s);
    case 3: return (int)run<3>(c, phases, s);
    default: return (int)run<kMaxInline>(c, phases, s);
  }
}

}  // namespace

// The form of a call of n probe rows into T slots with n_codes code
// columns: 0 columns, 1 shared, 2 rows.
extern "C" int hash_probe_form(int64_t n, int64_t T, int n_codes) {
  return form(n, T, n_codes);
}

// Bytes of scratch a call needs (the rows form's), else 0.
extern "C" int64_t hash_probe_scratch_bytes(int64_t n, int64_t T,
                                            int n_codes) {
  return form(n, T, n_codes) == kRows ? T * row_bytes(n_codes) : 0;
}

// Launch the call on `stream`: the row build, where its form has one,
// then the walk. `pcols`/`bcols` and `pstrides`/`bstrides` are host
// arrays of n_codes column pointers and element strides. Returns the
// cudaError_t of the first launch that failed (0 = success).
extern "C" int hash_probe_launch(const void* h, const void* step,
                                 const void* const* pcols,
                                 const int64_t* pstrides,
                                 const void* const* bcols,
                                 const int64_t* bstrides, const void* owner,
                                 const void* ok, void* idx, void* flag,
                                 void* scratch, int64_t n, int n_codes,
                                 int64_t T, int max_rounds, void* stream) {
  return launch(h, step, pcols, pstrides, bcols, bstrides, owner, ok, idx,
                flag, scratch, n, n_codes, T, max_rounds, kBuild | kWalk,
                stream);
}

// One phase of a call, for timing them apart: 1 the row build alone
// (rows form), 2 the walk alone (on rows a phase 1 launch built).
extern "C" int hash_probe_phase_launch(
    const void* h, const void* step, const void* const* pcols,
    const int64_t* pstrides, const void* const* bcols,
    const int64_t* bstrides, const void* owner, const void* ok, void* idx,
    void* flag, void* scratch, int64_t n, int n_codes, int64_t T,
    int max_rounds, int phase, void* stream) {
  if (phase != kBuild && phase != kWalk) return (int)cudaErrorInvalidValue;
  return launch(h, step, pcols, pstrides, bcols, bstrides, owner, ok, idx,
                flag, scratch, n, n_codes, T, max_rounds, phase, stream);
}
