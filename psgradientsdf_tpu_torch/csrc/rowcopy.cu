// Indexed contiguous-row copy kernels for Hopper (sm_90a).
//
// The culled fusion (core/volume.py) moves its volume-state rows between the
// [N, R] state tables and a compacted [CAP, R] working set:
//
//   gather :  rows[i, :]       = table[idx[i], :]      i in [0, CAP)
//   scatter:  table[idx[i], :] = rows[i, :]            in place
//
// Elements are 4 bytes wide (float32 state, int32 visibility words) and are
// moved as raw 32-bit words.  idx is int32 or int64 and must lie in [0, N):
// that is the caller's contract, as in the JAX package's ops/rowcopy.py.
//
// The kernels replace the four Pallas kernels of that file:
//
//   gather_rows_dma   -> gather_direct_kernel    (one table a launch)
//   gather_rows       -> gather_staged_kernel    (one table a launch)
//   scatter_rows_dma  -> scatter_tables_kernel<false>     (up to 8 tables)
//   scatter_rows      -> scatter_winner_kernel, then
//                        scatter_tables_kernel<true>      (up to 8 tables)
//
// All are bound by bytes: CAP rows read and CAP rows written, 2*CAP*R*4 bytes
// for each table plus the index vector, no arithmetic.
//
// The gathers answer that with wide coalesced accesses and many rows in
// flight: one warp per row, 16-byte vector loads/stores when the row length
// and the base pointers allow, a 4-byte path otherwise.
//
// The scatters go further, because a launch that moves one table of a few MB
// spends most of its time ramping up and waiting on three dependent round
// trips (index, load, store).  One launch (scatter_tables_kernel) writes back
// ALL the tables that share an index vector (a fused frame has five), laid
// out by slot: a warp owns slot i, reads idx[i] once and moves that slot's
// segment of every table, with the loads of all the segments started before
// the first store (16-byte lanes for tables whose row length and bases allow
// it, 4-byte lanes for the others, decided per table).  On an H100 it moves a
// fused frame's 75 MB at about the speed of one contiguous device copy of
// the same bytes.  (A second design, persistent blocks pulling groups of the
// contiguous rows[CAP, R] through a shared-memory ring with TMA bulk copies
// and pushing each row out with a bulk store, was built and timed on the same
// card: it was slower under every plan tried and is not kept.)
//
// The ordered scatter (duplicates in slot order, the LAST slot wins) runs the
// same write kernel with a predicate: a first pass finds the winning slot of
// every row once for the shared index vector, and only winners write, so a
// losing slot's rows are never read.  The write kernel is a programmatic
// dependent launch: it is brought onto the card and reads its indices while
// the winner pass still runs, and waits for that pass only where it needs a
// winner.
//
// Both scatters take an optional count of live slots (a device scalar): the
// caller states that every slot at or past it repeats an earlier slot, index
// and bytes alike, and the kernels skip those slots.
//
// The TPU designs' sequential grid, scalar prefetch and DMA semaphore ring
// have no counterpart here: a block reads its own indices and blocks run in
// any order.
//
// Plain C interface (loaded with ctypes).  Every function launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps per block
constexpr int kWarps = kThreads / 32;       // rows per block (direct kernels)
constexpr int kGroup = 8;                   // rows per block (staged gather)
constexpr int kTileWords = 1024;            // staged tile: 4 KB per row
constexpr int kMaxTables = 8;               // tables per scatter launch
constexpr int kBuf = 12;                    // scatter: jobs in flight per lane

__device__ __forceinline__ long long load_index(const void* idx, int i,
                                                int idx64) {
  return idx64 ? static_cast<const long long*>(idx)[i]
               : static_cast<long long>(static_cast<const int*>(idx)[i]);
}

// Slots at or past *live are skipped (null: every slot is live).
__device__ __forceinline__ bool is_live(const long long* live, int slot) {
  return live == nullptr || slot < *live;
}

// One warp copies one row of `words` 32-bit words.
template <bool kVec>
__device__ __forceinline__ void warp_copy_row(const uint32_t* __restrict__ src,
                                              uint32_t* __restrict__ dst,
                                              int words, int lane) {
  if (kVec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int n4 = words >> 2;
    for (int j = lane; j < n4; j += 32) d[j] = s[j];
  } else {
    for (int j = lane; j < words; j += 32) dst[j] = src[j];
  }
}

// ---------------------------------------------------------------------------
// 1. direct gather (replaces gather_rows_dma): global -> global, warp per row
// ---------------------------------------------------------------------------
template <bool kVec>
__global__ void gather_direct_kernel(const uint32_t* __restrict__ table,
                                     const void* __restrict__ idx,
                                     uint32_t* __restrict__ out, int cap,
                                     int r, int idx64) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= cap) return;
  const int lane = threadIdx.x & 31;
  const long long src = load_index(idx, row, idx64);   // every lane, same word
  warp_copy_row<kVec>(table + src * r, out + static_cast<long long>(row) * r,
                      r, lane);
}

// ---------------------------------------------------------------------------
// 2. staged gather (replaces gather_rows): a block takes a group of kGroup
// rows, brings them tile by tile into shared memory (cp.async on the 16-byte
// path) and writes them out.  CAP need not be a multiple of the group.
// ---------------------------------------------------------------------------
template <bool kVec>
__global__ void gather_staged_kernel(const uint32_t* __restrict__ table,
                                     const void* __restrict__ idx,
                                     uint32_t* __restrict__ out, int cap,
                                     int r, int idx64) {
  __shared__ __align__(16) uint32_t stage[kGroup][kTileWords];
  const int warp = threadIdx.x >> 5;       // kWarps == kGroup: warp w <-> row w
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGroup + warp;
  const bool live = row < cap;
  const long long src = live ? load_index(idx, row, idx64) : 0;
  const uint32_t* s = table + src * r;
  uint32_t* d = out + static_cast<long long>(row) * r;

  for (int t0 = 0; t0 < r; t0 += kTileWords) {
    const int words = min(kTileWords, r - t0);
    if (live) {
      if (kVec) {
        for (int j = lane * 4; j < words; j += 128)
          __pipeline_memcpy_async(&stage[warp][j], s + t0 + j, 16);
        __pipeline_commit();
        __pipeline_wait_prior(0);
      } else {
        for (int j = lane; j < words; j += 32) stage[warp][j] = s[t0 + j];
      }
    }
    __syncthreads();
    if (live) warp_copy_row<kVec>(&stage[warp][0], d + t0, words, lane);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3. multi-table scatter (replaces scatter_rows_dma and, with the predicate,
// scatter_rows).  Up to kMaxTables tables share one index vector.
// ---------------------------------------------------------------------------
struct TableDesc {
  uint32_t* table;          // [N, r]
  const uint32_t* rows;     // [CAP, r]
  int r;                    // 32-bit words per row
  int vec;                  // 1: r % 4 == 0 and both bases 16-byte aligned
};

struct Tables {
  TableDesc t[kMaxTables];
  int n;
};

// Winner entries are 64-bit: the call's tag in the high word, the slot in the
// low word.  Tags grow from call to call on one scratch, so whatever an older
// call left behind loses every atomicMax and the scratch is never refilled.
// That assumes the calls that share a scratch run one after the other on the
// device (the wrapper keeps one scratch per stream), each with a tag larger
// than the last: two calls overlapping on one scratch, or a captured graph
// replaying one tag with other indices, would take each other's entries for
// their own.
__device__ __forceinline__ unsigned long long winner_entry(unsigned int tag,
                                                           int slot) {
  return (static_cast<unsigned long long>(tag) << 32) |
         static_cast<unsigned int>(slot);
}

__global__ void scatter_winner_kernel(unsigned long long* __restrict__ winner,
                                      const void* __restrict__ idx,
                                      const long long* __restrict__ live,
                                      int cap, int idx64, unsigned int tag) {
  // the write kernel may be brought onto the card now; it waits for this
  // grid's end (griddepcontrol.wait) before it reads a winner
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap && is_live(live, i))
    atomicMax(winner + load_index(idx, i, idx64), winner_entry(tag, i));
}

// One warp per slot.  The slot's work is cut into jobs of 32 lanes x
// (16 bytes | 4 bytes), table after table; up to kBuf jobs are loaded before
// the first of them is stored, so a lane has that many loads in flight (the
// main path's five tables are 9 jobs: one pass).
// Duplicate indices race between warps.  Without the predicate the caller
// guarantees that slots sharing an index carry identical bytes; with it only
// one slot per row writes.
template <bool kPred>
__global__ void __launch_bounds__(kThreads)
scatter_tables_kernel(const __grid_constant__ Tables tabs,
                      const void* __restrict__ idx,
                      const long long* __restrict__ live,
                      const unsigned long long* __restrict__ winner,
                      unsigned int tag, int cap, int idx64) {
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= cap) return;
  const int lane = threadIdx.x & 31;
  const long long dst = load_index(idx, slot, idx64);
  if (!is_live(live, slot)) return;
  if (kPred) {
    // launched while the winner pass still runs: wait for its end here
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (winner[dst] != winner_entry(tag, slot)) return;
  }

  int t = 0, k = 0;                 // the next job: table t, 32-lane chunk k
  while (t < tabs.n) {
    uint4 buf[kBuf];
    int tt = t, kk = k;
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {
      if (tt < tabs.n) {
        const TableDesc d = tabs.t[tt];
        const int units = d.vec ? (d.r >> 2) : d.r;
        const int j = kk * 32 + lane;
        const uint32_t* src = d.rows + static_cast<long long>(slot) * d.r;
        if (j < units) {
          if (d.vec) buf[b] = __ldcs(reinterpret_cast<const uint4*>(src) + j);
          else buf[b].x = __ldcs(src + j);
        }
        if ((kk + 1) * 32 >= units) { ++tt; kk = 0; } else { ++kk; }
      }
    }
#pragma unroll
    for (int b = 0; b < kBuf; ++b) {
      if (t < tabs.n) {
        const TableDesc d = tabs.t[t];
        const int units = d.vec ? (d.r >> 2) : d.r;
        const int j = k * 32 + lane;
        uint32_t* out = d.table + dst * d.r;
        if (j < units) {
          if (d.vec) reinterpret_cast<uint4*>(out)[j] = buf[b];
          else out[j] = buf[b].x;
        }
        if ((k + 1) * 32 >= units) { ++t; k = 0; } else { ++k; }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline bool vec_ok(const void* a, const void* b, int r) {
  return (r % 4 == 0) && aligned16(a) && aligned16(b);
}

inline int blocks_for(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

}  // namespace

extern "C" {

int rowcopy_gather_direct(const void* table, const void* idx, void* out,
                          int cap, int r, int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int grid = blocks_for(cap, kWarps);
  if (vec_ok(table, out, r))
    gather_direct_kernel<true><<<grid, kThreads, 0, st>>>(t, idx, o, cap, r, idx64);
  else
    gather_direct_kernel<false><<<grid, kThreads, 0, st>>>(t, idx, o, cap, r, idx64);
  return static_cast<int>(cudaGetLastError());
}

int rowcopy_gather_staged(const void* table, const void* idx, void* out,
                          int cap, int r, int idx64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  const int grid = blocks_for(cap, kGroup);
  if (vec_ok(table, out, r))
    gather_staged_kernel<true><<<grid, kThreads, 0, st>>>(t, idx, o, cap, r, idx64);
  else
    gather_staged_kernel<false><<<grid, kThreads, 0, st>>>(t, idx, o, cap, r, idx64);
  return static_cast<int>(cudaGetLastError());
}

// Scatter up to 8 tables that share `idx` in one launch.  `winner` null:
// direct (slots that share an index carry identical rows).  `winner` given
// (uint64[>= N], see scatter_winner_kernel): ordered, the last slot wins; the
// winner pass is launched first, once for all tables.  `live` is null or a
// device int64: slots at or past it repeat earlier slots and are skipped.
int rowcopy_scatter_tables(void* const* tables, const void* const* rows,
                           const int* r, int n_tables, const void* idx,
                           const void* live, int cap, int idx64, void* winner,
                           unsigned int tag, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tables < 1 || n_tables > kMaxTables || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tabs;
  tabs.n = n_tables;
  for (int t = 0; t < n_tables; ++t) {
    tabs.t[t].table = static_cast<uint32_t*>(tables[t]);
    tabs.t[t].rows = static_cast<const uint32_t*>(rows[t]);
    tabs.t[t].r = r[t];
    tabs.t[t].vec = vec_ok(tables[t], rows[t], r[t]) ? 1 : 0;
  }
  for (int t = n_tables; t < kMaxTables; ++t) tabs.t[t] = TableDesc{nullptr, nullptr, 0, 0};

  const long long* lv = static_cast<const long long*>(live);
  unsigned long long* w = static_cast<unsigned long long*>(winner);
  if (w != nullptr) {
    scatter_winner_kernel<<<blocks_for(cap, kThreads), kThreads, 0, st>>>(
        w, idx, lv, cap, idx64, tag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = blocks_for(cap, kWarps);
  if (w != nullptr) {
    // programmatic dependent launch: the write kernel's launch and its index
    // loads overlap the winner pass
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const unsigned long long* wc = w;
    cudaError_t err = cudaLaunchKernelEx(&cfg, scatter_tables_kernel<true>, tabs,
                                         idx, lv, wc, tag, cap, idx64);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    scatter_tables_kernel<false><<<grid, kThreads, 0, st>>>(tabs, idx, lv, w, tag, cap, idx64);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
