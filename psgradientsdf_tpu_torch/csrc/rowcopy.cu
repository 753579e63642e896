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
// The kernels replace the four Pallas kernels of that file.  Every one of
// them moves ALL the tables that share an index vector (up to 8; a fused
// frame has five) in one launch:
//
//   gather_rows_dma   -> gather_tables_kernel
//   gather_rows       -> gather_staged_kernel
//   scatter_rows_dma  -> scatter_tables_kernel<false>
//   scatter_rows      -> scatter_winner_kernel, then
//                        scatter_tables_kernel<true>
//
// All are bound by bytes, no arithmetic.  A gather must read every DISTINCT
// source row once (a second read of a row is served by the L2 cache), write
// every slot's row and read the index vector once:
// (distinct + CAP) * sum(R) * 4 + CAP * 4 bytes.  A scatter must move only
// the rows that end up in the table: 2 * distinct * sum(R) * 4 + CAP * 4.
//
// A launch that moves one table of a few MB spends most of its time ramping
// up and waiting on three dependent round trips (index, load, store), hence
// one launch for all the tables.
//
// The direct gather and both scatters are laid out by slot: a warp owns slot
// i, reads idx[i] once and moves that slot's segment of every table, with the
// loads of all the segments started before the first store (16-byte lanes for
// tables whose row length and bases allow it, 4-byte lanes for the others,
// decided per table).  On an H100 that moves a fused frame's 75 MB at about
// the speed of one contiguous device copy of the same bytes.  (A second
// design for the scatters, persistent blocks pulling groups of the contiguous
// rows[CAP, R] through a shared-memory ring with bulk copies, was built and
// timed on the same card: slower under every plan tried, not kept.)
//
// The staged gather keeps the TPU kernel's mechanism, rows staged through
// on-chip memory, with this card's means: the same layout by slot, but the
// segment goes through the warp's shared-memory buffer by cp.async copies
// (section 2 below).  (A second design for it, persistent blocks bringing
// groups of 1-16 slots into shared-memory stages with one cp.async.bulk per
// row and table on an mbarrier and writing each table's piece out with one
// bulk store, was built and timed on the same card: level with this one on
// average, 3 % behind on the fusion's index pattern, and is not kept.)
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
// and bytes alike, and the kernels skip those slots.  The gathers take none:
// every slot of their output is written.
//
// The TPU designs' sequential grid, scalar prefetch and DMA semaphore ring
// have no counterpart here: a block reads its own indices and blocks run in
// any order.
//
// The gathers and the direct scatter take their tables by value and keep no
// state between calls, so they may be captured in a CUDA graph; the ordered
// scatter may not (see winner_entry).
//
// Plain C interface (loaded with ctypes).  Every function launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps per block
constexpr int kWarps = kThreads / 32;       // slots per block (warp per slot)
constexpr int kMaxTables = 8;               // tables per launch
constexpr int kBuf = 12;                    // warp per slot: jobs in flight per lane
constexpr int kWarpWords = 1152;            // staged gather: words per warp buffer
constexpr int kStagedSmem = kWarps * 2 * kWarpWords * 4;   // two buffers a warp

__device__ __forceinline__ long long load_index(const void* idx, int i,
                                                int idx64) {
  return idx64 ? static_cast<const long long*>(idx)[i]
               : static_cast<long long>(static_cast<const int*>(idx)[i]);
}

// Slots at or past *live are skipped (null: every slot is live).
__device__ __forceinline__ bool is_live(const long long* live, int slot) {
  return live == nullptr || slot < *live;
}

// Up to kMaxTables tables share one index vector.
struct TableDesc {
  uint32_t* table;          // [N, r]
  uint32_t* rows;           // [CAP, r]: a scatter's source, a gather's output
  int r;                    // 32-bit words per row
  int vec;                  // 1: r % 4 == 0 and both bases 16-byte aligned
};

struct Tables {
  TableDesc t[kMaxTables];
  int n;
};

// The memory instructions of a row move, by direction.  A scatter's source
// rows are read once and never again: streaming loads.  A gather's source
// rows are read again (by duplicate slots, and by the scatter that writes the
// same rows back): default loads; its output streams out, so that it does not
// push table rows out of the L2 cache.  (Timed on an H100 on a fused frame's
// five tables: streaming loads cost a gather 10 % where half of the slots are
// duplicates, streaming stores gain it 6 % there, and neither moves the time
// where every row is distinct.)
template <bool kGather>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  return kGather ? *p : __ldcs(p);
}
template <bool kGather>
__device__ __forceinline__ uint32_t load4(const uint32_t* p) {
  return kGather ? *p : __ldcs(p);
}
template <bool kGather>
__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  if (kGather) __stcs(p, v); else *p = v;
}
template <bool kGather>
__device__ __forceinline__ void store4(uint32_t* p, uint32_t v) {
  if (kGather) __stcs(p, v); else *p = v;
}

// One warp moves one slot's segment of every table between row `row` of the
// tables and slot `slot` of the row blocks: table -> rows when kGather, rows
// -> table otherwise.  The work is cut into jobs of 32 lanes x (16 bytes |
// 4 bytes), table after table; up to kBuf jobs are loaded before the first of
// them is stored, so a lane has that many loads in flight (the main path's
// five tables are 9 jobs: one pass).
template <bool kGather>
__device__ __forceinline__ void warp_move_slot(const Tables& tabs,
                                               long long row, int slot,
                                               int lane) {
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
        const uint32_t* src = kGather ? d.table + row * d.r
                                      : d.rows + static_cast<long long>(slot) * d.r;
        if (j < units) {
          if (d.vec) buf[b] = load16<kGather>(reinterpret_cast<const uint4*>(src) + j);
          else buf[b].x = load4<kGather>(src + j);
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
        uint32_t* dst = kGather ? d.rows + static_cast<long long>(slot) * d.r
                                : d.table + row * d.r;
        if (j < units) {
          if (d.vec) store16<kGather>(reinterpret_cast<uint4*>(dst) + j, buf[b]);
          else store4<kGather>(dst + j, buf[b].x);
        }
        if ((k + 1) * 32 >= units) { ++t; k = 0; } else { ++k; }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. direct gather (replaces gather_rows_dma): global -> global, a warp per
// slot, all the tables of the call.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
gather_tables_kernel(const __grid_constant__ Tables tabs,
                     const void* __restrict__ idx, int cap, int idx64) {
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= cap) return;
  const long long src = load_index(idx, slot, idx64);   // every lane, same word
  warp_move_slot<true>(tabs, src, slot, threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// 2. staged gather (replaces gather_rows): the rows go through shared memory.
// A warp per slot; the slot's segment of every table comes into the warp's
// own shared-memory buffer by asynchronous copies that hold no registers
// (cp.async, 16 bytes each; plain loads on the 4-byte path) and leaves it
// with streaming stores.  A buffer holds the main path's whole 4608-byte
// segment, so all of a slot's copies are in flight at once.  Wider segments
// go chunk by chunk through two buffers: the next chunk's copies are started
// before the warp waits for this one's.  Three blocks an SM.
// ---------------------------------------------------------------------------

// A slot's segment is cut into pieces, table after table: a piece is up to
// kWarpWords words of one table's row.  A chunk is as many consecutive pieces
// as fit one buffer.  A cursor names the next piece; t == tabs.n: none left.
struct Cursor { int t, off; };       // table, word offset in its row

// Calls f(table, word offset in the row, width, word offset in the buffer)
// for every piece of the chunk at `c` and moves `c` past it.
template <class F>
__device__ __forceinline__ void walk_chunk(const Tables& tabs, Cursor& c, F&& f) {
  int used = 0;
  while (c.t < tabs.n) {
    const int r = tabs.t[c.t].r;
    const int w = min(r - c.off, kWarpWords);
    const int sz = (w + 3) & ~3;                // pieces stay 16-byte aligned
    if (used + sz > kWarpWords) break;          // the first piece always fits
    f(tabs.t[c.t], c.off, w, used);
    used += sz;
    c.off += w;
    if (c.off == r) { ++c.t; c.off = 0; }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_staged_kernel(const __grid_constant__ Tables tabs,
                     const void* __restrict__ idx, int cap, int idx64) {
  extern __shared__ __align__(16) uint32_t stage_mem[];   // kStagedSmem bytes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + warp;
  if (slot >= cap) return;                       // only warp-level syncs below
  const long long src = load_index(idx, slot, idx64);
  uint32_t* buf = stage_mem + warp * 2 * kWarpWords;
  Cursor ci{0, 0}, cc{0, 0};                     // next chunk to load, to store

  auto start_copies = [&](int unit) {
    uint32_t* st = buf + (unit & 1) * kWarpWords;
    walk_chunk(tabs, ci, [&](const TableDesc& d, int off, int w, int at) {
      const uint32_t* from = d.table + src * d.r + off;
      if (d.vec)
        for (int x = lane * 4; x < w; x += 128)
          __pipeline_memcpy_async(st + at + x, from + x, 16);
      else
        for (int x = lane; x < w; x += 32) st[at + x] = from[x];
    });
    __pipeline_commit();
  };

  start_copies(0);
  for (int unit = 0; cc.t < tabs.n; ++unit) {
    if (ci.t < tabs.n) {
      start_copies(unit + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    const uint32_t* st = buf + (unit & 1) * kWarpWords;
    walk_chunk(tabs, cc, [&](const TableDesc& d, int off, int w, int at) {
      uint32_t* to = d.rows + static_cast<long long>(slot) * d.r + off;
      if (d.vec)
        for (int x = lane * 4; x < w; x += 128)
          store16<true>(reinterpret_cast<uint4*>(to + x),
                        *reinterpret_cast<const uint4*>(st + at + x));
      else
        for (int x = lane; x < w; x += 32) store4<true>(to + x, st[at + x]);
    });
    __syncwarp();                    // before the buffer is filled again
  }
}

// ---------------------------------------------------------------------------
// 3. multi-table scatter (replaces scatter_rows_dma and, with the predicate,
// scatter_rows).
// ---------------------------------------------------------------------------

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

// One warp per slot (warp_move_slot).  Duplicate indices race between warps.
// Without the predicate the caller guarantees that slots sharing an index
// carry identical bytes; with it only one slot per row writes.
template <bool kPred>
__global__ void __launch_bounds__(kThreads)
scatter_tables_kernel(const __grid_constant__ Tables tabs,
                      const void* __restrict__ idx,
                      const long long* __restrict__ live,
                      const unsigned long long* __restrict__ winner,
                      unsigned int tag, int cap, int idx64) {
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= cap) return;
  const long long dst = load_index(idx, slot, idx64);
  if (!is_live(live, slot)) return;
  if (kPred) {
    // launched while the winner pass still runs: wait for its end here
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (winner[dst] != winner_entry(tag, slot)) return;
  }
  warp_move_slot<false>(tabs, dst, slot, threadIdx.x & 31);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The descriptors of a call's tables; false when the call is malformed.
inline bool fill_tables(Tables& tabs, void* const* tables, void* const* rows,
                        const int* r, int n_tables, int cap) {
  if (n_tables < 1 || n_tables > kMaxTables || cap < 1) return false;
  tabs.n = n_tables;
  for (int t = 0; t < kMaxTables; ++t) {
    if (t < n_tables)
      tabs.t[t] = TableDesc{static_cast<uint32_t*>(tables[t]),
                            static_cast<uint32_t*>(rows[t]), r[t],
                            (r[t] % 4 == 0) && aligned16(tables[t]) &&
                                aligned16(rows[t]) ? 1 : 0};
    else
      tabs.t[t] = TableDesc{nullptr, nullptr, 0, 0};
  }
  return true;
}

inline int blocks_for(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

}  // namespace

extern "C" {

// Gather up to 8 tables that share `idx` in one launch of the direct kernel:
// rows[t][i, :] = tables[t][idx[i], :].
int rowcopy_gather_tables(void* const* tables, void* const* rows, const int* r,
                          int n_tables, const void* idx, int cap, int idx64,
                          void* stream) {
  Tables tabs;
  if (!fill_tables(tabs, tables, rows, r, n_tables, cap))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_tables_kernel<<<blocks_for(cap, kWarps), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(tabs, idx, cap, idx64);
  return static_cast<int>(cudaGetLastError());
}

// The same function through the staged kernel.
int rowcopy_gather_tables_staged(void* const* tables, void* const* rows,
                                 const int* r, int n_tables, const void* idx,
                                 int cap, int idx64, void* stream) {
  Tables tabs;
  if (!fill_tables(tabs, tables, rows, r, n_tables, cap))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB shared memory is granted only on request
  cudaError_t err = cudaFuncSetAttribute(
      gather_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStagedSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_staged_kernel<<<blocks_for(cap, kWarps), kThreads, kStagedSmem,
                         static_cast<cudaStream_t>(stream)>>>(tabs, idx, cap, idx64);
  return static_cast<int>(cudaGetLastError());
}

// Scatter up to 8 tables that share `idx` in one launch.  `winner` null:
// direct (slots that share an index carry identical rows).  `winner` given
// (uint64[>= N], see scatter_winner_kernel): ordered, the last slot wins; the
// winner pass is launched first, once for all tables.  `live` is null or a
// device int64: slots at or past it repeat earlier slots and are skipped.
int rowcopy_scatter_tables(void* const* tables, void* const* rows,
                           const int* r, int n_tables, const void* idx,
                           const void* live, int cap, int idx64, void* winner,
                           unsigned int tag, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Tables tabs;
  if (!fill_tables(tabs, tables, rows, r, n_tables, cap))
    return static_cast<int>(cudaErrorInvalidValue);

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
