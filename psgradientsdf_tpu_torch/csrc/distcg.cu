// The distance block's solve for Hopper (sm_90a): its normal equations
// assembled per row (dist_system), and the whole Jacobi-preconditioned CG in
// ONE cooperative launch (dist_cg).  On the one-card refinement the block's
// regularizer operators are a stage of dist_system and its update a stage
// of dist_cg, so a distance block is three launches: dist_jacobian
// (csrc/residual.cu), dist_system, dist_cg.
//
// Together they replace the JAX package's distance solve as
// psgradientsdf_tpu/refine/optimizer.py `_dist_block` (:186) runs it:
// refine/solvers.py `solve_distance` (:265) with jax.scipy.sparse.linalg.cg
// (:301) or `pcg_fixed` (:39) over `_distance_system` (:207), built from
// `stencil_apply` / `stencil_apply_T` / `stencil_diag` (:84, :100, :113),
// `eikonal_operator` (:135), `laplacian_operator` (:157) and `lap_apply` /
// `lap_apply_T` / `lap_diag` (:175, :184, :194).  XLA keeps that solve in
// one device program; the port's eager version ran some 85-90 launches a
// CG step, its transposes as atomic scatter-adds (index_add_).
//
// The assembled form (see ops/distcg.py): a row n of the photometric term
// touches x at its 4-point stencil (n and its three neighbours), so J^T W J
// is the sum of P_n^T A_n P_n with A_n = sum_{f,c} w a a^T + reg_weight_n
// e e^T (10 floats, symmetric) and the gradient's t_n = sum w r a +
// reg_weight_n r_e e.  (H x)[m] gathers s_n = A_n P_n x from the rows that
// name m through the reverse table rev [N,6]; the Laplacian is symmetric
// between compact rows, so its transpose gathers through lap_idx.  No
// atomics: every sum runs in one fixed order, a solve gives the same bits
// on every run.
//
// dist_system_kernel<G, staged>: a group of G lanes a row, G = the host's
// ops/distcg.system_lanes(F*3) (4, 8, 16 or 32: the fewest that give a lane
// at most 16 pairs; 4 at the LED run's F = 8, 8 at the main F = 40), so
// 32 / G rows share a warp.  Lane l of a group adds the pairs j = l, l + G,
// ... of the row's F*3 in order (kUnroll pairs' loads in flight), each
// product and sum rounded once (_rn intrinsics); the G lane sums are added
// pairwise over log2 G levels (lane l and l ^ G/2, then ^ G/4, ...) as a
// reduce-scatter, then the Eikonal row.  The plain version
// (ops/distcg.dist_system_plain) emulates that order: the kernel equals it
// bit for bit.  The launch follows the host plan ops/distcg._system_plan:
// a persistent grid (kSysBlocks blocks an SM where two ring stages fit,
// else one) over tiles of consecutive rows, 8 consumer warps, one
// producer warp and one regularizer warp a block, each consumer warp one
// row group a lane (32 / G rows) of a tile.
// A tile's inputs are seven contiguous runs (w, r, J0 [rows][F*3], Ji
// [rows][3][F*3], the Eikonal row's r, J0 [rows] and Ji [rows][3]); the
// producer's lane 0 copies them into a ring of up to 4 shared-memory stages
// with cp.async.bulk on the stage's mbarrier (csrc/async_copy.cuh; a run's
// last 1-3 floats past its 16-byte body by its own loads), so the next
// tiles are in flight while this one is summed; depth 0 (an input not
// 16-byte aligned, or a stage too large) has the lanes read device memory
// instead.  A warp stages its rows' A (10 floats) and t (4) in shared
// memory and writes each as one contiguous run with 16-byte stores.  Bound
// by bytes: w, r, J0 and Ji read once (24 bytes a pair: 141.6 MB at N =
// 49152, F = 40, 0.042 ms at 3.35 TB/s), 20 bytes a row of the Eikonal row
// and 56 bytes a row written; at F = 40 it reads at a plain torch.sum's rate
// over as many bytes (PERF.md §6 records the designs measured).
// The regularizer stage (reg): the Eikonal row and the Laplacian's residual
// are formed here from the rows' stencils in place of three staged runs
// (csrc/distreg.cu reg_operators_kernel's arithmetic, stencil.cuh, so the
// bits are the standalone kernel's): each work below a launch's own
// latency, it needs no launch of its own.  While the producer's lane 0
// issues a tile's bulk copies, the regularizer warp's 32 lanes gather the
// tile's rows' distances (valid, dist, the one-sided stencil's index,
// constant and direction; the Laplacian's six) and write each row's
// Eikonal terms into the stage's slots and its Laplacian residual to lap_r
// [N] (dist_cg's input), a tile ahead of the stage, then arrive on the
// stage's reg mbarrier (32 arrivals).  The consumers wait on it only after
// their pairs' sums, before they add the Eikonal row: its dependent gathers
// hold back neither the copies nor the sums (the producer's idle lanes
// doing the same, on the full mbarrier, were measured slower, PERF.md §6).  In the
// lanes' loads variant each row group forms its
// row's terms itself.  It reads 41 bytes a row of stencil in place of the
// 20 of the Eikonal row (+ 52 with the Laplacian: its stencil and lap_r).
//
// dist_cg_kernel: ONE cooperative launch runs the whole PCG.  The host plan
// (ops/distcg._cg_plan) gives each block a contiguous tile of rows whose
// start is a multiple of 16 rows, one block an SM and kCgThreads threads,
// and one of three layouts, the kernel's template parameter:
//   kTile     the tile's A, nbr, rev, valid and, under the Laplacian's
//             neighbour term, lap_idx are copied into shared memory in the
//             prologue, one 1-D bulk copy an array (cp.async.bulk completing
//             on an mbarrier; the last tile's ragged tails by the threads),
//             and the block's rows' s = A P p and its vectors x, r, z, A p,
//             p, the safe diagonal, damping diag (and its Laplacian rows)
//             live there for the whole launch: 121 bytes a row, 149 under
//             the neighbour term (at N = 49152, 128 blocks of 384 rows,
//             46.6 KB);
//   kVectors  a tile too large for that (ops/distcg.resident_tile_limit):
//             s and the vectors stay in shared memory, the rows and tables
//             are read from global memory;
//   kGlobal   a tile whose vectors do not fit either: they live in device
//             memory too, each block's own range.
// Device memory holds only what other tiles read: the block's rows' z and
// last p as one float2 pair (another tile's p is z + beta p_old from one
// load), their Laplacian rows, and under kTile each row's A row 1 + ax and
// its neighbours along the other two axes, per axis (written once, in the
// prologue); they are read across blocks with ld.global.cg after a
// barrier, and a block never reads its own rows back from there.
// The prologue forms b and diag in gather form (plus the Laplacian's
// L^T r_l and diagonal), the safe Jacobi diagonal, x = 0, r = b,
// z = p = r / d (solvers.distance_rhs's arithmetic, _rn intrinsics in the
// plain version's order); one grid.sync.  A step is
//   p = z + beta p_old of the block's rows (not at step 0), and under the
//       Laplacian's neighbour term its rows lap(p)_m; barrier;
//   H p with no grid barrier inside: each row n forms s_n = A_n P_n p into
//       shared memory; then row m adds s_m[0] and, for each row n that
//       names m (the reverse table), s_n[1 + ax]: a row of the tile's from
//       shared memory, another tile's formed here from its A row, its
//       stencil (whose neighbour along ax is m) and p there (z + beta p_old
//       from the published pairs), with the same products and sums in the
//       same order, so H p keeps operator_apply's bits
//       (ops/distcg.hp_gather_plain emulates it); + w_l L^T lap(p),
//       + damping diag p, where(valid, ., p); the block's part of p.Ap;
//       barrier;
//   alpha; x, r, z = r / d and the block's parts of r.z and r.r; barrier;
//       beta, and the stop test r.r > thr before the next step (scipy's
//       rule thr = max(tol^2 b.b, atol^2), or cg_static's tol^2 b.b with
//       its clamped divisions), decided on the device.
// A row's loads of other tiles' data are predicated instructions with no
// branch around them, so its six slots' loads are in flight together (with
// a branch a slot, nvcc waited for each slot's loads in turn).
// Two grid barriers a step (three under the neighbour term, whose L^T L p
// needs lap(p) at six neighbours), one grid.sync in the prologue; the
// classic PCG recurrence of the plain version.  Each barrier carries its
// sum: thread 0 writes the block's partials and arrives on one counter
// (red.release.gpu), warp 0 polls the counter (ld.acquire.gpu) until every
// block of this barrier has arrived, then reads all the partials in one
// parallel load and adds them in one fixed order, the same in every block,
// so every block holds the same alpha and beta and takes the same branch
// (csrc/cg_sync.cuh, shared with csrc/albedo.cu).
// Two sets of partials, alternating, suffice: a block cannot write barrier
// e + 2's before every block has passed e + 1.  (On the H100 this was the
// fastest barrier with its sum measured: grid.sync and the same load, and
// each block's partials tagged with the barrier's number and polled by
// every block, were slower; tools/distcg_tune.py, PERF.md.)  The counter
// is the only atomic and holds no value that is summed: two runs give the
// same bits.  The dots are summed in another order than the plain
// version's torch.sum, so the two agree to float32 rounding.  delta
// (masked by valid) and the step count go to device memory; nothing is
// read back.  Bound by bytes: A, t,
// the tables and the mask read once, delta written once (97 bytes a row
// without the Laplacian, 1.4 us at N = 49152); the time is set by the
// steps' scattered loads and their barriers (chip_smoke.py times an empty
// cooperative kernel crossing as many).
// The update stage (update): after the last step and delta, one more
// barrier, then each block applies the accept rule (|delta| < thr on a
// valid row, thr = sqrt(3) h rounded once to float) to its rows and their
// three neighbours and writes new_dist and the one-sided gradient of the
// accepted distances new_grad (csrc/distreg.cu dist_update_kernel's
// arithmetic, stencil.cuh): a row's own step and its tile's from x in the
// block's vectors, another tile's from delta by ld.global.cg.  It leaves
// delta's and the steps' bits as they are, and adds 44 bytes a row (dist,
// the direction and the constants read; new_dist and new_grad written).
//
// Plain C interface (loaded with ctypes): dist_system() and dist_cg() launch
// on the stream they are given; dist_cg_occupancy() checks the plan's
// layout on the current device; dist_barriers() launches the empty kernel.
// Each returns 0 or the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cg_sync.cuh"
#include "stencil.cuh"

namespace cg = cooperative_groups;

struct SystemPlan {            // ops/distcg.py SystemPlan, field for field
  int64_t lanes, tile, depth, blocks, smem_bytes, ring;
};

struct SystemArgs {            // ops/distcg.py _SystemArgs, field for field
  const float* w;
  const float* r;
  const float* J0;
  const float* Ji;
  const float* eik_r;          // the Eikonal row, formed beforehand (reg 0)
  const float* eik_J0;
  const float* eik_Ji;
  float* A;
  float* t;
  int64_t n, pairs, eik;
  double reg_weight_n;
  SystemPlan plan;
  // the regularizer stage (reg 1): the Eikonal row (eik) and the
  // Laplacian's residual (laplacian) formed from the rows' stencils
  const unsigned char* valid;  // [N]
  const float* dist;           // [N]
  const int32_t* nbr;          // [N, 3] the one-sided stencil
  const float* nbr_dir;        // [N, 3]
  const float* nbr_const;      // [N, 3] a frozen neighbour's distance
  const int32_t* lap;          // [N, 6] the Laplacian's stencil
  const float* lap_const;      // [N, 6]
  float* lap_r;                // [N] written: the Laplacian's residual
  int64_t reg, laplacian;
  double voxel;                // h
};

struct CgPlan {                // ops/distcg.py CgPlan, field for field
  int64_t blocks, tile, mode, smem_bytes, barriers;
  // byte offsets of the tile's regions in shared memory (0: not there)
  int64_t A, nbr, rev, lap, valid, vec;
  int64_t tail;                // grid barriers after the last step: 1 with the update stage
};

struct CgArgs {                // ops/distcg.py _CgArgs, field for field
  const float* A;
  const float* t;
  const int32_t* nbr;
  const int32_t* rev;
  const int32_t* lap;
  const unsigned char* valid;
  const float* lap_r;
  float* delta;
  int64_t* steps;
  float* work;                 // kPublished floats a row, then kTile's tables or kGlobal's rows
  uint32_t* sync;              // the barriers' counter (4 words), [2][blocks][2] floats
  int64_t n, maxiter, fixed, use_lap, lap_nbr;
  double reg_weight_l, diag_coef, nbr_coef, diag_coef_sq, nbr_coef_sq,
      damping, tol_sq, atol_sq;
  CgPlan plan;
  // the update stage (update 1): the accept rule and the new gradient
  const float* dist;           // [N]
  const float* nbr_dir;        // [N, 3]
  const float* nbr_const;      // [N, 3]
  float* new_dist;             // [N] written
  float* new_grad;             // [N, 3] written
  int64_t update;
  double voxel;                // h
  double accept;               // the threshold sqrt(3) h, a float's value
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSysWarps = 8;                        // ops/distcg.SYSTEM_WARPS
constexpr int kSysBlocks = 2;                       // ops/distcg.SYSTEM_BLOCKS
constexpr int kSysThreads = 32 * (kSysWarps + 2);   // and the producer and regularizer warps
constexpr int kSysDepth = 4;                        // ops/distcg.SYSTEM_DEPTH
constexpr int kSysBarriers = 3 * kSysDepth * 8;     // full[4], empty[4], reg[4]
constexpr int kUnroll = 4;        // pairs a lane has in flight

// A's 10 entries in the order 00 01 02 03 11 12 13 22 23 33: entry q is
// (pair_i(q), pair_k(q)), and (i, k) is entry sym(i, k) for any i, k (all
// folded at compile time in the unrolled loops)
__host__ __device__ constexpr int pair_i(int q) { return q < 4 ? 0 : q < 7 ? 1 : q < 9 ? 2 : 3; }
__host__ __device__ constexpr int pair_k(int q) {
  return q < 4 ? q : q < 7 ? q - 3 : q < 9 ? q - 5 : 3;
}
__host__ __device__ constexpr int sym(int i, int k) {
  return (i < k ? i : k) * 4 - (i < k ? i : k) * ((i < k ? i : k) - 1) / 2 +
         ((i < k ? k : i) - (i < k ? i : k));   // row a's entries start at 0, 4, 7, 9
}
static_assert(sym(1, 1) == 4 && sym(3, 2) == 8 && sym(3, 3) == 9, "A's layout");
static_assert(pair_i(5) == 1 && pair_k(5) == 2 && pair_k(8) == 3, "A's layout");

// ------------------------------------------------------------ dist_system

struct SystemParams {
  const float* __restrict__ w;
  const float* __restrict__ r;
  const float* __restrict__ J0;
  const float* __restrict__ Ji;
  const float* __restrict__ eik_r;
  const float* __restrict__ eik_J0;
  const float* __restrict__ eik_Ji;
  float* __restrict__ A;
  float* __restrict__ t;
  const unsigned char* __restrict__ valid;   // the regularizer stage
  const float* __restrict__ dist;
  const int32_t* __restrict__ nbr;
  const float* __restrict__ nbr_dir;
  const float* __restrict__ nbr_const;
  const int32_t* __restrict__ lap;
  const float* __restrict__ lap_const;
  float* __restrict__ lap_r;
  int64_t n, tiles;
  int pairs, eik, tile, depth, ring, reg, laplacian;
  float lam;
  RegConsts rc;
};

// The regularizer stage of row n from its stencil, in reg_operators_kernel's
// arithmetic (stencil.cuh): the Eikonal row's terms e = (J0, Ji, r), 0 on an
// invalid row or without the Eikonal term, and with the Laplacian (and
// `write_lap`) its residual into lap_r[n], 0 on an invalid row.  Every
// neighbour's distance is gathered before any arithmetic, so the row's
// nine gathers are in flight together.
__device__ __forceinline__ void reg_row(const SystemParams& p, int64_t n, float (&e)[5],
                                        bool write_lap) {
  const bool valid = p.valid[n] != 0;
  const float d = __ldg(p.dist + n);
  const bool lap = p.laplacian && write_lap;
  auto value = [&](int64_t j) { return __ldg(p.dist + j); };
  float dn[3], dl[6];
  if (p.eik) gather_row(value, p.nbr + 3 * n, p.nbr_const + 3 * n, dn);
  if (lap) gather_row(value, p.lap + 6 * n, p.lap_const + 6 * n, dl);
#pragma unroll
  for (int q = 0; q < 5; ++q) e[q] = 0.0f;
  if (p.eik && valid) eikonal_row(dn, p.nbr_dir + 3 * n, d, p.rc, e);
  if (lap) p.lap_r[n] = valid ? laplacian_row(dl, d, p.rc.inv_h2) : 0.0f;
}

// a pair's input: from the ring (shared memory) or from device memory
template <bool kStaged>
__device__ __forceinline__ float ld_pair(const float* a) {
  if constexpr (kStaged) return *a;
  else return __ldg(a);
}

// The producer's copy of one run of `count` floats into a stage: its
// 16-byte body by one bulk copy on bar (issued by bulk_run after the
// stage's expect_tx), the 1-3 floats past it here -> the body's bytes.
__device__ __forceinline__ uint32_t run_tail(float* s, const float* g, int64_t count) {
  const int64_t body = count & ~int64_t{3};
  for (int64_t i = body; i < count; ++i) s[i] = __ldg(g + i);
  return static_cast<uint32_t>(body * 4);
}

__device__ __forceinline__ void bulk_run(float* s, const float* g, uint32_t bytes, uint64_t* bar) {
  if (bytes) bulk_load(s, g, bytes, bar);
}

// `count` floats from shared memory to device memory by a warp: 16-byte
// stores from dst's first 16-byte boundary on, single floats around them
__device__ __forceinline__ void store_run(float* dst, const float* src, int count, int lane) {
  const int lead = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  const int head = lead < count ? lead : count;
  if (lane < head) dst[lane] = src[lane];
  const int body = (count - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = lane; i < body; i += 32) {
    const float* s = src + head + 4 * i;
    d4[i] = make_float4(s[0], s[1], s[2], s[3]);
  }
  for (int i = head + 4 * body + lane; i < count; i += 32) dst[i] = src[i];
}

// The reduce-scatter of a row group's 16 values (A's 10, t's 4, two zeros)
// over its G lanes: at the level of lanes l and l ^ s (s = G/2, ..., 1) the
// lane with bit s set keeps the upper half of its values and its partner
// the lower, each adding the half the other sends; with one value left the
// two add theirs.  Each sum pairs the same lanes' partial sums as the xor
// butterfly does (ops/distcg._lane_sum), so the bits are the butterfly's,
// for a quarter of its shuffles.  After it a lane holds the values [gl * 16
// / G, + 16 / G) (G <= 16), or value gl / 2 (G = 32).
template <int NV>
__device__ __forceinline__ void scatter_level(float (&v)[16], int s, bool upper) {
  if constexpr (NV > 1) {
    constexpr int H = NV / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[H + i];
      const float keep = upper ? v[H + i] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, s));
    }
  } else {
    v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], s));
  }
}

template <int G, int NV = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int gl) {
  if constexpr (G > 1) {
    scatter_level<NV>(v, G / 2, (gl & (G / 2)) != 0);
    reduce_scatter<G / 2, (NV > 1 ? NV / 2 : 1)>(v, gl);
  }
}

// Dynamic shared memory: full[kSysDepth], empty[kSysDepth] and
// reg[kSysDepth] mbarriers (kSysBarriers bytes), each consumer warp's staged
// outputs [32 / G] x (A's
// 10, then t's 4 a row), then from byte p.ring the ring: p.depth
// stages of the tile's w, r, J0 [tile][pairs], Ji [tile][3][pairs] and the
// Eikonal row's r, J0 [tile] and Ji [tile][3].
template <int G, bool kStaged>
__global__ void __launch_bounds__(kSysThreads, kSysBlocks)
dist_system_kernel(const __grid_constant__ SystemParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kRows = 32 / G;                     // rows a warp holds at once
  constexpr int kMine = G < 32 ? 16 / G : 1;        // values a lane ends with
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kSysDepth;
  uint64_t* regd = empty + kSysDepth;               // the regularizer warp's rows in
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int J = p.pairs, R = p.tile, D = p.depth;
  const int64_t run = static_cast<int64_t>(R) * J;  // a stage: 6 such runs, then 5 R
  const int64_t stage = 6 * run + 5 * R;
  float* ring = reinterpret_cast<float*>(smem + p.ring);
  if constexpr (kStaged) {
    if (threadIdx.x == 0) {
      // full: the bulk copies' bytes and the producer's arrival; regd: the
      // regularizer warp's 32 lanes' once their rows are in the stage
      for (int s = 0; s < D; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kSysWarps);
        mbar_init(&regd[s], 32);
      }
      fence_mbar_init();
    }
    __syncthreads();
  }
  if (warp == kSysWarps) {                          // the producer
    if constexpr (kStaged) {
      if (lane != 0) return;
      const int runs = p.eik && !p.reg ? 7 : 4;
      int k = 0;
      for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
        const int s = k % D;
        if (k >= D) mbar_wait(&empty[s], ((k / D) - 1) & 1);
        const int64_t n0 = tile * R;
        const int64_t rows = p.n - n0 < R ? p.n - n0 : R;
        float* st = ring + stage * s;
        const float* g[7] = {p.w + n0 * J, p.r + n0 * J, p.J0 + n0 * J, p.Ji + 3 * n0 * J,
                             p.eik_r + n0, p.eik_J0 + n0, p.eik_Ji + 3 * n0};
        float* d[7] = {st, st + run, st + 2 * run, st + 3 * run, st + 6 * run,
                       st + 6 * run + R, st + 6 * run + 2 * R};
        const int64_t count[7] = {rows * J, rows * J, rows * J, 3 * rows * J, rows, rows,
                                  3 * rows};
        uint32_t bytes[7], total = 0;
#pragma unroll
        for (int a = 0; a < 7; ++a)
          if (a < runs) total += bytes[a] = run_tail(d[a], g[a], count[a]);
        fence_proxy_async();
        mbar_arrive_expect_tx(&full[s], total);
#pragma unroll
        for (int a = 0; a < 7; ++a)
          if (a < runs) bulk_run(d[a], g[a], bytes[a], &full[s]);
      }
    }
    return;
  }
  if (warp == kSysWarps + 1) {                      // the regularizer stage
    if constexpr (kStaged) {
      if (!p.reg) return;
      // tile by tile beside the producer: lane l forms rows l and l + 32
      // of the tile (a tile has at most 64 rows) into registers (their
      // Laplacian residuals into lap_r) before the tile's stage is free,
      // then writes them into the stage's Eikonal slots and arrives, so
      // its gathers run a tile ahead of the copies
      int k = 0;
      for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
        const int64_t n0 = tile * R;
        const int rows = static_cast<int>(p.n - n0 < R ? p.n - n0 : R);
        float e[2][5];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (lane + 32 * h < rows) reg_row(p, n0 + lane + 32 * h, e[h], true);
        const int s = k % D;
        if (k >= D) mbar_wait(&empty[s], ((k / D) - 1) & 1);
        float* er = ring + stage * s + 6 * run;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = lane + 32 * h;
          if (row < rows) {
            er[row] = e[h][4];
            er[R + row] = e[h][0];
#pragma unroll
            for (int i = 0; i < 3; ++i) er[2 * R + 3 * row + i] = e[h][1 + i];
          }
        }
        mbar_arrive(&regd[s]);
      }
    }
    return;
  }

  const int grp = lane / G, gl = lane % G;
  float* outA = reinterpret_cast<float*>(smem + kSysBarriers) + warp * kRows * 14;
  float* outT = outA + kRows * 10;
  int k = 0;
  for (int64_t tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const int64_t n0 = tile * R;
    const int rows = static_cast<int>(p.n - n0 < R ? p.n - n0 : R);
    const int r0 = warp * kRows;                    // the warp's rows of the tile
    const int mine = max(0, min(kRows, rows - r0));
    const float *w, *r, *j0, *ji, *er, *ej0, *eji;
    if constexpr (kStaged) {
      mbar_wait(&full[k % D], (k / D) & 1);
      const float* st = ring + stage * (k % D);
      w = st;  r = st + run;  j0 = st + 2 * run;  ji = st + 3 * run;
      er = st + 6 * run;  ej0 = er + R;  eji = er + 2 * R;
    } else {
      w = p.w + n0 * J;  r = p.r + n0 * J;  j0 = p.J0 + n0 * J;  ji = p.Ji + 3 * n0 * J;
      er = p.eik_r + n0;  ej0 = p.eik_J0 + n0;  eji = p.eik_Ji + 3 * n0;
    }
    if (mine > 0) {                                 // the same branch in every lane
      const int row = grp;                          // the warp's local row
      const bool live = row < mine;
      const int lr = r0 + row;                      // the tile's
      float v[16], e[5];
#pragma unroll
      for (int q = 0; q < 16; ++q) v[q] = 0.0f;
      if (live) {
        if (!kStaged && p.reg) {                    // the lanes' loads: the stage here
          reg_row(p, n0 + lr, e, gl == 0);
        } else if (p.eik && !p.reg) {               // J0, Ji, r: in flight with the pairs
          e[0] = ld_pair<kStaged>(ej0 + lr);
          e[1] = ld_pair<kStaged>(eji + 3 * lr);
          e[2] = ld_pair<kStaged>(eji + 3 * lr + 1);
          e[3] = ld_pair<kStaged>(eji + 3 * lr + 2);
          e[4] = ld_pair<kStaged>(er + lr);
        }
        const float* wr = w + lr * J;
        const float* rr = r + lr * J;
        const float* j0r = j0 + lr * J;
        const float* jir = ji + 3 * lr * J;
        for (int base = gl; base < J; base += G * kUnroll) {
          float wv[kUnroll], rv[kUnroll], a[kUnroll][4];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = base + u * G;
            if (j < J) {
              wv[u] = ld_pair<kStaged>(wr + j);
              rv[u] = ld_pair<kStaged>(rr + j);
              a[u][0] = ld_pair<kStaged>(j0r + j);
              a[u][1] = ld_pair<kStaged>(jir + j);
              a[u][2] = ld_pair<kStaged>(jir + J + j);
              a[u][3] = ld_pair<kStaged>(jir + 2 * J + j);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (base + u * G >= J) continue;
            float wa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) wa[i] = __fmul_rn(wv[u], a[u][i]);
#pragma unroll
            for (int q = 0; q < 10; ++q)
              v[q] = __fadd_rn(v[q], __fmul_rn(wa[pair_i(q)], a[u][pair_k(q)]));
            const float wr_ = __fmul_rn(wv[u], rv[u]);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[10 + i] = __fadd_rn(v[10 + i], __fmul_rn(wr_, a[u][i]));
          }
        }
      }
      if (kStaged && p.reg) {                       // the regularizer warp's rows,
        mbar_wait(&regd[k % D], (k / D) & 1);       // needed only now
        if (live && p.eik) {
          e[0] = ej0[lr];
          e[1] = eji[3 * lr];
          e[2] = eji[3 * lr + 1];
          e[3] = eji[3 * lr + 2];
          e[4] = er[lr];
        }
      }
      reduce_scatter<G>(v, gl);
      if (live && !(G == 32 && (gl & 1))) {       // (G = 32: lanes 2m, 2m + 1 hold one value)
        const int base = G < 32 ? gl * kMine : gl >> 1;
        if (p.eik) {                                // then the Eikonal row's terms
          float ec[14], we[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) we[i] = __fmul_rn(p.lam, e[i]);
#pragma unroll
          for (int q = 0; q < 10; ++q) ec[q] = __fmul_rn(we[pair_i(q)], e[pair_k(q)]);
          const float wre = __fmul_rn(p.lam, e[4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) ec[10 + i] = __fmul_rn(wre, e[i]);
#pragma unroll
          for (int m = 0; m < kMine; ++m) {
            float add = 0.0f;
#pragma unroll
            for (int q = 0; q < 14; ++q) add = q == base + m ? ec[q] : add;
            v[m] = __fadd_rn(v[m], add);
          }
        }
#pragma unroll
        for (int m = 0; m < kMine; ++m) {
          const int q = base + m;
          if (q < 10) outA[row * 10 + q] = v[m];
          else if (q < 14) outT[row * 4 + q - 10] = v[m];
        }
      }
    }
    __syncwarp();
    if constexpr (kStaged) {
      if (lane == 0) mbar_arrive(&empty[k % D]);   // this warp is done with the stage
    }
    store_run(p.A + (n0 + r0) * 10, outA, mine * 10, lane);
    store_run(p.t + (n0 + r0) * 4, outT, mine * 4, lane);
    __syncwarp();
  }
}

// ---------------------------------------------------------------- dist_cg

// a block's layouts (ops/distcg.py TILE, VECTORS, GLOBAL)
constexpr int kTile = 0, kVectors = 1, kGlobal = 2;
// the block's own rows' s = A P p, 4 floats a row, then its vectors, `tile`
// floats each, in shared memory (kGlobal: [N][4] and [N] each in work after
// the published ones): x, r, z, A p, p, the safe diagonal, damping diag,
// the Laplacian rows (its neighbour term only)
constexpr int kX = 0, kR = 1, kZ = 2, kAp = 3, kP = 4, kDsafe = 5, kDd = 6, kLx = 7;
// what other blocks read, at the start of work: the (z, p_old) pairs
// [2][N] (float2; step k reads set k & 1, writes set (k + 1) & 1) and the
// Laplacian rows [N], 5 floats a row; then, from a 16-byte boundary,
// kTile's each row's A row 1 + ax [3][N] (float4) and its neighbours along
// the two other axes [3][N] (int2), written in the prologue (16-byte loads
// in place of six 4-byte gathers from 40- and 12-byte rows), or kGlobal's
// own rows (ops/distcg.py _work_floats)
constexpr int kPublished = 5;
// shared memory before the plan's regions: the mbarrier (16 bytes), the
// warps' sums [kCgWarps][2] and the grid's sums (16 bytes) (ops/distcg.py
// _HEADER)
constexpr int kHeader = 16 + kCgWarps * 2 * 4 + 16;

struct CgParams {
  const float* __restrict__ A;          // read-only inputs
  const float* __restrict__ t;
  const int32_t* __restrict__ nbr;
  const int32_t* __restrict__ rev;
  const int32_t* __restrict__ lap;
  const unsigned char* __restrict__ valid;
  const float* __restrict__ lap_r;
  float* delta;
  int64_t* steps;
  float4* arow;                         // published: read across blocks with ld.global.cg
  int2* onbr;
  float2* zp;
  float* lapx;
  float* own;                           // kGlobal: the blocks' s [N][4], vectors [8][N]
  uint32_t* counter;                    // the barriers' arrivals
  float* part;                          // [2][blocks][2]: the blocks' partials
  const float* __restrict__ dist;       // the update stage's inputs
  const float* __restrict__ nbr_dir;
  const float* __restrict__ nbr_const;
  float* new_dist;
  float* new_grad;
  int n, tile, blocks, maxiter, fixed, use_lap, lap_nbr, update;
  int off_A, off_nbr, off_rev, off_lap, off_valid, off_vec;
  float w_l, dc, nc, dc2, nc2, damping, one_plus_damping, tol2, atol2, inv_h_div, thr;
};

// ------------------------------------------ shared-memory copies, barriers

// (the mbarrier and bulk-copy helpers: csrc/async_copy.cuh)

// An array's tile, `count` elements: its whole 16-byte chunks -> the bytes
// of its bulk copy; the rest the threads copy (copy_tail).
template <typename T>
__device__ __forceinline__ uint32_t body_bytes(int count) {
  return static_cast<uint32_t>(count * static_cast<int>(sizeof(T))) & ~15u;
}

template <typename T>
__device__ __forceinline__ void copy_tail(T* s, const T* g, int count) {
  for (int i = body_bytes<T>(count) / sizeof(T) + threadIdx.x; i < count; i += kCgThreads)
    s[i] = g[i];
}

// Loads made only where `c` holds (a predicated instruction, no branch, so
// the loads of a row's slots are all in flight together); elsewhere 0 (-1
// for indices).  ld.global.nc: data read-only for the whole launch;
// ld.global.cg: data written inside it by other blocks.
__device__ __forceinline__ float ldg_if(bool c, const float* a) {
  float v = 0.0f;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q ld.global.nc.f32 %0, [%1];\n\t}"
      : "+f"(v)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

__device__ __forceinline__ int ldg_if(bool c, const int32_t* a) {
  int v = -1;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q ld.global.nc.b32 %0, [%1];\n\t}"
      : "+r"(v)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

__device__ __forceinline__ float ldcg_if(bool c, const float* a) {
  float v = 0.0f;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\t@q ld.global.cg.f32 %0, [%1];\n\t}"
      : "+f"(v)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

__device__ __forceinline__ float4 ldcg_if(bool c, const float4* a) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %5, 0;\n\t"
      "@q ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+f"(v.x), "+f"(v.y), "+f"(v.z), "+f"(v.w)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

__device__ __forceinline__ int2 ldcg_if(bool c, const int2* a) {
  int2 v = make_int2(-1, -1);
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t@q ld.global.cg.v2.b32 {%0, %1}, [%2];\n\t}"
      : "+r"(v.x), "+r"(v.y)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

__device__ __forceinline__ float2 ldcg_if(bool c, const float2* a) {
  float2 v = make_float2(0.0f, 0.0f);
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %3, 0;\n\t@q ld.global.cg.v2.f32 {%0, %1}, [%2];\n\t}"
      : "+f"(v.x), "+f"(v.y)
      : "l"(a), "r"(static_cast<unsigned>(c)));
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kCgThreads, 1)
dist_cg_kernel(const __grid_constant__ CgParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* buf = reinterpret_cast<float*>(smem + 16);         // the warps' sums
  float* bc = buf + 2 * kCgWarps;                           // the grid's sums
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int begin = blockIdx.x * p.tile;
  const int rows = min(p.n - begin, p.tile);

  // ---- the tile: A, nbr, rev, lap, valid of the block's rows
  const float* tA;
  const int32_t *tNbr, *tRev, *tLap;
  const unsigned char* tValid;
  if constexpr (kMode == kTile) {
    float* sA = reinterpret_cast<float*>(smem + p.off_A);
    int32_t* sNbr = reinterpret_cast<int32_t*>(smem + p.off_nbr);
    int32_t* sRev = reinterpret_cast<int32_t*>(smem + p.off_rev);
    int32_t* sLap = reinterpret_cast<int32_t*>(smem + p.off_lap);
    unsigned char* sValid = smem + p.off_valid;
    const float* gA = p.A + 10 * static_cast<size_t>(begin);
    const int32_t* gNbr = p.nbr + 3 * static_cast<size_t>(begin);
    const int32_t* gRev = p.rev + 6 * static_cast<size_t>(begin);
    const int32_t* gLap = p.lap + 6 * static_cast<size_t>(begin);
    const unsigned char* gValid = p.valid + begin;
    if (tid == 0) {
      const uint32_t bA = body_bytes<float>(10 * rows), bN = body_bytes<int32_t>(3 * rows),
                     bR = body_bytes<int32_t>(6 * rows),
                     bL = p.lap_nbr ? body_bytes<int32_t>(6 * rows) : 0u,
                     bV = body_bytes<unsigned char>(rows);
      mbar_init(bar, 1);
      fence_mbar_init();
      mbar_arrive_expect_tx(bar, bA + bN + bR + bL + bV);
      if (bA) bulk_load(sA, gA, bA, bar);
      if (bN) bulk_load(sNbr, gNbr, bN, bar);
      if (bR) bulk_load(sRev, gRev, bR, bar);
      if (bL) bulk_load(sLap, gLap, bL, bar);
      if (bV) bulk_load(sValid, gValid, bV, bar);
    }
    copy_tail(sA, gA, 10 * rows);
    copy_tail(sNbr, gNbr, 3 * rows);
    copy_tail(sRev, gRev, 6 * rows);
    if (p.lap_nbr) copy_tail(sLap, gLap, 6 * rows);
    copy_tail(sValid, gValid, rows);
    __syncthreads();                    // the mbarrier is set up, the tails are in
    mbar_wait(bar, 0);
    tA = sA;  tNbr = sNbr;  tRev = sRev;  tLap = sLap;  tValid = sValid;
  } else {
    tA = p.A + 10 * static_cast<size_t>(begin);
    tNbr = p.nbr + 3 * static_cast<size_t>(begin);
    tRev = p.rev + 6 * static_cast<size_t>(begin);
    tLap = p.lap + 6 * static_cast<size_t>(begin);
    tValid = p.valid + begin;
  }
  float *vs, *vec;
  int vstride;
  if constexpr (kMode == kGlobal) {
    vs = p.own + 4 * static_cast<size_t>(begin);
    vec = p.own + 4 * static_cast<size_t>(p.n) + begin;
    vstride = p.n;
  } else {
    vs = reinterpret_cast<float*>(smem + p.off_vec);
    vec = vs + 4 * p.tile;
    vstride = p.tile;
  }
  float* vx = vec + kX * vstride;
  float* vr = vec + kR * vstride;
  float* vz = vec + kZ * vstride;
  float* vap = vec + kAp * vstride;
  float* vp = vec + kP * vstride;
  float* vds = vec + kDsafe * vstride;
  float* vdd = vec + kDd * vstride;
  float* vlx = vec + kLx * vstride;

  // A_j[q], valid_j and the Laplacian row of any row: the tile's copy for a
  // row on it, global memory's for another tile's
  auto on = [&](int j) { return static_cast<unsigned>(j - begin) < static_cast<unsigned>(rows); };
  auto a_at = [&](int j, int q) -> float {
    if constexpr (kMode == kTile)
      return *(on(j) ? tA + 10 * (j - begin) + q : p.A + 10 * static_cast<size_t>(j) + q);
    return __ldg(p.A + 10 * static_cast<size_t>(j) + q);
  };
  auto valid_at = [&](int j) -> bool {
    if constexpr (kMode == kTile) return *(on(j) ? tValid + (j - begin) : p.valid + j) != 0;
    return __ldg(p.valid + j) != 0;
  };
  auto lapx_at = [&](int j) -> float {
    const bool o = on(j);
    const float mine = vlx[o ? j - begin : 0];
    const float other = ldcg_if(!o, p.lapx + j);
    return o ? mine : other;
  };

  // ---- the prologue: b, diag, the safe diagonal, x = 0, r = b, z = p = r / d
  float acc[2] = {0.0f, 0.0f};
  for (int l = tid; l < rows; l += kCgThreads) {
    const int m = begin + l;
    float bm = __ldg(p.t + 4 * static_cast<size_t>(m));
    float dm = tA[10 * l];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int n = tRev[6 * l + c];
      const int ax = 1 + (c >> 1);
      const float tn = n >= 0 ? __ldg(p.t + 4 * static_cast<size_t>(n) + ax) : 0.0f;
      const float an = n >= 0 ? a_at(n, sym(ax, ax)) : 0.0f;
      bm = __fadd_rn(bm, tn);
      dm = __fadd_rn(dm, an);
    }
    const bool v = tValid[l] != 0;
    if (p.use_lap) {
      // b += w_l lap(where(valid, r_l, 0)), diag += w_l lap_diag
      float lt = __fmul_rn(p.dc, v ? __ldg(p.lap_r + m) : 0.0f);
      float ld = v ? p.dc2 : 0.0f;
      if (p.lap_nbr) {
        float nb = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int j = tLap[6 * l + k];
          const bool vj = j >= 0 && valid_at(j);
          const float rj = vj ? __ldg(p.lap_r + j) : 0.0f;
          nb = k == 0 ? rj : __fadd_rn(nb, rj);
          ld = __fadd_rn(ld, vj ? p.nc2 : 0.0f);
        }
        lt = __fadd_rn(lt, __fmul_rn(p.nc, nb));
      }
      bm = __fadd_rn(bm, __fmul_rn(p.w_l, v ? lt : 0.0f));
      dm = __fadd_rn(dm, __fmul_rn(p.w_l, ld));
    }
    const float dt = __fmul_rn(p.one_plus_damping, dm);
    const float ds = (v && dt > 0.0f) ? dt : 1.0f;
    bm = v ? bm : 0.0f;
    const float zm = __fdiv_rn(bm, ds);
    vx[l] = 0.0f;
    vr[l] = bm;
    vz[l] = zm;
    vp[l] = zm;
    vds[l] = ds;
    vdd[l] = __fmul_rn(p.damping, dm);
    p.zp[m] = make_float2(zm, 0.0f);              // step 0 reads z: p = z
    p.zp[p.n + m].y = zm;                         // step 1 reads p_0
    // kTile: what another tile needs to form this row's s[1 + ax], one
    // float4 and one int2 an axis (the other layouts read A and nbr)
    if constexpr (kMode == kTile) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        p.arow[static_cast<size_t>(ax) * p.n + m] =
            make_float4(tA[10 * l + sym(1 + ax, 0)], tA[10 * l + sym(1 + ax, 1)],
                        tA[10 * l + sym(1 + ax, 2)], tA[10 * l + sym(1 + ax, 3)]);
        p.onbr[static_cast<size_t>(ax) * p.n + m] =
            make_int2(tNbr[3 * l + (ax == 0 ? 1 : 0)], tNbr[3 * l + (ax == 2 ? 1 : 2)]);
      }
    }
    acc[0] += bm * bm;
    acc[1] += bm * zm;
  }
  // the prologue's sums through set 0 and one grid.sync; the counter set
  // to 0 before any block arrives
  float mine[2], g[2];
  block_sum<2>(acc, mine, buf);
  if (tid == 0) {
    p.part[2 * blockIdx.x] = mine[0];
    p.part[2 * blockIdx.x + 1] = mine[1];
    if (blockIdx.x == 0) *p.counter = 0;
  }
  grid.sync();
  grid_sum<2>(p.part, p.blocks, g, bc);
  const float bb = g[0];
  float gamma = g[1], rr = bb, beta = 0.0f;
  const float thr = p.fixed ? p.tol2 * bb : fmaxf(p.tol2 * bb, p.atol2);

  uint32_t epoch = 0;
  int steps = 0;
  for (int k = 0; k < p.maxiter; ++k) {
    if (!(rr > thr)) break;                       // the same in every block
    const float2* zp_now = p.zp + static_cast<size_t>(k & 1) * p.n;   // (z_k, p_k-1)
    float2* zp_next = p.zp + static_cast<size_t>((k + 1) & 1) * p.n;
    // p at any row: the block's own from its vector, another tile's from
    // the pair that block published, in one load (step 0: p = z, else
    // z + beta p_old: the bits its owner forms)
    auto p_at = [&](int j) -> float {
      const bool o = on(j);
      const float mine = vp[o ? j - begin : 0];
      const float2 v = ldcg_if(!o, zp_now + j);
      const float other = k == 0 ? v.x : __fadd_rn(v.x, __fmul_rn(beta, v.y));
      return o ? mine : other;
    };

    // ---- p of the block's rows, and their Laplacian rows
    if (k > 0)
      for (int l = tid; l < rows; l += kCgThreads) {
        const float pl = __fadd_rn(vz[l], __fmul_rn(beta, vp[l]));
        vp[l] = pl;
        zp_next[begin + l].y = pl;
      }
    __syncthreads();
    if (p.lap_nbr) {
      for (int l = tid; l < rows; l += kCgThreads) {
        int j[6];
        float pj[6];
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) j[kk] = tLap[6 * l + kk];
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) pj[kk] = p_at(j[kk] >= 0 ? j[kk] : begin + l);
        float nb = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const float g = j[kk] >= 0 ? pj[kk] : 0.0f;
          nb = kk == 0 ? g : __fadd_rn(nb, g);
        }
        const float lx =
            tValid[l] != 0 ? __fadd_rn(__fmul_rn(p.dc, vp[l]), __fmul_rn(p.nc, nb)) : 0.0f;
        vlx[l] = lx;
        p.lapx[begin + l] = lx;
      }
      barrier(p, ++epoch);
    }

    // ---- H p in one phase (no grid barrier inside), the block's part of
    // p.Ap.  First every row n of the tile forms its s_n = A_n P_n p.
    for (int l = tid; l < rows; l += kCgThreads) {
      float u[4];
      int j[3];
      u[0] = vp[l];
#pragma unroll
      for (int a = 0; a < 3; ++a) j[a] = tNbr[3 * l + a];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float g = p_at(j[a] >= 0 ? j[a] : begin + l);
        u[1 + a] = j[a] >= 0 ? g : 0.0f;
      }
      float Arow[10];
#pragma unroll
      for (int q = 0; q < 10; ++q) Arow[q] = tA[10 * l + q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float si = __fmul_rn(Arow[sym(i, 0)], u[0]);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk) si = __fadd_rn(si, __fmul_rn(Arow[sym(i, kk)], u[kk]));
        vs[4 * l + i] = si;
      }
    }
    __syncthreads();
    // Then row m gathers s_n[1 + ax] of the rows n naming it along ax, in
    // the table's order: a row of the tile's from shared memory, another
    // tile's formed here from its A, its stencil (whose neighbour along ax
    // is m) and p there; the same products and sums in the same order, so
    // the same bits.  The loads go in two levels with no branch around
    // them.
    float pa[1] = {0.0f};
    for (int l = tid; l < rows; l += kCgThreads) {
      const int m = begin + l;
      const float pm = vp[l];
      const bool vm = tValid[l] != 0;
      int rv[6];
      bool off[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        rv[c] = tRev[6 * l + c];
        off[c] = rv[c] >= 0 && !on(rv[c]);
      }
      // the first level: s of the tile's naming rows; another tile's row
      // of A, its two other neighbours and its p; the Laplacian rows at
      // m's six neighbours
      float sn[6], an[6][4], pn[6], lq[6];
      int no[6][2];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int ax = c >> 1;
        const int n = off[c] ? rv[c] : m;           // m: unused
        const float sv = vs[4 * ((rv[c] >= 0 && !off[c] ? rv[c] : m) - begin) + 1 + ax];
        sn[c] = rv[c] >= 0 && !off[c] ? sv : 0.0f;
        if constexpr (kMode == kTile) {
          const float4 av = ldcg_if(off[c], p.arow + static_cast<size_t>(ax) * p.n + n);
          const int2 ov = ldcg_if(off[c], p.onbr + static_cast<size_t>(ax) * p.n + n);
          an[c][0] = av.x;
          an[c][1] = av.y;
          an[c][2] = av.z;
          an[c][3] = av.w;
          no[c][0] = ov.x;
          no[c][1] = ov.y;
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            an[c][kk] = ldg_if(off[c], p.A + 10 * static_cast<size_t>(n) + sym(1 + ax, kk));
          no[c][0] = ldg_if(off[c], p.nbr + 3 * static_cast<size_t>(n) + (ax == 0 ? 1 : 0));
          no[c][1] = ldg_if(off[c], p.nbr + 3 * static_cast<size_t>(n) + (ax == 2 ? 1 : 2));
        }
        const float pv = p_at(n);
        pn[c] = off[c] ? pv : 0.0f;
      }
      if (p.lap_nbr)
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const int j = tLap[6 * l + kk];
          const float g = lapx_at(j >= 0 ? j : m);
          lq[kk] = j >= 0 ? g : 0.0f;
        }
      // the second level: p at another tile's naming rows' other neighbours
      float pq[6][2];
#pragma unroll
      for (int c = 0; c < 6; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float g = p_at(no[c][i] >= 0 ? no[c][i] : m);
          pq[c][i] = no[c][i] >= 0 ? g : 0.0f;
        }
      float hx = vs[4 * l];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int ax = c >> 1;
        float w[4];
        w[0] = pn[c];
#pragma unroll
        for (int a = 0, i = 0; a < 3; ++a) {
          if (a == ax) {
            w[1 + a] = pm;
          } else {
            w[1 + a] = pq[c][i];
            ++i;
          }
        }
        float so = __fmul_rn(an[c][0], w[0]);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk) so = __fadd_rn(so, __fmul_rn(an[c][kk], w[kk]));
        hx = __fadd_rn(hx, off[c] ? so : sn[c]);
      }
      if (p.use_lap) {
        float lt;
        if (p.lap_nbr) {
          float nb = lq[0];
#pragma unroll
          for (int kk = 1; kk < 6; ++kk) nb = __fadd_rn(nb, lq[kk]);
          lt = __fadd_rn(__fmul_rn(p.dc, vlx[l]), __fmul_rn(p.nc, nb));
        } else {
          lt = __fmul_rn(p.dc, vm ? __fmul_rn(p.dc, pm) : 0.0f);
        }
        hx = __fadd_rn(hx, __fmul_rn(p.w_l, vm ? lt : 0.0f));
      }
      const float am = vm ? __fadd_rn(hx, __fmul_rn(vdd[l], pm)) : pm;
      vap[l] = am;
      pa[0] += pm * am;
    }
    float pAp[1];
    barrier_sum<1>(p, ++epoch, pa, pAp, buf, bc);
    const float alpha = gamma / (p.fixed ? clamp30(pAp[0]) : pAp[0]);

    // ---- the update: x, r, z and the block's parts of r.z and r.r
    float acc2[2] = {0.0f, 0.0f};
    for (int l = tid; l < rows; l += kCgThreads) {
      const float xl = __fadd_rn(vx[l], __fmul_rn(alpha, vp[l]));
      const float rl = __fsub_rn(vr[l], __fmul_rn(alpha, vap[l]));
      const float zl = __fdiv_rn(rl, vds[l]);
      vx[l] = xl;
      vr[l] = rl;
      vz[l] = zl;
      zp_next[begin + l].x = zl;
      acc2[0] += rl * zl;
      acc2[1] += rl * rl;
    }
    float gr[2];
    barrier_sum<2>(p, ++epoch, acc2, gr, buf, bc);
    beta = gr[0] / (p.fixed ? clamp30(gamma) : gamma);
    gamma = gr[0];
    rr = gr[1];
    steps = k + 1;
  }

  for (int l = tid; l < rows; l += kCgThreads)
    p.delta[begin + l] = tValid[l] != 0 ? vx[l] : 0.0f;
  if (blockIdx.x == 0 && tid == 0) *p.steps = steps;
  if (!p.update) return;

  // ---- the update stage: once every block's delta is written (one more
  // barrier), each row's accept rule and the one-sided gradient of the
  // accepted distances, in dist_update_kernel's arithmetic (stencil.cuh).
  // A row's neighbour's step: the block's own from x (= delta on a valid
  // row; an invalid row's step is not read), another tile's from delta,
  // written in this launch (ld.global.cg)
  barrier(p, ++epoch);
  auto accepted_at = [&](int64_t j64) -> float {
    const int j = static_cast<int>(j64);
    const bool o = on(j);
    const float mine = vx[o ? j - begin : 0];
    const float other = ldcg_if(!o, p.delta + j);
    return accepted(__ldg(p.dist + j), o ? mine : other, valid_at(j), p.thr);
  };
  for (int l = tid; l < rows; l += kCgThreads) {
    const size_t m = static_cast<size_t>(begin + l);
    const float d = accepted(__ldg(p.dist + m), vx[l], tValid[l] != 0, p.thr);
    float dn[3], g[3];
    gather_row(accepted_at, tNbr + 3 * l, p.nbr_const + 3 * m, dn);
    fd_row(dn, p.nbr_dir + 3 * m, d, p.inv_h_div, g);
    p.new_dist[m] = d;
#pragma unroll
    for (int i = 0; i < 3; ++i) p.new_grad[3 * m + i] = g[i];
  }
}

// An empty cooperative kernel on dist_cg's grid: kind 0 crosses `barriers`
// grid.syncs; kind 1 one grid.sync (the prologue's) and `barriers` - 1 of
// dist_cg's barriers, each with its two-value sums: the latency floor of a
// solve of that many barriers, and the two kinds of barrier side by side.
__global__ void __launch_bounds__(kCgThreads, 1)
dist_barrier_kernel(const __grid_constant__ CgParams p, int barriers, int kind) {
  __shared__ float buf[2 * kCgWarps + 4];
  cg::grid_group grid = cg::this_grid();
  if (kind == 0) {
    for (int k = 0; k < barriers; ++k) grid.sync();
    return;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.counter = 0;
  grid.sync();
  float g[2] = {1.0f, static_cast<float>(threadIdx.x)}, out[2];
  for (int e = 1; e < barriers; ++e) {
    barrier_sum<2>(p, static_cast<uint32_t>(e), g, out, buf, buf + 2 * kCgWarps);
    g[0] = out[0];
  }
}

const void* cg_kernel(int64_t mode) {
  if (mode == kTile) return reinterpret_cast<const void*>(dist_cg_kernel<kTile>);
  if (mode == kVectors) return reinterpret_cast<const void*>(dist_cg_kernel<kVectors>);
  return reinterpret_cast<const void*>(dist_cg_kernel<kGlobal>);
}

template <int G>
const void* system_kernel_for(bool staged) {
  return staged ? reinterpret_cast<const void*>(dist_system_kernel<G, true>)
                : reinterpret_cast<const void*>(dist_system_kernel<G, false>);
}

// dist_system_kernel for the plan's lanes and ring, or null
const void* system_kernel(int64_t lanes, bool staged) {
  switch (lanes) {
    case 4: return system_kernel_for<4>(staged);
    case 8: return system_kernel_for<8>(staged);
    case 16: return system_kernel_for<16>(staged);
    case 32: return system_kernel_for<32>(staged);
    default: return nullptr;
  }
}

void cg_params(CgParams& p, const CgPlan& plan, uint32_t* sync) {
  p.counter = sync;
  p.part = reinterpret_cast<float*>(sync + 4);
  p.tile = static_cast<int>(plan.tile);
  p.blocks = static_cast<int>(plan.blocks);
  p.off_A = static_cast<int>(plan.A);
  p.off_nbr = static_cast<int>(plan.nbr);
  p.off_rev = static_cast<int>(plan.rev);
  p.off_lap = static_cast<int>(plan.lap);
  p.off_valid = static_cast<int>(plan.valid);
  p.off_vec = static_cast<int>(plan.vec);
}

int cooperative(const void* kernel, int64_t blocks, int64_t smem, void** args, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                    dim3(kCgThreads), args, static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on the plan (ops/distcg._system_plan), checked here.
extern "C" int dist_system(const SystemArgs* a, void* stream) {
  const SystemPlan& pl = a->plan;
  const void* kernel = system_kernel(pl.lanes, pl.depth > 0);
  const int64_t stage = pl.tile * (24 * a->pairs + 20);
  const auto aligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) == 0; };
  const bool staged_eik = a->eik && !a->reg;      // the Eikonal row from eik_*
  const bool reg_ok =
      a->reg ? (a->eik || a->laplacian) && a->valid && a->dist && a->nbr && a->nbr_dir &&
                   a->nbr_const && (!a->laplacian || (a->lap && a->lap_const && a->lap_r))
             : !a->laplacian;
  if (a->n < 1 || a->pairs < 1 || !reg_ok ||
      (staged_eik && (!a->eik_r || !a->eik_J0 || !a->eik_Ji)) ||
      !kernel || pl.tile != kSysWarps * (32 / pl.lanes) || pl.depth < 0 || pl.depth == 1 ||
      pl.depth > kSysDepth || pl.blocks < 1 || pl.ring % 128 != 0 ||
      pl.ring < kSysBarriers + 56 * pl.tile || pl.smem_bytes != pl.ring + pl.depth * stage ||
      (pl.depth > 0 && !(aligned(a->w) && aligned(a->r) && aligned(a->J0) && aligned(a->Ji) &&
                         (!staged_eik || (aligned(a->eik_r) && aligned(a->eik_J0) &&
                                          aligned(a->eik_Ji))))))
    return static_cast<int>(cudaErrorInvalidValue);
  SystemParams p;
  p.w = a->w;  p.r = a->r;  p.J0 = a->J0;  p.Ji = a->Ji;
  p.eik_r = a->eik_r;  p.eik_J0 = a->eik_J0;  p.eik_Ji = a->eik_Ji;
  p.A = a->A;  p.t = a->t;
  p.valid = a->valid;  p.dist = a->dist;  p.nbr = a->nbr;  p.nbr_dir = a->nbr_dir;
  p.nbr_const = a->nbr_const;  p.lap = a->lap;  p.lap_const = a->lap_const;
  p.lap_r = a->lap_r;
  p.reg = static_cast<int>(a->reg);
  p.laplacian = static_cast<int>(a->laplacian);
  p.rc = reg_consts(a->voxel);
  p.n = a->n;
  p.tiles = (a->n + pl.tile - 1) / pl.tile;
  p.pairs = static_cast<int>(a->pairs);
  p.eik = static_cast<int>(a->eik);
  p.tile = static_cast<int>(pl.tile);
  p.depth = static_cast<int>(pl.depth);
  p.ring = static_cast<int>(pl.ring);
  p.lam = static_cast<float>(a->reg_weight_n);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(pl.smem_bytes));
  void* args[] = {&p};
  if (e == cudaSuccess)
    e = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(pl.blocks)), dim3(kSysThreads), args,
                         static_cast<size_t>(pl.smem_bytes), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether the plan's layout (mode, its shared memory) runs cooperatively on
// the current device: the blocks an SM holds at that shared memory (which
// the launch asks for the same way) -> per_sm.
extern "C" int dist_cg_occupancy(int64_t mode, int64_t smem_bytes, int64_t* per_sm) {
  if (mode < kTile || mode > kGlobal || smem_bytes < kHeader)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, occ = 0;
  const void* kernel = cg_kernel(mode);
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kCgThreads,
                                                      static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  *per_sm = occ;
  return 0;
}

extern "C" int dist_cg(const CgArgs* a, void* stream) {
  const int64_t n = a->n;
  const CgPlan& plan = a->plan;
  if (n < 1 || a->maxiter < 0 || n > (int64_t{1} << 30) / 16 ||
      (a->use_lap && a->lap_r == nullptr) || plan.tail != (a->update ? 1 : 0) ||
      (a->update && !(a->dist && a->nbr_dir && a->nbr_const && a->new_dist && a->new_grad)) ||
      plan.mode < kTile || plan.mode > kGlobal ||
      plan.tile < 16 || plan.tile % 16 != 0 || plan.blocks < 1 ||
      (plan.blocks - 1) * plan.tile >= n || plan.blocks * plan.tile < n ||
      plan.smem_bytes < kHeader)
    return static_cast<int>(cudaErrorInvalidValue);
  CgParams p;
  p.A = a->A;  p.t = a->t;  p.nbr = a->nbr;  p.rev = a->rev;  p.lap = a->lap;
  p.valid = a->valid;  p.lap_r = a->lap_r;
  p.delta = a->delta;  p.steps = a->steps;
  float* w = a->work;
  p.zp = reinterpret_cast<float2*>(w);
  p.lapx = w + 4 * n;
  float* tables = w + ((kPublished * n + 3) & ~int64_t{3});
  p.arow = reinterpret_cast<float4*>(tables);
  p.onbr = reinterpret_cast<int2*>(tables + 12 * n);
  p.own = w + kPublished * n;
  cg_params(p, plan, a->sync);
  p.n = static_cast<int>(n);
  p.maxiter = static_cast<int>(a->maxiter);
  p.fixed = static_cast<int>(a->fixed);
  p.use_lap = static_cast<int>(a->use_lap);
  p.lap_nbr = static_cast<int>(a->use_lap && a->lap_nbr);
  p.w_l = static_cast<float>(a->reg_weight_l);
  p.dc = static_cast<float>(a->diag_coef);
  p.nc = static_cast<float>(a->nbr_coef);
  p.dc2 = static_cast<float>(a->diag_coef_sq);
  p.nc2 = static_cast<float>(a->nbr_coef_sq);
  p.damping = static_cast<float>(a->damping);
  p.one_plus_damping = static_cast<float>(1.0 + a->damping);
  p.tol2 = static_cast<float>(a->tol_sq);
  p.atol2 = static_cast<float>(a->atol_sq);
  p.update = static_cast<int>(a->update);
  p.dist = a->dist;  p.nbr_dir = a->nbr_dir;  p.nbr_const = a->nbr_const;
  p.new_dist = a->new_dist;  p.new_grad = a->new_grad;
  p.inv_h_div = reg_consts(a->voxel).inv_h_div;
  p.thr = static_cast<float>(a->accept);
  void* args[] = {&p};
  return cooperative(cg_kernel(plan.mode), plan.blocks, plan.smem_bytes, args, stream);
}

// The empty cooperative kernel on a plan's grid (dist_barrier_kernel); sync
// as dist_cg's.
extern "C" int dist_barriers(const CgPlan* plan, int64_t barriers, int64_t kind, void* sync,
                             void* stream) {
  if (plan->blocks < 1 || barriers < 1 || kind < 0 || kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CgParams p = {};
  cg_params(p, *plan, static_cast<uint32_t*>(sync));
  int b = static_cast<int>(barriers), k = static_cast<int>(kind);
  void* args[] = {&p, &b, &k};
  return cooperative(reinterpret_cast<const void*>(dist_barrier_kernel), plan->blocks, 0, args,
                     stream);
}
