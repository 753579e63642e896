// The albedo block's solve for Hopper (sm_90a) in ONE cooperative launch
// (albedo_block_kernel): its data terms formed per (voxel, keyframe) pair
// from bulk-copied stages and, under the albedo regularizer, its linearized
// rows; then the whole Jacobi-preconditioned CG with the (0, 1) accept rule.
//
// It replaces the JAX package's albedo block as
// psgradientsdf_tpu/refine/optimizer.py `_albedo_core` (:77) runs it:
// refine/jacobians.py `albedo_jacobian_sh` (:128) / `albedo_jacobian_led`
// (:138, through `_led_reflectance` :175), refine/solvers.py `solve_albedo`
// (:424) with the einsums of :443-444, the regularizer of :446-478, the CG
// (jax.scipy.sparse.linalg.cg :496 or `pcg_fixed` :39) and `update_albedo`
// (:502).  XLA keeps that block in one device program; so does this kernel:
// the system never reaches device memory and nothing is read back.
//
// The system.  The albedo's variables are [N, 3]; a photometric residual
// (n, f, c) touches x[n, c] alone, so the data term is diagonal:
//   b[n, c] = sum_f J w r,   diag_ps[n, c] = sum_f J^2 w,
// with J[n, f, c] = -(l_f . SH_B(ghat_n)) under SH (B = 4 or 9, the same
// for every channel) and refl(n, f) l_c under LED, refl = (ghat . R_f p) /
// max(|p|, 1e-12)^3 from the residual pass's p_cam.  The regularizer (its
// weight rho != 0) is the per-channel norm of the one-sided FD albedo
// gradient: r_reg [N, 3] and its stencil Jacobian J0r [N, 3] (the row's own
// column) and Jir [N, 3ax, 3ch] (the neighbour along ax); b += rho J^T r_reg
// and diag += rho diag(J^T J), the transposes gathered through the reverse
// stencil table (ops/distcg.stencil_reverse: rev[m, 2 ax + side] is the row
// naming m along ax), so no sum runs in an order that changes.
//
// The launch runs on ops/distcg._cg_plan's tiles (one block an SM of
// kCgThreads = 512 threads, a contiguous tile of voxels a block on 16-row
// starts) with the host plan ops/albedo._albedo_plan.  A block:
// 1. Streams its tile's pairs.  The tile's rows of w and r (and p_cam under
//    LED), [N,F,3] each, and of the stored gradient [N,3] are one
//    contiguous span of each tensor; a stage is kStageRows = 4 voxel rows
//    of each, and warp v takes the tile's stages v, v + 16, ... through its
//    own ring of `depth` stages in shared memory (the plan sets the depth
//    from F so that the rings fit beside the CG's vectors; depth 0, at an F
//    too large for one stage a warp, reads the rows from device memory).
//    Lane 0 fills a stage by one cp.async.bulk a span that completes on the
//    stage's mbarrier (csrc/async_copy.cuh); a stage whose spans break the
//    bulk copy's 16-byte sizes or addresses (a tile's partial last stage,
//    an unaligned tensor) the warp's lanes load themselves.  After a stage
//    is used the warp refills its slot with its stage `depth` further on.
//    (The gradient rides in the stage: read per row from device memory it
//    put a memory latency on every stage of every warp.)
// 2. Forms each row's b and diag_ps from the staged pairs: a group of
//    kGroup = 8 lanes a row (four rows a warp, a stage), lane k forms J of
//    frames k, k + 8, ... in registers (never written) and adds each
//    channel's J (w r) and (J J) w in that order, each product and sum
//    rounded once (_rn intrinsics); the 8 lane sums are added by an xor
//    butterfly inside the group, and the group's lanes 0-2 write b, 3-5
//    diag_ps, straight into the block's CG vectors (shared memory, or the
//    block's range of the work buffer past ops/albedo.shared_tile_limit).
//    The plain version (ops/albedo.albedo_system_plain) emulates that order:
//    the system equals it bit for bit.  Under the regularizer lanes 0-2 also
//    form their channel's r_reg, J0r and Jir into the work buffer (the rows'
//    own arithmetic of solvers.albedo_reg_operator, in a fixed order); one
//    grid.sync; then a thread a row gathers the rows naming it and adds rho
//    J^T r_reg and rho diag(J^T J).
// 3. Runs the PCG.  A row is a voxel with its three channels, and a thread
//    keeps the same rows to the end.  The block's own vectors x, r, z, A p,
//    p, the safe diagonal, damping diag and diag_ps (96 bytes a row) sit
//    beside the rings.  The prologue forms the safe Jacobi diagonal, x = 0,
//    r = where(valid, b, 0), z = p = r / d and the block's parts of b.b and
//    r.z; without the regularizer the operator is diagonal, so step 0's
//    A p and p.Ap come from the row alone and ride on the prologue's
//    barrier too.  A step is
//      p = z + beta p_old of the block's rows (not at step 0);
//      kReg: publish p; barrier; y = J p of the block's rows (J0r p + the
//            neighbours' p through nbr, other tiles' from device memory);
//            publish y; barrier;
//      A p = diag_ps p (+ rho (J0r y + the y of the rows naming it, through
//          rev)) + damping diag p, where(valid, ., p); the block's part of
//          p.Ap; barrier (not at the diagonal instance's step 0);
//      alpha; x, r, z = r / d and the block's parts of r.z and r.r; barrier;
//      beta, and the stop test r.r > thr before the next step, thr = tol^2
//      b.b (scipy's rule at atol 0, as the JAX package calls it, or
//      cg_static's with its clamped divisions), decided on the device.
//    Both recipes set reg albedo 0 and their solve ends after one step: two
//    grid barriers (the prologue's and the step's), where the two launches
//    this kernel replaced crossed three.  Under the regularizer a step
//    crosses four.  The barriers and block sums are csrc/cg_sync.cuh's
//    (shared with csrc/distcg.cu), each sum added on its own, so the third
//    prologue sum leaves the other two's bits as they were.
// 4. The epilogue writes delta = where(valid, x, 0) and the new albedo,
//    cand = albedo - delta kept where 0 < cand < 1 on a valid row, else the
//    old (solvers.update_albedo: the same subtraction and comparisons, so
//    equal to it on this delta bit for bit), the step count and the grid
//    barriers crossed.
// The dots are summed in another order than the plain version's torch.sum,
// so the two CGs agree to float32 rounding.  Bound by bytes: w and r read
// once (24 bytes a pair; LED: p_cam too, 36), the row's gradient and mask,
// the albedo read and delta and the new albedo written (49 bytes a row):
// 49.6 MB at N = 49152, F = 40, 0.0148 ms at 3.35 TB/s.
//
// `phases` (3 on every path) runs the kernel's halves apart without the
// regularizer: 1 forms the system and writes it out, 2 reads it and
// solves.  tools/albedo_block_ab.py times the two-launch form so made
// against the one launch.
//
// Plain C interface (loaded with ctypes): albedo_block() launches on the
// stream it is given; albedo_block_occupancy() checks a plan's shared
// memory on the current device.  Each returns 0 or the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "cg_sync.cuh"
#include "stencil.cuh"

namespace cg = cooperative_groups;

struct BlockPlan {             // ops/albedo.AlbedoPlan, field for field
  int64_t blocks;              // the grid: one block an SM at most
  int64_t tile;                // voxels a block, a multiple of 16
  int64_t shared;              // 1: the CG's vectors in shared memory at `vec`
  int64_t depth;               // stages a warp's ring holds (0: pairs from device memory)
  int64_t stage_bytes;         // bytes a stage: kStageRows rows of w, r (p_cam), grad
  int64_t ring;                // offset of the rings in shared memory
  int64_t vec;                 // offset of the vectors (when shared)
  int64_t smem_bytes;          // dynamic shared memory a block
};

struct BlockArgs {             // ops/albedo.py _BlockArgs, field for field
  const float* w;              // [N,F,3]
  const float* r;              // [N,F,3]
  const float* p_cam;          // [N,F,3] (LED)
  const float* grad;           // [N,3] the stored gradient
  const float* lights;         // [F,B] (SH) or [3] (LED)
  const float* poses;          // [F,4,4] (LED)
  const unsigned char* valid;  // [N]
  const float* albedo;         // [N,3]
  const int32_t* nbr;          // [N,3] (regularizer)
  const int32_t* rev;          // [N,6] (regularizer)
  const float* nbr_dir;        // [N,3] (regularizer)
  const float* nbr_const;      // [N,3,3] (regularizer)
  float* delta;                // [N,3]
  float* albedo_out;           // [N,3]
  int64_t* steps;              // [2]: the CG's steps, the grid barriers crossed
  float* work;                 // p, y, r_reg, J0r, Jir (regularizer), then the own vectors
  uint32_t* sync;              // the barriers' counter (4 words), [2][blocks][kSlots] floats
  float* b_out;                // [N,3] the system, written when given
  float* diag_ps_out;          // [N,3]
  float* diag_out;             // [N,3] (regularizer)
  const float* b_in;           // [N,3] phases 2: the system read from here
  const float* diag_ps_in;     // [N,3]
  int64_t n, f, basis, led, reg, maxiter, fixed, phases;
  double inv_h, reg_weight_rho, damping, tol_sq;
  BlockPlan plan;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
// a row's group of lanes (a power of two, at least 6: the group's lanes 0-5
// write the row's outputs), the groups (rows) a warp, which is a stage
constexpr int kGroupShift = 3;
constexpr int kGroup = 1 << kGroupShift;
constexpr int kStageRows = 32 / kGroup;        // ops/albedo.STAGE_ROWS
constexpr int kMaxBasis = 9;
// the floats each block publishes per barrier (the prologue's three sums)
constexpr int kSlots = 4;                      // ops/albedo.SLOTS
// shared memory before the mbarriers: the warps' sums [kCgWarps][kSlots]
// and the grid's sums (16 bytes) (ops/albedo.py _HEADER)
constexpr int kHeader = kCgWarps * kSlots * 4 + 16;
// the block's own vectors, 3 floats a row each (ops/albedo.py _VECTORS)
constexpr int kX = 0, kR = 1, kZ = 2, kAp = 3, kP = 4, kDsafe = 5, kDd = 6, kDps = 7;
constexpr int kVectors = 8;

struct BlockParams {
  const float* __restrict__ w;
  const float* __restrict__ r;
  const float* __restrict__ p_cam;
  const float* __restrict__ grad;
  const float* __restrict__ lights;
  const float* __restrict__ poses;
  const unsigned char* __restrict__ valid;
  const float* __restrict__ albedo;
  const int32_t* __restrict__ nbr;
  const int32_t* __restrict__ rev;
  const float* __restrict__ nbr_dir;
  const float* __restrict__ nbr_const;
  const float* __restrict__ b_in;
  const float* __restrict__ diag_ps_in;
  float* delta;
  float* albedo_out;
  int64_t* steps;
  // the regularizer's rows, written before the launch's grid.sync and
  // read-only after it (the CG's steps read J0r and Jir through L1), and
  // the published p and y, rewritten every step and read across blocks
  // after a barrier with ld.global.cg
  float* r_reg;
  const float* J0r;
  const float* Jir;
  float* J0r_out;
  float* Jir_out;
  float* pub_p;
  float* pub_y;
  float* own;                           // the own vectors when they are not in shared memory
  float* b_out;
  float* diag_ps_out;
  float* diag_out;
  uint32_t* counter;                    // the barriers' arrivals
  float* part;                          // [2][blocks][kSlots]: the blocks' partials
  int64_t n;
  int f, basis, tile, blocks, maxiter, fixed, shared, depth, stage_bytes, ring, vec, phases;
  float inv_h, rho, damping, one_plus_damping, tol2;
};

// ---------------------------------------------------------------- the system

// J of a pair for the three channels from its p_cam q (LED): -(l_f .
// SH(ghat)) (SH) or refl(n, f) l_c (LED)
template <bool kLed>
__device__ __forceinline__ void pair_jacobian(const BlockParams& p, int f, const float* q,
                                              const float* nn, const float* basis,
                                              const float* led_light, float* J) {
  if constexpr (kLed) {
    const float* P = p.poses + 16 * static_cast<int64_t>(f);
    const float qv[3] = {q[0], q[1], q[2]};
    float Rp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)            // R p in ops/fuse.rot_apply's order
      Rp[i] = fadd(fadd(fmul(__ldg(P + 4 * i), qv[0]), fmul(__ldg(P + 4 * i + 1), qv[1])),
                   fmul(__ldg(P + 4 * i + 2), qv[2]));
    const float num = dot3(nn, Rp);
    const float pn = clamp_min(norm3(qv), 1e-12f);
    const float refl = fdiv(num, fmul(fmul(pn, pn), pn));
#pragma unroll
    for (int c = 0; c < 3; ++c) J[c] = fmul(refl, led_light[c]);
  } else {
    const float* l = p.lights + static_cast<int64_t>(f) * p.basis;
    float e = fmul(basis[0], __ldg(l));
    for (int k = 1; k < p.basis; ++k) e = fadd(e, fmul(basis[k], __ldg(l + k)));
#pragma unroll
    for (int c = 0; c < 3; ++c) J[c] = -e;
  }
}

// Row n's regularizer rows for channel c: r_reg, J0r and Jir
// (solvers.albedo_reg_operator's arithmetic in a fixed order)
__device__ __forceinline__ void reg_rows(const BlockParams& p, int64_t n, int c) {
  const float a = __ldg(p.albedo + 3 * n + c);
  float g[3], dir[3], e[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int j = __ldg(p.nbr + 3 * n + ax);
    dir[ax] = __ldg(p.nbr_dir + 3 * n + ax);
    const float an = j >= 0 ? __ldg(p.albedo + 3 * static_cast<int64_t>(j) + c)
                            : __ldg(p.nbr_const + 9 * n + 3 * ax + c);
    g[ax] = fmul(fmul(dir[ax], fsub(an, a)), p.inv_h);
    e[ax] = fmul(-p.inv_h, dir[ax]);
  }
  const float nrm = norm3(g);
  const bool v = __ldg(p.valid + n) != 0;
  const float scale = nrm != 0.0f ? fdiv(1.0f, clamp_min(nrm, 1e-12f)) : 1.0f;
  p.r_reg[3 * n + c] = v ? nrm : 0.0f;
  p.J0r_out[3 * n + c] = v ? fmul(dot3(g, e), scale) : 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    p.Jir_out[9 * n + 3 * ax + c] = v ? fmul(fmul(g[ax], fmul(dir[ax], p.inv_h)), scale) : 0.0f;
}

// One row through its group of lanes: the row's pairs at wrow, rrow (and
// qrow, p_cam) and its stored gradient at grow, in a stage or in device
// memory; b into vr and diag_ps into vdp at local row l.  Every lane of the
// warp takes part (the butterfly's shuffles).
template <bool kLed, bool kReg>
__device__ __forceinline__ void form_rows(const BlockParams& p, int64_t n, bool active, int l,
                                          const float* wrow, const float* rrow,
                                          const float* qrow, const float* grow,
                                          const float* led_light, float* vr, float* vdp) {
  const int k = threadIdx.x & (kGroup - 1);     // the lane in its row's group
  float acc[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) acc[q] = 0.0f;
  if (active) {
    // the normalized stored gradient and (SH) its basis
    const float g[3] = {grow[0], grow[1], grow[2]};
    const float c0 = clamp_min(norm3(g), 1e-12f);
    const float nn[3] = {fdiv(g[0], c0), fdiv(g[1], c0), fdiv(g[2], c0)};
    float basis[kMaxBasis];
    basis[0] = 1.0f;
    basis[1] = nn[0];
    basis[2] = nn[1];
    basis[3] = nn[2];
    if (!kLed && p.basis == 9) {
      basis[4] = fmul(nn[0], nn[1]);
      basis[5] = fmul(nn[0], nn[2]);
      basis[6] = fmul(nn[1], nn[2]);
      basis[7] = fsub(fmul(nn[0], nn[0]), fmul(nn[1], nn[1]));
      basis[8] = fsub(fmul(nn[0], nn[0]), fmul(nn[2], nn[2]));
    }
    // lane k of the group: frames k, k + kGroup, ...; acc[c] = sum J (w r),
    // acc[3 + c] = sum (J J) w
    for (int f = k; f < p.f; f += kGroup) {
      float J[3];
      pair_jacobian<kLed>(p, f, kLed ? qrow + 3 * f : nullptr, nn, basis, led_light, J);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float wc = wrow[3 * f + c];
        const float wr = fmul(wc, rrow[3 * f + c]);
        acc[c] = fadd(acc[c], fmul(J[c], wr));
        acc[3 + c] = fadd(acc[3 + c], fmul(fmul(J[c], J[c]), wc));
      }
    }
  }
  // the group's lane sums by an xor butterfly inside the group
#pragma unroll
  for (int s = kGroup / 2; s >= 1; s >>= 1)
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[q] = fadd(acc[q], __shfl_xor_sync(kFull, acc[q], s));
  float mine = 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q)
    if (k == q) mine = acc[q];
  if (active) {
    if (k < 3) vr[3 * l + k] = mine;
    else if (k < 6) vdp[3 * l + k - 3] = mine;
    if constexpr (kReg) {
      if (k < 3) reg_rows(p, n, k);
    }
  }
}

// Warp `warp`'s stage j of the block's tile [begin, begin + rows) into its
// slot: the rows' pairs of w, r (and p_cam), then their stored gradients;
// one bulk copy a span where every span is 16-byte sized and aligned (lane
// 0 arrives expecting their bytes), else the lanes' own loads (lane 0 then
// arrives).  The slot's earlier reads are done (the warp has passed a
// __syncwarp since).
template <bool kLed>
__device__ __forceinline__ void stage_in(const BlockParams& p, int64_t begin, int rows, int warp,
                                         int j, float* slot, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const int l0 = (warp + kCgWarps * j) * kStageRows;
  const int nr = min(kStageRows, rows - l0);
  const int64_t off = (begin + l0) * p.f * 3;
  const int floats = nr * p.f * 3;
  const int span = kStageRows * p.f * 3;        // a tensor's region in a slot
  constexpr int kT = kLed ? 3 : 2;
  const float* src[3] = {p.w + off, p.r + off, kLed ? p.p_cam + off : p.w + off};
  const float* gsrc = p.grad + 3 * (begin + l0);
  float* gdst = slot + kT * span;
  const uint32_t bytes = static_cast<uint32_t>(floats) * 4u;
  const uint32_t gbytes = static_cast<uint32_t>(nr) * 12u;
  bool bulk = ((bytes | gbytes) & 15u) == 0 && (reinterpret_cast<uintptr_t>(gsrc) & 15u) == 0;
#pragma unroll
  for (int t = 0; t < kT; ++t) bulk = bulk && (reinterpret_cast<uintptr_t>(src[t]) & 15u) == 0;
  if (bulk) {
    if (lane == 0) {
      fence_proxy_async();
      mbar_arrive_expect_tx(bar, kT * bytes + gbytes);
#pragma unroll
      for (int t = 0; t < kT; ++t) bulk_load(slot + t * span, src[t], bytes, bar);
      bulk_load(gdst, gsrc, gbytes, bar);
    }
  } else {
#pragma unroll
    for (int t = 0; t < kT; ++t)
      for (int i = lane; i < floats; i += 32) slot[t * span + i] = __ldg(src[t] + i);
    if (lane < 3 * nr) gdst[lane] = __ldg(gsrc + lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// Step 2 of the block: every row of its tile formed into vr and vdp (and,
// under the regularizer, its rows into the work buffer).
template <bool kLed, bool kReg>
__device__ __forceinline__ void form_system(const BlockParams& p, unsigned char* smem,
                                           int64_t begin, int rows, float* vr, float* vdp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> kGroupShift;            // the group's row in a stage
  float led_light[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kLed) {
    led_light[0] = __ldg(p.lights);
    led_light[1] = __ldg(p.lights + 1);
    led_light[2] = __ldg(p.lights + 2);
  }
  const int stages = (rows + kStageRows - 1) / kStageRows;
  const int rowf = 3 * p.f;                     // floats of a row of a tensor
  if (p.depth == 0) {
    for (int s = warp; s < stages; s += kCgWarps) {
      const int l = s * kStageRows + g;
      const bool active = l < rows;
      const int64_t n = begin + (active ? l : 0);
      const float* wr = p.w + n * rowf;
      const float* rr = p.r + n * rowf;
      const float* qr = kLed ? p.p_cam + n * rowf : nullptr;
      form_rows<kLed, kReg>(p, n, active, l, wr, rr, qr, p.grad + 3 * n, led_light, vr, vdp);
    }
    return;
  }
  const int D = p.depth;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kHeader) + warp * D;
  float* ring = reinterpret_cast<float*>(smem + p.ring + static_cast<int64_t>(warp) * D *
                                                             p.stage_bytes);
  const int slot_floats = p.stage_bytes / 4;
  const int span = kStageRows * rowf;
  for (int j = 0; j < D && warp + kCgWarps * j < stages; ++j)
    stage_in<kLed>(p, begin, rows, warp, j, ring + j * slot_floats, &bars[j]);
  for (int j = 0;; ++j) {
    const int s = warp + kCgWarps * j;
    if (s >= stages) break;
    const int slot = j % D;
    float* st = ring + slot * slot_floats;
    mbar_wait(&bars[slot], static_cast<uint32_t>((j / D) & 1));
    const int l = s * kStageRows + g;
    const bool active = l < rows;
    constexpr int kT = kLed ? 3 : 2;
    form_rows<kLed, kReg>(p, begin + (active ? l : 0), active, l, st + g * rowf,
                          st + span + g * rowf, kLed ? st + 2 * span + g * rowf : nullptr,
                          st + kT * span + 3 * g, led_light, vr, vdp);
    __syncwarp();
    if (s + kCgWarps * D < stages) stage_in<kLed>(p, begin, rows, warp, j + D, st, &bars[slot]);
  }
}

// ------------------------------------------------------------------ the block

template <bool kLed, bool kReg>
__global__ void __launch_bounds__(kCgThreads, 1)
albedo_block_kernel(const __grid_constant__ BlockParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);              // the warps' sums
  float* bc = buf + kSlots * kCgWarps;                      // the grid's sums
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * p.tile;
  const int rows = static_cast<int>(min(p.n - begin, static_cast<int64_t>(p.tile)));
  float* vec;
  int64_t vstride;
  if (p.shared) {
    vec = reinterpret_cast<float*>(smem + p.vec);
    vstride = 3 * p.tile;
  } else {
    vec = p.own + 3 * begin;
    vstride = 3 * p.n;
  }
  float* vx = vec + kX * vstride;
  float* vr = vec + kR * vstride;
  float* vz = vec + kZ * vstride;
  float* vap = vec + kAp * vstride;
  float* vp = vec + kP * vstride;
  float* vds = vec + kDsafe * vstride;
  float* vdd = vec + kDd * vstride;
  float* vdp = vec + kDps * vstride;

  // ---- the system: b into vr, diag_ps into vdp (under the regularizer
  // diag into vdd until the prologue)
  if (p.phases & 1) {
    if (p.depth > 0) {
      if (tid == 0) {
        uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kHeader);
        for (int i = 0; i < kCgWarps * p.depth; ++i) mbar_init(&bars[i], 1);
        fence_mbar_init();
      }
      __syncthreads();
    }
    form_system<kLed, kReg>(p, smem, begin, rows, vr, vdp);
    if constexpr (kReg) {
      // the regularizer's transposes in gather form: row m takes its own
      // column and the Jir column of each row naming it, in rev's order,
      // after the grid.sync (barrier 0; the counter set to 0 before it)
      if (blockIdx.x == 0 && tid == 0) *p.counter = 0;
      grid.sync();
      for (int l = tid; l < rows; l += kCgThreads) {
        const int64_t m = begin + l;
        int rv[6];
#pragma unroll
        for (int col = 0; col < 6; ++col) rv[col] = __ldg(p.rev + 6 * m + col);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float j0 = __ldcg(p.J0r + 3 * m + c);
          float ub = fmul(j0, __ldcg(p.r_reg + 3 * m + c));
          float ud = fmul(j0, j0);
#pragma unroll
          for (int col = 0; col < 6; ++col) {
            const int64_t nr = rv[col];
            const int64_t at = nr >= 0 ? nr : m;                 // m: unused
            const float ji = __ldcg(p.Jir + 9 * at + 3 * (col >> 1) + c);
            const float rn = __ldcg(p.r_reg + 3 * at + c);
            ub = fadd(ub, nr >= 0 ? fmul(ji, rn) : 0.0f);
            ud = fadd(ud, nr >= 0 ? fmul(ji, ji) : 0.0f);
          }
          const int o = 3 * l + c;
          vr[o] = fadd(vr[o], fmul(p.rho, ub));
          vdd[o] = fadd(vdp[o], fmul(p.rho, ud));
        }
      }
    }
  } else {
    for (int l = tid; l < rows; l += kCgThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int64_t i = 3 * (begin + l) + c;
        vr[3 * l + c] = __ldg(p.b_in + i);
        vdp[3 * l + c] = __ldg(p.diag_ps_in + i);
      }
  }
  __syncthreads();
  if (p.b_out)
    for (int l = tid; l < rows; l += kCgThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int64_t i = 3 * (begin + l) + c;
        const int o = 3 * l + c;
        p.b_out[i] = vr[o];
        p.diag_ps_out[i] = vdp[o];
        if constexpr (kReg) p.diag_out[i] = vdd[o];
      }
  if (!(p.phases & 2)) return;

  // ---- the prologue: the safe diagonal, x = 0, r = where(valid, b, 0),
  // z = p = r / d; without the regularizer also A p and p.Ap of step 0
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int l = tid; l < rows; l += kCgThreads) {
    const bool v = __ldg(p.valid + begin + l) != 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int o = 3 * l + c;
      const float bm = v ? vr[o] : 0.0f;
      const float dm = kReg ? vdd[o] : vdp[o];
      const float dt = fmul(p.one_plus_damping, dm);
      const float ds = (v && dt > 0.0f) ? dt : 1.0f;
      const float zm = fdiv(bm, ds);
      const float dd = fmul(p.damping, dm);
      vx[o] = 0.0f;
      vr[o] = bm;
      vz[o] = zm;
      vp[o] = zm;
      vds[o] = ds;
      vdd[o] = dd;
      acc[0] += bm * bm;
      acc[1] += bm * zm;
      if constexpr (!kReg) {
        const float out = fadd(fmul(vdp[o], zm), fmul(dd, zm));
        const float am = v ? out : zm;
        vap[o] = am;
        acc[2] += zm * am;
      }
    }
  }
  // the prologue's sums: without the regularizer through set 0 and the
  // launch's grid.sync (the counter set to 0 before any block arrives),
  // under it through barrier 1 (its grid.sync came before the transposes)
  uint32_t epoch = 0;
  float g[3], pAp0 = 0.0f;
  if constexpr (kReg) {
    const float a2[2] = {acc[0], acc[1]};
    float g2[2];
    barrier_sum<2, kSlots>(p, ++epoch, a2, g2, buf, bc);
    g[0] = g2[0];
    g[1] = g2[1];
  } else {
    float mine[3];
    block_sum<3, kSlots>(acc, mine, buf);
    if (tid == 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) p.part[kSlots * blockIdx.x + q] = mine[q];
      if (blockIdx.x == 0) *p.counter = 0;
    }
    grid.sync();
    grid_sum<3, kSlots>(p.part, p.blocks, g, bc);
    pAp0 = g[2];
  }
  const float bb = g[0];
  float gamma = g[1], rr = bb, beta = 0.0f;
  const float thr = p.tol2 * bb;

  int steps = 0;
  for (int k = 0; k < p.maxiter; ++k) {
    if (!(rr > thr)) break;                       // the same in every block
    // ---- p of the block's rows
    if (k > 0 || kReg)
      for (int l = tid; l < rows; l += kCgThreads)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int o = 3 * l + c;
          const float pl = k > 0 ? fadd(vz[o], fmul(beta, vp[o])) : vp[o];
          vp[o] = pl;
          if constexpr (kReg) p.pub_p[3 * (begin + l) + c] = pl;
        }
    if constexpr (kReg) {
      // ---- y = J p of the block's rows, the neighbours' p from any tile
      barrier(p, ++epoch);
      for (int l = tid; l < rows; l += kCgThreads) {
        const int64_t m = begin + l;
        int j[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) j[ax] = __ldg(p.nbr + 3 * m + ax);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float y = fmul(p.J0r[3 * m + c], vp[3 * l + c]);
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float pj = j[ax] >= 0 ? __ldcg(p.pub_p + 3 * static_cast<int64_t>(j[ax]) + c)
                                        : 0.0f;
            y = fadd(y, fmul(p.Jir[9 * m + 3 * ax + c], pj));
          }
          p.pub_y[3 * m + c] = y;
        }
      }
      barrier(p, ++epoch);
    }
    // ---- A p and the block's part of p.Ap (the diagonal instance's step
    // 0: both from the prologue)
    float pAp;
    if (kReg || k > 0) {
      float pa[1] = {0.0f};
      for (int l = tid; l < rows; l += kCgThreads) {
        const int64_t m = begin + l;
        const bool v = __ldg(p.valid + m) != 0;
        int rv[6];
        if constexpr (kReg)
#pragma unroll
          for (int col = 0; col < 6; ++col) rv[col] = __ldg(p.rev + 6 * m + col);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int o = 3 * l + c;
          const float pm = vp[o];
          float out = fmul(vdp[o], pm);
          if constexpr (kReg) {
            float u = fmul(p.J0r[3 * m + c], __ldcg(p.pub_y + 3 * m + c));
#pragma unroll
            for (int col = 0; col < 6; ++col) {
              const int64_t nr = rv[col];
              const int64_t at = nr >= 0 ? nr : m;              // m: unused
              const float t = fmul(p.Jir[9 * at + 3 * (col >> 1) + c],
                                   __ldcg(p.pub_y + 3 * at + c));
              u = fadd(u, nr >= 0 ? t : 0.0f);
            }
            out = fadd(out, fmul(p.rho, u));
          }
          out = fadd(out, fmul(vdd[o], pm));
          const float am = v ? out : pm;
          vap[o] = am;
          pa[0] += pm * am;
        }
      }
      float sum[1];
      barrier_sum<1, kSlots>(p, ++epoch, pa, sum, buf, bc);
      pAp = sum[0];
    } else {
      pAp = pAp0;
    }
    const float alpha = gamma / (p.fixed ? clamp30(pAp) : pAp);

    // ---- the update: x, r, z and the block's parts of r.z and r.r
    float acc2[2] = {0.0f, 0.0f};
    for (int l = tid; l < rows; l += kCgThreads)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int o = 3 * l + c;
        const float xl = fadd(vx[o], fmul(alpha, vp[o]));
        const float rl = fsub(vr[o], fmul(alpha, vap[o]));
        const float zl = fdiv(rl, vds[o]);
        vx[o] = xl;
        vr[o] = rl;
        vz[o] = zl;
        acc2[0] += rl * zl;
        acc2[1] += rl * rl;
      }
    float gr[2];
    barrier_sum<2, kSlots>(p, ++epoch, acc2, gr, buf, bc);
    beta = gr[0] / (p.fixed ? clamp30(gamma) : gamma);
    gamma = gr[0];
    rr = gr[1];
    steps = k + 1;
  }

  // ---- delta and the accept rule (solvers.update_albedo)
  for (int l = tid; l < rows; l += kCgThreads) {
    const int64_t m = begin + l;
    const bool v = __ldg(p.valid + m) != 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = v ? vx[3 * l + c] : 0.0f;
      const float a = __ldg(p.albedo + 3 * m + c);
      const float cand = fsub(a, d);
      p.delta[3 * m + c] = d;
      p.albedo_out[3 * m + c] = (v && cand > 0.0f && cand < 1.0f) ? cand : a;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    p.steps[0] = steps;
    p.steps[1] = 1 + static_cast<int64_t>(epoch);   // the grid.sync and the counter barriers
  }
}

const void* block_kernel(bool led, bool reg) {
  if (led)
    return reg ? reinterpret_cast<const void*>(albedo_block_kernel<true, true>)
               : reinterpret_cast<const void*>(albedo_block_kernel<true, false>);
  return reg ? reinterpret_cast<const void*>(albedo_block_kernel<false, true>)
             : reinterpret_cast<const void*>(albedo_block_kernel<false, false>);
}

int finish(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// the plan's shared memory laid out as the kernel reads it: the header, the
// warps' mbarriers, the rings, the vectors
bool plan_ok(const BlockPlan& q, int64_t n, int64_t f, bool led) {
  const int64_t tensors = led ? 3 : 2;
  const int64_t bars_end = kHeader + 8 * kCgWarps * q.depth;
  const int64_t ring_end = q.ring + kCgWarps * q.depth * q.stage_bytes;
  return q.tile >= 16 && q.tile % 16 == 0 && q.blocks >= 1 && (q.blocks - 1) * q.tile < n &&
         q.blocks * q.tile >= n && q.depth >= 0 &&
         q.stage_bytes == kStageRows * (f * 12 * tensors + 12) && q.ring % 16 == 0 &&
         q.ring >= bars_end && q.smem_bytes >= ring_end && q.smem_bytes >= kHeader &&
         (!q.shared || (q.vec >= ring_end && q.vec % 16 == 0 &&
                        q.smem_bytes >= q.vec + 4 * kVectors * 3 * q.tile)) &&
         q.smem_bytes <= (int64_t{1} << 30);
}

}  // namespace

// Whether albedo_block's kernel (LED or SH, with or without the
// regularizer) runs cooperatively on the current device at `smem_bytes` of
// dynamic shared memory: the blocks an SM holds -> per_sm.
extern "C" int albedo_block_occupancy(int64_t led, int64_t reg, int64_t smem_bytes,
                                      int64_t* per_sm) {
  if (smem_bytes < kHeader) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, occ = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  const void* kernel = block_kernel(led != 0, reg != 0);
  if (ce == cudaSuccess)
    ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kCgThreads,
                                                       static_cast<size_t>(smem_bytes));
  if (ce != cudaSuccess) return finish(ce);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  *per_sm = occ;
  return 0;
}

extern "C" int albedo_block(const BlockArgs* a, void* stream) {
  const bool led = a->led != 0, reg = a->reg != 0;
  const int64_t n = a->n;
  const bool system = (a->phases & 1) != 0, solve = (a->phases & 2) != 0;
  if (n < 1 || a->f < 1 || n > (int64_t{1} << 31) / 9 || a->f > (int64_t{1} << 31) / 12 ||
      a->maxiter < 0 || a->phases < 1 || a->phases > 3 || !plan_ok(a->plan, n, a->f, led) ||
      (reg && a->phases != 3) || !a->valid || !a->albedo || !a->steps || !a->sync ||
      (system && (!a->w || !a->r || !a->grad || !a->lights ||
                  (!led && (a->basis != 4 && a->basis != 9)) ||
                  (led && (!a->p_cam || !a->poses)))) ||
      (!system && (!a->b_in || !a->diag_ps_in)) || (!solve && !a->b_out) ||
      (a->b_out && (!a->diag_ps_out || (reg && !a->diag_out))) ||
      (solve && (!a->delta || !a->albedo_out)) ||
      (reg && (!a->nbr || !a->rev || !a->nbr_dir || !a->nbr_const)) ||
      (!a->plan.shared && !a->work) || (reg && !a->work))
    return static_cast<int>(cudaErrorInvalidValue);
  BlockParams p;
  p.w = a->w;  p.r = a->r;  p.p_cam = a->p_cam;  p.grad = a->grad;
  p.lights = a->lights;  p.poses = a->poses;  p.valid = a->valid;  p.albedo = a->albedo;
  p.nbr = a->nbr;  p.rev = a->rev;  p.nbr_dir = a->nbr_dir;  p.nbr_const = a->nbr_const;
  p.b_in = a->b_in;  p.diag_ps_in = a->diag_ps_in;
  p.delta = a->delta;  p.albedo_out = a->albedo_out;  p.steps = a->steps;
  p.b_out = a->b_out;  p.diag_ps_out = a->diag_ps_out;  p.diag_out = a->diag_out;
  // the work buffer: p, y, r_reg, J0r [3N] each and Jir [9N] (regularizer),
  // then the own vectors [kVectors][3N] where they are not in shared memory
  float* w = a->work;
  p.pub_p = reg ? w : nullptr;
  p.pub_y = reg ? w + 3 * n : nullptr;
  p.r_reg = reg ? w + 6 * n : nullptr;
  p.J0r = p.J0r_out = reg ? w + 9 * n : nullptr;
  p.Jir = p.Jir_out = reg ? w + 12 * n : nullptr;
  p.own = w ? w + (reg ? 21 * n : 0) : nullptr;
  p.counter = a->sync;
  p.part = reinterpret_cast<float*>(a->sync + 4);
  p.n = n;
  p.f = static_cast<int>(a->f);
  p.basis = static_cast<int>(a->basis);
  p.tile = static_cast<int>(a->plan.tile);
  p.blocks = static_cast<int>(a->plan.blocks);
  p.maxiter = static_cast<int>(a->maxiter);
  p.fixed = static_cast<int>(a->fixed);
  p.shared = static_cast<int>(a->plan.shared);
  p.depth = static_cast<int>(a->plan.depth);
  p.stage_bytes = static_cast<int>(a->plan.stage_bytes);
  p.ring = static_cast<int>(a->plan.ring);
  p.vec = static_cast<int>(a->plan.vec);
  p.phases = static_cast<int>(a->phases);
  p.inv_h = static_cast<float>(a->inv_h);
  p.rho = static_cast<float>(a->reg_weight_rho);
  p.damping = static_cast<float>(a->damping);
  p.one_plus_damping = static_cast<float>(1.0 + a->damping);
  p.tol2 = static_cast<float>(a->tol_sq);
  const void* kernel = block_kernel(led, reg);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a->plan.smem_bytes));
  void* args[] = {&p};
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(a->plan.blocks)),
                                    dim3(kCgThreads), args,
                                    static_cast<size_t>(a->plan.smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  return finish(e);
}
