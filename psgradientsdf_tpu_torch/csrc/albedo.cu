// The albedo block's solve for Hopper (sm_90a): its data terms formed per
// (voxel, keyframe) pair and, under the albedo regularizer, its linearized
// rows (albedo_system), and the whole Jacobi-preconditioned CG with the
// (0, 1) accept rule in ONE cooperative launch (albedo_cg).
//
// Together they replace the JAX package's albedo block as
// psgradientsdf_tpu/refine/optimizer.py `_albedo_core` (:77) runs it:
// refine/jacobians.py `albedo_jacobian_sh` (:128) / `albedo_jacobian_led`
// (:138, through `_led_reflectance` :175), refine/solvers.py `solve_albedo`
// (:424) with the einsums of :443-444, the regularizer of :446-478, the CG
// (jax.scipy.sparse.linalg.cg :496 or `pcg_fixed` :39) and `update_albedo`
// (:502).  XLA keeps that block in one device program; the port's eager
// version ran some 340 operations a block (1380 under the regularizer),
// read the CG's stop flag back twice or more, and added the regularizer's
// transposes with atomic scatter-adds (index_add_).
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
// albedo_system_kernel<kLed, kReg>: a group of kGroup = 8 lanes a row, four
// rows a warp (grid-stride), the frames in the group's lanes: lane k forms
// J of frames k, k + 8, ... in registers (never written) and adds each
// channel's J (w r) and (J J) w in that order, each product and sum
// rounded once (_rn intrinsics); the 8 lane sums are added by an xor
// butterfly inside the group; its lanes 0-2 write b, 3-5 diag_ps.  (A
// warp a row, the first design, idled the lanes past F and spent a warp's
// normalisation and 32-lane butterfly on each row: 11 % slower at F = 40,
// twice as slow at F = 8; 16 lanes a row was no faster at F = 40 and
// slower at F = 8: PERF.md §6, tools/albedo_lanes_ab.py.)  Under the
// regularizer lanes 0-2 also form their channel's r_reg, J0r and Jir (the
// rows' own arithmetic of solvers.albedo_reg_operator, in a fixed order),
// the kernel crosses one grid.sync (a cooperative launch), and then a
// thread a row gathers the rows naming it and adds rho J^T r_reg and rho
// diag(J^T J).  The plain version (ops/albedo.albedo_system_plain) emulates
// that order: the kernel equals it bit for bit.  Bound by bytes: w and r
// read once (24 bytes a pair; LED: p_cam too, 36), the row's gradient, its
// mask, b and diag_ps (37 bytes a row): 49.0 MB at N = 49152, F = 40,
// 0.0146 ms at 3.35 TB/s.
//
// albedo_cg_kernel<kReg>: ONE cooperative launch runs the whole PCG.  The
// row is widened: a row is a voxel with its three channels (the plan's
// rows are voxels, ops/distcg._cg_plan's tiles: one block an SM, a
// contiguous tile a block on 16-row starts).  The block's own vectors x, r,
// z, A p, p, the safe diagonal, damping diag and diag_ps (96 bytes a row)
// live in shared memory where the tile fits (ops/albedo.shared_tile_limit;
// else in device memory, each block's own range), and a thread keeps the
// same rows through the whole launch.  The prologue forms the safe Jacobi
// diagonal, x = 0, r = where(valid, b, 0), z = p = r / d; one grid.sync.  A
// step is
//   p = z + beta p_old of the block's rows (not at step 0);
//   kReg: publish p; barrier; y = J p of the block's rows (J0r p + the
//         neighbours' p through nbr, other tiles' from device memory);
//         publish y; barrier;
//   A p = diag_ps p (+ rho (J0r y + the y of the rows naming it, through
//       rev)) + damping diag p, where(valid, ., p); the block's part of
//       p.Ap; barrier;
//   alpha; x, r, z = r / d and the block's parts of r.z and r.r; barrier;
//   beta, and the stop test r.r > thr before the next step, thr = tol^2
//   b.b (scipy's rule at atol 0, as the JAX package calls it, or
//   cg_static's with its clamped divisions), decided on the device.
// Without the regularizer (both recipes) the operator is diagonal: its
// instance gathers nothing and crosses two barriers a step, those of its
// dots (csrc/cg_sync.cuh, shared with csrc/distcg.cu); under it, four.  The
// epilogue writes delta = where(valid, x, 0) and the new albedo, cand =
// albedo - delta kept where 0 < cand < 1 on a valid row, else the old
// (solvers.update_albedo: the same subtraction and comparisons, so equal
// to it on this delta bit for bit), and the step count; nothing is read
// back.  The dots are summed in another order than the plain version's
// torch.sum, so the two agree to float32 rounding.  Bound by bytes: b,
// diag_ps, diag, valid and albedo read once, delta and the albedo written
// once (73 bytes a row; under the regularizer J0r, Jir, nbr and rev too);
// the time is set by the barriers (chip_smoke.py times an empty
// cooperative kernel crossing as many).
//
// Plain C interface (loaded with ctypes): albedo_system() and albedo_cg()
// launch on the stream they are given; albedo_cg_occupancy() checks the
// plan's shared memory on the current device.  Each returns 0 or the CUDA
// error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cg_sync.cuh"

namespace cg = cooperative_groups;

struct SystemArgs {            // ops/albedo.py _SystemArgs, field for field
  const float* w;              // [N,F,3]
  const float* r;              // [N,F,3]
  const float* p_cam;          // [N,F,3] (LED)
  const float* grad;           // [N,3] the stored gradient
  const float* lights;         // [F,B] (SH) or [3] (LED)
  const float* poses;          // [F,4,4] (LED)
  const unsigned char* valid;  // [N]
  const float* albedo;         // [N,3] (regularizer)
  const int32_t* nbr;          // [N,3] (regularizer)
  const int32_t* rev;          // [N,6] (regularizer)
  const float* nbr_dir;        // [N,3] (regularizer)
  const float* nbr_const;      // [N,3,3] (regularizer)
  float* b;                    // [N,3]
  float* diag_ps;              // [N,3]
  float* diag;                 // [N,3] (regularizer; else diag_ps is diag)
  float* r_reg;                // [N,3] (regularizer)
  float* J0r;                  // [N,3] (regularizer)
  float* Jir;                  // [N,3,3] (regularizer)
  int64_t n, f, basis, led, reg;
  double inv_h, reg_weight_rho;
};

struct CgArgs {                // ops/albedo.py _CgArgs, field for field
  const float* b;
  const float* diag_ps;
  const float* diag;
  const float* J0r;
  const float* Jir;
  const int32_t* nbr;
  const int32_t* rev;
  const unsigned char* valid;
  const float* albedo;
  float* delta;
  float* albedo_out;
  int64_t* steps;
  float* work;                 // published p, y [3N] each (regularizer), then own rows
  uint32_t* sync;              // the barriers' counter (4 words), [2][blocks][2] floats
  int64_t n, maxiter, fixed, reg, blocks, tile, smem_bytes, shared;
  double reg_weight_rho, damping, tol_sq;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSysThreads = 256;
// albedo_system: a row's group of lanes (a power of two, at least 6: the
// group's lanes 0-5 write the row's outputs), the groups a warp
constexpr int kGroupShift = 3;
constexpr int kGroup = 1 << kGroupShift;
constexpr int kGroups = 32 / kGroup;
constexpr int kMaxBasis = 9;

// ------------------------------------------------------------- arithmetic

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(min=): a NaN input is returned as it is
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// geometry.dot3: (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return fadd(fadd(fmul(a[0], b[0]), fmul(a[1], b[1])), fmul(a[2], b[2]));
}

// geometry.norm3: s = fma(v2, v2, fma(v1, v1, v0 v0)), each fma the exact
// product plus s in double rounded to float, then the root in double
// rounded to float
__device__ __forceinline__ float norm3(const float* v) {
  float s = fmul(v[0], v[0]);
  s = __double2float_rn(__dadd_rn(__dmul_rn(v[1], v[1]), static_cast<double>(s)));
  s = __double2float_rn(__dadd_rn(__dmul_rn(v[2], v[2]), static_cast<double>(s)));
  return __double2float_rn(__dsqrt_rn(static_cast<double>(s)));
}

// ------------------------------------------------------------ albedo_system

struct SystemParams {
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
  float* b;                    // written, then (regularizer) read back after the grid.sync
  float* diag_ps;
  float* diag;
  float* r_reg;
  float* J0r;
  float* Jir;
  int64_t n;
  int f, basis;
  float inv_h, rho;
};

// J of pair (n, f) for the three channels: -(l_f . SH(ghat)) (SH) or
// refl(n, f) l_c (LED)
template <bool kLed>
__device__ __forceinline__ void pair_jacobian(const SystemParams& p, int64_t n, int f,
                                              const float* nn, const float* basis,
                                              const float* led_light, float* J) {
  if constexpr (kLed) {
    const float* P = p.poses + 16 * static_cast<int64_t>(f);
    const float* pc = p.p_cam + (n * p.f + f) * 3;
    const float q[3] = {__ldg(pc), __ldg(pc + 1), __ldg(pc + 2)};
    float Rp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)            // R p in ops/fuse.rot_apply's order
      Rp[i] = fadd(fadd(fmul(__ldg(P + 4 * i), q[0]), fmul(__ldg(P + 4 * i + 1), q[1])),
                   fmul(__ldg(P + 4 * i + 2), q[2]));
    const float num = dot3(nn, Rp);
    const float pn = clamp_min(norm3(q), 1e-12f);
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
__device__ __forceinline__ void reg_rows(const SystemParams& p, int64_t n, int c) {
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
  p.J0r[3 * n + c] = v ? fmul(dot3(g, e), scale) : 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    p.Jir[9 * n + 3 * ax + c] = v ? fmul(fmul(g[ax], fmul(dir[ax], p.inv_h)), scale) : 0.0f;
}

template <bool kLed, bool kReg>
__global__ void __launch_bounds__(kSysThreads)
albedo_system_kernel(const __grid_constant__ SystemParams p) {
  const int lane = threadIdx.x & 31;
  const int k = lane & (kGroup - 1);             // the lane in its row's group
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kSysThreads / 32);
  float led_light[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kLed) {
    led_light[0] = __ldg(p.lights);
    led_light[1] = __ldg(p.lights + 1);
    led_light[2] = __ldg(p.lights + 2);
  }
  // a warp takes kGroups consecutive rows at a time, every lane through
  // every turn (the butterfly's shuffles need the whole warp)
  for (int64_t base = ((static_cast<int64_t>(blockIdx.x) * kSysThreads + threadIdx.x) >> 5) *
                      kGroups;
       base < p.n; base += warps * kGroups) {
    const int64_t n = base + (lane >> kGroupShift);
    const bool active = n < p.n;
    const int64_t at = active ? n : base;          // an inactive group reads row base
    // the normalized stored gradient and (SH) its basis
    const float g[3] = {__ldg(p.grad + 3 * at), __ldg(p.grad + 3 * at + 1),
                        __ldg(p.grad + 3 * at + 2)};
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
    float acc[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[q] = 0.0f;
    if (active)
      for (int f = k; f < p.f; f += kGroup) {
        float J[3];
        pair_jacobian<kLed>(p, n, f, nn, basis, led_light, J);
        const float* wp = p.w + (n * p.f + f) * 3;
        const float* rp = p.r + (n * p.f + f) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float wc = __ldg(wp + c);
          const float wr = fmul(wc, __ldg(rp + c));
          acc[c] = fadd(acc[c], fmul(J[c], wr));
          acc[3 + c] = fadd(acc[3 + c], fmul(fmul(J[c], J[c]), wc));
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
      if (k < 3) p.b[3 * n + k] = mine;
      else if (k < 6) p.diag_ps[3 * n + k - 3] = mine;
      if constexpr (kReg) {
        if (k < 3) reg_rows(p, n, k);
      }
    }
  }
  if constexpr (kReg) {
    // the regularizer's transposes in gather form: row m takes its own
    // column and the Jir column of each row naming it, in rev's order
    cg::this_grid().sync();
    const int64_t threads = static_cast<int64_t>(gridDim.x) * kSysThreads;
    for (int64_t m = static_cast<int64_t>(blockIdx.x) * kSysThreads + threadIdx.x; m < p.n;
         m += threads) {
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
        // rows of other blocks' warps, written before the grid.sync: read
        // through L2 (ld.global.cg)
        p.b[3 * m + c] = fadd(__ldcg(p.b + 3 * m + c), fmul(p.rho, ub));
        p.diag[3 * m + c] = fadd(__ldcg(p.diag_ps + 3 * m + c), fmul(p.rho, ud));
      }
    }
  }
}

// --------------------------------------------------------------- albedo_cg

// the block's own vectors, 3 floats a row each (ops/albedo.py _VECTORS)
constexpr int kX = 0, kR = 1, kZ = 2, kAp = 3, kP = 4, kDsafe = 5, kDd = 6, kDps = 7;
constexpr int kVectors = 8;
// shared memory before the vectors: the warps' sums [kCgWarps][2] and the
// grid's sums (16 bytes) (ops/albedo.py _HEADER)
constexpr int kHeader = kCgWarps * 2 * 4 + 16;

struct CgParams {
  const float* __restrict__ b;
  const float* __restrict__ diag_ps;
  const float* __restrict__ diag;
  const float* __restrict__ J0r;
  const float* __restrict__ Jir;
  const int32_t* __restrict__ nbr;
  const int32_t* __restrict__ rev;
  const unsigned char* __restrict__ valid;
  const float* __restrict__ albedo;
  float* delta;
  float* albedo_out;
  int64_t* steps;
  float* pub_p;                         // published: read across blocks with ld.global.cg
  float* pub_y;
  float* own;                           // the own vectors when they are not in shared memory
  uint32_t* counter;                    // the barriers' arrivals
  float* part;                          // [2][blocks][2]: the blocks' partials
  int n, tile, blocks, maxiter, fixed, shared;
  float rho, damping, one_plus_damping, tol2;
};

template <bool kReg>
__global__ void __launch_bounds__(kCgThreads, 1)
albedo_cg_kernel(const __grid_constant__ CgParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);              // the warps' sums
  float* bc = buf + 2 * kCgWarps;                           // the grid's sums
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int begin = blockIdx.x * p.tile;
  const int rows = min(p.n - begin, p.tile);
  float* vec;
  int vstride;
  if (p.shared) {
    vec = reinterpret_cast<float*>(smem + kHeader);
    vstride = 3 * p.tile;
  } else {
    vec = p.own + 3 * static_cast<size_t>(begin);
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

  // ---- the prologue: the safe diagonal, x = 0, r = where(valid, b, 0),
  // z = p = r / d
  float acc[2] = {0.0f, 0.0f};
  for (int l = tid; l < rows; l += kCgThreads) {
    const int m = begin + l;
    const bool v = __ldg(p.valid + m) != 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int i = 3 * m + c, o = 3 * l + c;
      const float bm = v ? __ldg(p.b + i) : 0.0f;
      const float dm = __ldg(p.diag + i);
      const float dt = fmul(p.one_plus_damping, dm);
      const float ds = (v && dt > 0.0f) ? dt : 1.0f;
      const float zm = fdiv(bm, ds);
      vx[o] = 0.0f;
      vr[o] = bm;
      vz[o] = zm;
      vp[o] = zm;
      vds[o] = ds;
      vdd[o] = fmul(p.damping, dm);
      vdp[o] = __ldg(p.diag_ps + i);
      acc[0] += bm * bm;
      acc[1] += bm * zm;
    }
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
  const float thr = p.tol2 * bb;

  uint32_t epoch = 0;
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
        const int m = begin + l;
        int j[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) j[ax] = __ldg(p.nbr + 3 * m + ax);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float y = fmul(__ldg(p.J0r + 3 * m + c), vp[3 * l + c]);
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float pj = j[ax] >= 0 ? __ldcg(p.pub_p + 3 * j[ax] + c) : 0.0f;
            y = fadd(y, fmul(__ldg(p.Jir + 9 * m + 3 * ax + c), pj));
          }
          p.pub_y[3 * m + c] = y;
        }
      }
      barrier(p, ++epoch);
    }
    // ---- A p and the block's part of p.Ap
    float pa[1] = {0.0f};
    for (int l = tid; l < rows; l += kCgThreads) {
      const int m = begin + l;
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
          float u = fmul(__ldg(p.J0r + 3 * m + c), __ldcg(p.pub_y + 3 * m + c));
#pragma unroll
          for (int col = 0; col < 6; ++col) {
            const int nr = rv[col];
            const int at = nr >= 0 ? nr : m;                    // m: unused
            const float t = fmul(__ldg(p.Jir + 9 * static_cast<size_t>(at) + 3 * (col >> 1) + c),
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
    float pAp[1];
    barrier_sum<1>(p, ++epoch, pa, pAp, buf, bc);
    const float alpha = gamma / (p.fixed ? clamp30(pAp[0]) : pAp[0]);

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
    barrier_sum<2>(p, ++epoch, acc2, gr, buf, bc);
    beta = gr[0] / (p.fixed ? clamp30(gamma) : gamma);
    gamma = gr[0];
    rr = gr[1];
    steps = k + 1;
  }

  // ---- delta and the accept rule (solvers.update_albedo)
  for (int l = tid; l < rows; l += kCgThreads) {
    const int m = begin + l;
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
  if (blockIdx.x == 0 && tid == 0) *p.steps = steps;
}

const void* cg_kernel(bool reg) {
  return reg ? reinterpret_cast<const void*>(albedo_cg_kernel<true>)
             : reinterpret_cast<const void*>(albedo_cg_kernel<false>);
}

const void* system_kernel(bool led, bool reg) {
  if (led)
    return reg ? reinterpret_cast<const void*>(albedo_system_kernel<true, true>)
               : reinterpret_cast<const void*>(albedo_system_kernel<true, false>);
  return reg ? reinterpret_cast<const void*>(albedo_system_kernel<false, true>)
             : reinterpret_cast<const void*>(albedo_system_kernel<false, false>);
}

int device_sms(int* sms, int* coop) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(coop, cudaDevAttrCooperativeLaunch, dev);
  return static_cast<int>(e);
}

int finish(cudaError_t e) {
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int albedo_system(const SystemArgs* a, void* stream) {
  const bool led = a->led != 0, reg = a->reg != 0;
  if (a->n < 1 || a->f < 1 || a->n > (int64_t{1} << 31) / 9 ||
      (!led && (a->basis != 4 && a->basis != 9)) || (led && !a->p_cam) ||
      (reg && (!a->albedo || !a->nbr || !a->rev || !a->nbr_dir || !a->nbr_const ||
               !a->diag || !a->r_reg || !a->J0r || !a->Jir)))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, coop = 0, occ = 0;
  int e = device_sms(&sms, &coop);
  if (e) return e;
  if (reg && !coop) return static_cast<int>(cudaErrorNotSupported);
  const void* kernel = system_kernel(led, reg);
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kSysThreads, 0);
  if (ce != cudaSuccess) return finish(ce);
  SystemParams p;
  p.w = a->w;  p.r = a->r;  p.p_cam = a->p_cam;  p.grad = a->grad;
  p.lights = a->lights;  p.poses = a->poses;  p.valid = a->valid;
  p.albedo = a->albedo;  p.nbr = a->nbr;  p.rev = a->rev;
  p.nbr_dir = a->nbr_dir;  p.nbr_const = a->nbr_const;
  p.b = a->b;  p.diag_ps = a->diag_ps;  p.diag = a->diag;
  p.r_reg = a->r_reg;  p.J0r = a->J0r;  p.Jir = a->Jir;
  p.n = a->n;
  p.f = static_cast<int>(a->f);
  p.basis = static_cast<int>(a->basis);
  p.inv_h = static_cast<float>(a->inv_h);
  p.rho = static_cast<float>(a->reg_weight_rho);
  const int64_t rows_a_block = kSysThreads / kGroup;
  const int64_t want = (a->n + rows_a_block - 1) / rows_a_block;
  const int64_t cap = static_cast<int64_t>(sms) * (occ > 0 ? occ : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  void* args[] = {&p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (reg)      // a grid.sync between the rows and their transposes
    return finish(cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kSysThreads), args, 0,
                                              s));
  return finish(cudaLaunchKernel(kernel, dim3(blocks), dim3(kSysThreads), args, 0, s));
}

// Whether albedo_cg's kernel (with or without the regularizer) runs
// cooperatively on the current device at `smem_bytes` of dynamic shared
// memory: the blocks an SM holds -> per_sm.
extern "C" int albedo_cg_occupancy(int64_t reg, int64_t smem_bytes, int64_t* per_sm) {
  if (smem_bytes < kHeader) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, coop = 0, occ = 0;
  const void* kernel = cg_kernel(reg != 0);
  int e = device_sms(&sms, &coop);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem_bytes));
  if (ce == cudaSuccess)
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kCgThreads,
                                                       static_cast<size_t>(smem_bytes));
  if (ce != cudaSuccess) return finish(ce);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  *per_sm = occ;
  return 0;
}

extern "C" int albedo_cg(const CgArgs* a, void* stream) {
  const int64_t n = a->n;
  if (n < 1 || a->maxiter < 0 || n > (int64_t{1} << 31) / 9 || a->tile < 16 ||
      a->tile % 16 != 0 || a->blocks < 1 || (a->blocks - 1) * a->tile >= n ||
      a->blocks * a->tile < n || a->smem_bytes < kHeader ||
      (a->shared && a->smem_bytes < kHeader + 4 * kVectors * 3 * a->tile) ||
      (a->reg && (!a->J0r || !a->Jir || !a->nbr || !a->rev)))
    return static_cast<int>(cudaErrorInvalidValue);
  CgParams p;
  p.b = a->b;  p.diag_ps = a->diag_ps;  p.diag = a->diag;
  p.J0r = a->J0r;  p.Jir = a->Jir;  p.nbr = a->nbr;  p.rev = a->rev;
  p.valid = a->valid;  p.albedo = a->albedo;
  p.delta = a->delta;  p.albedo_out = a->albedo_out;  p.steps = a->steps;
  float* w = a->work;
  const int64_t published = a->reg ? 6 * n : 0;
  p.pub_p = w;
  p.pub_y = w + 3 * n;
  p.own = w + published;
  p.counter = a->sync;
  p.part = reinterpret_cast<float*>(a->sync + 4);
  p.n = static_cast<int>(n);
  p.tile = static_cast<int>(a->tile);
  p.blocks = static_cast<int>(a->blocks);
  p.maxiter = static_cast<int>(a->maxiter);
  p.fixed = static_cast<int>(a->fixed);
  p.shared = static_cast<int>(a->shared);
  p.rho = static_cast<float>(a->reg_weight_rho);
  p.damping = static_cast<float>(a->damping);
  p.one_plus_damping = static_cast<float>(1.0 + a->damping);
  p.tol2 = static_cast<float>(a->tol_sq);
  const void* kernel = cg_kernel(a->reg != 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(a->smem_bytes));
  void* args[] = {&p};
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(a->blocks)),
                                    dim3(kCgThreads), args, static_cast<size_t>(a->smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  return finish(e);
}
