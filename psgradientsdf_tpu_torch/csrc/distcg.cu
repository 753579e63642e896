// The distance block's solve for Hopper (sm_90a): its normal equations
// assembled per row (dist_system), and the whole Jacobi-preconditioned CG in
// ONE cooperative launch (dist_cg).
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
// dist_system_kernel: a warp a row (grid-stride).  Lane l adds the pairs
// j = l, l + 32, ... of the row's F*3 in order (kUnroll pairs' loads in
// flight), each product and sum rounded once (_rn intrinsics); the 32 lane
// sums are added by an xor butterfly (every lane ends with the same bits),
// then the Eikonal row; lane q writes output q (A's 10, then t's 4).  The
// plain version (ops/distcg.dist_system_plain) emulates that order: the
// kernel equals it bit for bit.  Bound by bytes: w, r, J0 and Ji read once
// (24 bytes a pair: 141.6 MB at N = 49152, F = 40, 0.042 ms at 3.35 TB/s)
// and 56 bytes a row written.
//
// dist_cg_kernel: the grid is the SM count x the occupancy the runtime
// reports, at most a row a thread, launched cooperatively so that every
// block is resident and may wait at a grid barrier.  Each block owns a
// contiguous tile of rows for the whole launch.  The prologue forms b and
// diag in gather form (plus the Laplacian's L^T r_l and diagonal), the
// masks and the safe Jacobi diagonal, x = 0, r = b, z = p = r / d; then
// each CG step is
//   phase 1, per row n: p (from z and the last p: p = z + beta p_old, at
//            the row and its stencil neighbours, so no barrier is spent on
//            it), s_n = A_n P_n p and the Laplacian row lap(p)_n; barrier;
//   phase 2, per row m: (H p)[m] gathered, + w_l L^T lap(p), + damping diag
//            p, where(valid, ., p); the block's part of p.Ap; barrier;
//   every block sums the partials (one fixed order, so every block holds
//            the same alpha and takes the same branch), then per row x, r,
//            z = r / d and the block's parts of r.z and r.r; barrier;
//   beta, and the stop test r.r > thr before the next step (scipy's rule
//            thr = max(tol^2 b.b, atol^2), or cg_static's tol^2 b.b with its
//            clamped divisions), decided on the device.
// Three grid barriers a step, one in the prologue.  delta (masked by valid)
// and the step count go to device memory; nothing is read back.  The dots
// are summed in another order than the plain version's torch.sum, so the
// two agree to float32 rounding.  Vectors written inside the launch are read
// across blocks with ld.global.cg (L2), never through the non-coherent path.
// Bound by bytes: A, t, the tables and the mask read once, delta written
// once (97 bytes a row without the Laplacian, 1.4 us at N = 49152); a step
// moves about 10 MB through L2, and the time is set by its grid barriers
// (chip_smoke.py times an empty cooperative kernel crossing as many).
//
// Plain C interface (loaded with ctypes): dist_system() and dist_cg() launch
// on the stream they are given; dist_cg_plan() picks the grid.  Each returns
// 0 or the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

struct SystemArgs {            // ops/distcg.py _SystemArgs, field for field
  const float* w;
  const float* r;
  const float* J0;
  const float* Ji;
  const float* eik_r;
  const float* eik_J0;
  const float* eik_Ji;
  float* A;
  float* t;
  int64_t n, pairs, eik;
  double reg_weight_n;
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
  float* work;
  float* partials;
  int64_t n, blocks, maxiter, fixed, use_lap, lap_nbr;
  double reg_weight_l, diag_coef, nbr_coef, diag_coef_sq, nbr_coef_sq,
      damping, tol_sq, atol_sq;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSysThreads = 256;
constexpr int kUnroll = 4;        // pairs a lane has in flight
constexpr int kCgThreads = 256;
constexpr int kCgWarps = kCgThreads / 32;

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
  int64_t n;
  int pairs, eik;
  float lam;
};

__global__ void __launch_bounds__(kSysThreads)
dist_system_kernel(const __grid_constant__ SystemParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kSysThreads / 32);
  const int J = p.pairs;
  for (int64_t n = (static_cast<int64_t>(blockIdx.x) * kSysThreads + threadIdx.x) >> 5;
       n < p.n; n += warps) {
    const float* w = p.w + n * J;
    const float* r = p.r + n * J;
    const float* j0 = p.J0 + n * J;
    const float* ji = p.Ji + n * 3 * J;
    float acc[14];
#pragma unroll
    for (int q = 0; q < 14; ++q) acc[q] = 0.0f;
    for (int base = 0; base < J; base += 32 * kUnroll) {
      float wv[kUnroll], rv[kUnroll], a[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * 32 + lane;
        if (j < J) {
          wv[u] = __ldg(w + j);
          rv[u] = __ldg(r + j);
          a[u][0] = __ldg(j0 + j);
          a[u][1] = __ldg(ji + j);
          a[u][2] = __ldg(ji + J + j);
          a[u][3] = __ldg(ji + 2 * J + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * 32 + lane;
        if (j >= J) continue;
        float wa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) wa[i] = __fmul_rn(wv[u], a[u][i]);
#pragma unroll
        for (int q = 0; q < 10; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wa[pair_i(q)], a[u][pair_k(q)]));
        const float wr = __fmul_rn(wv[u], rv[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[10 + i] = __fadd_rn(acc[10 + i], __fmul_rn(wr, a[u][i]));
      }
    }
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1)
#pragma unroll
      for (int q = 0; q < 14; ++q) acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(kFull, acc[q], s));
    if (p.eik) {
      const float e[4] = {__ldg(p.eik_J0 + n), __ldg(p.eik_Ji + 3 * n),
                          __ldg(p.eik_Ji + 3 * n + 1), __ldg(p.eik_Ji + 3 * n + 2)};
      float we[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) we[i] = __fmul_rn(p.lam, e[i]);
#pragma unroll
      for (int q = 0; q < 10; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(we[pair_i(q)], e[pair_k(q)]));
      const float wr = __fmul_rn(p.lam, __ldg(p.eik_r + n));
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[10 + i] = __fadd_rn(acc[10 + i], __fmul_rn(wr, e[i]));
    }
    float mine = 0.0f;
#pragma unroll
    for (int q = 0; q < 14; ++q)
      if (lane == q) mine = acc[q];
    if (lane < 10) p.A[n * 10 + lane] = mine;
    else if (lane < 14) p.t[n * 4 + lane - 10] = mine;
  }
}

// ---------------------------------------------------------------- dist_cg

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
  // vectors written inside the launch (read across blocks with ld.global.cg)
  float *x, *r, *z, *p0, *p1, *s, *lapx, *ap, *diag, *dsafe;
  float* part_a;                        // [blocks]: p.Ap
  float* part_b;                        // [blocks][2]: (r.z, r.r), the prologue's (b.b, r.z)
  int n, tile, maxiter, fixed, use_lap, lap_nbr;
  float w_l, dc, nc, dc2, nc2, damping, one_plus_damping, tol2, atol2;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// The block's sums of K values in one fixed order (each thread's, then the
// warp's butterfly, then the warps in order) -> thread 0's v.
template <int K>
__device__ void block_sums(float (&v)[K], float (*red)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = warp_sum(v[q]);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) red[warp][q] = v[q];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float s = red[0][q];
      for (int k = 1; k < kCgWarps; ++k) s += red[k][q];
      v[q] = s;
    }
  __syncthreads();
}

// All blocks' partials [blocks][K] summed in one fixed order (the same in
// every block) -> out, in every thread.
template <int K>
__device__ void grid_sums(const float* part, int blocks, float (&out)[K], float* bcast) {
  if (threadIdx.x < 32) {
    float s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = 0.0f;
    for (int b = threadIdx.x; b < blocks; b += 32)
#pragma unroll
      for (int q = 0; q < K; ++q) s[q] += __ldcg(part + b * K + q);
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = warp_sum(s[q]);
    if (threadIdx.x == 0)
#pragma unroll
      for (int q = 0; q < K; ++q) bcast[q] = s[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = bcast[q];
  __syncthreads();
}

// torch.clamp(v, min=1e-30): NaN passes through
__device__ __forceinline__ float clamp30(float v) { return v < 1e-30f ? 1e-30f : v; }

__global__ void __launch_bounds__(kCgThreads)
dist_cg_kernel(const __grid_constant__ CgParams p) {
  __shared__ float red[kCgWarps][2];
  __shared__ float red1[kCgWarps][1];
  __shared__ float bcast[2];
  cg::grid_group grid = cg::this_grid();
  const int begin = blockIdx.x * p.tile;
  const int end = min(p.n, begin + p.tile);

  // ---- the prologue: b, diag, the safe diagonal, x = 0, r = b, z = p = r / d
  float acc[2] = {0.0f, 0.0f};
  for (int m = begin + threadIdx.x; m < end; m += kCgThreads) {
    float bm = __ldg(p.t + 4 * m);
    float dm = __ldg(p.A + 10 * m);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const int n = __ldg(p.rev + 6 * m + c);
      if (n >= 0) {
        const int ax = 1 + (c >> 1);
        bm += __ldg(p.t + 4 * n + ax);
        dm += __ldg(p.A + 10 * n + sym(ax, ax));
      }
    }
    const bool v = p.valid[m] != 0;
    if (p.use_lap) {
      float lt = p.dc * (v ? __ldg(p.lap_r + m) : 0.0f);
      float ld = v ? p.dc2 : 0.0f;
      if (p.lap_nbr) {
        float nb = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const int n = __ldg(p.lap + 6 * m + k);
          const bool vn = n >= 0 && p.valid[n] != 0;
          const float rn = vn ? __ldg(p.lap_r + n) : 0.0f;
          nb = k == 0 ? rn : nb + rn;
          ld += vn ? p.nc2 : 0.0f;
        }
        lt = lt + p.nc * nb;
      }
      bm += p.w_l * (v ? lt : 0.0f);
      dm += p.w_l * ld;
    }
    const float dt = p.one_plus_damping * dm;
    const float ds = (v && dt > 0.0f) ? dt : 1.0f;
    bm = v ? bm : 0.0f;
    const float zm = bm / ds;
    p.x[m] = 0.0f;
    p.r[m] = bm;
    p.z[m] = zm;
    p.p0[m] = zm;
    p.diag[m] = dm;
    p.dsafe[m] = ds;
    acc[0] += bm * bm;
    acc[1] += bm * zm;
  }
  block_sums<2>(acc, red);
  if (threadIdx.x == 0) {
    p.part_b[2 * blockIdx.x] = acc[0];
    p.part_b[2 * blockIdx.x + 1] = acc[1];
  }
  grid.sync();
  float g[2];
  grid_sums<2>(p.part_b, gridDim.x, g, bcast);
  const float bb = g[0];
  float gamma = g[1], rr = bb, beta = 0.0f;
  const float thr = p.fixed ? p.tol2 * bb : fmaxf(p.tol2 * bb, p.atol2);

  int steps = 0;
  for (int k = 0; k < p.maxiter; ++k) {
    if (!(rr > thr)) break;                       // the same in every block
    float* pk = (k & 1) ? p.p1 : p.p0;            // this step's p
    const float* pold = (k & 1) ? p.p0 : p.p1;    // the last step's
    // p at any row: written in the prologue (k = 0), else z + beta p_old
    auto pval = [&](int j) -> float {
      return k == 0 ? __ldcg(pk + j) : __ldcg(p.z + j) + beta * __ldcg(pold + j);
    };

    // ---- phase 1: s_n = A_n P_n p and the Laplacian row
    for (int n = begin + threadIdx.x; n < end; n += kCgThreads) {
      float v[4];
      v[0] = pval(n);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int j = __ldg(p.nbr + 3 * n + a);
        v[1 + a] = j >= 0 ? pval(j) : 0.0f;
      }
      float Arow[10];
#pragma unroll
      for (int q = 0; q < 10; ++q) Arow[q] = __ldg(p.A + 10 * n + q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float si = Arow[sym(i, 0)] * v[0];
#pragma unroll
        for (int kk = 1; kk < 4; ++kk) si += Arow[sym(i, kk)] * v[kk];
        p.s[4 * n + i] = si;
      }
      if (p.use_lap) {
        float lx = p.dc * v[0];
        if (p.lap_nbr) {
          float nb = 0.0f;
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) {
            const int j = __ldg(p.lap + 6 * n + kk);
            const float pj = j >= 0 ? pval(j) : 0.0f;
            nb = kk == 0 ? pj : nb + pj;
          }
          lx = lx + p.nc * nb;
        }
        p.lapx[n] = p.valid[n] != 0 ? lx : 0.0f;
      }
      if (k > 0) pk[n] = v[0];
    }
    grid.sync();

    // ---- phase 2: (H p)[m] in gather form, the block's part of p.Ap
    float pa[1] = {0.0f};
    for (int m = begin + threadIdx.x; m < end; m += kCgThreads) {
      const float pm = pk[m];
      float hx = p.s[4 * m];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int n = __ldg(p.rev + 6 * m + c);
        if (n >= 0) hx += __ldcg(p.s + 4 * n + 1 + (c >> 1));
      }
      if (p.use_lap) {
        float lt = p.dc * p.lapx[m];
        if (p.lap_nbr) {
          float nb = 0.0f;
#pragma unroll
          for (int kk = 0; kk < 6; ++kk) {
            const int j = __ldg(p.lap + 6 * m + kk);
            const float lj = j >= 0 ? __ldcg(p.lapx + j) : 0.0f;
            nb = kk == 0 ? lj : nb + lj;
          }
          lt = lt + p.nc * nb;
        }
        hx += p.w_l * (p.valid[m] != 0 ? lt : 0.0f);
      }
      hx += p.damping * p.diag[m] * pm;
      const float am = p.valid[m] != 0 ? hx : pm;
      p.ap[m] = am;
      pa[0] += pm * am;
    }
    block_sums<1>(pa, red1);
    if (threadIdx.x == 0) p.part_a[blockIdx.x] = pa[0];
    grid.sync();
    float pAp[1];
    grid_sums<1>(p.part_a, gridDim.x, pAp, bcast);
    const float alpha = gamma / (p.fixed ? clamp30(pAp[0]) : pAp[0]);

    // ---- the update: x, r, z and the block's parts of r.z and r.r
    float acc2[2] = {0.0f, 0.0f};
    for (int m = begin + threadIdx.x; m < end; m += kCgThreads) {
      const float xm = p.x[m] + alpha * pk[m];
      const float rm = p.r[m] - alpha * p.ap[m];
      const float zm = rm / p.dsafe[m];
      p.x[m] = xm;
      p.r[m] = rm;
      p.z[m] = zm;
      acc2[0] += rm * zm;
      acc2[1] += rm * rm;
    }
    block_sums<2>(acc2, red);
    if (threadIdx.x == 0) {
      p.part_b[2 * blockIdx.x] = acc2[0];
      p.part_b[2 * blockIdx.x + 1] = acc2[1];
    }
    grid.sync();
    float gr[2];
    grid_sums<2>(p.part_b, gridDim.x, gr, bcast);
    beta = gr[0] / (p.fixed ? clamp30(gamma) : gamma);
    gamma = gr[0];
    rr = gr[1];
    steps = k + 1;
  }

  for (int m = begin + threadIdx.x; m < end; m += kCgThreads)
    p.delta[m] = p.valid[m] != 0 ? p.x[m] : 0.0f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.steps = steps;
}

// An empty cooperative kernel on dist_cg's grid that crosses `barriers`
// grid barriers: the latency floor of a solve.
__global__ void __launch_bounds__(kCgThreads) dist_barrier_kernel(int barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < barriers; ++k) grid.sync();
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

}  // namespace

extern "C" int dist_system(const SystemArgs* a, void* stream) {
  if (a->n < 1 || a->pairs < 1 || (a->eik && (!a->eik_r || !a->eik_J0 || !a->eik_Ji)))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, occ = 0;
  int e = device_sms(&sms);
  if (e) return e;
  cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, dist_system_kernel, kSysThreads, 0);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  SystemParams p;
  p.w = a->w;  p.r = a->r;  p.J0 = a->J0;  p.Ji = a->Ji;
  p.eik_r = a->eik_r;  p.eik_J0 = a->eik_J0;  p.eik_Ji = a->eik_Ji;
  p.A = a->A;  p.t = a->t;
  p.n = a->n;
  p.pairs = static_cast<int>(a->pairs);
  p.eik = static_cast<int>(a->eik);
  p.lam = static_cast<float>(a->reg_weight_n);
  const int64_t rows_a_block = kSysThreads / 32;
  const int64_t want = (a->n + rows_a_block - 1) / rows_a_block;
  const int64_t cap = static_cast<int64_t>(sms) * (occ > 0 ? occ : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  dist_system_kernel<<<blocks, kSysThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dist_cg's grid for n rows on the current device: the SM count x the
// occupancy the runtime reports, at most one block a kCgThreads rows.
extern "C" int dist_cg_plan(int64_t n, int64_t* blocks) {
  int sms = 0, coop = 0, dev = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, dist_cg_kernel, kCgThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (occ < 1 || n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t cap = static_cast<int64_t>(sms) * occ;
  const int64_t want = (n + kCgThreads - 1) / kCgThreads;
  *blocks = want < cap ? want : cap;
  return 0;
}

extern "C" int dist_cg(const CgArgs* a, void* stream) {
  const int64_t n = a->n, blocks = a->blocks;
  if (n < 1 || blocks < 1 || a->maxiter < 0 || n > (int64_t{1} << 30) / 16 ||
      (a->use_lap && a->lap_r == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CgParams p;
  p.A = a->A;  p.t = a->t;  p.nbr = a->nbr;  p.rev = a->rev;  p.lap = a->lap;
  p.valid = a->valid;  p.lap_r = a->lap_r;
  p.delta = a->delta;  p.steps = a->steps;
  float* w = a->work;
  p.x = w;          p.r = w + n;      p.z = w + 2 * n;   p.p0 = w + 3 * n;
  p.p1 = w + 4 * n; p.s = w + 5 * n;  p.lapx = w + 9 * n; p.ap = w + 10 * n;
  p.diag = w + 11 * n;  p.dsafe = w + 12 * n;
  p.part_a = a->partials;
  p.part_b = a->partials + blocks;
  p.n = static_cast<int>(n);
  p.tile = static_cast<int>((n + blocks - 1) / blocks);
  p.maxiter = static_cast<int>(a->maxiter);
  p.fixed = static_cast<int>(a->fixed);
  p.use_lap = static_cast<int>(a->use_lap);
  p.lap_nbr = static_cast<int>(a->lap_nbr);
  p.w_l = static_cast<float>(a->reg_weight_l);
  p.dc = static_cast<float>(a->diag_coef);
  p.nc = static_cast<float>(a->nbr_coef);
  p.dc2 = static_cast<float>(a->diag_coef_sq);
  p.nc2 = static_cast<float>(a->nbr_coef_sq);
  p.damping = static_cast<float>(a->damping);
  p.one_plus_damping = static_cast<float>(1.0 + a->damping);
  p.tol2 = static_cast<float>(a->tol_sq);
  p.atol2 = static_cast<float>(a->atol_sq);
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dist_cg_kernel), dim3(static_cast<int>(blocks)),
      dim3(kCgThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dist_barriers(int64_t blocks, int64_t barriers, void* stream) {
  int b = static_cast<int>(barriers);
  void* args[] = {&b};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dist_barrier_kernel), dim3(static_cast<int>(blocks)),
      dim3(kCgThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
