// The SH light block's clipped eigen-solve for Hopper (sm_90a): one launch
// a light block.
//
// Replaces the tail of the JAX package's solve_light_sh
// (psgradientsdf_tpu/refine/solvers.py :512, jnp.linalg.eigh and the clipped
// products :531-535), which XLA runs inside the jitted iteration
// (refine/optimizer.py `_iteration_update`).  The port ran it as a batched
// torch.linalg.eigh in float32, which waits for the host on the card and so
// cannot be held by a CUDA graph; this kernel computes the same function in
// float64 and waits for nothing.
//
// For each keyframe f, from H [F, B, B] (its lower triangle, as eigh reads
// it) and g [F, B], both float32, B = 4 (SH1) or 9 (SH2):
//   * a symmetric eigen-decomposition H = V diag(lambda) V^T in double by
//     parallel-ordered Jacobi (ops/smallsolve.jacobi_rounds): B padded to
//     an even n (9 -> 10, the pairs of the padding index dropped), a sweep
//     n - 1 rounds of disjoint pairs by the circle method, every pair once
//     a sweep; an off-diagonal entry dropped once it no longer changes
//     either diagonal entry it couples in double (|a_pp| + |a_pq| ==
//     |a_pp| and the same for a_qq); sweeps until one would apply no
//     rotation, at most kMaxSweeps;
//   * the clip: an eigenvalue lambda <= 1e-6 max(lambda_max, 0) gets
//     1 / lambda = 0 (the reference's CG never enters the null space);
//   * delta = V inv V^T g in double, rounded once to float32.
// The plain version (ops/smallsolve.light_solve_plain) is the same function
// through torch.linalg.eigh on the float64 casts: the two agree to double
// rounding where no eigenvalue sits at the clip.
//
// Bound on the card: latency.  At F = 40, B = 4 it reads 3.2 KB and writes
// 0.6 KB, and its float64 work is some 2 kFLOP a keyframe; the launch and
// the rotations' dependent chain set its time, not bytes or operations.
// The design shortens the chain a keyframe walks: a round's rotations are
// disjoint and run at once, one lane a pair, so a sweep's chain is n - 1
// rounds (3 at B = 4, 9 at B = 9) instead of B (B - 1) / 2 rotations (6,
// 36); each rotation's (c, s, t) is a square root and a reciprocal square
// root, no division; the schedule is read from a plan the host made once
// (ops/smallsolve.jacobi_plan), so a round does no index arithmetic; a
// lane keeps its entries of A and V in registers, so a round reads shared
// memory only for the partners of its A entries; and the last sweep, which
// would rotate nothing, is one test of every entry instead of n - 1
// rounds.  An empty launch of the same grid (light_solve_floor) is its
// floor.
//
// Layout: one warp a keyframe, kWarps keyframes a block.  Lane l owns two
// entries (i, j0), (i, j0 + 1) of one row of A's upper triangle (at most
// 25 lanes at B = 9) and column vc of V at rows vr + L k, L = 32 / B (at
// most 3 rows); shared memory holds the packed upper triangle, which each
// lane rewrites its entries of after every round.  A round:
//   1. lane k < len(pairs) takes pair k: it reads a_pp, a_qq and a_pq,
//      applies the rule above and forms, with dd = a_qq - a_pp, e = 2 a_pq
//      (theta = dd / e), h = sqrt(dd^2 + e^2), w = |dd| + h and
//      rr = rsqrt(2 h w): c = w rr, s = sgn(theta) |e| rr and
//      t = s / c = 2 h rr s (t = sgn(theta) / (|theta| + sqrt(theta^2 +
//      1)) and c = rsqrt(t^2 + 1) without forming theta);
//   2. if any pair rotated, every lane takes the (c, s) of its indices'
//      pairs from the pair lanes by shuffle (J's column x is c e_x - s e_q
//      for a pair's p, s e_p + c e_x for its q) and computes its entries of
//      A' = J^T A J, alpha_i (alpha_j a_ij + beta_j a_i,pj) + beta_i
//      (alpha_j a_pi,j + beta_j a_pi,pj), the pair's own 2x2 block in the
//      closed form a_pp - t a_pq, a_qq + t a_pq and 0, and its entries of
//      V' = V J, their partner column by shuffle.  A pair that does not
//      rotate hands on c = 1, s = t = 0, so a round that rotates nothing
//      keeps every entry but its pairs' dropped ones, which become 0 (no
//      branch on the round's ballot, which only counts).
//
// Plain C interface (loaded with ctypes): light_solve() launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// the launch's CUDA error as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the C interface's argument block (ops/smallsolve._SolveArgs)
struct SolveArgs {
  const float* H;        // [F, B, B]
  const float* g;        // [F, B]
  float* delta;          // [F, B]
  int32_t* rotations;    // [F]: the rotations applied, or null
  int64_t F;
  int64_t B;
  int32_t* rounds;       // [F]: the rounds that applied a rotation, or null
  const uint4* plan;     // [n][32]: ops/smallsolve.jacobi_plan(B)
};

namespace {

constexpr int kMaxB = 9;
constexpr int kMaxTri = kMaxB * (kMaxB + 1) / 2;
constexpr int kMaxRows = kMaxB + 1;          // the plan's header and n - 1 rounds
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSweeps = 32;
constexpr int kVRows = 3;                    // ops/smallsolve.V_ROWS_PER_LANE
constexpr unsigned kNone = 0xff;             // ops/smallsolve.NONE
constexpr unsigned kFull = 0xffffffffu;

// an off-diagonal entry that no longer changes the diagonal entries it
// couples
__device__ __forceinline__ bool negligible(double apq, double app, double aqq) {
  const double e = fabs(apq);
  return fabs(app) + e == fabs(app) && fabs(aqq) + e == fabs(aqq);
}

__device__ __forceinline__ unsigned byte_of(unsigned w, int k) { return w >> 8 * k & 0xff; }

// index x's rotation from the pair lanes' (c, s): J's column x is
// alpha e_x + beta e_(partner), alpha = c, beta = -s for the pair's p and s
// for its q; `code` is x's 4 bits of the plan (the lane, the p-bit)
__device__ __forceinline__ double2 coef_of(unsigned code, double c, double s) {
  const double cx = __shfl_sync(kFull, c, code & 7);
  const double sx = __shfl_sync(kFull, s, code & 7);
  return make_double2(cx, (code & 8) ? -sx : sx);
}

__global__ void __launch_bounds__(kThreads) light_solve_kernel(SolveArgs a) {
  __shared__ uint4 sPlan[kMaxRows][32];
  __shared__ double sA[kWarps][kMaxTri];       // the packed upper triangle
  __shared__ double sV[kWarps][kMaxB * kMaxB];
  __shared__ double sgv[kWarps][kMaxB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = static_cast<int>(a.B);
  const int rows = B + (B & 1);                // n: the header and n - 1 rounds
  for (int e = threadIdx.x; e < rows * 32; e += kThreads)
    sPlan[e >> 5][e & 31] = a.plan[e];
  __syncthreads();
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (f >= a.F) return;            // the whole warp: no block barrier follows

  // what the lane owns: entries (ti, tj[0]), (ti, tj[1]) of A's packed
  // upper triangle (own[k] their offsets) and V's column vc at rows
  // vr + L k, all in registers through the sweeps
  const uint4 head = sPlan[0][lane];
  const unsigned own[2] = {byte_of(head.x, 0), byte_of(head.x, 1)};
  const int ti = byte_of(head.x, 2);
  const int tj[2] = {int(byte_of(head.x, 3)), int(byte_of(head.y, 0))};
  const int vr = byte_of(head.y, 1), vc = byte_of(head.y, 2), L = byte_of(head.y, 3);
  const float* H = a.H + f * B * B;
  double aij[2], v[kVRows];
#pragma unroll
  for (int k = 0; k < 2; ++k)      // the lower triangle, as eigh reads it
    aij[k] = own[k] != kNone ? static_cast<double>(H[tj[k] * B + ti]) : 0.0;
#pragma unroll
  for (int k = 0; k < kVRows; ++k) v[k] = vr != kNone && vr + L * k == vc ? 1.0 : 0.0;
  const double gl = lane < B ? static_cast<double>(a.g[f * B + lane]) : 0.0;
  double* A = sA[warp];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (own[k] != kNone) A[own[k]] = aij[k];
  __syncwarp();

  int rotations = 0, rounds = 0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    // a sweep rotates nothing exactly when every off-diagonal entry is
    // negligible at its start: then they become 0 and the solve ends
    bool live = false;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (own[k] != kNone && tj[k] != ti)
        live |= !negligible(aij[k], A[byte_of(head.z, 0)], A[byte_of(head.z, k + 1)]);
    if (!__any_sync(kFull, live)) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (tj[k] != ti) aij[k] = 0.0;
      break;
    }
    for (int r = 1; r < rows; ++r) {
      const uint4 plan = sPlan[r][lane];
      // the pair's entries (on a pair's lane), then the partners of the
      // lane's entries: these depend on the round's partners alone, so they
      // overlap the rotations' chain
      const unsigned kind = plan.w >> 24;
      const double app = A[byte_of(plan.w, 0)], aqq = A[byte_of(plan.w, 1)],
                   apq = A[byte_of(plan.w, 2)];
      double aipj[2], apij[2], apipj[2], vp[kVRows];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const unsigned t = k == 0 ? plan.x : plan.y;
        aipj[k] = A[byte_of(t, 0)];
        apij[k] = A[byte_of(t, 1)];
        apipj[k] = A[byte_of(t, 2)];
      }
#pragma unroll
      for (int k = 0; k < kVRows; ++k) vp[k] = __shfl_sync(kFull, v[k], plan.z >> 16 & 31);
      // 1. the round's pairs, one lane each: (c, s) and d = t a_pq
      bool rot = false;
      double c = 1.0, s = 0.0, d = 0.0;
      if (kind == 1 && !negligible(apq, app, aqq)) {
        rot = true;
        // with dd = a_qq - a_pp and e = 2 a_pq (theta = dd / e), brought up
        // by 2^500 when both are tiny (the rotation depends on dd / e
        // alone), h = sqrt(dd^2 + e^2), w = |dd| + h and rr = rsqrt(2 h w):
        // c = w rr, |s| = |e| rr, |t| = |e| / w = 2 h |e| rr^2 (no division)
        double dd = aqq - app, e = 2.0 * apq;
        if (fmax(fabs(dd), fabs(e)) < 0x1p-450) {
          dd *= 0x1p500;
          e *= 0x1p500;
        }
        const double h = sqrt(dd * dd + e * e);
        const double w = fabs(dd) + h;
        const double rr = rsqrt(2.0 * h * w);
        s = (dd < 0.0) != (e < 0.0) && dd != 0.0 ? -fabs(e) * rr : fabs(e) * rr;
        c = w * rr;
        d = (2.0 * h * rr) * s * apq;
      }
      const unsigned mask = __ballot_sync(kFull, rot);
      rotations += __popc(mask);
      rounds += mask != 0;
      // 2. the coefficients from the pair lanes (c = 1, s = d = 0 where
      // nothing rotated: the update then keeps every entry but the pair's),
      // then A' = J^T A J on the lane's entries (the pair's own 2x2 block in
      // closed form: a_pp - t a_pq, a_qq + t a_pq, 0) and V' = V J
      const double2 ci = coef_of(plan.z, c, s);
      const double2 cj0 = coef_of(plan.z >> 4, c, s);
      const double2 cj1 = coef_of(plan.z >> 8, c, s);
      const double2 cv = coef_of(plan.z >> 12, c, s);
      const double di = __shfl_sync(kFull, d, plan.z & 7);
      const double shift = (plan.z & 8) ? -di : di;
      double x[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const double2 cj = k == 0 ? cj0 : cj1;
        const double rowi = cj.x * aij[k] + cj.y * aipj[k];
        const double rowp = cj.x * apij[k] + cj.y * apipj[k];
        x[k] = ti == tj[k] ? aij[k] + shift
               : ((k == 0 ? plan.x : plan.y) >> 24) ? 0.0 : ci.x * rowi + ci.y * rowp;
      }
#pragma unroll
      for (int k = 0; k < kVRows; ++k) v[k] = cv.x * v[k] + cv.y * vp[k];
      aij[0] = x[0];
      aij[1] = x[1];
      __syncwarp();                // every read of A done
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (own[k] != kNone) A[own[k]] = x[k];
      __syncwarp();
    }
  }

  // V to shared memory; the clip: lambda <= 1e-6 max(lambda_max, 0)
  // contributes nothing
  double* V = sV[warp];
#pragma unroll
  for (int k = 0; k < kVRows; ++k)
    if (vr != kNone && vr + L * k < B) V[(vr + L * k) * B + vc] = v[k];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (own[k] != kNone) A[own[k]] = aij[k];
  __syncwarp();
  const double lam = A[lane < B ? lane * (2 * B - lane + 1) / 2 : 0];   // (lane, lane)
  double vmax = lam;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double other = __shfl_xor_sync(kFull, vmax, o);
    vmax = other > vmax ? other : vmax;
  }
  const double thr = fmax(vmax, 0.0) * 1e-6;
  // V^T g, then V inv V^T g, each sum in index order
  double gv = 0.0;
#pragma unroll
  for (int d = 0; d < kMaxB; ++d)
    if (d < B) gv = fma(V[d * B + (lane < B ? lane : 0)], __shfl_sync(kFull, gl, d), gv);
  if (lane < B) sgv[warp][lane] = (lam > thr ? 1.0 / lam : 0.0) * gv;
  __syncwarp();
  if (lane < B) {
    double x = 0.0;
#pragma unroll
    for (int d = 0; d < kMaxB; ++d)
      if (d < B) x = fma(V[lane * B + d], sgv[warp][d], x);
    a.delta[f * B + lane] = __double2float_rn(x);
  }
  if (lane == 0 && a.rotations != nullptr) a.rotations[f] = rotations;
  if (lane == 0 && a.rounds != nullptr) a.rounds[f] = rounds;
}

__global__ void __launch_bounds__(kThreads) light_solve_floor_kernel(SolveArgs) {}

unsigned blocks_of(int64_t F) { return static_cast<unsigned>((F + kWarps - 1) / kWarps); }

}  // namespace

extern "C" {

int light_solve(const SolveArgs* a, void* stream) {
  if (a->F < 0 || a->B < 1 || a->B > kMaxB || a->plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->F == 0) return 0;
  light_solve_kernel<<<blocks_of(a->F), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel on light_solve's grid: the launch's floor, timed beside it
int light_solve_floor(const SolveArgs* a, void* stream) {
  if (a->F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  light_solve_floor_kernel<<<blocks_of(a->F), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
