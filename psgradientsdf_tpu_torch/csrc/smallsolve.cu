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
//     cyclic Jacobi: rotations (p, q) in row order, a sweep at most
//     B (B - 1) / 2 of them (36 at B = 9), an off-diagonal entry dropped once
//     it no longer changes either diagonal entry it couples in double
//     (|a_pp| + |a_pq| == |a_pp| and the same for a_qq), sweeps until one
//     applies no rotation (at most kMaxSweeps);
//   * the clip: an eigenvalue lambda <= 1e-6 max(lambda_max, 0) gets
//     1 / lambda = 0 (the reference's CG never enters the null space);
//   * delta = V inv V^T g in double, rounded once to float32.
// The plain version (ops/smallsolve.light_solve_plain) is the same function
// through torch.linalg.eigh on the float64 casts: the two agree to double
// rounding where no eigenvalue sits at the clip.
//
// Layout: one warp a keyframe, kWarps keyframes a block; the warp's A, V
// and g in shared memory as doubles.  A rotation is two warp-synchronous
// steps: every lane reads the three coupled entries and forms (c, s, t)
// itself (the same bits in every lane, so every branch is uniform), lane k
// reads row k's two columns, then writes row and column k of the rotated A
// and row k of V.  The warp's lanes past B idle.
//
// Bound on the card: latency.  At F = 40, B = 4 it reads 3.2 KB and writes
// 0.6 KB, and its float64 work is some 2 kFLOP a keyframe; the launch and
// the rotations' dependent chain set its time, not bytes or operations.
// An empty launch of the same grid (light_solve_floor) is its floor.
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
};

namespace {

constexpr int kMaxB = 9;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSweeps = 32;

// an off-diagonal entry that no longer changes the diagonal entries it
// couples
__device__ __forceinline__ bool negligible(double apq, double app, double aqq) {
  const double e = fabs(apq);
  return fabs(app) + e == fabs(app) && fabs(aqq) + e == fabs(aqq);
}

__global__ void __launch_bounds__(kThreads) light_solve_kernel(SolveArgs a) {
  __shared__ double sA[kWarps][kMaxB * kMaxB];
  __shared__ double sV[kWarps][kMaxB * kMaxB];
  __shared__ double sg[kWarps][kMaxB];
  __shared__ double sgv[kWarps][kMaxB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (f >= a.F) return;            // the whole warp: no block barrier follows
  const int B = static_cast<int>(a.B);
  double* A = sA[warp];
  double* V = sV[warp];
  const float* H = a.H + f * B * B;
  for (int i = lane; i < B * B; i += 32) {
    const int r = i / B, c = i % B;
    A[i] = static_cast<double>(r >= c ? H[r * B + c] : H[c * B + r]);
    V[i] = r == c ? 1.0 : 0.0;
  }
  if (lane < B) sg[warp][lane] = static_cast<double>(a.g[f * B + lane]);
  __syncwarp();

  int rotations = 0;
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < B - 1; ++p) {
      for (int q = p + 1; q < B; ++q) {
        const double apq = A[p * B + q], app = A[p * B + p], aqq = A[q * B + q];
        __syncwarp();
        if (negligible(apq, app, aqq)) {
          if (apq != 0.0 && lane == 0) A[p * B + q] = A[q * B + p] = 0.0;
          __syncwarp();
          continue;
        }
        rotated = true;
        ++rotations;
        const double theta = (aqq - app) / (2.0 * apq);
        double t = fabs(theta) > 1e150 ? 0.5 / fabs(theta)
                                       : 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        const int k = lane;
        double akp = 0.0, akq = 0.0, vkp = 0.0, vkq = 0.0;
        if (k < B) {
          akp = A[k * B + p];
          akq = A[k * B + q];
          vkp = V[k * B + p];
          vkq = V[k * B + q];
        }
        __syncwarp();
        if (k < B) {
          if (k == p) {
            A[p * B + p] = app - t * apq;
            A[p * B + q] = A[q * B + p] = 0.0;
          } else if (k == q) {
            A[q * B + q] = aqq + t * apq;
          } else {
            const double nkp = c * akp - s * akq, nkq = s * akp + c * akq;
            A[k * B + p] = A[p * B + k] = nkp;
            A[k * B + q] = A[q * B + k] = nkq;
          }
          V[k * B + p] = c * vkp - s * vkq;
          V[k * B + q] = s * vkp + c * vkq;
        }
        __syncwarp();
      }
    }
    if (!rotated) break;
  }

  // the clip: lambda <= 1e-6 max(lambda_max, 0) contributes nothing
  double vmax = A[0];
  for (int k = 1; k < B; ++k) vmax = A[k * B + k] > vmax ? A[k * B + k] : vmax;
  const double thr = fmax(vmax, 0.0) * 1e-6;
  // V^T g, then V inv V^T g, each sum in index order
  if (lane < B) {
    double gv = 0.0;
    for (int d = 0; d < B; ++d) gv = fma(V[d * B + lane], sg[warp][d], gv);
    const double lam = A[lane * B + lane];
    sgv[warp][lane] = (lam > thr ? 1.0 / lam : 0.0) * gv;
  }
  __syncwarp();
  if (lane < B) {
    double x = 0.0;
    for (int d = 0; d < B; ++d) x = fma(V[lane * B + d], sgv[warp][d], x);
    a.delta[f * B + lane] = __double2float_rn(x);
  }
  if (lane == 0 && a.rotations != nullptr) a.rotations[f] = rotations;
}

__global__ void __launch_bounds__(kThreads) light_solve_floor_kernel(SolveArgs) {}

unsigned blocks_of(int64_t F) { return static_cast<unsigned>((F + kWarps - 1) / kWarps); }

}  // namespace

extern "C" {

int light_solve(const SolveArgs* a, void* stream) {
  if (a->F < 0 || a->B < 1 || a->B > kMaxB) return static_cast<int>(cudaErrorInvalidValue);
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
