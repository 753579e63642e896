// The SH light block's clipped eigen-solve in its cyclic-order design: the
// kernel that psgradientsdf_tpu_torch/csrc/smallsolve.cu's round-robin
// design replaced, kept as the yardstick that design is timed against in
// turns (chip_smoke.py phase light_solve_kernels, tools/light_solve_ab.py).
// It is on no path of the package and nothing counts its launches.
//
// The same function and C interface (its SolveArgs is a prefix of the
// package's): per keyframe, cyclic Jacobi in double, rotations (p, q) in
// row order one at a time, a sweep B (B - 1) / 2 of them; every lane of the
// keyframe's warp forms each rotation's (c, s, t) itself (three divisions
// and two square roots, a dependent chain), lane k then rotates row and
// column k of A and row k of V; the same rule for a dropped entry, the
// same clip and products.  Built by nvcc with the package's flags
// (chip_smoke._parent_build).

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
