// The distance block's eager tail for Hopper (sm_90a): its regularizer
// operators and its update, one launch each.
//
// Replaces two pieces of the JAX package's jit-fused distance block
// (psgradientsdf_tpu/refine/optimizer.py `_dist_block` :186 -> `_dist_core`
// :104, and `_joint_dp_core`):
//   * reg_operators_kernel: refine/solvers.py `eikonal_operator` (:135) and
//     `laplacian_operator` (:157), both in one launch;
//   * dist_update_kernel: refine/solvers.py `update_distance` (:307), the
//     accept rule and the new stored gradient (geometry.fd_grad) in one
//     launch.
// The port's plain versions (refine/solvers.py `eikonal_operator`,
// `laplacian_operator`, `accept_distance` + geometry.fd_grad, through
// ops/distreg.py) are chains of some 24, 8 and 12 eager ops.
//
// Both kernels take a row a thread, with a grid stride.
//   * reg_operators_kernel gathers the row's three one-sided neighbours
//     (nbr_idx; -1 reads the frozen nbr_dist_const) and writes the Eikonal
//     operator's r = |g| - 1, J0 = (g . n_d0) s and Ji = (g dir / h) s, s the
//     reciprocal of |g| where it is positive; with the Laplacian on it
//     gathers the six lap_idx neighbours (lap_dist_const) and writes the
//     Laplacian's r = (sum - 6 d) / h^2, the sum taken left to right.  An
//     invalid row writes 0.
//   * dist_update_kernel applies the accept rule (|delta| < sqrt(3) h and
//     valid) to its own row and recomputes each of its three neighbours'
//     acceptance in place from dist and delta, which are inputs and never
//     written, then forms the one-sided gradient of the new distances:
//     no second pass and no grid barrier.  Without delta it forms the
//     gradient of dist alone.
//
// Bits.  Every product, sum and quotient is an explicit _rn intrinsic
// (stencil.cuh) in the plain chain's order; a division by the voxel size is
// a product with the float reciprocal, as PyTorch divides a CUDA tensor by
// a number, and a product with a number uses that number rounded to float.
// The host passes the acceptance threshold as the float PyTorch compares
// with (sqrt(3) h rounded once).  So each output equals the plain chain's
// on the card bit for bit.
//
// Bound on the card: bytes.  At N = 49152 rows the operators read about
// 77 bytes a row (125 with the Laplacian) and write 20 (24); the update
// reads 57 and writes 16; some 7 MB and 3.6 MB, 2.1 and 1.1 us at
// 3.35 TB/s, under a launch's own latency.  The design's aim is one launch
// in place of an eager chain's dozens.
//
// Plain C interface (loaded with ctypes): reg_operators() and dist_update()
// launch on the stream they are given, do not synchronise, allocate
// nothing and return the launch's CUDA error as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil.cuh"

// The C interface's argument blocks: every field 8 bytes wide, in this
// order (ops/distreg.py builds the same blocks with ctypes).
struct RegArgs {
  const uint8_t* valid;          // [N] bool
  const float* dist;             // [N]
  const float* nbr_dir;          // [N, 3]
  const int64_t* nbr_idx;        // [N, 3]
  const float* nbr_dist_const;   // [N, 3]
  const int64_t* lap_idx;        // [N, 6]
  const float* lap_dist_const;   // [N, 6]
  float* r;                      // [N] the Eikonal residual
  float* J0;                     // [N]
  float* Ji;                     // [N, 3]
  float* lap_r;                  // [N] the Laplacian residual
  int64_t N, eikonal, laplacian, blocks;
  double voxel;                  // h
};

struct UpdateArgs {
  const uint8_t* valid;          // [N] bool
  const float* dist;             // [N]
  const float* delta;            // [N], or null: the gradient of dist alone
  const float* nbr_dir;          // [N, 3]
  const int64_t* nbr_idx;        // [N, 3]
  const float* nbr_dist_const;   // [N, 3]
  float* new_dist;               // [N] (unused without delta)
  float* new_grad;               // [N, 3]
  int64_t N, blocks;
  double voxel;                  // h
  double accept;                 // the threshold sqrt(3) h, a float's value
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
reg_operators_kernel(RegArgs a, float inv_h_div, float inv_h, float neg_inv_h,
                     float inv_h2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; n < a.N;
       n += stride) {
    const bool valid = a.valid[n] != 0;
    const float d = a.dist[n];
    if (a.eikonal) {
      float r = 0.0f, J0 = 0.0f, Ji[3] = {0.0f, 0.0f, 0.0f};
      if (valid) {
        float g[3];
        fd_grad(a.dist, a.nbr_idx, a.nbr_dist_const, a.nbr_dir, n, d, inv_h_div, g);
        const float gnorm = norm3(g);
        r = fsub(gnorm, 1.0f);
        const float* dir = a.nbr_dir + 3 * n;
        const float nd0[3] = {fmul(dir[0], neg_inv_h), fmul(dir[1], neg_inv_h),
                              fmul(dir[2], neg_inv_h)};
        const float scale = gnorm > 0.0f ? frcp(clamp_min(gnorm, 1e-12f)) : 1.0f;
        J0 = fmul(dot3(g, nd0), scale);
#pragma unroll
        for (int i = 0; i < 3; ++i) Ji[i] = fmul(fmul(fmul(g[i], dir[i]), inv_h), scale);
      }
      a.r[n] = r;
      a.J0[n] = J0;
#pragma unroll
      for (int i = 0; i < 3; ++i) a.Ji[3 * n + i] = Ji[i];
    }
    if (a.laplacian) {
      float lap = 0.0f;
      if (valid) {
        float s = nbr_value(a.dist, a.lap_idx[6 * n], a.lap_dist_const[6 * n]);
#pragma unroll
        for (int i = 1; i < 6; ++i)
          s = fadd(s, nbr_value(a.dist, a.lap_idx[6 * n + i], a.lap_dist_const[6 * n + i]));
        lap = fmul(fsub(s, fmul(6.0f, d)), inv_h2);
      }
      a.lap_r[n] = lap;
    }
  }
}

// the accept rule's distance of row m: d - delta where |delta| < thr and
// the row is valid, else d
__device__ __forceinline__ float accepted(const UpdateArgs& a, int64_t m, float thr) {
  const float d = a.dist[m];
  if (a.delta == nullptr) return d;
  const float dl = a.delta[m];
  return (fabsf(dl) < thr) & (a.valid[m] != 0) ? fsub(d, dl) : d;
}

__global__ void __launch_bounds__(kThreads)
dist_update_kernel(UpdateArgs a, float inv_h_div, float thr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; n < a.N;
       n += stride) {
    const float d = accepted(a, n, thr);
    if (a.delta != nullptr) a.new_dist[n] = d;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int64_t j = a.nbr_idx[3 * n + i];
      const float dn = j >= 0 ? accepted(a, j, thr) : a.nbr_dist_const[3 * n + i];
      a.new_grad[3 * n + i] = fmul(fmul(a.nbr_dir[3 * n + i], fsub(dn, d)), inv_h_div);
    }
  }
}

}  // namespace

extern "C" {

int reg_operators(const RegArgs* a, void* stream) {
  if (a->N < 0 || a->blocks <= 0 || !(a->eikonal || a->laplacian))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->N == 0) return 0;
  // 1 / (float)h, as a CUDA tensor is divided by h; the Python numbers
  // -1 / h and 1 / h rounded to float, as a tensor is multiplied by them;
  // 1 / (float)(h h), as fd_laplacian divides by h^2
  const float inv_h_div = 1.0f / static_cast<float>(a->voxel);
  const float inv_h = static_cast<float>(1.0 / a->voxel);
  const float neg_inv_h = static_cast<float>(-(1.0 / a->voxel));
  const float inv_h2 = 1.0f / static_cast<float>(a->voxel * a->voxel);
  reg_operators_kernel<<<static_cast<unsigned>(a->blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a, inv_h_div, inv_h,
                                                              neg_inv_h, inv_h2);
  return static_cast<int>(cudaGetLastError());
}

int dist_update(const UpdateArgs* a, void* stream) {
  if (a->N < 0 || a->blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->N == 0) return 0;
  const float inv_h_div = 1.0f / static_cast<float>(a->voxel);
  dist_update_kernel<<<static_cast<unsigned>(a->blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *a, inv_h_div, static_cast<float>(a->accept));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
