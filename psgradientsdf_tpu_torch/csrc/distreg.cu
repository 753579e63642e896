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
// The one-card refinement runs neither kernel: their rows are
// stages of csrc/distcg.cu's dist_system (the Eikonal row and the
// Laplacian's residual) and dist_cg (the update).  They stay for the joint
// step and the mesh's shards.  The per-row arithmetic is stencil.cuh's
// (gather_row, eikonal_row, laplacian_row, accepted, fd_row), shared with
// those stages.
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
reg_operators_kernel(RegArgs a, RegConsts c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  auto value = [&](int64_t j) { return a.dist[j]; };
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; n < a.N;
       n += stride) {
    const bool valid = a.valid[n] != 0;
    const float d = a.dist[n];
    if (a.eikonal) {
      float e[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // J0, Ji, r
      if (valid) {
        float dn[3];
        gather_row(value, a.nbr_idx + 3 * n, a.nbr_dist_const + 3 * n, dn);
        eikonal_row(dn, a.nbr_dir + 3 * n, d, c, e);
      }
      a.r[n] = e[4];
      a.J0[n] = e[0];
#pragma unroll
      for (int i = 0; i < 3; ++i) a.Ji[3 * n + i] = e[1 + i];
    }
    if (a.laplacian) {
      float lap = 0.0f;
      if (valid) {
        float dl[6];
        gather_row(value, a.lap_idx + 6 * n, a.lap_dist_const + 6 * n, dl);
        lap = laplacian_row(dl, d, c.inv_h2);
      }
      a.lap_r[n] = lap;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dist_update_kernel(UpdateArgs a, float inv_h_div, float thr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the accept rule's distance of row m (dist itself without delta)
  auto acc = [&](int64_t m) {
    return a.delta == nullptr ? a.dist[m] : accepted(a.dist[m], a.delta[m], a.valid[m] != 0, thr);
  };
  for (int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; n < a.N;
       n += stride) {
    const float d = acc(n);
    if (a.delta != nullptr) a.new_dist[n] = d;
    float dn[3], g[3];
    gather_row(acc, a.nbr_idx + 3 * n, a.nbr_dist_const + 3 * n, dn);
    fd_row(dn, a.nbr_dir + 3 * n, d, inv_h_div, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) a.new_grad[3 * n + i] = g[i];
  }
}

}  // namespace

extern "C" {

int reg_operators(const RegArgs* a, void* stream) {
  if (a->N < 0 || a->blocks <= 0 || !(a->eikonal || a->laplacian))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->N == 0) return 0;
  reg_operators_kernel<<<static_cast<unsigned>(a->blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a, reg_consts(a->voxel));
  return static_cast<int>(cudaGetLastError());
}

int dist_update(const UpdateArgs* a, void* stream) {
  if (a->N < 0 || a->blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a->N == 0) return 0;
  dist_update_kernel<<<static_cast<unsigned>(a->blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *a, reg_consts(a->voxel).inv_h_div, static_cast<float>(a->accept));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
