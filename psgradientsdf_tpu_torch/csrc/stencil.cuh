// The float arithmetic of refine/geometry.py, shared by the refinement's
// kernels that must equal its plain PyTorch chains on the card bit for bit
// (csrc/residual.cu, csrc/albedo.cu, csrc/distreg.cu, csrc/distcg.cu,
// csrc/normaleq.cu), and the distance block's per-row regularizer and
// update arithmetic, which csrc/distreg.cu's standalone kernels and the
// stages of csrc/distcg.cu's dist_system and dist_cg share.
//
// kernels.py's NVCC_FLAGS has no -fmad=false, so nvcc would contract
// a * b + c into a fused multiply-add: every multiply, add and divide here
// is an explicit round-to-nearest intrinsic, in the plain chain's order.
//
// Included by the .cu sources above; kernels.py hashes every csrc/*.cuh
// header into each CUDA library's name, so an edited header rebuilds them.

#pragma once

#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// 1.0 / t on a tensor: the tensor's reciprocal (times 1.0)
__device__ __forceinline__ float frcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.clamp(min=) on a CUDA tensor: a NaN input is returned as it is
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

// geometry.normalize: v / max(|v|, 1e-12)
__device__ __forceinline__ void normalize(const float* v, float* out) {
  const float c = clamp_min(norm3(v), 1e-12f);
  out[0] = fdiv(v[0], c);
  out[1] = fdiv(v[1], c);
  out[2] = fdiv(v[2], c);
}

// geometry.gather_nbr of one row's K neighbours: value(j) for the neighbour
// j = idx[i], a frozen neighbour's constant frozen[i] where j < 0
template <int K, class Value, typename Idx>
__device__ __forceinline__ void gather_row(Value value, const Idx* idx, const float* frozen,
                                           float (&out)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int64_t j = idx[i];
    out[i] = j >= 0 ? value(j) : frozen[i];
  }
}

// geometry.fd_grad of one row from its three neighbours' values dn:
// (dir_i * (dn_i - d)) / h.  inv_h is 1 / (float)h: PyTorch divides a CUDA
// tensor by a number as a product with its float reciprocal
__device__ __forceinline__ void fd_row(const float (&dn)[3], const float* dir, float d,
                                       float inv_h, float* g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = fmul(fmul(dir[i], fsub(dn[i], d)), inv_h);
}

// fd_row of row n of [N, 3] tables, its neighbours' values from dist
__device__ __forceinline__ void fd_grad(const float* dist, const int64_t* nbr_idx,
                                        const float* nbr_const, const float* nbr_dir,
                                        int64_t n, float d, float inv_h, float* g) {
  float dn[3];
  gather_row([&](int64_t j) { return dist[j]; }, nbr_idx + 3 * n, nbr_const + 3 * n, dn);
  fd_row(dn, nbr_dir + 3 * n, d, inv_h, g);
}

// ------------------------------------------------ the distance regularizers

// The host's float constants of the distance block's regularizers at voxel
// size h: 1 / (float)h, as a CUDA tensor is divided by h; the Python
// numbers 1 / h and -1 / h rounded to float, as a tensor is multiplied by
// them; 1 / (float)(h h), as fd_laplacian divides by h^2
struct RegConsts {
  float inv_h_div, inv_h, neg_inv_h, inv_h2;
};

inline RegConsts reg_consts(double voxel) {
  return RegConsts{1.0f / static_cast<float>(voxel), static_cast<float>(1.0 / voxel),
                   static_cast<float>(-(1.0 / voxel)),
                   1.0f / static_cast<float>(voxel * voxel)};
}

// refine/solvers.py eikonal_operator of one valid row at distance d from
// its one-sided neighbours' values dn (gather_row) and directions dir: the
// gradient g, then e = (J0, Ji_0, Ji_1, Ji_2, r) with r = |g| - 1, J0 =
// (g . n_d0) s, Ji = (g dir / h) s, n_d0 = -dir / h and s the reciprocal of
// |g| where it is positive.  An invalid row's terms are 0 (the caller's).
__device__ __forceinline__ void eikonal_row(const float (&dn)[3], const float* dir, float d,
                                            const RegConsts& c, float (&e)[5]) {
  float g[3];
  fd_row(dn, dir, d, c.inv_h_div, g);
  const float gnorm = norm3(g);
  const float nd0[3] = {fmul(dir[0], c.neg_inv_h), fmul(dir[1], c.neg_inv_h),
                        fmul(dir[2], c.neg_inv_h)};
  const float scale = gnorm > 0.0f ? frcp(clamp_min(gnorm, 1e-12f)) : 1.0f;
  e[0] = fmul(dot3(g, nd0), scale);
#pragma unroll
  for (int i = 0; i < 3; ++i) e[1 + i] = fmul(fmul(fmul(g[i], dir[i]), c.inv_h), scale);
  e[4] = fsub(gnorm, 1.0f);
}

// refine/solvers.py laplacian_operator's residual of one valid row from its
// six neighbours' values dl (gather_row): (sum - 6 d) / h^2, the sum left to
// right
__device__ __forceinline__ float laplacian_row(const float (&dl)[6], float d, float inv_h2) {
  float s = dl[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) s = fadd(s, dl[i]);
  return fmul(fsub(s, fmul(6.0f, d)), inv_h2);
}

// refine/solvers.py accept_distance of one row: d - delta where |delta| <
// thr on a valid row, else d; thr is sqrt(3) h rounded once to float, the
// value PyTorch compares a float tensor with (ops/distreg.accept_threshold)
__device__ __forceinline__ float accepted(float d, float delta, bool valid, float thr) {
  return (fabsf(delta) < thr) & valid ? fsub(d, delta) : d;
}

// R p (transpose false) or R^T p (true), R the pose's rotation rows, in
// ops/fuse.rot_apply's order
__device__ __forceinline__ void rot(const float* R, const float* p, bool transpose,
                                   float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a = transpose ? R[i] : R[3 * i];
    const float b = transpose ? R[3 + i] : R[3 * i + 1];
    const float c = transpose ? R[6 + i] : R[3 * i + 2];
    out[i] = fadd(fadd(fmul(a, p[0]), fmul(b, p[1])), fmul(c, p[2]));
  }
}

}  // namespace
