// The float arithmetic of refine/geometry.py, shared by the refinement's
// kernels that must equal its plain PyTorch chains on the card bit for bit
// (csrc/residual.cu, csrc/albedo.cu, csrc/distreg.cu, csrc/normaleq.cu).
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

// geometry.gather_nbr of one entry: x[j], a frozen neighbour's constant
// where j < 0
__device__ __forceinline__ float nbr_value(const float* x, int64_t j, float frozen) {
  return j >= 0 ? x[j] : frozen;
}

// geometry.fd_grad: (dir_i * (d_nbr_i - d)) / h, a frozen neighbour's value
// where nbr_idx < 0.  inv_h is 1 / (float)h: PyTorch divides a CUDA tensor
// by a number as a product with its float reciprocal
__device__ __forceinline__ void fd_grad(const float* dist, const int64_t* nbr_idx,
                                        const float* nbr_const, const float* nbr_dir,
                                        int64_t n, float d, float inv_h, float* g) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int64_t j = nbr_idx[3 * n + i];
    const float dn = j >= 0 ? dist[j] : nbr_const[3 * n + i];
    g[i] = fmul(fmul(nbr_dir[3 * n + i], fsub(dn, d)), inv_h);
  }
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
