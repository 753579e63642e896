// The refinement's residual pass and the distance block's Jacobian for
// Hopper (sm_90a): one launch each.
//
// Replaces two of the JAX package's jit-fused programs on the refinement's
// path (XLA fuses each; neither is Pallas):
//   * residual_pass_kernel: psgradientsdf_tpu/refine/optimizer.py
//     `_residuals` (:52) -> refine/render.py `compute_residuals` (:127):
//     `surface_points_world` :46, `project_to_frames` :54,
//     refine/patches.py `sample_patch_all` :135 (`build_span` :49,
//     `fetch_patches` :57, `_patch_math` :76), `rendered_intensity_sh` :89 /
//     `_led` :104 and utils/robust.py `irls_weight`;
//   * dist_jacobian_kernel: refine/optimizer.py `_dist_block` (:186) and
//     `_joint_dp_core` (:276) -> refine/jacobians.py `image_pi_grad` :44,
//     `dist_jacobian_sh` :193, `dist_jacobian_led` :238.
// The port's plain versions are ops/residual.py `residual_pass_plain` and
// `dist_jacobian_plain` (refine/render.py, patches.py, jacobians.py,
// geometry.py, utils/sh.py, utils/robust.py): eager chains of some hundred
// PyTorch passes over [N, F, ...] tensors, with a [F, H*W, 9] span table
// built for every residual pass.
//
// For every (surface voxel n, keyframe f) pair, residual_pass_kernel
// computes
//   * the surface point x = c_v - d * ghat_stored and p_cam = R^T (x - t);
//   * uv and the in-image flag, the 3x3 RGB patch (rows clipped at the
//     image edge, columns clipped around the clipped base column, as the
//     span table replicates them), the bilinear intensity and the image
//     gradients (d/du, d/dv) with ops/image.py's border fallbacks;
//   * the shading: SH1/SH2 irradiance l_f . SH(n_hat) of the FD normal, or
//     the LED falloff -n_hat . (R p) / |p|^3 times the light;
//   * mask = vis & in_img & valid, r = I - rho * shade and the IRLS weight
//     (L2, Cauchy, Huber, Tukey, truncated L2), 0 where masked;
// and writes r, w, mask, p_cam, uv and g_img for every pair, padded rows
// included.  dist_jacobian_kernel reads p_cam and g_img back and computes,
// per pair, G = dI/dx_cam (image_pi_grad), G R^T, the reprojection part
// G R^T dx/dd of the 4-point stencil, and the shading part (SH1 through
// l[1:4], SH2 through dSH/dn, LED through the attenuation chain rule) ->
// J0 [N,F,3], Ji [N,3,F,3], and G [N,F,3,3] when the caller asks for it.
//
// Work assignment: a block takes vb consecutive voxels (vb = 256 / F, at
// least 1, at most kMaxVox) and all their frames.  The per-voxel terms (the
// surface point, the FD normal and its SH basis, the stencil's normal
// Jacobians, dx/dd, dSH) are computed once a voxel into shared memory; then
// each thread takes pairs q = tid, tid + 256, ... of the block's vb * F,
// voxel-major, so that consecutive threads take consecutive frames of one
// voxel and the [N, F, ...] stores of a warp are consecutive.  Neighbouring
// voxels (the compacted surface order is a raster of the grid) hit
// neighbouring pixels in each frame, which keeps the patch reads of the
// blocks in flight within the L2 cache.  Per-frame poses, K and lights are
// read through the read-only path.
//
// Rounding: every operation is written with the _rn intrinsics in the plain
// version's order (the sums over an axis of 3 as (a0 b0 + a1 b1) + a2 b2,
// the SH sums from coefficient 0 up, no contraction into FMAs), and two of
// PyTorch's conventions on a CUDA tensor are kept: a tensor divided by a
// Python number is multiplied by the number's float32 reciprocal (x / h, r /
// lambda), and a Python number divided by a tensor is the tensor's
// reciprocal times the number (1 / z, lambda / |r|).  So the kernels equal
// the plain versions on the card bit for bit.  Pixel indices are floor()
// and a 64-bit integer conversion, as `.long()`: a pair at or behind the
// camera plane (|z| <= 1e-12 divides by 1e-12) reaches |u| ~ 1e15, which a
// 32-bit conversion would saturate.
//
// Bound on the card: bytes.  residual_pass writes 69 bytes a pair (r, w,
// p_cam: 12 each; uv 8; g_img 24; mask 1), reads vis (1 byte a pair), the
// per-voxel inputs once and the distinct pixels the patches touch once;
// about 200 flops a pair.  dist_jacobian reads p_cam and g_img (36 bytes a
// pair) and writes J0 and Ji (48; G 36 more); about 250 flops a pair.
//
// Plain C interface (loaded with ctypes): residual_pass() and
// dist_jacobian() launch on the stream they are given, do not synchronise,
// allocate nothing and return cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

// The C interface's argument blocks: every field 8 bytes wide, in this
// order (ops/residual.py builds the same blocks with ctypes).  All arrays
// are contiguous; bools are one byte.
struct ResidualArgs {
  const int32_t* idx_xyz;          // [N,3]
  const float* dist;               // [N]
  const float* albedo;             // [N,3]
  const float* grad;               // [N,3] the stored gradient
  const int64_t* nbr_idx;          // [N,3] compact index, -1: frozen
  const float* nbr_dist_const;     // [N,3]
  const float* nbr_dir;            // [N,3]
  const unsigned char* valid;      // [N]
  const unsigned char* vis;        // [N,F]
  const float* poses;              // [F,4,4] camera-to-world
  const float* lights;             // [F,B] (SH) or [3] (LED)
  const float* images;             // [F,H,W,3]
  const float* K;                  // [3,3]
  float* r;                        // [N,F,3]
  float* w;                        // [N,F,3]
  unsigned char* mask;             // [N,F]
  float* p_cam;                    // [N,F,3]
  float* uv;                       // [N,F,2]
  float* g_img;                    // [N,F,3,2]
  int64_t N, F, H, W, led, basis, loss;
  double origin_x, origin_y, origin_z, voxel, lam;
};

struct JacobianArgs {
  const float* dist;               // [N]
  const float* albedo;             // [N,3]
  const float* grad;               // [N,3] the stored gradient
  const int64_t* nbr_idx;          // [N,3]
  const float* nbr_dist_const;     // [N,3]
  const float* nbr_dir;            // [N,3]
  const float* p_cam;              // [N,F,3] of the residual pass
  const float* g_img;              // [N,F,3,2] of the residual pass
  const float* poses;              // [F,4,4]
  const float* lights;             // [F,B] (SH) or [3] (LED)
  const float* K;                  // [3,3]
  float* J0;                       // [N,F,3]
  float* Ji;                       // [N,3,F,3]
  float* G;                        // [N,F,3,3], or null
  int64_t N, F, led, basis;
  double voxel;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVox = 64;        // voxels a block, at most
constexpr int kResVox = 16;        // floats of a voxel's residual terms
constexpr int kJacVox = 52;        // floats of a voxel's Jacobian terms

// loss ids of utils/robust.py
constexpr int kCauchy = 1, kHuber = 2, kTukey = 3, kTruncL2 = 4;   // else L2

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

// geometry.fd_grad: (dir_i * (d_nbr_i - d)) / h, a frozen neighbour's value
// where nbr_idx < 0
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

// utils/sh.sh_basis of a unit normal: B = 4 or 9 coefficients
__device__ __forceinline__ void sh_basis(const float* nn, int B, float* out) {
  const float nx = nn[0], ny = nn[1], nz = nn[2];
  out[0] = 1.0f;
  out[1] = nx;
  out[2] = ny;
  out[3] = nz;
  if (B == 9) {
    out[4] = fmul(nx, ny);
    out[5] = fmul(nx, nz);
    out[6] = fmul(ny, nz);
    out[7] = fsub(fmul(nx, nx), fmul(ny, ny));
    out[8] = fsub(fmul(nx, nx), fmul(nz, nz));
  }
}

// utils/sh.irradiance: sum_b c[b] l[b], from b = 0 up
__device__ __forceinline__ float irradiance(const float* c, const float* l, int B) {
  float out = fmul(c[0], __ldg(l));
  for (int b = 1; b < B; ++b) out = fadd(out, fmul(c[b], __ldg(l + b)));
  return out;
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

// a frame's rotation rows and translation, read through the read-only path
__device__ __forceinline__ void load_pose(const float* poses, int f, float* R, float* t) {
  const float* P = poses + 16 * f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    R[3 * i] = __ldg(P + 4 * i);
    R[3 * i + 1] = __ldg(P + 4 * i + 1);
    R[3 * i + 2] = __ldg(P + 4 * i + 2);
    t[i] = __ldg(P + 4 * i + 3);
  }
}

// utils/robust.irls_weight of one residual
__device__ __forceinline__ float irls(float r, int loss, float inv_lam, float lam,
                                      float lam_sq) {
  const float r2 = fmul(r, r);
  if (loss == kCauchy) {
    const float s = fmul(r, inv_lam);
    return frcp(fadd(fmul(s, s), 1.0f));
  }
  if (loss == kTukey) {
    const float s = fmul(r, inv_lam);
    const float t = fsub(1.0f, fmul(s, s));
    return r2 < lam_sq ? fmul(t, t) : 0.0f;
  }
  if (loss == kHuber) {
    const float wl = fmul(frcp(clamp_min(fabsf(r), 1e-12f)), lam);
    return r2 < lam_sq ? 1.0f : wl;
  }
  if (loss == kTruncL2) return r2 < lam_sq ? 1.0f : 0.0f;
  return 1.0f;
}

struct ResidualParams {
  ResidualArgs a;
  int vb, B;
  float ox, oy, oz, h, inv_h, inv_lam, lam, lam_sq;
};

// ---------------------------------------------------------------- residuals

__global__ void __launch_bounds__(kThreads)
residual_pass_kernel(const __grid_constant__ ResidualParams p) {
  // a voxel's terms: x[0:3], the SH basis (SH) or the FD normal (LED)
  // [3:12], rho (SH) or rho * light (LED) [12:15], valid [15]
  __shared__ float vox[kMaxVox][kResVox];
  const ResidualArgs& a = p.a;
  const int F = static_cast<int>(a.F);
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * p.vb;
  const int nv = static_cast<int>(a.N - n0 < p.vb ? a.N - n0 : p.vb);

  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const int64_t n = n0 + v;
    float* s = vox[v];
    const float d = a.dist[n];
    // x = c_v - d * ghat_stored (surface_points_world)
    const float g[3] = {a.grad[3 * n], a.grad[3 * n + 1], a.grad[3 * n + 2]};
    float ghat[3];
    normalize(g, ghat);
    const float o[3] = {p.ox, p.oy, p.oz};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float c = fadd(o[i], fmul(p.h, static_cast<float>(a.idx_xyz[3 * n + i])));
      s[i] = fsub(c, fmul(d, ghat[i]));
    }
    // the shading normal: the normalized FD gradient
    float gfd[3], nn[3];
    fd_grad(a.dist, a.nbr_idx, a.nbr_dist_const, a.nbr_dir, n, d, p.inv_h, gfd);
    normalize(gfd, nn);
    if (a.led) {
      s[3] = nn[0]; s[4] = nn[1]; s[5] = nn[2];
#pragma unroll
      for (int c = 0; c < 3; ++c) s[12 + c] = fmul(a.albedo[3 * n + c], __ldg(a.lights + c));
    } else {
      sh_basis(nn, p.B, s + 3);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[12 + c] = a.albedo[3 * n + c];
    }
    s[15] = a.valid[n] ? 1.0f : 0.0f;
  }
  __syncthreads();

  const float fx = __ldg(a.K), cx = __ldg(a.K + 2), fy = __ldg(a.K + 4),
              cy = __ldg(a.K + 5);
  const int64_t H = a.H, W = a.W;
  const float Hf = static_cast<float>(H), Wf = static_cast<float>(W);
  for (int q = threadIdx.x; q < nv * F; q += kThreads) {
    const int v = q / F;
    const int f = q - v * F;
    const int64_t n = n0 + v;
    const int64_t pair = n * F + f;
    const float* s = vox[v];

    // ---- the projection (world_to_cam, project_to_frames)
    float R[9], t[3];
    load_pose(a.poses, f, R, t);
    const float dx[3] = {fsub(s[0], t[0]), fsub(s[1], t[1]), fsub(s[2], t[2])};
    float pc[3];
    rot(R, dx, true, pc);
    const float z = pc[2];
    const float safe_z = fabsf(z) > 1e-12f ? z : 1e-12f;
    const float u = fadd(fdiv(fmul(fx, pc[0]), safe_z), cx);
    const float vv = fadd(fdiv(fmul(fy, pc[1]), safe_z), cy);
    const bool in_img = (u >= 0.0f) & (u < Wf) & (vv >= 0.0f) & (vv < Hf);

    // ---- the 3x3 patch (fetch_patches): rows clip(r0 - 1 + i), columns
    // clip(c0c - 1 + j) around c0c = clip(c0), in 64-bit integers
    const float r0f = floorf(vv), c0f = floorf(u);
    const long long r0 = static_cast<long long>(r0f);
    const long long c0 = static_cast<long long>(c0f);
    const long long c0c = c0 < 0 ? 0 : (c0 > W - 1 ? W - 1 : c0);
    long long rows[3], cols[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const long long rr = r0 - 1 + i;
      rows[i] = rr < 0 ? 0 : (rr > H - 1 ? H - 1 : rr);
      const long long cc = c0c - 1 + i;
      cols[i] = cc < 0 ? 0 : (cc > W - 1 ? W - 1 : cc);
    }
    const float* img = a.images + static_cast<int64_t>(f) * H * W * 3;
    // P[i][j] for the eight entries _patch_math reads (P[0][0] is unused)
    float P[3][3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (i == 0 && j == 0) continue;
        const float* px = img + (rows[i] * W + cols[j]) * 3;
        P[i][j][0] = __ldg(px);
        P[i][j][1] = __ldg(px + 1);
        P[i][j][2] = __ldg(px + 2);
      }
    }
    // ---- bilinear intensity and image gradients (_patch_math)
    const float fr = fsub(vv, r0f), fc = fsub(u, c0f);
    const float omfr = fsub(1.0f, fr), omfc = fsub(1.0f, fc);
    const bool row_ok = r0 + 1 < H, col_ok = c0 + 1 < W;
    const bool both = row_ok & col_ok;
    float I[3], gimg[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v00 = P[1][1][c], v01 = P[1][2][c], v10 = P[2][1][c],
                  v11 = P[2][2][c];
      const float full = fadd(fmul(omfc, fadd(fmul(fr, v10), fmul(omfr, v00))),
                              fmul(fc, fadd(fmul(fr, v11), fmul(omfr, v01))));
      const float col_only = fadd(fmul(omfc, v00), fmul(fc, v01));
      const float row_only = fadd(fmul(fr, v10), fmul(omfr, v00));
      I[c] = both ? full : (col_ok ? col_only : (row_ok ? row_only : v00));
      // d/d col
      const float d_r0 = fsub(v01, v00), d_r1 = fsub(v11, v10);
      const float b_r0 = fsub(v00, P[1][0][c]), b_r1 = fsub(v10, P[2][0][c]);
      const float blended = fadd(fmul(omfr, d_r0), fmul(fr, d_r1));
      const float blended_back = fadd(fmul(omfr, b_r0), fmul(fr, b_r1));
      gimg[2 * c] = both ? blended : (!row_ok ? d_r0 : blended_back);
      // d/d row
      const float d_c0 = fsub(v10, v00), d_c1 = fsub(v11, v01);
      const float b_c0 = fsub(v00, P[0][1][c]), b_c1 = fsub(v01, P[0][2][c]);
      const float blended_v = fadd(fmul(omfc, d_c0), fmul(fc, d_c1));
      const float blended_back_v = fadd(fmul(omfc, b_c0), fmul(fc, b_c1));
      gimg[2 * c + 1] = both ? blended_v : (!col_ok ? d_c0 : blended_back_v);
    }

    // ---- the shading
    float shade;
    if (a.led) {
      // -(n . R p) / max(|p|, 1e-12)^3 (led_reflectance)
      float Rp[3];
      rot(R, pc, false, Rp);
      const float num = dot3(s + 3, Rp);
      const float pn = clamp_min(norm3(pc), 1e-12f);
      shade = -fdiv(num, fmul(fmul(pn, pn), pn));
    } else {
      shade = irradiance(s + 3, a.lights + static_cast<int64_t>(f) * p.B, p.B);
    }

    // ---- mask, residual, weight
    const bool m = a.vis[pair] && in_img && s[15] != 0.0f;
    float* r = a.r + 3 * pair;
    float* w = a.w + 3 * pair;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rc = m ? fsub(I[c], fmul(s[12 + c], shade)) : 0.0f;
      r[c] = rc;
      w[c] = m ? irls(rc, static_cast<int>(a.loss), p.inv_lam, p.lam, p.lam_sq) : 0.0f;
    }
    a.mask[pair] = m ? 1 : 0;
    float* po = a.p_cam + 3 * pair;
    po[0] = pc[0]; po[1] = pc[1]; po[2] = pc[2];
    a.uv[2 * pair] = u;
    a.uv[2 * pair + 1] = vv;
    float* go = a.g_img + 6 * pair;
#pragma unroll
    for (int k = 0; k < 6; ++k) go[k] = gimg[k];
  }
}

// ------------------------------------------------------ the distance Jacobian

struct JacobianParams {
  JacobianArgs a;
  int vb, B;
  float inv_h;
};

// geometry.normal_jacobian (lag false): N_inv n_d - N_inv^3 (n_d . g) g with
// n_d = -direction / h
__device__ __forceinline__ void normal_jacobian(const float* g, const float* dir,
                                                float n_inv, float inv_h, float* out) {
  const float nd[3] = {fmul(-dir[0], inv_h), fmul(-dir[1], inv_h), fmul(-dir[2], inv_h)};
  const float dN = fmul(fmul(fmul(n_inv, n_inv), n_inv), dot3(nd, g));
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = fsub(fmul(n_inv, nd[i]), fmul(dN, g[i]));
}

// a voxel's Jacobian terms, offsets into its kJacVox floats
constexpr int kDx0 = 0;      // dx/dd0 [3]
constexpr int kDxi = 3;      // dx/dd_i [3][3]
constexpr int kRho = 12;     // rho (SH) or rho * light (LED) [3]
constexpr int kDn0 = 15;     // SH1, LED: dn/dd0 [3]
constexpr int kDni = 18;     // SH1, LED: dn/dd_i [3][3]
constexpr int kNfd = 27;     // LED: the FD normal [3]
constexpr int kT2 = 30;      // LED: n_fd . dx for d0 and the d_i [4]
constexpr int kSh0 = 15;     // SH2: dSH/dd0 [9]
constexpr int kShi = 24;     // SH2: dSH/dd_i [3][9]
static_assert(kShi + 27 <= kJacVox && kT2 + 4 <= kJacVox, "voxel terms");

__global__ void __launch_bounds__(kThreads)
dist_jacobian_kernel(const __grid_constant__ JacobianParams p) {
  __shared__ float vox[kMaxVox][kJacVox];
  const JacobianArgs& a = p.a;
  const int F = static_cast<int>(a.F);
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * p.vb;
  const int nv = static_cast<int>(a.N - n0 < p.vb ? a.N - n0 : p.vb);

  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const int64_t n = n0 + v;
    float* s = vox[v];
    const float d = a.dist[n];
    // the stencil's normal Jacobians (dn_stencil) of the FD gradient
    float gfd[3];
    fd_grad(a.dist, a.nbr_idx, a.nbr_dist_const, a.nbr_dir, n, d, p.inv_h, gfd);
    const float n_inv = frcp(clamp_min(norm3(gfd), 1e-3f));
    const float pos[3] = {a.nbr_dir[3 * n], a.nbr_dir[3 * n + 1], a.nbr_dir[3 * n + 2]};
    float dn0[3], dni[3][3];
    normal_jacobian(gfd, pos, n_inv, p.inv_h, dn0);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      // direction -pos_ax e_ax, written as -pos times a row of the identity
      const float dir[3] = {fmul(-pos[ax], ax == 0 ? 1.0f : 0.0f),
                            fmul(-pos[ax], ax == 1 ? 1.0f : 0.0f),
                            fmul(-pos[ax], ax == 2 ? 1.0f : 0.0f)};
      normal_jacobian(gfd, dir, n_inv, p.inv_h, dni[ax]);
    }
    // dx/dd (_reprojection_terms): -ghat_stored - d dn0, and -d dn_i
    const float g[3] = {a.grad[3 * n], a.grad[3 * n + 1], a.grad[3 * n + 2]};
    float ghat[3];
    normalize(g, ghat);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[kDx0 + i] = fsub(-ghat[i], fmul(d, dn0[i]));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) s[kDxi + 3 * ax + i] = fmul(-d, dni[ax][i]);
    }
    if (a.led) {
      float nfd[3];
      normalize(gfd, nfd);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s[kDn0 + i] = dn0[i];
        s[kNfd + i] = nfd[i];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) s[kDni + 3 * ax + i] = dni[ax][i];
      }
      s[kT2] = dot3(nfd, s + kDx0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) s[kT2 + 1 + ax] = dot3(nfd, s + kDxi + 3 * ax);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[kRho + c] = fmul(a.albedo[3 * n + c], __ldg(a.lights + c));
    } else if (p.B == 4) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s[kDn0 + i] = dn0[i];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) s[kDni + 3 * ax + i] = dni[ax][i];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) s[kRho + c] = a.albedo[3 * n + c];
    } else {
      // dSH = dsh_dn(n_fd)^T dn: the rows of utils/sh.dsh_dn, y = 0, 1, 2
      float nfd[3];
      normalize(gfd, nfd);
      const float nx = nfd[0], ny = nfd[1], nz = nfd[2];
      const float dsh[3][9] = {
          {0.0f, 1.0f, 0.0f, 0.0f, ny, nz, 0.0f, fmul(2.0f, nx), fmul(2.0f, nx)},
          {0.0f, 0.0f, 1.0f, 0.0f, nx, 0.0f, nz, fmul(-2.0f, ny), 0.0f},
          {0.0f, 0.0f, 0.0f, 1.0f, 0.0f, nx, ny, 0.0f, fmul(-2.0f, nz)}};
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        const float col[3] = {dsh[0][b], dsh[1][b], dsh[2][b]};
        s[kSh0 + b] = dot3(col, dn0);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) s[kShi + 9 * ax + b] = dot3(col, dni[ax]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) s[kRho + c] = a.albedo[3 * n + c];
    }
  }
  __syncthreads();

  const float fx = __ldg(a.K), fy = __ldg(a.K + 4);
  for (int q = threadIdx.x; q < nv * F; q += kThreads) {
    const int v = q / F;
    const int f = q - v * F;
    const int64_t n = n0 + v;
    const int64_t pair = n * F + f;
    const float* s = vox[v];

    const float pc[3] = {a.p_cam[3 * pair], a.p_cam[3 * pair + 1], a.p_cam[3 * pair + 2]};
    float gi[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) gi[k] = a.g_img[6 * pair + k];
    // ---- G = dI/dx_cam (image_pi_grad)
    const float z = pc[2];
    const float z_inv = frcp(fabsf(z) > 1e-12f ? z : 1e-12f);
    const float z_inv_sq = fmul(z_inv, z_inv);
    const float ax_u = fmul(fx, z_inv), ax_v = fmul(fy, z_inv);
    const float az_u = fmul(fmul(fx, pc[0]), z_inv_sq);
    const float az_v = fmul(fmul(fy, pc[1]), z_inv_sq);
    float G[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float gu = gi[2 * c], gv = gi[2 * c + 1];
      G[c][0] = fmul(gu, ax_u);
      G[c][1] = fmul(gv, ax_v);
      G[c][2] = -fadd(fmul(gu, az_u), fmul(gv, az_v));
    }
    if (a.G != nullptr) {
      float* go = a.G + 9 * pair;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        go[3 * c] = G[c][0]; go[3 * c + 1] = G[c][1]; go[3 * c + 2] = G[c][2];
      }
    }
    // ---- G R^T, then the reprojection part dI = (G R^T) dx
    float R[9], t[3];
    load_pose(a.poses, f, R, t);
    float GRt[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int y = 0; y < 3; ++y) GRt[c][y] = dot3(G[c], R + 3 * y);
    }
    float dI0[3], dIi[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dI0[c] = dot3(GRt[c], s + kDx0);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) dIi[ax][c] = dot3(GRt[c], s + kDxi + 3 * ax);
    }
    // ---- the shading part
    float* J0 = a.J0 + 3 * pair;
    if (a.led) {
      float Rp[3];
      rot(R, pc, false, Rp);
      const float pn = clamp_min(norm3(pc), 1e-12f);
      const float radius = fmul(fmul(pn, pn), pn);
      const float pn5 = fmul(fmul(radius, pn), pn);
      const float m_val = dot3(s + kNfd, Rp);
      // m_terms: (dn . Rp + n_fd . dx) / |p|^3 - 3 (Rp . dx) / |p|^5 m
      auto dm = [&](const float* dn, const float* dxv, float t2) {
        const float num = fadd(dot3(dn, Rp), t2);
        const float rad = fdiv(fmul(-3.0f, dot3(Rp, dxv)), pn5);
        return fadd(fdiv(num, radius), fmul(rad, m_val));
      };
      const float dm0 = dm(s + kDn0, s + kDx0, s[kT2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) J0[c] = fadd(dI0[c], fmul(s[kRho + c], dm0));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const float dmi = dm(s + kDni + 3 * ax, s + kDxi + 3 * ax, s[kT2 + 1 + ax]);
        float* Ji = a.Ji + ((n * 3 + ax) * F + f) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) Ji[c] = fadd(dIi[ax][c], fmul(s[kRho + c], dmi));
      }
    } else {
      const float* l = a.lights + static_cast<int64_t>(f) * p.B;
      float dS0, dSi[3];
      if (p.B == 4) {
        // l[1:4] . dn
        const float l13[3] = {__ldg(l + 1), __ldg(l + 2), __ldg(l + 3)};
        dS0 = dot3(s + kDn0, l13);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) dSi[ax] = dot3(s + kDni + 3 * ax, l13);
      } else {
        dS0 = irradiance(s + kSh0, l, 9);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) dSi[ax] = irradiance(s + kShi + 9 * ax, l, 9);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) J0[c] = fsub(dI0[c], fmul(s[kRho + c], dS0));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float* Ji = a.Ji + ((n * 3 + ax) * F + f) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) Ji[c] = fsub(dIi[ax][c], fmul(s[kRho + c], dSi[ax]));
      }
    }
  }
}

// voxels a block: 256 / F, at least 1, at most kMaxVox
int voxels_per_block(int64_t F) {
  int64_t vb = kThreads / (F > 0 ? F : 1);
  if (vb < 1) vb = 1;
  if (vb > kMaxVox) vb = kMaxVox;
  return static_cast<int>(vb);
}

}  // namespace

extern "C" int residual_pass(const ResidualArgs* a, void* stream) {
  ResidualParams p;
  p.a = *a;
  p.vb = voxels_per_block(a->F);
  p.B = a->led ? 3 : static_cast<int>(a->basis);
  p.ox = static_cast<float>(a->origin_x);
  p.oy = static_cast<float>(a->origin_y);
  p.oz = static_cast<float>(a->origin_z);
  p.h = static_cast<float>(a->voxel);
  // PyTorch divides a CUDA tensor by a Python number as a product with the
  // float32 reciprocal, computed on the host in float
  p.inv_h = 1.0f / p.h;
  p.lam = static_cast<float>(a->lam);
  p.inv_lam = 1.0f / p.lam;
  // r^2 < lam * lam: the product in double, compared in float
  p.lam_sq = static_cast<float>(a->lam * a->lam);
  if (a->N > 0 && a->F > 0) {
    const int64_t blocks = (a->N + p.vb - 1) / p.vb;
    residual_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dist_jacobian(const JacobianArgs* a, void* stream) {
  JacobianParams p;
  p.a = *a;
  p.vb = voxels_per_block(a->F);
  p.B = a->led ? 3 : static_cast<int>(a->basis);
  p.inv_h = 1.0f / static_cast<float>(a->voxel);
  if (a->N > 0 && a->F > 0) {
    const int64_t blocks = (a->N + p.vb - 1) / p.vb;
    dist_jacobian_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
