// The per-voxel fusion update for Hopper (sm_90a): one launch per fused
// frame, one thread per (slot, voxel).
//
// Replaces the JAX package's jit-fused update, psgradientsdf_tpu/core/
// volume.py `_fuse_voxel_update` (:104) on the voxel centres of
// `_row_world_coords` (:785), as XLA fuses both inside `_fuse_culled_slab`
// (:475).  The port's plain version is ops/fuse.py `fuse_voxel_update` on
// `row_world_coords`: a chain of some forty eager PyTorch passes over the
// [CAP, S] rows.
//
// For every live slot s (slots at or past *live are skipped) and voxel j of
// its row (or S-voxel X-segment) r = rows[s] (r = s when rows is null):
//   * the voxel centre from the row id: plane z0 + r / (Y*NS) (or
//     z_map[r / (Y*NS)]), row (r / NS) % Y, x = (r % NS)*S + j;
//   * camera coordinates through R^T (p - t), the nearest pixel by the
//     reference's int-cast rounding, ONE 32-byte pixel-payload row (depth,
//     normal, colour, 1/n^2);
//   * the six gates (in front, in the image, depth range, fusion weight > 0,
//     normal valid, viewing angle) and the caller's gate (a scalar or one
//     per slot);
//   * the weighted running means of distance and colour, -w R n added to
//     the gradient, and the frame's bit ORed into the visibility word.
//
// State goes in and out IN PLACE through a pointer, a row stride and a
// voxel stride per field (the three components of grad and colour are
// consecutive), so one kernel serves the gathered SoA row blocks, the packed
// [CAP, S, 8] rows, the whole grid and the chunk-resident rows.  The
// visibility pointer may be null (a K-batched fusion that drops the bits of
// a word that does not exist).
//
// Rounding: every operation is written with the _rn intrinsics in the plain
// version's order (the fixed multiply-add order of rot_apply, the divisions
// where PyTorch divides, no contraction into FMAs), so the kernel equals the
// plain version on the card bit for bit.  Two of PyTorch's conventions on a
// CUDA tensor are kept: a tensor divided by a Python number is multiplied by
// the number's float32 reciprocal (sdf / T), and clamp returns a NaN input
// as it is.
//
// Bound on the card: bytes.  Each live voxel reads its four fields and its
// visibility word (36 bytes: 1 + 3 + 1 + 3 floats and an int) and writes
// them back, and reads one 32-byte pixel row: 104 bytes a live voxel, about
// 20 flops.  3636 live rows of 128 voxels: 48 MB, 14 us at 3.35 TB/s.
//
// Plain C interface (loaded with ctypes): fuse_rows() launches on the stream
// it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

// The C interface's argument block: every field 8 bytes wide, in this order
// (ops/fuse.py builds the same block with ctypes).  Strides are in
// elements.
struct FuseArgs {
  float* dist;    int64_t dist_rs, dist_vs;
  float* grad;    int64_t grad_rs, grad_vs;
  float* weight;  int64_t weight_rs, weight_vs;
  float* color;   int64_t color_rs, color_vs;
  int32_t* vis;   int64_t vis_rs, vis_vs;       // vis may be null
  const int32_t* rows;                           // [cap] grid row ids, or null
  const int64_t* live;                           // device scalar, or null
  const unsigned char* gate;  int64_t gate_stride;   // bool; stride 0: scalar
  const float* z_map;  int64_t z_map_len;        // [Zl] global planes, or null
  const float* pix;                              // [H*W, 8]
  const float* K;                                // [3, 3]
  const float* pose;                             // [4, 4] camera-to-world
  int64_t cap, S, NS, Y, H, W, bit, has_z0;
  double z0, origin_x, origin_y, origin_z, voxel, truncation, zmin, zmax,
      cos_thresh_sq;
};

namespace {

constexpr int kThreads = 256;

// The kernel's own parameters: the numbers as float32, as PyTorch rounds a
// Python number it combines with a float32 tensor.
struct FuseParams {
  float* dist;    int64_t dist_rs, dist_vs;
  float* grad;    int64_t grad_rs, grad_vs;
  float* weight;  int64_t weight_rs, weight_vs;
  float* color;   int64_t color_rs, color_vs;
  int32_t* vis;   int64_t vis_rs, vis_vs;
  const int32_t* rows;
  const int64_t* live;
  const unsigned char* gate;  int64_t gate_stride;
  const float* z_map;  int64_t z_map_len;
  const float4* pix;
  const float* K;
  const float* pose;
  int64_t cap, total;
  int S, NS, Y, H, W, bit, has_z0;
  float z0, ox, oy, oz, h, trunc, neg_trunc, inv_trunc, zmin, zmax, cos_sq;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp on a CUDA tensor: a NaN input is returned as it is
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// (R00*x + R01*y) + R02*z, as rot_apply writes it
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return fadd(fadd(fmul(a, x), fmul(b, y)), fmul(c, z));
}

__global__ void __launch_bounds__(kThreads)
fuse_rows_kernel(const __grid_constant__ FuseParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.total) return;
  const int64_t slot = i / p.S;
  const int j = static_cast<int>(i - slot * p.S);
  if (p.live != nullptr && slot >= *p.live) return;

  // ---- the voxel centre (row_world_coords)
  const int64_t r = p.rows != nullptr ? static_cast<int64_t>(p.rows[slot]) : slot;
  const int64_t rz_l = r / (static_cast<int64_t>(p.Y) * p.NS);
  float rz;
  if (p.z_map != nullptr) {
    rz = p.z_map[rz_l < p.z_map_len - 1 ? rz_l : p.z_map_len - 1];
  } else {
    rz = static_cast<float>(rz_l);
    if (p.has_z0) rz = fadd(rz, p.z0);
  }
  const float ry = static_cast<float>((r / p.NS) % p.Y);
  const float rx = fadd(fmul(static_cast<float>(r % p.NS), static_cast<float>(p.S)),
                        static_cast<float>(j));
  const float pwx = fadd(p.ox, fmul(p.h, rx));
  const float pwy = fadd(p.oy, fmul(p.h, ry));
  const float pwz = fadd(p.oz, fmul(p.h, rz));

  // ---- camera coordinates: R^T (p - t)
  const float* P = p.pose;
  const float r00 = P[0], r01 = P[1], r02 = P[2], tx = P[3];
  const float r10 = P[4], r11 = P[5], r12 = P[6], ty = P[7];
  const float r20 = P[8], r21 = P[9], r22 = P[10], tz = P[11];
  const float dx = fsub(pwx, tx), dy = fsub(pwy, ty), dz = fsub(pwz, tz);
  const float pcx = dot3(r00, r10, r20, dx, dy, dz);
  const float pcy = dot3(r01, r11, r21, dx, dy, dz);
  const float pz = dot3(r02, r12, r22, dx, dy, dz);
  const bool in_front = pz > 0.0f;
  const float safe_z = in_front ? pz : 1.0f;

  // ---- the nearest pixel: +0.5 and an int cast (truncation toward zero)
  const float fx = p.K[0], cx = p.K[2], fy = p.K[4], cy = p.K[5];
  const int u = static_cast<int>(fadd(fadd(cx, fdiv(fmul(fx, pcx), safe_z)), 0.5f));
  const int v = static_cast<int>(fadd(fadd(cy, fdiv(fmul(fy, pcy), safe_z)), 0.5f));
  const bool in_img = (u >= 0) & (u < p.W) & (v >= 0) & (v < p.H);
  const int uc = min(max(u, 0), p.W - 1);
  const int vc = min(max(v, 0), p.H - 1);
  const int64_t pix = static_cast<int64_t>(vc) * p.W + uc;
  const float4 lo = p.pix[2 * pix];        // depth, normal
  const float4 hi = p.pix[2 * pix + 1];    // colour, 1/n^2
  const float z = lo.x, nx = lo.y, ny = lo.z, nz = lo.w;

  const bool z_ok = (z > p.zmin) & (z < p.zmax);
  const float sdf = fsub(z, pz);
  // fusion_weight: 1 in front, 1 + sdf/T on [-T, 0), 0 behind
  const float w = sdf >= 0.0f ? 1.0f
      : (sdf >= p.neg_trunc ? fadd(1.0f, fmul(sdf, p.inv_trunc)) : 0.0f);
  const bool n_valid = fadd(fadd(fmul(nx, nx), fmul(ny, ny)), fmul(nz, nz)) >= 0.1f;
  const float ndot = fadd(fadd(fmul(nx, fdiv(pcx, safe_z)), fmul(ny, fdiv(pcy, safe_z))),
                          fmul(nz, fdiv(pz, safe_z)));
  const bool angle_ok = fmul(fmul(ndot, ndot), hi.w) >= p.cos_sq;

  bool mask = in_front & in_img & z_ok & (w > 0.0f) & n_valid & angle_ok;
  if (p.gate != nullptr) mask = mask & (p.gate[slot * p.gate_stride] != 0);
  const float wm = mask ? w : 0.0f;

  // ---- the running means, in place
  float* dp = p.dist + slot * p.dist_rs + j * p.dist_vs;
  float* wp = p.weight + slot * p.weight_rs + j * p.weight_vs;
  float* gp = p.grad + slot * p.grad_rs + j * p.grad_vs;
  float* cp = p.color + slot * p.color_rs + j * p.color_vs;
  const float dist = *dp;
  const float new_weight = fadd(*wp, wm);
  const float safe_w = clamp_min(new_weight, 1e-12f);
  const float tr_sdf = clamp2(sdf, p.neg_trunc, p.trunc);
  *dp = fadd(dist, fdiv(fmul(fsub(tr_sdf, dist), wm), safe_w));
  *wp = new_weight;
  // the normals point inward: -w R n
  gp[0] = fsub(gp[0], fmul(wm, dot3(r00, r01, r02, nx, ny, nz)));
  gp[1] = fsub(gp[1], fmul(wm, dot3(r10, r11, r12, nx, ny, nz)));
  gp[2] = fsub(gp[2], fmul(wm, dot3(r20, r21, r22, nx, ny, nz)));
  const float q = fdiv(wm, safe_w);
  cp[0] = fadd(cp[0], fmul(fsub(hi.x, cp[0]), q));
  cp[1] = fadd(cp[1], fmul(fsub(hi.y, cp[1]), q));
  cp[2] = fadd(cp[2], fmul(fsub(hi.z, cp[2]), q));
  if (mask && p.vis != nullptr) p.vis[slot * p.vis_rs + j * p.vis_vs] |= p.bit;
}

}  // namespace

extern "C" int fuse_rows(const FuseArgs* a, void* stream) {
  FuseParams p;
  p.dist = a->dist;      p.dist_rs = a->dist_rs;      p.dist_vs = a->dist_vs;
  p.grad = a->grad;      p.grad_rs = a->grad_rs;      p.grad_vs = a->grad_vs;
  p.weight = a->weight;  p.weight_rs = a->weight_rs;  p.weight_vs = a->weight_vs;
  p.color = a->color;    p.color_rs = a->color_rs;    p.color_vs = a->color_vs;
  p.vis = a->vis;        p.vis_rs = a->vis_rs;        p.vis_vs = a->vis_vs;
  p.rows = a->rows;
  p.live = a->live;
  p.gate = a->gate;      p.gate_stride = a->gate_stride;
  p.z_map = a->z_map;    p.z_map_len = a->z_map_len;
  p.pix = reinterpret_cast<const float4*>(a->pix);
  p.K = a->K;
  p.pose = a->pose;
  p.cap = a->cap;
  p.total = a->cap * a->S;
  p.S = static_cast<int>(a->S);
  p.NS = static_cast<int>(a->NS);
  p.Y = static_cast<int>(a->Y);
  p.H = static_cast<int>(a->H);
  p.W = static_cast<int>(a->W);
  p.bit = static_cast<int>(a->bit);
  p.has_z0 = static_cast<int>(a->has_z0);
  p.z0 = static_cast<float>(a->z0);
  p.ox = static_cast<float>(a->origin_x);
  p.oy = static_cast<float>(a->origin_y);
  p.oz = static_cast<float>(a->origin_z);
  p.h = static_cast<float>(a->voxel);
  p.trunc = static_cast<float>(a->truncation);
  p.neg_trunc = static_cast<float>(-a->truncation);
  // PyTorch divides a CUDA tensor by a Python number as a product with the
  // float32 reciprocal, computed on the host in float
  p.inv_trunc = 1.0f / p.trunc;
  p.zmin = static_cast<float>(a->zmin);
  p.zmax = static_cast<float>(a->zmax);
  p.cos_sq = static_cast<float>(a->cos_thresh_sq);
  if (p.total > 0) {
    const int64_t blocks = (p.total + kThreads - 1) / kThreads;
    fuse_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
