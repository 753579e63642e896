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
// Work assignment.  The host plans tiles (ops/residual.py `_tile_plan`): a
// tile is V consecutive voxels x all F frames (V F <= P pairs), or, where F
// exceeds P, one voxel x a range of P frames.  A tile's pairs are then ONE
// contiguous span of the [N, F] pairs.  The grid is persistent: the SMs
// times the blocks an SM holds, each block walking tiles blockIdx.x,
// + gridDim.x, ...  A block is 8 consumer warps and 2 service warps.
// Shared memory holds two buffers of the frame terms (and of the pass's
// staged outputs) and four of the voxel terms; service warp s owns buffer s
// (and voxel-term buffers s and s + 2) and the block's tiles s, s + 2, ...,
// and hands them over through two mbarriers a buffer, "full" and "done":
//   * for its next tile, service warp s computes the tile's voxel terms
//     (the surface point, the FD normal and its SH basis, the stencil's
//     normal Jacobians, dx/dd, dSH, the LED terms), a lane a voxel, into
//     its voxel-term buffer that the consumers do not read, while they may
//     still read its last tile's; once they are done with that tile, the
//     pass's service warp writes its staged outputs out, each output
//     span's 16-byte-aligned body with one bulk copy (cp.async.bulk ...
//     bulk_group), its head and tail byte by byte; then it writes a
//     frame's terms (its rotation, translation and SH light), a lane a
//     frame, once where every tile has all frames, and arrives on "full"
//     (the pass's once the bulk stores have read the staging buffer,
//     cp.async.bulk.wait_group.read);
//   * the consumers, meanwhile on the other buffer's tile, take a tile's
//     pairs; a voxel's and a frame's terms are reads of rows of odd stride
//     (broadcast or free of bank conflicts); then each consumer warp
//     arrives on "done".  In the pass consecutive threads take
//     consecutive voxels of one frame (a warp's pixel reads fall in a few
//     images) and each pair's outputs go into the staging buffer laid out
//     exactly as the global spans (at each span's address modulo 16), so
//     the lane map does not set how the stores coalesce.  In the Jacobian
//     consecutive threads take consecutive frames of one voxel, so a
//     warp's p_cam and g_img loads and its J0, Ji and G stores are runs of
//     consecutive pairs, and each thread loads and stores its own pairs:
//     staging them (bulk loads of the inputs, bulk stores of the outputs)
//     measured slower on an H100 (PERF.md).
// No consumer waits on a block barrier: only on its next buffer being full.
// The plan sizes the tiles and asks for the shared-memory carveout of the
// blocks an SM it wants, leaving the rest to the L1 cache: the pass's
// 3x3 patches are 8 scattered pixel reads a pair (3 4-byte loads a pixel
// from the [F,H,W,3] images), about half its time on an H100.
//
// Rounding: every operation is written with the _rn intrinsics in the plain
// version's order (the sums over an axis of 3 as (a0 b0 + a1 b1) + a2 b2,
// the SH sums from coefficient 0 up, no contraction into FMAs), and two of
// PyTorch's conventions on a CUDA tensor are kept: a tensor divided by a
// Python number is multiplied by the number's float32 reciprocal (x / h, r /
// lambda), and a Python number divided by a tensor is the tensor's
// reciprocal times the number (1 / z, lambda / |r|).  So the kernels equal
// the plain versions on the card bit for bit, whatever the tiles.  Pixel
// indices are floor() and an integer conversion, as `.long()` (NaN to 0):
// a pair at or behind the camera plane (|z| <= 1e-12 divides by 1e-12)
// reaches |u| ~ 1e15, so floor(u) is clamped to a margin around the image
// before the 32-bit conversion, which changes no clipped index.
//
// Bound on the card: bytes.  residual_pass writes 69 bytes a pair (r, w,
// p_cam: 12 each; uv 8; g_img 24; mask 1), reads vis (1 byte a pair), the
// per-voxel inputs once and the distinct pixels the patches touch once;
// about 200 flops a pair.  dist_jacobian reads p_cam and g_img (36 bytes a
// pair) and writes J0 and Ji (48; G 36 more); about 250 flops a pair.  The
// design moves the pass's stores as bulk copies of whole spans and reads
// every per-voxel and per-frame term from shared memory; the pixel reads at
// scattered addresses, and the _rn arithmetic that the bit-for-bit contract
// fixes, stay.
//
// Plain C interface (loaded with ctypes): residual_pass() and
// dist_jacobian() launch on the stream they are given, do not synchronise,
// allocate nothing and return the CUDA error as an int (a refused
// shared-memory attribute or launch included); residual_blocks_per_sm()
// reports the blocks an SM holds at a plan's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil.cuh"

// The host's tile plan (ops/residual.py `_tile_plan`): byte offsets into a
// block's dynamic shared memory, which starts with four mbarriers; four
// buffers of the voxel terms, two of the frame terms and staged outputs.
struct TilePlan {
  int64_t voxels;       // V: voxels a tile (1 for a frame-range tile)
  int64_t frames;       // FT: frames a tile (F, or a range of them when V = 1)
  int64_t tiles;        // ceil(N / V) * ceil(F / FT)
  int64_t smem_bytes;   // dynamic shared memory a block
  int64_t vox;          // the voxel terms
  int64_t vox_bytes;
  int64_t frm;          // the frame terms
  int64_t frm_bytes;
  int64_t stage;        // residual_pass: the staged outputs
  int64_t stage_bytes;
  int64_t out[6];       // each output's region in a staging buffer
  int64_t carveout;     // the shared-memory carveout asked for, percent of
                        // the SM's maximum (it sets the blocks an SM holds
                        // and leaves the rest to the L1 cache)
};

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
  TilePlan plan;
  // the grid's voxel size, which places the voxel centres (geom.voxel2world);
  // `voxel` is the finite differences' step (the caller's voxel_size).  The
  // refinement's loop keeps the step it started with past the upsample, as
  // the JAX package's does, while the grid halves
  double grid_voxel;
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
  TilePlan plan;
};

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 64;   // and the two service warps
constexpr int kResVox = 17;        // floats a voxel's residual terms take (16 used)
constexpr int kJacVox = 53;        // floats a voxel's Jacobian terms take (51 used)
constexpr int kFrameFloats = 21;   // a frame's terms: R 9, t 3, the SH light (up to 9)

// loss ids of utils/robust.py
constexpr int kCauchy = 1, kHuber = 2, kTukey = 3, kTruncL2 = 4;   // else L2

// The block's mbarriers, one of each a buffer: full (the service warp's
// terms are in, and the pass's staging buffer is free), done (the consumers
// have read the terms and written the tile's outputs: staged them, in the
// pass).
struct Barriers {
  uint64_t full[2], done[2];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count);

// thread 0: full counts the service warp's 32 lanes, done one a consumer
// warp
__device__ __forceinline__ void init_barriers(Barriers& bar) {
  for (int b = 0; b < 2; ++b) {
    mbar_init(&bar.full[b], 32);
    mbar_init(&bar.done[b], kConsumerWarps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// ------------------------------------------------ barriers and bulk copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Buffer use j (0, 1, 2, ...) takes buffer j & 1; its phase of a barrier
// completes with parity (j >> 1) & 1, and the use before it on the same
// buffer (j - 2) with the other parity.
__device__ __forceinline__ uint32_t parity(int j) { return (j >> 1) & 1; }

// shared memory written by threads, made visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* g, const void* s, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(g),
               "r"(smem_addr(s)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// the committed bulk stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// A span [g, g + bytes) splits into a head up to the first 16-byte boundary,
// a body of whole 16-byte chunks (one bulk copy) and a tail.
__device__ __forceinline__ void span_parts(const void* g, int64_t bytes, int64_t& head,
                                           int64_t& body) {
  head = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15);
  if (head > bytes) head = bytes;
  body = (bytes - head) & ~static_cast<int64_t>(15);
}

// where the span starting at g is staged in a region: at g's address
// modulo 16, so that the bodies of both are 16-byte aligned
template <typename T>
__device__ __forceinline__ T* staged(unsigned char* smem, int64_t region, T* g) {
  return reinterpret_cast<T*>(smem + region + (reinterpret_cast<uintptr_t>(g) & 15));
}

// A staged span written out by a service warp: the body by one bulk copy of
// lane 0, the head and tail byte by byte.
__device__ __forceinline__ void store_span(void* gv, const void* sv, int64_t bytes, int lane) {
  unsigned char* g = static_cast<unsigned char*>(gv);
  const unsigned char* s = static_cast<const unsigned char*>(sv);
  int64_t head, body;
  span_parts(g, bytes, head, body);
  if (lane == 0 && body > 0) bulk_store(g + head, s + head, static_cast<uint32_t>(body));
  const int64_t edges = bytes - body;
  for (int64_t i = lane; i < edges; i += 32) {
    const int64_t k = i < head ? i : i + body;
    g[k] = s[k];
  }
}

// ------------------------------------------------------------------ tiles

struct Tile {
  int64_t n0;     // first voxel
  int nv;         // voxels
  int f0;         // first frame
  int nf;         // frames
  int pairs;      // nv * nf
  int64_t first;  // the first pair, n0 * F + f0: the tile's pairs are the
                  // span [first, first + pairs) of the [N, F] pairs
};

// tile t of the plan: voxel group t / ceil(F / FT), frame range t mod it
__device__ __forceinline__ Tile tile_at(const TilePlan& plan, int64_t N, int64_t F, int64_t t) {
  const int64_t frame_tiles = (F + plan.frames - 1) / plan.frames;
  const int64_t g = t / frame_tiles;
  Tile tl;
  tl.n0 = g * plan.voxels;
  tl.nv = static_cast<int>(N - tl.n0 < plan.voxels ? N - tl.n0 : plan.voxels);
  tl.f0 = static_cast<int>((t - g * frame_tiles) * plan.frames);
  tl.nf = static_cast<int>(F - tl.f0 < plan.frames ? F - tl.f0 : plan.frames);
  tl.pairs = tl.nv * tl.nf;
  tl.first = tl.n0 * F + tl.f0;
  return tl;
}

// The consumers' lane map: the tile's pair q -> its voxel v and frame
// offset fl, consecutive threads on consecutive voxels of one frame
// (voxel-fastest) or on consecutive frames of one voxel.  The residual
// pass takes the first (a warp's pixel reads fall in a few images, its
// frame terms are one broadcast; the faster on an H100), the Jacobian the
// second (a warp's loads and stores are runs of consecutive pairs).
template <bool kVoxelFastest>
__device__ __forceinline__ void pair_of(int q, const Tile& tl, int& v, int& fl) {
  if (kVoxelFastest) {
    fl = q / tl.nv;
    v = q - fl * tl.nv;
  } else {
    v = q / tl.nf;
    fl = q - v * tl.nf;
  }
}

// a block's buffer `b` of a region
__device__ __forceinline__ unsigned char* buffer(unsigned char* smem, int64_t region,
                                                 int64_t bytes, int b) {
  return smem + region + b * bytes;
}

// the voxel terms of the block's tile j: four buffers, so that a service
// warp writes a tile's while the consumers read its buffer's last tile's
constexpr int kVoxBuffers = 4;

__device__ __forceinline__ unsigned char* vox_buffer(unsigned char* smem, const TilePlan& plan,
                                                     int64_t j) {
  return buffer(smem, plan.vox, plan.vox_bytes, static_cast<int>(j % kVoxBuffers));
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
  float out = fmul(c[0], l[0]);
  for (int b = 1; b < B; ++b) out = fadd(out, fmul(c[b], l[b]));
  return out;
}

// a frame's terms (kFrameFloats): the pose's rotation rows R [0:9] and
// translation t [9:12], and under SH the frame's light [12:12 + B]
__device__ __forceinline__ void frame_terms(const float* poses, const float* lights, int B,
                                            bool sh, int64_t f, float* out) {
  const float* P = poses + 16 * f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = __ldg(P + 4 * i);
    out[3 * i + 1] = __ldg(P + 4 * i + 1);
    out[3 * i + 2] = __ldg(P + 4 * i + 2);
    out[9 + i] = __ldg(P + 4 * i + 3);
  }
  if (sh) {
    for (int b = 0; b < B; ++b) out[12 + b] = __ldg(lights + f * B + b);
  }
}

// a tile's frame terms, a lane a frame
__device__ __forceinline__ void tile_frame_terms(const float* poses, const float* lights, int B,
                                                 bool sh, const Tile& tl, float* frm, int lane) {
  for (int fl = lane; fl < tl.nf; fl += 32)
    frame_terms(poses, lights, B, sh, tl.f0 + fl, frm + fl * kFrameFloats);
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

// ---------------------------------------------------------------- residuals

// ---------------------------------------------------------------- residuals

struct ResidualParams {
  ResidualArgs a;
  int B;
  float ox, oy, oz, h, inv_h, inv_lam, lam, lam_sq;
};

// a voxel's residual terms: x[0:3], the SH basis (SH) or the FD normal (LED)
// [3:12], rho (SH) or rho * light (LED) [12:15], valid [15]
__device__ __forceinline__ void residual_voxel_terms(const ResidualParams& p, int64_t n,
                                                     float* s) {
  const ResidualArgs& a = p.a;
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

// one pair's outputs
struct PairOut {
  float r[3], w[3], pc[3], u, v, g[6];
  bool m;
};

// the residual pass of pair `pair` (keyframe f) from its voxel's terms s
// and its frame's terms fr
__device__ __forceinline__ void residual_pair(const ResidualParams& p, const float* s,
                                              const float* fr, int64_t pair, int f, float fx,
                                              float cx, float fy, float cy, PairOut& o) {
  const ResidualArgs& a = p.a;
  const int H = static_cast<int>(a.H), W = static_cast<int>(a.W);
  const float Hf = static_cast<float>(H), Wf = static_cast<float>(W);

  // ---- the projection (world_to_cam, project_to_frames)
  const float* R = fr;
  const float* t = fr + 9;
  const float dx[3] = {fsub(s[0], t[0]), fsub(s[1], t[1]), fsub(s[2], t[2])};
  float pc[3];
  rot(R, dx, true, pc);
  const float z = pc[2];
  const float safe_z = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float u = fadd(fdiv(fmul(fx, pc[0]), safe_z), cx);
  const float vv = fadd(fdiv(fmul(fy, pc[1]), safe_z), cy);
  const bool in_img = (u >= 0.0f) & (u < Wf) & (vv >= 0.0f) & (vv < Hf);

  // ---- the 3x3 patch (fetch_patches): rows clip(r0 - 1 + i), columns
  // clip(c0c - 1 + j) around c0c = clip(c0).  r0 = floor(v) and c0 =
  // floor(u) as `.long()` gives them (NaN to 0), clamped to [-2, H + 1] and
  // [-2, W + 1]: every clipped row and column and both edge flags are those
  // of the unclamped 64-bit integers, and fit 32 bits
  const float r0f = floorf(vv), c0f = floorf(u);
  const int r0 = isnan(r0f) ? 0 : static_cast<int>(fminf(fmaxf(r0f, -2.0f), Hf + 1.0f));
  const int c0 = isnan(c0f) ? 0 : static_cast<int>(fminf(fmaxf(c0f, -2.0f), Wf + 1.0f));
  const int c0c = c0 < 0 ? 0 : (c0 > W - 1 ? W - 1 : c0);
  int rows[3], cols[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int rr = r0 - 1 + i;
    rows[i] = rr < 0 ? 0 : (rr > H - 1 ? H - 1 : rr);
    const int cc = c0c - 1 + i;
    cols[i] = cc < 0 ? 0 : (cc > W - 1 ? W - 1 : cc);
  }
  // P[i][j] for the eight entries _patch_math reads (P[0][0] is unused)
  float P[3][3][3];
  const float* img = a.images + static_cast<int64_t>(f) * H * W * 3;
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
  const float fr_ = fsub(vv, r0f), fc = fsub(u, c0f);
  const float omfr = fsub(1.0f, fr_), omfc = fsub(1.0f, fc);
  const bool row_ok = r0 + 1 < H, col_ok = c0 + 1 < W;
  const bool both = row_ok & col_ok;
  float I[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = P[1][1][c], v01 = P[1][2][c], v10 = P[2][1][c],
                v11 = P[2][2][c];
    const float full = fadd(fmul(omfc, fadd(fmul(fr_, v10), fmul(omfr, v00))),
                            fmul(fc, fadd(fmul(fr_, v11), fmul(omfr, v01))));
    const float col_only = fadd(fmul(omfc, v00), fmul(fc, v01));
    const float row_only = fadd(fmul(fr_, v10), fmul(omfr, v00));
    I[c] = both ? full : (col_ok ? col_only : (row_ok ? row_only : v00));
    // d/d col
    const float d_r0 = fsub(v01, v00), d_r1 = fsub(v11, v10);
    const float b_r0 = fsub(v00, P[1][0][c]), b_r1 = fsub(v10, P[2][0][c]);
    const float blended = fadd(fmul(omfr, d_r0), fmul(fr_, d_r1));
    const float blended_back = fadd(fmul(omfr, b_r0), fmul(fr_, b_r1));
    o.g[2 * c] = both ? blended : (!row_ok ? d_r0 : blended_back);
    // d/d row
    const float d_c0 = fsub(v10, v00), d_c1 = fsub(v11, v01);
    const float b_c0 = fsub(v00, P[0][1][c]), b_c1 = fsub(v01, P[0][2][c]);
    const float blended_v = fadd(fmul(omfc, d_c0), fmul(fc, d_c1));
    const float blended_back_v = fadd(fmul(omfc, b_c0), fmul(fc, b_c1));
    o.g[2 * c + 1] = both ? blended_v : (!col_ok ? d_c0 : blended_back_v);
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
    shade = irradiance(s + 3, fr + 12, p.B);
  }

  // ---- mask, residual, weight
  const bool m = a.vis[pair] && in_img && s[15] != 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rc = m ? fsub(I[c], fmul(s[12 + c], shade)) : 0.0f;
    o.r[c] = rc;
    o.w[c] = m ? irls(rc, static_cast<int>(a.loss), p.inv_lam, p.lam, p.lam_sq) : 0.0f;
  }
  o.m = m;
  o.pc[0] = pc[0]; o.pc[1] = pc[1]; o.pc[2] = pc[2];
  o.u = u;
  o.v = vv;
}

// a tile's outputs in staging buffer `stage`, each laid out as its global
// span
struct ResidualOut {
  float* r;
  float* w;
  unsigned char* m;
  float* pc;
  float2* uv;
  float2* g;
};

__device__ __forceinline__ ResidualOut residual_out(const ResidualArgs& a, const TilePlan& plan,
                                                    unsigned char* stage, int64_t first) {
  ResidualOut o;
  o.r = staged(stage, plan.out[0], a.r + 3 * first);
  o.w = staged(stage, plan.out[1], a.w + 3 * first);
  o.m = staged(stage, plan.out[2], a.mask + first);
  o.pc = staged(stage, plan.out[3], a.p_cam + 3 * first);
  o.uv = reinterpret_cast<float2*>(staged(stage, plan.out[4], a.uv + 2 * first));
  o.g = reinterpret_cast<float2*>(staged(stage, plan.out[5], a.g_img + 6 * first));
  return o;
}

// service warp: write a staged tile's spans out (lane 0 commits the bulk
// copies as one group)
__device__ __forceinline__ void store_residual_tile(const ResidualArgs& a, const TilePlan& plan,
                                                    unsigned char* stage, const Tile& tl,
                                                    int lane) {
  const ResidualOut o = residual_out(a, plan, stage, tl.first);
  const int64_t n = tl.pairs, first = tl.first;
  store_span(a.r + 3 * first, o.r, 12 * n, lane);
  store_span(a.w + 3 * first, o.w, 12 * n, lane);
  store_span(a.mask + first, o.m, n, lane);
  store_span(a.p_cam + 3 * first, o.pc, 12 * n, lane);
  store_span(a.uv + 2 * first, o.uv, 8 * n, lane);
  store_span(a.g_img + 6 * first, o.g, 24 * n, lane);
  if (lane == 0) bulk_commit();
}

__global__ void __launch_bounds__(kThreads)
residual_pass_kernel(const __grid_constant__ ResidualParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ResidualArgs& a = p.a;
  const TilePlan& plan = a.plan;
  Barriers& bar = *reinterpret_cast<Barriers*>(smem);
  if (threadIdx.x == 0) init_barriers(bar);
  __syncthreads();
  const int64_t F = a.F;
  const int64_t step = gridDim.x;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= kConsumers) {
    // ---- service warp s: the block's tiles s, s + 2, ... in buffer s
    const int s = (threadIdx.x - kConsumers) >> 5;
    unsigned char* stage = buffer(smem, plan.stage, plan.stage_bytes, s);
    float* frm = reinterpret_cast<float*>(buffer(smem, plan.frm, plan.frm_bytes, s));
    for (int64_t t = blockIdx.x + s * step, j = s;; t += 2 * step, j += 2) {
      if (t < plan.tiles) {
        // the tile's voxel terms, a lane a voxel, while the consumers may
        // still read the buffer's last tile's (the other of its two)
        const Tile tl = tile_at(plan, a.N, F, t);
        float* vox = reinterpret_cast<float*>(vox_buffer(smem, plan, j));
        for (int v = lane; v < tl.nv; v += 32) residual_voxel_terms(p, tl.n0 + v, vox + v * kResVox);
      }
      if (j >= 2) {
        // the buffer's last tile, read and staged by the consumers: out
        mbar_wait(&bar.done[s], parity(j - 2));
        store_residual_tile(a, plan, stage, tile_at(plan, a.N, F, t - 2 * step), lane);
      }
      if (t >= plan.tiles) break;
      if (j < 2 || plan.frames < F)
        tile_frame_terms(a.poses, a.lights, p.B, !a.led, tile_at(plan, a.N, F, t), frm, lane);
      if (lane == 0 && j >= 2) bulk_wait_read();
      __syncwarp();
      mbar_arrive(&bar.full[s]);
    }
    if (lane == 0) bulk_wait();
    return;
  }

  // ---- the consumers: a tile's pairs into its staging buffer
  const int ctid = threadIdx.x;
  const float fx = __ldg(a.K), cx = __ldg(a.K + 2), fy = __ldg(a.K + 4), cy = __ldg(a.K + 5);
  int j = 0;
  for (int64_t t = blockIdx.x; t < plan.tiles; t += step, ++j) {
    const int b = j & 1;
    const Tile tl = tile_at(plan, a.N, F, t);
    const ResidualOut o =
        residual_out(a, plan, buffer(smem, plan.stage, plan.stage_bytes, b), tl.first);
    const float* vox = reinterpret_cast<const float*>(vox_buffer(smem, plan, j));
    const float* frm = reinterpret_cast<const float*>(buffer(smem, plan.frm, plan.frm_bytes, b));
    mbar_wait(&bar.full[b], parity(j));
    for (int q = ctid; q < tl.pairs; q += kConsumers) {
      int v, fl;
      pair_of<true>(q, tl, v, fl);
      const int qs = v * tl.nf + fl;
      PairOut po;
      residual_pair(p, vox + v * kResVox, frm + fl * kFrameFloats, tl.first + qs, tl.f0 + fl,
                    fx, cx, fy, cy, po);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o.r[3 * qs + c] = po.r[c];
        o.w[3 * qs + c] = po.w[c];
        o.pc[3 * qs + c] = po.pc[c];
      }
      o.m[qs] = po.m ? 1 : 0;
      o.uv[qs] = make_float2(po.u, po.v);
#pragma unroll
      for (int c = 0; c < 3; ++c) o.g[3 * qs + c] = make_float2(po.g[2 * c], po.g[2 * c + 1]);
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.done[b]);
  }
}

// ------------------------------------------------------ the distance Jacobian

struct JacobianParams {
  JacobianArgs a;
  int B;
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
static_assert(kShi + 27 < kJacVox && kT2 + 4 < kJacVox, "voxel terms");

__device__ __forceinline__ void jacobian_voxel_terms(const JacobianParams& p, int64_t n,
                                                     float* s) {
  const JacobianArgs& a = p.a;
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

// the distance Jacobian of a pair from its p_cam, g_img, its voxel's terms
// s and its frame's terms fr -> G, J0 and the three Ji rows
__device__ __forceinline__ void jacobian_pair(const JacobianParams& p, const float* s,
                                              const float* fr, const float* pc,
                                              const float* gi, float fx, float fy,
                                              float G[3][3], float J0[3], float Ji[3][3]) {
  const JacobianArgs& a = p.a;
  // ---- G = dI/dx_cam (image_pi_grad)
  const float z = pc[2];
  const float z_inv = frcp(fabsf(z) > 1e-12f ? z : 1e-12f);
  const float z_inv_sq = fmul(z_inv, z_inv);
  const float ax_u = fmul(fx, z_inv), ax_v = fmul(fy, z_inv);
  const float az_u = fmul(fmul(fx, pc[0]), z_inv_sq);
  const float az_v = fmul(fmul(fy, pc[1]), z_inv_sq);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gu = gi[2 * c], gv = gi[2 * c + 1];
    G[c][0] = fmul(gu, ax_u);
    G[c][1] = fmul(gv, ax_v);
    G[c][2] = -fadd(fmul(gu, az_u), fmul(gv, az_v));
  }
  // ---- G R^T, then the reprojection part dI = (G R^T) dx
  const float* R = fr;
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
#pragma unroll
      for (int c = 0; c < 3; ++c) Ji[ax][c] = fadd(dIi[ax][c], fmul(s[kRho + c], dmi));
    }
  } else {
    const float* l = fr + 12;
    float dS0, dSi[3];
    if (p.B == 4) {
      // l[1:4] . dn
      dS0 = dot3(s + kDn0, l + 1);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) dSi[ax] = dot3(s + kDni + 3 * ax, l + 1);
    } else {
      dS0 = irradiance(s + kSh0, l, 9);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) dSi[ax] = irradiance(s + kShi + 9 * ax, l, 9);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) J0[c] = fsub(dI0[c], fmul(s[kRho + c], dS0));
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
      for (int c = 0; c < 3; ++c) Ji[ax][c] = fsub(dIi[ax][c], fmul(s[kRho + c], dSi[ax]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dist_jacobian_kernel(const __grid_constant__ JacobianParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const JacobianArgs& a = p.a;
  const TilePlan& plan = a.plan;
  Barriers& bar = *reinterpret_cast<Barriers*>(smem);
  if (threadIdx.x == 0) init_barriers(bar);
  __syncthreads();
  const int64_t F = a.F;
  const int64_t step = gridDim.x;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= kConsumers) {
    // ---- service warp s: the block's tiles s, s + 2, ... in buffer s
    const int s = (threadIdx.x - kConsumers) >> 5;
    float* frm = reinterpret_cast<float*>(buffer(smem, plan.frm, plan.frm_bytes, s));
    for (int64_t t = blockIdx.x + s * step, j = s; t < plan.tiles; t += 2 * step, j += 2) {
      // the tile's voxel terms, a lane a voxel, while the consumers may
      // still read the buffer's last tile's (the other of its two)
      const Tile tl = tile_at(plan, a.N, F, t);
      float* vox = reinterpret_cast<float*>(vox_buffer(smem, plan, j));
      for (int v = lane; v < tl.nv; v += 32) jacobian_voxel_terms(p, tl.n0 + v, vox + v * kJacVox);
      // the frame terms, once the consumers are done with the buffer's last
      // tile
      if (j >= 2) mbar_wait(&bar.done[s], parity(j - 2));
      if (j < 2 || plan.frames < F) tile_frame_terms(a.poses, a.lights, p.B, !a.led, tl, frm, lane);
      mbar_arrive(&bar.full[s]);
    }
    return;
  }

  // ---- the consumers: a tile's pairs, each loaded and stored by its thread
  const int ctid = threadIdx.x;
  const float fx = __ldg(a.K), fy = __ldg(a.K + 4);
  const bool with_G = a.G != nullptr;
  int j = 0;
  for (int64_t t = blockIdx.x; t < plan.tiles; t += step, ++j) {
    const int b = j & 1;
    const Tile tl = tile_at(plan, a.N, F, t);
    const float* vox = reinterpret_cast<const float*>(vox_buffer(smem, plan, j));
    const float* frm = reinterpret_cast<const float*>(buffer(smem, plan.frm, plan.frm_bytes, b));
    mbar_wait(&bar.full[b], parity(j));
    for (int q = ctid; q < tl.pairs; q += kConsumers) {
      int v, fl;
      pair_of<false>(q, tl, v, fl);
      const int64_t pair = tl.first + q;   // frame-fastest: q = v nf + fl
      const float pc[3] = {__ldg(a.p_cam + 3 * pair), __ldg(a.p_cam + 3 * pair + 1),
                           __ldg(a.p_cam + 3 * pair + 2)};
      float gi[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) gi[c] = __ldg(a.g_img + 6 * pair + c);
      float G[3][3], J0[3], Ji[3][3];
      jacobian_pair(p, vox + v * kJacVox, frm + fl * kFrameFloats, pc, gi, fx, fy, G, J0, Ji);
#pragma unroll
      for (int c = 0; c < 3; ++c) a.J0[3 * pair + c] = J0[c];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float* ji = a.Ji + (((tl.n0 + v) * 3 + ax) * F + tl.f0 + fl) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) ji[c] = Ji[ax][c];
      }
      if (with_G) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int y = 0; y < 3; ++y) a.G[9 * pair + 3 * c + y] = G[c][y];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&bar.done[b]);
  }
}

// The grid of a persistent kernel: the SMs times the blocks an SM holds at
// the plan's shared memory (raised above the 48 KB default first), at most
// the tiles.  A refused attribute returns its error.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, const TilePlan& plan, unsigned* grid,
                            int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem_bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             static_cast<int>(plan.carveout));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads,
                                                      static_cast<size_t>(plan.smem_bytes));
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();   // not left behind for a later launch to report
    return e;
  }
  int64_t g = static_cast<int64_t>(sms) * *per_sm;
  if (g > plan.tiles) g = plan.tiles;
  *grid = static_cast<unsigned>(g);
  return cudaSuccess;
}

}  // namespace

extern "C" int residual_pass(const ResidualArgs* a, void* stream) {
  ResidualParams p;
  p.a = *a;
  p.B = a->led ? 3 : static_cast<int>(a->basis);
  p.ox = static_cast<float>(a->origin_x);
  p.oy = static_cast<float>(a->origin_y);
  p.oz = static_cast<float>(a->origin_z);
  p.h = static_cast<float>(a->grid_voxel);
  // PyTorch divides a CUDA tensor by a Python number as a product with the
  // float32 reciprocal, computed on the host in float
  p.inv_h = 1.0f / static_cast<float>(a->voxel);
  p.lam = static_cast<float>(a->lam);
  p.inv_lam = 1.0f / p.lam;
  // r^2 < lam * lam: the product in double, compared in float
  p.lam_sq = static_cast<float>(a->lam * a->lam);
  if (a->N > 0 && a->F > 0) {
    unsigned grid = 0;
    int per_sm = 0;
    const cudaError_t e = persistent_grid(residual_pass_kernel, a->plan, &grid, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    residual_pass_kernel<<<grid, kThreads, static_cast<size_t>(a->plan.smem_bytes),
                           static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dist_jacobian(const JacobianArgs* a, void* stream) {
  JacobianParams p;
  p.a = *a;
  p.B = a->led ? 3 : static_cast<int>(a->basis);
  p.inv_h = 1.0f / static_cast<float>(a->voxel);
  if (a->N > 0 && a->F > 0) {
    unsigned grid = 0;
    int per_sm = 0;
    const cudaError_t e = persistent_grid(dist_jacobian_kernel, a->plan, &grid, &per_sm);
    if (e != cudaSuccess) return static_cast<int>(e);
    dist_jacobian_kernel<<<grid, kThreads, static_cast<size_t>(a->plan.smem_bytes),
                           static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The blocks an SM holds of residual_pass_kernel (kernel 0) or
// dist_jacobian_kernel (1) at a plan's shared memory and carveout.
extern "C" int residual_blocks_per_sm(int kernel, int64_t smem_bytes, int64_t carveout,
                                      int* per_sm) {
  TilePlan plan = {};
  plan.smem_bytes = smem_bytes;
  plan.carveout = carveout;
  plan.tiles = 1;
  unsigned grid = 0;
  const cudaError_t e = kernel == 0 ? persistent_grid(residual_pass_kernel, plan, &grid, per_sm)
                                    : persistent_grid(dist_jacobian_kernel, plan, &grid, per_sm);
  return static_cast<int>(e);
}
