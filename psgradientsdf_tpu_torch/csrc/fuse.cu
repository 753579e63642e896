// The per-voxel fusion update for Hopper (sm_90a): one launch per fused
// frame, a persistent grid that walks the live slots, one warp a slot.
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
// Work assignment: the grid is the SM count x the occupancy the runtime
// reports; each block reads *live once, and its warps walk the slots before
// it in a grid stride, so the padding slots cost nothing.  A warp takes one
// slot: the row's plane, row and segment are found once, in 32-bit
// arithmetic, and lane l takes the voxels j = l + 32k, kBatch of them at a
// time (their loads issued together, then their updates).
//
// State goes in and out IN PLACE through a pointer, a row stride and a
// voxel stride per field (the three components of grad and colour are
// consecutive), so one kernel serves the gathered SoA row blocks, the packed
// [CAP, S, 8] rows, the whole grid and the chunk-resident rows.  SoA fields
// are read and written a float a lane, coalesced across the warp.  A packed
// voxel (dist, grad, weight, colour in the 8 consecutive floats of one
// 32-byte row, 16-byte aligned) is read and written as two float4s, so a
// warp moves 1 KB in an instruction pair instead of eight stride-8 passes;
// the wrapper names that layout (kPacked).  The pixel row is read as two
// float4s through the read-only path.  The visibility pointer may be null
// (a K-batched fusion that drops the bits of a word that does not exist).
//
// The frame's visibility bit: a number the host gives (`bit`, the frame's
// word already picked as the vis rows of the slots), or, with `frame` set,
// the frame id read on the device, as the JAX package takes it traced
// (psgradientsdf_tpu/core/volume.py:529-531): `vis` is then the whole table
// [words, rows, S], the word frame / 32 (clamped to the table, as
// dynamic_index_in_dim clamps) is picked on the device and the slot's row
// read and written in place at its grid row r, the bit 1 << frame % 32.  A
// CUDA graph of the scan (tracking/graph.py) replays this form: nothing of
// the frame is frozen into the launch.  The live slots' rows are distinct,
// so no two warps touch one word.
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
// them back, and the pixel table is read at most once: 72 bytes a live
// voxel plus min(voxels, H*W) x 32, about 20 flops a voxel.  Frame 24 at
// 128^3 (5583 live rows of 128 voxels): 51.5 MB + 9.8 MB, 18.3 us at
// 3.35 TB/s.
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
  int64_t packed;    // 1: dist is the base of [cap, S, 8] rows, 16-byte aligned
  double z0, origin_x, origin_y, origin_z, voxel, truncation, zmin, zmax,
      cos_thresh_sq;
  const int32_t* frame;   // device frame id, or null: `bit` and vis by slot
  int64_t vis_ws;         // with frame: the table's word stride (elements)
  int64_t vis_words;      // with frame: the table's words
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 2;                 // voxels a lane loads together
constexpr int kMinBlocks = 2;             // blocks an SM holds, at least

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
  const float* z_map;  int z_map_len;
  const float4* pix;
  const float* K;
  const float* pose;
  int cap, S, NS, Y, YNS, H, W, bit, has_z0;
  float z0, ox, oy, oz, h, trunc, neg_trunc, inv_trunc, zmin, zmax, cos_sq;
  const int32_t* frame;  int64_t vis_ws;  int vis_words;
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

// a voxel's state: distance, gradient, weight, colour
struct Voxel {
  float d, g0, g1, g2, w, c0, c1, c2;
};

template <bool kPacked>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fuse_rows_kernel(const __grid_constant__ FuseParams p) {
  __shared__ int live_slots, frame_id;
  if (threadIdx.x == 0) {
    const int64_t l = p.live != nullptr ? *p.live : p.cap;
    live_slots = static_cast<int>(l < p.cap ? (l > 0 ? l : 0) : p.cap);
    frame_id = p.frame != nullptr ? *p.frame : 0;
  }
  __syncthreads();
  const int live = live_slots;
  // the frame's word and bit: the host's, or from the device frame id
  int32_t* vis_base = p.vis;
  int32_t bit = p.bit;
  if (p.frame != nullptr) {
    const int f = frame_id;
    int word = f >= 0 ? f >> 5 : -((-f + 31) >> 5);    // floor(f / 32)
    word = word < 0 ? 0 : (word < p.vis_words ? word : p.vis_words - 1);
    bit = static_cast<int32_t>(1u << (f & 31));        // f mod 32
    if (vis_base != nullptr) vis_base += static_cast<int64_t>(word) * p.vis_ws;
  }
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;

  const float* P = p.pose;
  const float r00 = P[0], r01 = P[1], r02 = P[2], tx = P[3];
  const float r10 = P[4], r11 = P[5], r12 = P[6], ty = P[7];
  const float r20 = P[8], r21 = P[9], r22 = P[10], tz = P[11];
  const float fx = p.K[0], cx = p.K[2], fy = p.K[4], cy = p.K[5];

  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the row id of the warp's next slot, read one slot ahead
  int next_r = first < live && p.rows != nullptr ? p.rows[first] : first;
  for (int slot = first; slot < live; slot += warps) {
    // ---- the row, once a warp (row_world_coords)
    const int r = next_r;
    if (p.rows != nullptr && slot + warps < live) next_r = p.rows[slot + warps];
    else next_r = slot + warps;
    const int rz_l = r / p.YNS;
    const int rest = r - rz_l * p.YNS;
    const int row_y = rest / p.NS;
    const int seg = rest - row_y * p.NS;
    float rz;
    if (p.z_map != nullptr) {
      rz = p.z_map[rz_l < p.z_map_len - 1 ? rz_l : p.z_map_len - 1];
    } else {
      rz = static_cast<float>(rz_l);
      if (p.has_z0) rz = fadd(rz, p.z0);
    }
    const float ry = static_cast<float>(row_y);
    const float seg_x = fmul(static_cast<float>(seg), static_cast<float>(p.S));
    const float pwy = fadd(p.oy, fmul(p.h, ry));
    const float pwz = fadd(p.oz, fmul(p.h, rz));
    const bool open = p.gate == nullptr ||
                      p.gate[static_cast<int64_t>(slot) * p.gate_stride] != 0;
    const int64_t s64 = slot;
    float* dist = p.dist + s64 * p.dist_rs;
    float* grad = p.grad + s64 * p.grad_rs;
    float* weight = p.weight + s64 * p.weight_rs;
    float* color = p.color + s64 * p.color_rs;
    // the slot's visibility row: gathered by slot, or the table's row r
    int32_t* vis = vis_base != nullptr
        ? vis_base + (p.frame != nullptr ? static_cast<int64_t>(r) : s64) * p.vis_rs
        : nullptr;

    // camera coordinates of voxel j: R^T (p - t)
    auto camera = [&](int j, float& pcx, float& pcy, float& pz) {
      const float rx = fadd(seg_x, static_cast<float>(j));
      const float pwx = fadd(p.ox, fmul(p.h, rx));
      const float dx = fsub(pwx, tx), dy = fsub(pwy, ty), dz = fsub(pwz, tz);
      pcx = dot3(r00, r10, r20, dx, dy, dz);
      pcy = dot3(r01, r11, r21, dx, dy, dz);
      pz = dot3(r02, r12, r22, dx, dy, dz);
    };
    for (int j0 = lane; j0 < p.S; j0 += 32 * kBatch) {
      float4 lo[kBatch], hi[kBatch];
      Voxel v[kBatch];
      int32_t word[kBatch];
      bool in_img[kBatch];
      // ---- geometry and the loads of kBatch voxels
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + 32 * b;
        if (j >= p.S) continue;
        float pcx, pcy, pz;
        camera(j, pcx, pcy, pz);
        const float safe_z = pz > 0.0f ? pz : 1.0f;
        // the nearest pixel: +0.5 and an int cast (truncation toward zero)
        const int u = static_cast<int>(fadd(fadd(cx, fdiv(fmul(fx, pcx), safe_z)), 0.5f));
        const int vv = static_cast<int>(fadd(fadd(cy, fdiv(fmul(fy, pcy), safe_z)), 0.5f));
        in_img[b] = (u >= 0) & (u < p.W) & (vv >= 0) & (vv < p.H);
        const int uc = min(max(u, 0), p.W - 1);
        const int vc = min(max(vv, 0), p.H - 1);
        const int pix = vc * p.W + uc;
        lo[b] = __ldg(p.pix + 2 * pix);       // depth, normal
        hi[b] = __ldg(p.pix + 2 * pix + 1);   // colour, 1/n^2
        if (kPacked) {
          const float4* s = reinterpret_cast<const float4*>(dist + 8 * j);
          const float4 a = s[0], c = s[1];
          v[b] = Voxel{a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
        } else {
          const float* gp = grad + j * p.grad_vs;
          const float* cp = color + j * p.color_vs;
          v[b] = Voxel{dist[j * p.dist_vs], gp[0], gp[1], gp[2],
                       weight[j * p.weight_vs], cp[0], cp[1], cp[2]};
        }
        word[b] = vis != nullptr ? vis[j * p.vis_vs] : 0;
      }
      // ---- the updates, in place
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + 32 * b;
        if (j >= p.S) continue;
        float pcx, pcy, pz;
        camera(j, pcx, pcy, pz);
        const bool in_front = pz > 0.0f;
        const float safe_z = in_front ? pz : 1.0f;
        const float z = lo[b].x, nx = lo[b].y, ny = lo[b].z, nz = lo[b].w;
        const bool z_ok = (z > p.zmin) & (z < p.zmax);
        const float sdf = fsub(z, pz);
        // fusion_weight: 1 in front, 1 + sdf/T on [-T, 0), 0 behind
        const float w = sdf >= 0.0f ? 1.0f
            : (sdf >= p.neg_trunc ? fadd(1.0f, fmul(sdf, p.inv_trunc)) : 0.0f);
        const bool n_valid =
            fadd(fadd(fmul(nx, nx), fmul(ny, ny)), fmul(nz, nz)) >= 0.1f;
        const float ndot = fadd(fadd(fmul(nx, fdiv(pcx, safe_z)),
                                     fmul(ny, fdiv(pcy, safe_z))),
                                fmul(nz, fdiv(pz, safe_z)));
        const bool angle_ok = fmul(fmul(ndot, ndot), hi[b].w) >= p.cos_sq;
        const bool mask = in_front & in_img[b] & z_ok & (w > 0.0f) & n_valid &
                          angle_ok & open;
        const float wm = mask ? w : 0.0f;

        Voxel o;
        o.w = fadd(v[b].w, wm);
        const float safe_w = clamp_min(o.w, 1e-12f);
        const float tr_sdf = clamp2(sdf, p.neg_trunc, p.trunc);
        o.d = fadd(v[b].d, fdiv(fmul(fsub(tr_sdf, v[b].d), wm), safe_w));
        // the normals point inward: -w R n
        o.g0 = fsub(v[b].g0, fmul(wm, dot3(r00, r01, r02, nx, ny, nz)));
        o.g1 = fsub(v[b].g1, fmul(wm, dot3(r10, r11, r12, nx, ny, nz)));
        o.g2 = fsub(v[b].g2, fmul(wm, dot3(r20, r21, r22, nx, ny, nz)));
        const float q = fdiv(wm, safe_w);
        o.c0 = fadd(v[b].c0, fmul(fsub(hi[b].x, v[b].c0), q));
        o.c1 = fadd(v[b].c1, fmul(fsub(hi[b].y, v[b].c1), q));
        o.c2 = fadd(v[b].c2, fmul(fsub(hi[b].z, v[b].c2), q));
        if (kPacked) {
          float4* s = reinterpret_cast<float4*>(dist + 8 * j);
          s[0] = make_float4(o.d, o.g0, o.g1, o.g2);
          s[1] = make_float4(o.w, o.c0, o.c1, o.c2);
        } else {
          float* gp = grad + j * p.grad_vs;
          float* cp = color + j * p.color_vs;
          dist[j * p.dist_vs] = o.d;
          weight[j * p.weight_vs] = o.w;
          gp[0] = o.g0; gp[1] = o.g1; gp[2] = o.g2;
          cp[0] = o.c0; cp[1] = o.c1; cp[2] = o.c2;
        }
        if (mask && vis != nullptr) vis[j * p.vis_vs] = word[b] | bit;
      }
    }
  }
}

// the persistent grid of a layout: the SM count x the blocks an SM holds,
// found once a device
int grid_for(bool packed, int* blocks) {
  static int known[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* slot = dev < 64 ? &known[packed ? 1 : 0][dev] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *blocks = *slot;
    return 0;
  }
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = packed ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &occ, fuse_rows_kernel<true>, kThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &occ, fuse_rows_kernel<false>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = sms * (occ > 0 ? occ : 1);
  if (slot != nullptr) *slot = *blocks;
  return 0;
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
  p.z_map = a->z_map;    p.z_map_len = static_cast<int>(a->z_map_len);
  p.pix = reinterpret_cast<const float4*>(a->pix);
  p.K = a->K;
  p.pose = a->pose;
  p.cap = static_cast<int>(a->cap);
  p.S = static_cast<int>(a->S);
  p.NS = static_cast<int>(a->NS);
  p.Y = static_cast<int>(a->Y);
  p.YNS = p.Y * p.NS;
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
  p.frame = a->frame;
  p.vis_ws = a->vis_ws;
  p.vis_words = static_cast<int>(a->vis_words);
  if (p.cap > 0 && p.S > 0) {
    const bool packed = a->packed != 0;
    int blocks = 0;
    const int rc = grid_for(packed, &blocks);
    if (rc != 0) return rc;
    if (blocks > (p.cap + kWarps - 1) / kWarps) blocks = (p.cap + kWarps - 1) / kWarps;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) {
      fuse_rows_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    } else {
      fuse_rows_kernel<false><<<blocks, kThreads, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
