// The culled fusion's level-1 cull and level-2 compaction for Hopper
// (sm_90a): one cooperative launch each, nothing read back to the host.
//
// Replaces the JAX package's psgradientsdf_tpu/core/volume.py
// `_row_activity` (:252) and the `jnp.nonzero(size=, fill_value=)`
// compaction with its duplicate-first padding inside `_fuse_culled_slab`
// (:513-528), both inside the one device program `fuse_frame_culled`
// (:396).  The port's plain versions (ops/cull.py `row_activity_plain`,
// `compact_active_plain`, `compact_padded_plain`) are eager chains of
// PyTorch ops: with them a scan frame ran 243 device ops on the card, with
// these two kernels 43 (tools/scan_profile_ab.py on an H100 80GB HBM3 at
// 700 W).
//
// row_activity_kernel: a conservative activity mask over a grid's (or a
// Z-slab's) X-rows or X-segments.
//   1. The row maxima: a warp an image row (grid stride) takes the largest
//      depth in (zmin, zmax) of the row (NaN and out-of-range depths count
//      as -inf) and writes it to row_max[H] in device memory.
//   2. One grid barrier (grid.sync): every row needs the whole image.
//   3. Each block loads row_max into shared memory, takes its maximum (the
//      `mixed` rows' bound), and builds the plain version's sparse table of
//      range maxima there (levels x H floats; st[l][i] = max(st[l-1][i],
//      st[l-1][min(i + 2^(l-1), H-1)])).  A thread an entry (grid stride)
//      then projects the entry's two endpoints and applies the three tests
//      (behind the camera, off the image, behind the truncation band), with
//      the gate ANDed in; the mask is written, or ORed into a caller's mask
//      (a K-frame union).
//   The level k = floor(log2(span) + 1e-6) of the plain version is
//   31 - clz(span) here: the two agree for every span below 524287, and the
//   wrapper refuses images whose table does not fit shared memory (some 4000
//   rows).  Max is exact, so the table gives the plain version's bits.
//   Rounding: every product, sum and quotient is written with the _rn
//   intrinsics in the plain version's order (rot_apply's transpose form, a
//   Python number combined with a tensor as its float32 value), and
//   torch.minimum / maximum / clamp's NaN rules are kept, so the mask
//   equals the plain version's on the card element for element.
//
// compact_rows_kernel: the first `capacity` set entries of a flag array
// [n], ascending, padded with the fill value n (compact_active's contract,
// int64 indices) or with the first set entry, n - 1 when none is set
// (compact_padded's, int32), and the scalars n_active, live = max(n_active,
// 1) and overflow = n_active > capacity.
//   1. Each block owns a contiguous run of 32-flag groups, each warp a
//      contiguous run of the block's: a warp counts its groups' flags by
//      ballots and popcounts and notes its first set entry; the block's
//      count and first entry go to part[].
//   2. One grid barrier; every block then reads all blocks' counts (warp 0,
//      a lane a block) for its exclusive offset, the total and the first
//      set entry.
//   3. A warp walks its groups again and writes each set entry's index at
//      its rank (offset + the popcount of the lanes before it) while the
//      rank is below the capacity; the grid fills the padding slots; block
//      0 writes the scalars.
//
// Bound on the card: bytes, and at the scan's sizes the launch.  The cull
// reads the depth image once (H*W*4 bytes) and writes the mask (a byte an
// entry); the compaction reads the flags (a byte each) and writes the
// indices (4 or 8 bytes a slot).  At 128^3 and 640x480 that is 1.25 MB and
// 49 KB: under 0.001 ms at 3.35 TB/s, well under an empty cooperative
// launch (0.006 ms on an H100 80GB HBM3 at 700 W, chip_smoke.py), so the
// design's aim is one launch each with one grid barrier, on as few blocks
// as the work fills (one an SM at most).
//
// Plain C interface (loaded with ctypes): row_activity() and compact_rows()
// (and barrier_floor(), an empty launch of the same shape) launch on the
// stream they are given, do not synchronise, allocate nothing and return
// the launch's CUDA error as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The C interface's argument blocks: every field 8 bytes wide, in this
// order (ops/cull.py builds the same blocks with ctypes).
struct CullArgs {
  const float* depth;             // [H, W]
  const float* K;                 // [3, 3]
  const float* pose;              // [4, 4] camera-to-world
  const float* z_map;             // [z_rows] global planes, or null
  const unsigned char* gate;      // bool scalar, or null
  unsigned char* out;             // [z_rows, Y, NS] bool
  float* row_max;                 // [H] scratch
  int64_t H, W, levels, z_rows, Y, S, NS, has_z0, accumulate;
  double z0, origin_x, origin_y, origin_z, voxel, truncation, zmin, zmax,
      margin_px, margin_t;
};

struct CompactArgs {
  const unsigned char* flags;     // [n] bool
  void* idx;                      // [capacity] int64 (idx64) or int32
  int64_t* scalars;               // [2]: n_active, live
  unsigned char* overflow;        // bool scalar
  int32_t* part;                  // [2, blocks] scratch
  int64_t n, capacity, idx64, padded, blocks;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct CullParams {
  const float* depth;
  const float* K;
  const float* pose;
  const float* z_map;
  const unsigned char* gate;
  unsigned char* out;
  float* row_max;
  int H, W, levels, Y, NS, YNS, n, has_z0, accumulate;
  // the Python numbers as float32, as PyTorch rounds a Python number it
  // combines with a float32 tensor
  float z0, ox, oy, oz, h, trunc, zmin, zmax, margin_px, margin_t;
  float S, S1, W_edge, H_edge, H1;   // S, S - 1, W - 0.5, H - 0.5, H - 1
};

struct CompactParams {
  const unsigned char* flags;
  void* idx;
  int64_t* scalars;
  unsigned char* overflow;
  int32_t* part;
  int n, capacity, idx64, padded, groups, groups_per_block;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.clamp on a CUDA tensor: a NaN input is returned as it is
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// (a*x + b*y) + c*z, as rot_apply writes it
__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return fadd(fadd(fmul(a, x), fmul(b, y)), fmul(c, z));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__global__ void __launch_bounds__(kThreads)
row_activity_kernel(const __grid_constant__ CullParams p) {
  extern __shared__ float st[];            // [levels][H]
  __shared__ float warp_best[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- 1. the row maxima of the valid depth, a warp an image row
  for (int r = blockIdx.x * kWarps + warp; r < p.H; r += gridDim.x * kWarps) {
    const float* row = p.depth + static_cast<int64_t>(r) * p.W;
    float m = -INFINITY;
    for (int c = lane; c < p.W; c += 32) {
      const float d = row[c];
      m = fmaxf(m, (d > p.zmin) & (d < p.zmax) ? d : -INFINITY);
    }
    m = warp_max(m);
    if (lane == 0) p.row_max[r] = m;
  }
  grid.sync();

  // ---- 3. the range table and the image's maximum, in every block
  float m = -INFINITY;
  for (int i = threadIdx.x; i < p.H; i += kThreads) {
    const float v = __ldcg(p.row_max + i);
    st[i] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  if (lane == 0) warp_best[warp] = m;
  __syncthreads();
  for (int l = 1; l < p.levels; ++l) {
    const int half = 1 << (l - 1);
    const float* prev = st + (l - 1) * p.H;
    float* cur = st + l * p.H;
    for (int i = threadIdx.x; i < p.H; i += kThreads)
      cur[i] = fmaxf(prev[i], prev[min(i + half, p.H - 1)]);
    __syncthreads();
  }
  float image_max = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) image_max = fmaxf(image_max, warp_best[w]);

  const float* P = p.pose;
  const float r00 = P[0], r01 = P[1], r02 = P[2], tx = P[3];
  const float r10 = P[4], r11 = P[5], r12 = P[6], ty = P[7];
  const float r20 = P[8], r21 = P[9], r22 = P[10], tz = P[11];
  const float fx = p.K[0], cx = p.K[2], fy = p.K[4], cy = p.K[5];
  const bool open = p.gate == nullptr || *p.gate != 0;

  for (int e = blockIdx.x * kThreads + threadIdx.x; e < p.n; e += gridDim.x * kThreads) {
    const int zl = e / p.YNS;
    const int rest = e - zl * p.YNS;
    const int y = rest / p.NS;
    const int s = rest - y * p.NS;
    float zi;
    if (p.z_map != nullptr) {
      zi = p.z_map[zl];
    } else {
      zi = static_cast<float>(zl);
      if (p.has_z0) zi = fadd(zi, p.z0);
    }
    const float dy = fsub(fadd(p.oy, fmul(p.h, static_cast<float>(y))), ty);
    const float dz = fsub(fadd(p.oz, fmul(p.h, zi)), tz);
    const float x0 = fmul(static_cast<float>(s), p.S);
    const float x1 = fadd(x0, p.S1);
    // the endpoints' camera coordinates: R^T (p - t)
    const float dx0 = fsub(fadd(p.ox, fmul(p.h, x0)), tx);
    const float dx1 = fsub(fadd(p.ox, fmul(p.h, x1)), tx);
    const float p0x = dot3(r00, r10, r20, dx0, dy, dz);
    const float p0y = dot3(r01, r11, r21, dx0, dy, dz);
    const float pz0 = dot3(r02, r12, r22, dx0, dy, dz);
    const float p1x = dot3(r00, r10, r20, dx1, dy, dz);
    const float p1y = dot3(r01, r11, r21, dx1, dy, dz);
    const float pz1 = dot3(r02, r12, r22, dx1, dy, dz);

    const float eps = fadd(fmul(fadd(fabsf(pz0), fabsf(pz1)), 1e-5f), 1e-6f);
    const float behind = fsub(eps, p.margin_t);
    const bool both_behind = (pz0 <= behind) & (pz1 <= behind);
    const bool both_front = (pz0 > eps) & (pz1 > eps);
    const bool mixed = !both_behind & !both_front;

    const float sz0 = pz0 > 0.0f ? pz0 : 1.0f;
    const float sz1 = pz1 > 0.0f ? pz1 : 1.0f;
    const float u0 = fadd(cx, fdiv(fmul(fx, p0x), sz0));
    const float u1 = fadd(cx, fdiv(fmul(fx, p1x), sz1));
    const float v0 = fadd(cy, fdiv(fmul(fy, p0y), sz0));
    const float v1 = fadd(cy, fdiv(fmul(fy, p1y), sz1));
    const float mu = fadd(fadd(fmul(fadd(fabsf(u0), fabsf(u1)), 1e-5f), 0.01f), p.margin_px);
    const float mv = fadd(fadd(fmul(fadd(fabsf(v0), fabsf(v1)), 1e-5f), 0.01f), p.margin_px);
    const float u_min = fsub(tmin(u0, u1), mu);
    const float u_max = fadd(tmax(u0, u1), mu);
    const float v_min = fsub(tmin(v0, v1), mv);
    const float v_max = fadd(tmax(v0, v1), mv);
    const bool img = (u_max > -1.5f) & (u_min < p.W_edge) & (v_max > -1.5f) &
                     (v_min < p.H_edge);

    // the largest valid depth over the image rows [v_lo, v_hi]
    const int v_lo = static_cast<int>(clamp2(floorf(fsub(v_min, 1.0f)), 0.0f, p.H1));
    const int v_hi = static_cast<int>(clamp2(ceilf(fadd(v_max, 1.0f)), 0.0f, p.H1));
    const int span = max(v_hi - v_lo + 1, 1);
    const int k = min(31 - __clz(span), p.levels - 1);
    const float* level = st + k * p.H;
    float z_fp = fmaxf(level[v_lo], level[max(v_hi - (1 << k) + 1, 0)]);
    if (mixed) z_fp = image_max;

    const float pz_min = fsub(tmin(pz0, pz1), eps);
    const bool carve_ok = fsub(fsub(pz_min, p.trunc), p.margin_t) <= z_fp;
    const bool act = open & !both_behind & (img | mixed) & carve_ok;
    if (p.accumulate) {
      if (act) p.out[e] = 1;
    } else {
      p.out[e] = act;
    }
  }
}

__device__ __forceinline__ void put_index(const CompactParams& p, int slot, int value) {
  if (p.idx64)
    static_cast<int64_t*>(p.idx)[slot] = value;
  else
    static_cast<int32_t*>(p.idx)[slot] = value;
}

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const __grid_constant__ CompactParams p) {
  __shared__ int warp_count[kWarps];
  __shared__ int warp_first[kWarps];
  __shared__ int grid_facts[3];            // block offset, total, first set entry
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_begin = min(static_cast<int>(blockIdx.x) * p.groups_per_block, p.groups);
  const int g_end = min(g_begin + p.groups_per_block, p.groups);
  const int per_warp = (p.groups_per_block + kWarps - 1) / kWarps;
  const int w_begin = min(g_begin + warp * per_warp, g_end);
  const int w_end = min(w_begin + per_warp, g_end);

  // ---- 1. the warps' and the block's counts and first set entries
  int count = 0, first = p.n;
  for (int g = w_begin; g < w_end; ++g) {
    const int i = g * 32 + lane;
    const unsigned b = __ballot_sync(kFull, i < p.n && p.flags[i] != 0);
    if (first == p.n && b != 0u) first = g * 32 + __ffs(b) - 1;
    count += __popc(b);
  }
  if (lane == 0) {
    warp_count[warp] = count;
    warp_first[warp] = first;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0, f = p.n;
    for (int w = 0; w < kWarps; ++w) {
      c += warp_count[w];
      f = min(f, warp_first[w]);
    }
    p.part[blockIdx.x] = c;
    p.part[gridDim.x + blockIdx.x] = f;
  }
  grid.sync();

  // ---- 2. the block's offset, the total and the first set entry
  if (warp == 0) {
    int before = 0, total = 0, f = p.n;
    for (int j = lane; j < static_cast<int>(gridDim.x); j += 32) {
      const int c = __ldcg(p.part + j);
      total += c;
      if (j < static_cast<int>(blockIdx.x)) before += c;
      f = min(f, __ldcg(p.part + gridDim.x + j));
    }
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      before += __shfl_xor_sync(kFull, before, s);
      total += __shfl_xor_sync(kFull, total, s);
      f = min(f, __shfl_xor_sync(kFull, f, s));
    }
    if (lane == 0) {
      grid_facts[0] = before;
      grid_facts[1] = total;
      grid_facts[2] = f;
    }
  }
  __syncthreads();
  const int total = grid_facts[1];

  // ---- 3. the indices at their ranks, then the padding and the scalars
  int base = grid_facts[0];
  for (int w = 0; w < warp; ++w) base += warp_count[w];
  const unsigned below = (1u << lane) - 1u;
  for (int g = w_begin; g < w_end && base < p.capacity; ++g) {
    const int i = g * 32 + lane;
    const bool set = i < p.n && p.flags[i] != 0;
    const unsigned b = __ballot_sync(kFull, set);
    const int slot = base + __popc(b & below);
    if (set && slot < p.capacity) put_index(p, slot, i);
    base += __popc(b);
  }
  const int fill = p.padded ? (total > 0 ? grid_facts[2] : p.n - 1) : p.n;
  for (int s = min(total, p.capacity) + blockIdx.x * kThreads + threadIdx.x;
       s < p.capacity; s += gridDim.x * kThreads)
    put_index(p, s, fill);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.scalars[0] = total;
    p.scalars[1] = total > 1 ? total : 1;
    *p.overflow = total > p.capacity;
  }
}

// An empty cooperative kernel crossing one grid barrier: the latency floor
// of the two launches above (timed by chip_smoke.py, on no path).
__global__ void __launch_bounds__(kThreads) barrier_floor_kernel(int unused) {
  if (unused) return;
  cg::this_grid().sync();
}

// The cull's dynamic shared memory above 48 KB is allowed once a device.
cudaError_t allow_table(int bytes) {
  static bool allowed[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(row_activity_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (e == cudaSuccess && dev < 64) allowed[dev] = true;
  return e;
}

}  // namespace

extern "C" int row_activity(const CullArgs* a, int blocks, void* stream) {
  CullParams p;
  p.depth = a->depth;
  p.K = a->K;
  p.pose = a->pose;
  p.z_map = a->z_map;
  p.gate = a->gate;
  p.out = a->out;
  p.row_max = a->row_max;
  p.H = static_cast<int>(a->H);
  p.W = static_cast<int>(a->W);
  p.levels = static_cast<int>(a->levels);
  p.Y = static_cast<int>(a->Y);
  p.NS = static_cast<int>(a->NS);
  p.YNS = p.Y * p.NS;
  p.n = static_cast<int>(a->z_rows) * p.YNS;
  p.has_z0 = static_cast<int>(a->has_z0);
  p.accumulate = static_cast<int>(a->accumulate);
  p.z0 = static_cast<float>(a->z0);
  p.ox = static_cast<float>(a->origin_x);
  p.oy = static_cast<float>(a->origin_y);
  p.oz = static_cast<float>(a->origin_z);
  p.h = static_cast<float>(a->voxel);
  p.trunc = static_cast<float>(a->truncation);
  p.zmin = static_cast<float>(a->zmin);
  p.zmax = static_cast<float>(a->zmax);
  p.margin_px = static_cast<float>(a->margin_px);
  p.margin_t = static_cast<float>(a->margin_t);
  p.S = static_cast<float>(a->S);
  p.S1 = static_cast<float>(a->S - 1);
  p.W_edge = static_cast<float>(static_cast<double>(a->W) - 0.5);
  p.H_edge = static_cast<float>(static_cast<double>(a->H) - 0.5);
  p.H1 = static_cast<float>(a->H - 1);
  if (p.n <= 0 || p.H <= 0 || p.W <= 0 || blocks <= 0) return 0;
  const int smem = p.levels * p.H * static_cast<int>(sizeof(float));
  cudaError_t e = allow_table(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(row_activity_kernel),
                                  dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                  args, static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compact_rows(const CompactArgs* a, void* stream) {
  CompactParams p;
  p.flags = a->flags;
  p.idx = a->idx;
  p.scalars = a->scalars;
  p.overflow = a->overflow;
  p.part = a->part;
  p.n = static_cast<int>(a->n);
  p.capacity = static_cast<int>(a->capacity);
  p.idx64 = static_cast<int>(a->idx64);
  p.padded = static_cast<int>(a->padded);
  p.groups = (p.n + 31) / 32;
  const int blocks = static_cast<int>(a->blocks);
  if (p.n <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p.groups_per_block = (p.groups + blocks - 1) / blocks;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(compact_rows_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int barrier_floor(int blocks, int smem, void* stream) {
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(barrier_floor_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int unused = 0;
  void* args[] = {&unused};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_floor_kernel),
                                  dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                                  static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
