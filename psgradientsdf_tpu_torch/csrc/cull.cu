// The culled fusion's level-1 cull and level-2 compaction for Hopper
// (sm_90a): ONE cooperative launch, nothing read back to the host.
//
// Replaces the JAX package's psgradientsdf_tpu/core/volume.py
// `_row_activity` (:252) and the `jnp.nonzero(size=, fill_value=)`
// compaction with its duplicate-first padding inside `_fuse_culled_slab`
// (:513-528), both inside the one device program `fuse_frame_culled`
// (:396), and the K-frame union of `fuse_frames_culled` (:679-728).  The
// port's plain versions (ops/cull.py `row_activity_plain`,
// `compact_active_plain`, `compact_padded_plain`) are eager chains of
// PyTorch ops.
//
// cull_compact_kernel<true>: the first `capacity` set entries of the
// activity mask over a grid's (or a Z-slab's) X-rows or X-segments, the
// mask being the union of K frames' culls (each ANDed with its gate) ANDed
// with an optional `allow` array.
//   1. The row maxima of the K frames: a warp an image row (grid stride over
//      K*H rows) takes the largest depth in (zmin, zmax) of the row (NaN and
//      out-of-range depths count as -inf) into row_max[K][H], device memory.
//   2. Grid barrier 1: a frame's every entry needs the frame's whole image.
//   3. Each block owns a contiguous run of entries, a whole number of
//      32-entry groups, and keeps the run's mask in shared memory as words
//      of 32 bits.  The frames go in passes of as many as shared memory
//      holds the tables of (`pass`, the host's plan): a pass builds its
//      frames' sparse tables of range maxima side by side (levels x H
//      floats each; st[l][i] = max(st[l-1][i], st[l-1][min(i + 2^(l-1),
//      H-1)]), the plain version's), and a thread an entry projects the
//      entry's two endpoints and applies the three tests (behind the
//      camera, off the image, behind the truncation band) frame after
//      frame until one keeps it; a warp's ballot is ORed into the group's
//      word.  The cameras and gates of a pass wait in shared memory.
//      `allow` is ANDed into the words, the mask goes to device memory only
//      when asked for (written, or ORed into a caller's mask), and each warp
//      counts its contiguous share of the words; the block's count and first
//      set entry go to part[].
//   4. Grid barrier 2; every block then reads all blocks' counts (warp 0, a
//      lane a block) for its exclusive offset, the total and the first set
//      entry, and each warp writes the set entries of its words at their
//      ranks (the offset + the popcount of the bits before), while the rank
//      is below the capacity.  The flags never leave shared memory.
//   5. The padding: the fill value n (compact_active's contract, int64
//      indices) or the first set entry, n - 1 when none is set
//      (compact_padded's, int32); block 0 writes n_active, live = max(n_active,
//      1) and overflow = n_active > capacity.  A capacity of 0 counts only.
// cull_compact_kernel<false> skips steps 1-3's cull: its words are a
// caller's flag array [n] (ANDed with `allow`), then steps 4-5 as above: the
// compaction alone, one launch crossing one grid barrier.
//
// The cull's level k = floor(log2(span) + 1e-6) of the plain version is
// 31 - clz(span) here: the two agree for every span below 524287, and the
// wrapper refuses images whose table and words do not fit shared memory.
// Max is exact, so the table gives the plain version's bits.  Rounding:
// every product, sum and quotient is written with the _rn intrinsics in the
// plain version's order (rot_apply's transpose form, a Python number
// combined with a tensor as its float32 value), and torch.minimum / maximum
// / clamp's NaN rules are kept, so the mask equals the plain version's on
// the card element for element, and so do the indices and the scalars.
//
// Bound on the card: bytes, and at the scan's sizes the launch.  The work
// reads the K depth images once (K*H*W*4 bytes) and writes the indices (4
// or 8 bytes a slot) and the scalars; the mask stays on the chip unless it
// is asked for.  At 128^3 and 640x480 that is 1.26 MB: under 0.0004 ms at
// 3.35 TB/s, well under an empty cooperative launch (0.006 ms on an H100
// 80GB HBM3 at 700 W, chip_smoke.py), so the design's aim is ONE launch for
// the cull, the compaction and a K-frame union (where PR 21's design made
// K + 1), on as few blocks as the work fills (one an SM at most).
//
// Plain C interface (loaded with ctypes): cull_compact() (and
// barrier_floor(), an empty launch crossing a given number of grid
// barriers) launch on the stream they are given, do not synchronise,
// allocate nothing and return the launch's CUDA error as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The C interface's argument block: every field 8 bytes wide, in this order
// (ops/cull.py builds the same block with ctypes).
struct CullCompactArgs {
  const float* depth;             // [frames, H, W] (cull), or null
  const float* K;                 // [3, 3]
  const float* pose;              // [frames, 4, 4] camera-to-world
  const float* z_map;             // [z_rows] global planes, or null
  const unsigned char* gates;     // [frames] bool, or null
  const unsigned char* flags;     // [n] bool (the compaction alone), or null
  const unsigned char* allow;     // [n] bool, or null
  unsigned char* mask;            // [n] bool out, or null
  void* idx;                      // [capacity] int64 (idx64) or int32
  int64_t* scalars;               // [3]: n_active, live, overflow (byte 16)
  int32_t* scratch;               // [frames*H] float row maxima, [2, blocks] int32
  int64_t cull, frames, H, W, levels, n, Y, S, NS, has_z0, accumulate,
      capacity, idx64, padded, blocks, frames_per_pass;
  double z0, origin_x, origin_y, origin_z, voxel, truncation, zmin, zmax,
      margin_px, margin_t;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPass = 16;      // frames a pass, at most (ops/cull.py MAX_PASS)

struct Params {
  const float* depth;
  const float* K;
  const float* pose;
  const float* z_map;
  const unsigned char* gates;
  const unsigned char* flags;
  const unsigned char* allow;
  unsigned char* mask;
  void* idx;
  int64_t* scalars;
  float* row_max;
  int32_t* part;
  int frames, H, W, levels, Y, NS, YNS, n, has_z0, accumulate, capacity,
      idx64, padded;
  int run;                        // entries a block owns, a multiple of 32
  int pass;                       // frames whose tables a pass builds
  // the Python numbers as float32, as PyTorch rounds a Python number it
  // combines with a float32 tensor
  float z0, ox, oy, oz, h, trunc, zmin, zmax, margin_px, margin_t;
  float S, S1, W_edge, H_edge, H1;   // S, S - 1, W - 0.5, H - 0.5, H - 1
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

// One frame's camera: the pose's rows and the intrinsics.
struct Camera {
  float r00, r01, r02, tx, r10, r11, r12, ty, r20, r21, r22, tz;
  float fx, cx, fy, cy;
};

// A pass's cameras in shared memory: [f][0..11] the pose's first three rows,
// [kMaxPass][0..3] fx, cx, fy, cy; open[f] the gate.
struct PassCameras {
  float pose[kMaxPass + 1][12];
  int open[kMaxPass];
};

__device__ __forceinline__ void load_cameras(const Params& p, int k0, int kn,
                                             PassCameras& pc) {
  const int t = threadIdx.x;
  if (t < 12 * kn) pc.pose[t / 12][t % 12] = p.pose[16 * (k0 + t / 12) + t % 12];
  if (t >= 256 && t < 256 + kn)
    pc.open[t - 256] = p.gates == nullptr || p.gates[k0 + t - 256] != 0;
  if (t >= 288 && t < 292)                 // fx, cx, fy, cy: K[0], K[2], K[4], K[5]
    pc.pose[kMaxPass][t - 288] = p.K[t == 291 ? 5 : 2 * (t - 288)];
}

// The largest depth in (zmin, zmax) of an image row (NaN and out-of-range
// depths count as -inf), in every lane of the warp.
__device__ __forceinline__ float row_maximum(const Params& p, const float* row) {
  float m = -INFINITY;
  for (int c = threadIdx.x & 31; c < p.W; c += 32) {
    const float d = row[c];
    m = fmaxf(m, (d > p.zmin) & (d < p.zmax) ? d : -INFINITY);
  }
  return warp_max(m);
}

__device__ __forceinline__ Camera camera(const PassCameras& pc, int f) {
  const float* P = pc.pose[f];
  const float* I = pc.pose[kMaxPass];
  Camera c;
  c.r00 = P[0]; c.r01 = P[1]; c.r02 = P[2]; c.tx = P[3];
  c.r10 = P[4]; c.r11 = P[5]; c.r12 = P[6]; c.ty = P[7];
  c.r20 = P[8]; c.r21 = P[9]; c.r22 = P[10]; c.tz = P[11];
  c.fx = I[0]; c.cx = I[1]; c.fy = I[2]; c.cy = I[3];
  return c;
}

// Entry e's cull against one frame: the plain version's three tests, each
// operation rounded once in its order; st is the frame's range table.
__device__ __forceinline__ bool entry_active(const Params& p, const Camera& c,
                                             const float* st, float image_max,
                                             int e) {
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
  const float dy = fsub(fadd(p.oy, fmul(p.h, static_cast<float>(y))), c.ty);
  const float dz = fsub(fadd(p.oz, fmul(p.h, zi)), c.tz);
  const float x0 = fmul(static_cast<float>(s), p.S);
  const float x1 = fadd(x0, p.S1);
  // the endpoints' camera coordinates: R^T (p - t)
  const float dx0 = fsub(fadd(p.ox, fmul(p.h, x0)), c.tx);
  const float dx1 = fsub(fadd(p.ox, fmul(p.h, x1)), c.tx);
  const float p0x = dot3(c.r00, c.r10, c.r20, dx0, dy, dz);
  const float p0y = dot3(c.r01, c.r11, c.r21, dx0, dy, dz);
  const float pz0 = dot3(c.r02, c.r12, c.r22, dx0, dy, dz);
  const float p1x = dot3(c.r00, c.r10, c.r20, dx1, dy, dz);
  const float p1y = dot3(c.r01, c.r11, c.r21, dx1, dy, dz);
  const float pz1 = dot3(c.r02, c.r12, c.r22, dx1, dy, dz);

  const float eps = fadd(fmul(fadd(fabsf(pz0), fabsf(pz1)), 1e-5f), 1e-6f);
  const float behind = fsub(eps, p.margin_t);
  const bool both_behind = (pz0 <= behind) & (pz1 <= behind);
  const bool both_front = (pz0 > eps) & (pz1 > eps);
  const bool mixed = !both_behind & !both_front;

  const float sz0 = pz0 > 0.0f ? pz0 : 1.0f;
  const float sz1 = pz1 > 0.0f ? pz1 : 1.0f;
  const float u0 = fadd(c.cx, fdiv(fmul(c.fx, p0x), sz0));
  const float u1 = fadd(c.cx, fdiv(fmul(c.fx, p1x), sz1));
  const float v0 = fadd(c.cy, fdiv(fmul(c.fy, p0y), sz0));
  const float v1 = fadd(c.cy, fdiv(fmul(c.fy, p1y), sz1));
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
  return !both_behind & (img | mixed) & carve_ok;
}

// The range tables of frames k0 .. k0 + kn - 1 over their row maxima, side
// by side in st ([f][levels][H]), in every block (build_tables: level 0
// from row_max, then build_levels).  Three levels a block
// barrier: level b + j is the max of 2^j windows of level b, st[b+j][i] =
// max_t st[b][min(i + t 2^b, H-1)] for t < 2^j, the same rows as the plain
// version's level-by-level recurrence covers (max is exact: the same bits).
__device__ __forceinline__ void build_levels(const Params& p, int kn, float* st) {
  const int table = p.levels * p.H;
  for (int b = 0; b + 1 < p.levels; b += 3) {
    const int q = 1 << b, top = min(3, p.levels - 1 - b);
    for (int f = 0; f < kn; ++f) {
      const float* src = st + f * table + b * p.H;
      float* dst = st + f * table + b * p.H;
      for (int r = threadIdx.x; r < p.H; r += kThreads) {
        float v[8];                        // the 8 windows, read together
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = src[min(r + t * q, p.H - 1)];
        const float m1 = fmaxf(v[0], v[1]);
        const float m2 = fmaxf(m1, fmaxf(v[2], v[3]));
        const float m3 = fmaxf(m2, fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
        dst[p.H + r] = m1;
        if (top > 1) dst[2 * p.H + r] = m2;
        if (top > 2) dst[3 * p.H + r] = m3;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void build_tables(const Params& p, int k0, int kn,
                                             float* st) {
  const int table = p.levels * p.H;
  for (int r = threadIdx.x; r < p.H; r += kThreads) {
    float v[kMaxPass];                     // the frames' loads, in flight together
#pragma unroll
    for (int f = 0; f < kMaxPass; ++f)
      if (f < kn) v[f] = __ldcg(p.row_max + (k0 + f) * p.H + r);
#pragma unroll
    for (int f = 0; f < kMaxPass; ++f)
      if (f < kn) st[f * table + r] = v[f];
  }
  __syncthreads();
  build_levels(p, kn, st);
}

// A frame's largest valid depth (the `mixed` rows' bound) from its table:
// two windows of the top level, 2^(levels-1) rows each, cover [0, H-1]
// (levels = bit_length(H - 1)); max is exact, so this is the plain
// version's torch.max(row_max).
__device__ __forceinline__ float image_max(const Params& p, const float* st) {
  const float* top = st + (p.levels - 1) * p.H;
  return fmaxf(top[0], top[p.H - (1 << (p.levels - 1))]);
}

__device__ __forceinline__ void put_index(const Params& p, int slot, int value) {
  if (p.idx64)
    static_cast<int64_t*>(p.idx)[slot] = value;
  else
    static_cast<int32_t*>(p.idx)[slot] = value;
}

// A block's tally of its run's words: each warp counts its contiguous share
// (groups w_begin .. w_end) and notes its first set entry; warp 0 then sums
// the warps' counts with shuffles into each warp's exclusive base, the
// block's count and its first set entry.
struct Tally {
  int count[kWarps];
  int first[kWarps];
  int base[kWarps];
  int block_count, block_first;
};

__device__ __forceinline__ void tally_words(const Params& p, const unsigned* words,
                                            int begin, int w_begin, int w_end,
                                            Tally& tl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0, first = p.n;
  for (int g = w_begin + lane; g < w_end; g += 32) {
    const unsigned w = words[g];
    count += __popc(w);
    if (w != 0u) first = min(first, begin + g * 32 + __ffs(w) - 1);
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    count += __shfl_xor_sync(kFull, count, s);
    first = min(first, __shfl_xor_sync(kFull, first, s));
  }
  if (lane == 0) {
    tl.count[warp] = count;
    tl.first[warp] = first;
  }
  __syncthreads();
  if (warp == 0) {
    const int c = lane < kWarps ? tl.count[lane] : 0;
    int f = lane < kWarps ? tl.first[lane] : p.n;
    int incl = c;                        // inclusive scan over the warps
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += v;
    }
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) f = min(f, __shfl_xor_sync(kFull, f, s));
    if (lane < kWarps) tl.base[lane] = incl - c;
    if (lane == 31) {
      tl.block_count = incl;
      tl.block_first = f;
    }
  }
  __syncthreads();
}

// Steps 4-5 after the offsets: the set entries of the warp's words at their
// ranks, then the padding and (block 0) the scalars.
__device__ __forceinline__ void ranked_writes(const Params& p, const unsigned* words,
                                              int begin, int w_begin, int w_end,
                                              const Tally& tl, const int* grid_facts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = grid_facts[1];
  int base = grid_facts[0] + tl.base[warp];
  const unsigned below = (1u << lane) - 1u;
  for (int g = w_begin; g < w_end && base < p.capacity; ++g) {
    const unsigned w = words[g];
    const int slot = base + __popc(w & below);
    if (((w >> lane) & 1u) && slot < p.capacity) put_index(p, slot, begin + g * 32 + lane);
    base += __popc(w);
  }
  const int fill = p.padded ? (total > 0 ? grid_facts[2] : p.n - 1) : p.n;
  for (int s = min(total, p.capacity) + blockIdx.x * kThreads + threadIdx.x;
       s < p.capacity; s += gridDim.x * kThreads)
    put_index(p, s, fill);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.scalars[0] = total;
    p.scalars[1] = total > 1 ? total : 1;
    *reinterpret_cast<unsigned char*>(p.scalars + 2) = total > p.capacity;
  }
}

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
cull_compact_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned smem[];       // the run's mask words, then the tables
  unsigned* words = smem;                  // [run / 32]
  float* st = reinterpret_cast<float*>(smem + p.run / 32);   // [pass][levels][H]
  __shared__ PassCameras cams;
  __shared__ Tally tally;
  __shared__ int grid_facts[3];            // block offset, total, first set entry
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int begin = min(static_cast<int>(blockIdx.x) * p.run, p.n);
  const int end = min(begin + p.run, p.n);
  const int groups = (end - begin + 31) / 32;
  // a pass of the block over its run: thread t takes entry begin + base + t,
  // so warp w's lanes are group base / 32 + w

  if constexpr (kCull) {
    load_cameras(p, 0, min(p.pass, p.frames), cams);
    // ---- 1. the row maxima of the valid depth, a warp an image row
    for (int r = blockIdx.x * kWarps + warp; r < p.frames * p.H;
         r += gridDim.x * kWarps) {
      const float m = row_maximum(p, p.depth + static_cast<int64_t>(r) * p.W);
      if (lane == 0) p.row_max[r] = m;
    }
    for (int g = threadIdx.x; g < groups; g += kThreads) words[g] = 0u;
    grid.sync();                           // ---- 2. grid barrier 1

    // ---- 3. the frames' culls of the run, a pass of frames at a time
    const int table = p.levels * p.H;
    for (int k0 = 0; k0 < p.frames; k0 += p.pass) {
      const int kn = min(p.pass, p.frames - k0);
      if (k0 > 0) {
        __syncthreads();                   // the last pass's tables are read
        load_cameras(p, k0, kn, cams);
      }
      build_tables(p, k0, kn, st);         // ends with a block barrier
      // a run shorter than the block: `slices` slices of `sweep` threads, a
      // slice taking frames slice, slice + slices, ... of the pass
      const int sweep = min(kThreads, groups * 32);
      const int slices = kThreads / max(sweep, 32);
      const int slice = threadIdx.x / max(sweep, 32);
      if (slice < slices) {                // warp-uniform
        const int li = threadIdx.x - slice * sweep;
        for (int base = 0; base < groups * 32; base += sweep) {
          const int g = (base + li) >> 5;
          if (g >= groups) continue;       // warp-uniform
          const int e = begin + base + li;
          bool act = false;
          if (e < end) {
            for (int f = slice; f < kn && !act; f += slices) {
              if (!cams.open[f]) continue;
              const float* t = st + f * table;
              act = entry_active(p, camera(cams, f), t, image_max(p, t), e);
            }
          }
          const unsigned b = __ballot_sync(kFull, act);
          if (lane == 0 && b != 0u) atomicOr(words + g, b);
        }
      }
    }
  } else {
    for (int base = 0; base < groups * 32; base += kThreads) {
      const int g = (base >> 5) + warp;
      if (g >= groups) continue;
      const int e = begin + base + threadIdx.x;
      const unsigned b = __ballot_sync(kFull, e < end && p.flags[e] != 0);
      if (lane == 0) words[g] = b;
    }
  }
  __syncthreads();

  // allow ANDed in, then the mask to device memory where it is asked for
  if (p.allow != nullptr || p.mask != nullptr) {
    for (int base = 0; base < groups * 32; base += kThreads) {
      const int g = (base >> 5) + warp;
      if (g >= groups) continue;
      const int e = begin + base + threadIdx.x;
      unsigned w = words[g];
      if (p.allow != nullptr) {
        w &= __ballot_sync(kFull, e < end && p.allow[e] != 0);
        if (lane == 0) words[g] = w;
      }
      if (p.mask != nullptr && e < end) {
        const bool bit = (w >> lane) & 1u;
        if (!p.accumulate)
          p.mask[e] = bit;
        else if (bit)
          p.mask[e] = 1;
      }
    }
    __syncthreads();
  }

  // the warps' counts of their contiguous shares of the words, the block's
  const int per_warp = (groups + kWarps - 1) / kWarps;
  const int w_begin = min(warp * per_warp, groups);
  const int w_end = min(w_begin + per_warp, groups);
  tally_words(p, words, begin, w_begin, w_end, tally);
  if (threadIdx.x == 0) {
    p.part[blockIdx.x] = tally.block_count;
    p.part[gridDim.x + blockIdx.x] = tally.block_first;
  }
  grid.sync();                             // ---- 4. grid barrier 2

  // the block's offset, the total and the first set entry
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
  ranked_writes(p, words, begin, w_begin, w_end, tally, grid_facts);
}

// An empty cooperative kernel crossing `barriers` grid barriers: the latency
// floor of the launch above (timed by chip_smoke.py, on no path).
__global__ void __launch_bounds__(kThreads) barrier_floor_kernel(int barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < barriers; ++i) grid.sync();
}

// Dynamic shared memory above 48 KB is allowed once a device and kernel.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int which, int bytes) {
  static bool allowed[3][64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[which][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           200 * 1024);
  if (e == cudaSuccess && dev < 64) allowed[which][dev] = true;
  return e;
}

// The argument block as the kernel's parameters, the run of each of
// `blocks` blocks included -> false where the block is not a valid launch.
bool make_params(const CullCompactArgs* a, int blocks, Params& p) {
  const bool cull = a->cull != 0;
  p.depth = a->depth;
  p.K = a->K;
  p.pose = a->pose;
  p.z_map = a->z_map;
  p.gates = a->gates;
  p.flags = a->flags;
  p.allow = a->allow;
  p.mask = a->mask;
  p.idx = a->idx;
  p.scalars = a->scalars;
  p.frames = static_cast<int>(a->frames);
  p.H = static_cast<int>(a->H);
  p.W = static_cast<int>(a->W);
  p.levels = static_cast<int>(a->levels);
  p.Y = static_cast<int>(a->Y);
  p.NS = static_cast<int>(a->NS);
  p.YNS = p.Y * p.NS;
  p.n = static_cast<int>(a->n);
  p.has_z0 = static_cast<int>(a->has_z0);
  p.accumulate = static_cast<int>(a->accumulate);
  p.capacity = static_cast<int>(a->capacity);
  p.idx64 = static_cast<int>(a->idx64);
  p.padded = static_cast<int>(a->padded);
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
  p.pass = static_cast<int>(a->frames_per_pass);
  p.row_max = nullptr;
  p.part = nullptr;
  if (p.n <= 0 || blocks <= 0 || p.capacity < 0 ||
      (cull && (p.frames <= 0 || p.H <= 0 || p.W <= 0 || p.levels <= 0 ||
                p.pass <= 0 || p.pass > kMaxPass)) ||
      (!cull && p.flags == nullptr))
    return false;
  // a block's run: its share of the entries in whole 32-entry groups
  p.run = ((p.n + blocks - 1) / blocks + 31) / 32 * 32;
  return true;
}

}  // namespace

extern "C" int cull_compact(const CullCompactArgs* a, void* stream) {
  Params p;
  const bool cull = a->cull != 0;
  const int blocks = static_cast<int>(a->blocks);
  if (!make_params(a, blocks, p)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = cull ? p.frames * p.H : 0;
  p.row_max = reinterpret_cast<float*>(a->scratch);
  p.part = a->scratch + rows;
  const int smem = (p.run / 32 + (cull ? p.pass * p.levels * p.H : 0)) * 4;
  const void* kernel = cull ? reinterpret_cast<const void*>(cull_compact_kernel<true>)
                            : reinterpret_cast<const void*>(cull_compact_kernel<false>);
  cudaError_t e = cull ? allow_shared(cull_compact_kernel<true>, 0, smem)
                       : allow_shared(cull_compact_kernel<false>, 1, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)),
                                  dim3(kThreads), args, static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int barrier_floor(int blocks, int smem, int barriers, void* stream) {
  if (blocks <= 0 || barriers < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_shared(barrier_floor_kernel, 2, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&barriers};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_floor_kernel),
                                  dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
                                  static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
