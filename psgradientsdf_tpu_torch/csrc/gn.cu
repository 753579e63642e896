// The camera tracker's Gauss-Newton solve for Hopper (sm_90a): a frame's
// whole GN loop in ONE cooperative launch (gn_solve), and the masked Gram
// of frozen records at a given pose in one launch (gn_gram).
//
// gn_solve replaces the JAX package's track_frame program: psgradientsdf_tpu/
// tracking/tracker.py `run_gn_rounds` (:76-207), its `gn_step` (:112-157)
// with the records (`gather_records` :274-284, through core/volume.py
// `sdf_records_packed` :1007) and the Gram (`masked_gram` :286-301), inside
// the lax.while_loop (:183, early_exit) or the unrolled lax.fori_loop
// (:197, fixed trip) that XLA keeps on the device.  The port's plain
// version (ops/gn.py gn_solve_plain: the round loop over gn_step_plain) is
// some sixty eager PyTorch ops a step and reads the done flag back.
//
// The grid: the SM count x the occupancy the runtime reports, launched
// cooperatively, so every block is resident and may wait at a grid barrier.
// Each block owns a fixed tile of pixels for the whole launch.  The rounds:
// with early_exit up to num_iterations, ending once the carry is no longer
// active (converged, failed or out of budget); without it
// ceil(num_iterations / regather_every).  Each round is one fresh step and
// regather_every - 1 frozen steps.  A step whose carry is not active is a
// masked no-op and runs no pass (a fresh one still clears the round-local
// stall flag).  Per active step:
//   * per pixel (kPix of a thread's pixels at a time, their reads issued
//     first): the camera point moved by the pose; a fresh step finds the
//     nearest voxel with the border test (nearest_info), reads d, g and w
//     in place through a pointer and a voxel stride per field (a
//     PackedVolume payload or the SoA fields), forms ghat = g / max(|g|,
//     1e-12), the voxel centre c_v and ok = inside & w > 0 & depth in
//     range, and keeps the record (d, ghat, c_v, ok) when frozen steps
//     follow; a frozen step reads it back; then the row mask * [ghat,
//     p x ghat, psi, 1], psi = d + ghat.(c_v - p), and its 36 distinct
//     products added to the thread's sums;
//   * each block adds its threads' sums in a fixed order (each thread's
//     row in shared memory, then 14 interleaved groups of rows, then the
//     groups in order) and writes them to the partials buffer of the
//     step's parity; one grid barrier;
//   * EVERY block adds all blocks' partials in the same fixed order, so
//     every block holds the same S, and thread 0 runs the solve (solve_step)
//     on the block's own copy of the carry in shared memory.  Every block
//     therefore takes the same branch at every loop test: the exit is
//     uniform and no block waits at a barrier the others skip.
// Block 0 writes the carry back at the end.  No float atomics: a frame
// gives the same bits on every run (on a given card: the grid is a
// function of its SM count and the frame's size).
//
// The frame on chip: the block's camera points (backprojected once a
// launch from the depth tile) and, when frozen steps follow, its records
// (d, ghat, c_v, ok) stay in shared memory for the launch, 44 bytes a pixel
// (100 KB a block at 640x480 on 132 SMs, beside the 74 KB of the block
// sum's rows); a frozen step then reads nothing from device memory.  When
// the tile does not fit the shared-memory budget (1280x960 at stride 1 with
// frozen steps) the depth is read and backprojected at every step and the
// records go to the caller's [N, 8] buffer.  Chosen by size, not by a
// switch.
//
// The solve (solve_step, one thread): the 8x8 S packs H = S[:6,:6], g =
// S[:6,6], E = S[6,6] and the count S[7,7]; add the relative jitter, factor
// the 6x6 system (Cholesky), solve, damp; then the small-step, trust-region
// and fresh-step rules and the masked carry update of gn_step, and pose <-
// se3_exp(-xi) @ pose.
//
// gn_gram is the pass alone on frozen records [N, 8] at a given pose (the
// JAX package's masked_gram :286-301): the summed-Gram mesh tracker and the
// resident tracker sum it across shards and keep their own PyTorch solve.
// Its launch follows the host plan ops/gn.gram_plan, a function of N and the
// SM count alone: at most one block an SM (SMs / 8 clusters of 8 blocks,
// fewer for a small frame), each block a contiguous tile of pixels whose
// records its thread 0 bulk-copies (cp.async.bulk, csrc/async_copy.cuh) in
// chunks of kGramChunk pixels through a ring of kGramStages stages (all of a
// 640x480 frame's tile in flight at once); each thread reads its kGramPix
// pixels' depths of the next chunk while this one is summed.  A block adds
// its threads' sums through shared memory in a fixed order (block_sum_rows,
// as gn_solve's); the cluster's rank-0 block adds its blocks' sums in rank
// order from their shared memory (distributed shared memory) and writes the
// cluster's 36 sums; an integer ticket elects the last cluster, whose
// rank-0 block adds the clusters' sums in cluster order into S and resets
// the ticket to 0 for the next launch.  No float atomics: two runs give the
// same bits.  Bound by bytes: the depth map and the records read once (36
// bytes a pixel: 11.06 MB at 640x480, 3.3 us at 3.35 TB/s); an empty launch
// of the same grid and clusters takes longer than that (chip_smoke.py times
// it beside the kernel; PERF.md §6 records the grids and designs measured).
//
// The carry buffer (float32, see ops/gn.py): pose [0:16] row-major,
// converged 16, failed 17, stalled 18, E_mean 19, count 20, iterations 21,
// the S of the last active step [24:88].
//
// Rounding: the voxel index f = (p - origin) * (1/h) is formed as PyTorch
// forms (p - origin) / h on a CUDA tensor (a product with the float32
// reciprocal), with the _rn intrinsics; the floor(f + 0.5) voxel choice is
// a knife edge.  The pose product and the sums run in another order than
// the plain version's matrix products: S agrees to float32 rounding, not
// bit for bit.
//
// Bound on the card: bytes, per kind of step, at 640x480 (N = 307200):
//   * a fresh step without records (regather_every 1): the depth map once
//     (4 N bytes) and one 32-byte sector per DISTINCT voxel record it reads
//     (12353 at frame 24: 1.23 MB + 0.40 MB, 0.48 us at 3.35 TB/s);
//   * a fresh step that writes records: the same, plus 32 N bytes of
//     records written when they do not fit on chip (9.83 MB more), nothing
//     more when they stay in shared memory;
//   * a frozen step: nothing when the depth and records stay on chip; else
//     the depth and the records read again (4 N + 32 N bytes, 11.06 MB,
//     3.3 us).
// A frame on chip: the depth once and each fresh step's distinct records.
// The loop is bound by latency before either: a step is the pass, the
// block sum, a grid barrier, the partials' sum and the one-thread solve,
// one after the other (chip_smoke.py times an empty cooperative kernel that
// crosses as many barriers: the latency floor).
//
// Plain C interface (loaded with ctypes): gn_solve_plan() picks the grid,
// gn_solve(), gn_barriers(), gn_gram() and gn_gram_floor() launch on the
// stream they are given, do not synchronise, allocate nothing and return
// cudaGetLastError() (or the error of the failed call) as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

// The C interface's argument block: every field 8 bytes wide, in this order
// (ops/gn.py builds the same block with ctypes).  Strides are in elements.
struct GnArgs {
  const float* depth;  int64_t h, w, depth_rs, depth_cs;
  double coord_stride;
  const float* K;
  double zmin, zmax;
  const float* dist;    int64_t dist_vs;
  const float* grad;    int64_t grad_vs;
  const float* weight;  int64_t weight_vs;
  int64_t X, Y, Z;
  double origin_x, origin_y, origin_z, voxel;
  float* records;        // [N, 8] (d, ghat, c_v, ok): gn_gram's input;
                         // gn_solve's when they do not fit on chip; else null
  float* carry;          // gn_solve: the carry
  const float* pose;     // gn_gram: [4, 4]
  float* gram_out;       // gn_gram: [8, 8]
  float* partials;       // gn_gram: [clusters, 36]; gn_solve: [2, blocks, 36]
  unsigned int* ticket;  // gn_gram: one counter, 0 between launches
  int64_t num_iterations, regather_every, early_exit;
  int64_t blocks, on_chip;   // gn_solve: its plan (gn_solve_plan); gn_gram: blocks
  double conv_threshold_sq, damping, lever;
  int64_t cluster, tile;     // gn_gram: its plan's (ops/gn.gram_plan)
};

namespace {

constexpr int kTerms = 36;               // distinct products of the 8x8 Gram
constexpr int kGramThreads = 256;        // gn_gram (ops/gn.GRAM_THREADS)
constexpr int kGramGroups = kGramThreads / kTerms;    // 7 x 36 = 252 threads
constexpr int kGramPix = 4;              // ops/gn.GRAM_PIX
constexpr int kGramCluster = 8;          // ops/gn.GRAM_CLUSTER
constexpr int kGramChunk = kGramThreads * kGramPix;   // pixels a ring stage
constexpr int kGramStages = 3;
constexpr int kGramSmem = kGramStages * kGramChunk * 32;   // the ring: 96 KB
constexpr int kSolveThreads = 512;       // gn_solve: one block an SM
constexpr int kSolveGroups = kSolveThreads / kTerms;   // 14 x 36 = 504
constexpr int kPix = 2;                  // pixels a thread reads together
constexpr int kRedStride = kTerms + 1;   // a thread's row of the block sum
constexpr int kSumBatch = 10;            // partials a thread loads together
// gn_solve's dynamic shared memory before the tile: the block sum's rows
constexpr int64_t kRedBytes = int64_t{4} * kSolveThreads * kRedStride;

// carry layout
constexpr int kConv = 16, kFail = 17, kStalled = 18, kEMean = 19, kCount = 20,
              kIters = 21, kS = 24, kCarry = kS + 64;


struct GnParams {
  const float* depth;  int64_t depth_rs, depth_cs;
  int h, w, n;
  float coord_stride;
  const float* K;
  float zmin, zmax;
  const float* dist;    int64_t dist_vs;
  const float* grad;    int64_t grad_vs;
  const float* weight;  int64_t weight_vs;
  int X, Y, Z;
  float ox, oy, oz, h_vox, inv_h;
  float* records;
  float* carry;
  const float* pose;
  float* gram_out;
  float* partials;
  unsigned int* ticket;
  int num_iterations, regather_every, early_exit;
  int tile, on_chip;
  float conv_sq, damping, lever, trust_radius;
};

// a pixel's frozen record
struct Rec {
  float d, gx, gy, gz, cx, cy, cz;
  bool ok;
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float dot3(float a, float b, float c, float x,
                                      float y, float z) {
  return fadd(fadd(fmul(a, x), fmul(b, y)), fmul(c, z));
}

// Is the carry still active: not converged, failed, stalled (a fresh step
// clears the stall flag), nor out of budget?
__device__ __forceinline__ bool carry_active(const float* c, bool fresh,
                                             int num_iterations) {
  const bool stalled = !fresh && c[kStalled] != 0.0f;
  return c[kConv] == 0.0f && c[kFail] == 0.0f && !stalled &&
         c[kIters] < static_cast<float>(num_iterations);
}

// the pixel at (row, col) of depth z backprojected (camera_points): ((u -
// cx) / fx * z, (v - cy) / fy * z, z), with Kc = (fx, cx, fy, cy)
__device__ __forceinline__ float3 camera_point_rc(const GnParams& p, const float Kc[4],
                                                  int row, int col, float z) {
  const float u = fmul(static_cast<float>(col), p.coord_stride);
  const float v = fmul(static_cast<float>(row), p.coord_stride);
  return make_float3(fmul(fdiv(fsub(u, Kc[1]), Kc[0]), z),
                     fmul(fdiv(fsub(v, Kc[3]), Kc[2]), z), z);
}

// pixel i backprojected
__device__ __forceinline__ float3 camera_point(const GnParams& p, const float Kc[4],
                                               int i) {
  const int row = i / p.w, col = i - row * p.w;
  return camera_point_rc(p, Kc, row, col, p.depth[row * p.depth_rs + col * p.depth_cs]);
}

// a camera point moved by the pose P (row-major 3x4)
__device__ __forceinline__ void world_point(const float* P, float3 q, float& px,
                                            float& py, float& pz) {
  px = fadd(dot3(P[0], P[1], P[2], q.x, q.y, q.z), P[3]);
  py = fadd(dot3(P[4], P[5], P[6], q.x, q.y, q.z), P[7]);
  pz = fadd(dot3(P[8], P[9], P[10], q.x, q.y, q.z), P[11]);
}

// the nearest voxel of world point p and its raw fields (a fresh step's
// reads, issued before any of them is used)
struct Raw {
  float d, g0, g1, g2, w;
  int ix, iy, iz;
  bool inside;
};

__device__ __forceinline__ Raw voxel_read(const GnParams& p, float px, float py,
                                          float pz) {
  Raw v;
  // nearest_info: (p - origin) / h, strictly inside (0, dim - 1)
  const float fxv = fmul(fsub(px, p.ox), p.inv_h);
  const float fyv = fmul(fsub(py, p.oy), p.inv_h);
  const float fzv = fmul(fsub(pz, p.oz), p.inv_h);
  v.inside = (fxv > 0.0f) & (fxv < static_cast<float>(p.X - 1)) &
             (fyv > 0.0f) & (fyv < static_cast<float>(p.Y - 1)) &
             (fzv > 0.0f) & (fzv < static_cast<float>(p.Z - 1));
  v.ix = min(max(static_cast<int>(floorf(fadd(fxv, 0.5f))), 0), p.X - 1);
  v.iy = min(max(static_cast<int>(floorf(fadd(fyv, 0.5f))), 0), p.Y - 1);
  v.iz = min(max(static_cast<int>(floorf(fadd(fzv, 0.5f))), 0), p.Z - 1);
  const int64_t lin = (static_cast<int64_t>(v.iz) * p.Y + v.iy) * p.X + v.ix;
  v.d = p.dist[lin * p.dist_vs];
  const float* gp = p.grad + lin * p.grad_vs;
  v.g0 = gp[0]; v.g1 = gp[1]; v.g2 = gp[2];
  v.w = p.weight[lin * p.weight_vs];
  return v;
}

// the record of a voxel read at depth z
__device__ __forceinline__ Rec voxel_record(const GnParams& p, const Raw& v, float z) {
  Rec r;
  const bool valid_z = (z > p.zmin) & (z < p.zmax);
  const float gn = fmaxf(sqrtf(fadd(fadd(fmul(v.g0, v.g0), fmul(v.g1, v.g1)),
                                 fmul(v.g2, v.g2))), 1e-12f);
  r.d = v.d;
  r.gx = fdiv(v.g0, gn); r.gy = fdiv(v.g1, gn); r.gz = fdiv(v.g2, gn);
  r.cx = fadd(p.ox, fmul(p.h_vox, static_cast<float>(v.ix)));
  r.cy = fadd(p.oy, fmul(p.h_vox, static_cast<float>(v.iy)));
  r.cz = fadd(p.oz, fmul(p.h_vox, static_cast<float>(v.iz)));
  r.ok = v.inside & (v.w > 0.0f) & valid_z;
  return r;
}

__device__ __forceinline__ void store_record(float* records, int64_t i, const Rec& r) {
  float4* rec = reinterpret_cast<float4*>(records) + 2 * i;
  rec[0] = make_float4(r.d, r.gx, r.gy, r.gz);
  rec[1] = make_float4(r.cx, r.cy, r.cz, r.ok ? 1.0f : 0.0f);
}

__device__ __forceinline__ Rec load_record(const float* records, int64_t i) {
  const float4* rec = reinterpret_cast<const float4*>(records) + 2 * i;
  const float4 a = rec[0], b = rec[1];
  return Rec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w != 0.0f};
}

// the record in shared memory: field f of local pixel l at s[f * tile + l]
__device__ __forceinline__ void store_record_smem(float* s, int tile, int l, const Rec& r) {
  s[l] = r.d; s[tile + l] = r.gx; s[2 * tile + l] = r.gy; s[3 * tile + l] = r.gz;
  s[4 * tile + l] = r.cx; s[5 * tile + l] = r.cy; s[6 * tile + l] = r.cz;
  s[7 * tile + l] = r.ok ? 1.0f : 0.0f;
}

__device__ __forceinline__ Rec load_record_smem(const float* s, int tile, int l) {
  return Rec{s[l], s[tile + l], s[2 * tile + l], s[3 * tile + l], s[4 * tile + l],
             s[5 * tile + l], s[6 * tile + l], s[7 * tile + l] != 0.0f};
}

// a pixel's 36 Gram products (none when masked) added to acc
__device__ __forceinline__ void add_row(const Rec& r, float px, float py,
                                        float pz, float acc[kTerms]) {
  if (!r.ok) return;
  const float psi = fadd(r.d, fadd(fadd(fmul(r.gx, fsub(r.cx, px)),
                                        fmul(r.gy, fsub(r.cy, py))),
                                   fmul(r.gz, fsub(r.cz, pz))));
  float g[8];
  g[0] = r.gx; g[1] = r.gy; g[2] = r.gz;
  g[3] = fsub(fmul(py, r.gz), fmul(pz, r.gy));
  g[4] = fsub(fmul(pz, r.gx), fmul(px, r.gz));
  g[5] = fsub(fmul(px, r.gy), fmul(py, r.gx));
  g[6] = psi;
  g[7] = 1.0f;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = a; b < 8; ++b) acc[k++] += g[a] * g[b];
}

// A block's sums of its kT threads' acc (gn_solve's and gn_gram's), through
// shared memory: each thread writes its 36 sums to its row of `red`, then
// kG x 36 threads each add one term over every kG-th row in order, then 36
// threads add the groups in order -> the block's sums in threads 0..35.
template <int kT, int kG>
__device__ __forceinline__ float block_sum_rows(const float acc[kTerms], float* red,
                                                float (*group_sums)[kTerms]) {
  float* mine = red + threadIdx.x * kRedStride;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) mine[k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kG * kTerms) {
    const int k = threadIdx.x % kTerms, grp = threadIdx.x / kTerms;
    constexpr int kRows = (kT + kG - 1) / kG;
    float v[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int t = grp + q * kG;
      v[q] = t < kT ? red[t * kRedStride + k] : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kRows; ++q) s += v[q];
    group_sums[grp][k] = s;
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < kTerms)
    for (int grp = 0; grp < kG; ++grp) s += group_sums[grp][threadIdx.x];
  return s;
}

// The partials of `blocks` blocks (rows of 36) added in block order (kG
// interleaved groups, kSumBatch loads of a group issued together, then the
// groups in order) into the symmetric S.
template <int kG>
__device__ __forceinline__ void sum_partials(const float* partials, int blocks,
                                             float (*group_sums)[kTerms], float* S) {
  if (threadIdx.x < kG * kTerms) {
    const int k = threadIdx.x % kTerms, grp = threadIdx.x / kTerms;
    float s = 0.0f;
    for (int b0 = grp; b0 < blocks; b0 += kG * kSumBatch) {
      float v[kSumBatch];
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) {
        const int b = b0 + q * kG;
        v[q] = b < blocks ? __ldcg(partials + b * kTerms + k) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) s += v[q];
    }
    group_sums[grp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
    for (int grp = 0; grp < kG; ++grp) s += group_sums[grp][threadIdx.x];
    // term k -> (a, b), a <= b
    int k = threadIdx.x, a = 0;
    while (k >= 8 - a) { k -= 8 - a; ++a; }
    const int b = a + k;
    S[a * 8 + b] = s;
    S[b * 8 + a] = s;
  }
  __syncthreads();
}

// se3_exp(xi) @ pose, xi = [rho, omega] (utils/se3.se3_exp), into pose.
__device__ void se3_exp_left(const float xi[6], float pose[16]) {
  const float rx = xi[0], ry = xi[1], rz = xi[2];
  const float wx = xi[3], wy = xi[4], wz = xi[5];
  const float th_sq = wx * wx + wy * wy + wz * wz;
  const float th = sqrtf(fmaxf(th_sq, 1e-16f));
  const bool taylor = th_sq < 1e-8f;
  const float a = taylor ? 1.0f - th_sq / 6.0f : sinf(th) / th;
  const float b = taylor ? 0.5f - th_sq / 24.0f : (1.0f - cosf(th)) / fmaxf(th_sq, 1e-16f);
  const float c = taylor ? 1.0f / 6.0f - th_sq / 120.0f
                         : (th - sinf(th)) / fmaxf(th_sq * th, 1e-8f);
  const float Km[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
  float K2[9];
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 3; ++q)
      K2[r * 3 + q] = Km[r * 3] * Km[q] + Km[r * 3 + 1] * Km[3 + q] +
                      Km[r * 3 + 2] * Km[6 + q];
  float T[12];
  for (int r = 0; r < 3; ++r) {
    float t = 0.0f;
    for (int q = 0; q < 3; ++q) {
      const float e = r == q ? 1.0f : 0.0f;
      T[r * 4 + q] = e + a * Km[r * 3 + q] + b * K2[r * 3 + q];
      const float Vrq = e + b * Km[r * 3 + q] + c * K2[r * 3 + q];
      t += Vrq * (q == 0 ? rx : q == 1 ? ry : rz);
    }
    T[r * 4 + 3] = t;
  }
  float out[16];
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 4; ++q)
      out[r * 4 + q] = T[r * 4] * pose[q] + T[r * 4 + 1] * pose[4 + q] +
                       T[r * 4 + 2] * pose[8 + q] + T[r * 4 + 3] * pose[12 + q];
  for (int q = 0; q < 4; ++q) out[12 + q] = pose[12 + q];
  for (int k = 0; k < 16; ++k) pose[k] = out[k];
}

// The solve and the masked carry update of gn_step (one thread), on the
// carry c.
__device__ void solve_step(const GnParams& p, float* c, bool fresh, const float* S) {
  const bool active = carry_active(c, fresh, p.num_iterations);
  if (fresh) c[kStalled] = 0.0f;              // the round-local flag
  const float E = S[6 * 8 + 6], cnt = S[7 * 8 + 7];
  const bool fail_now = cnt < 0.5f;
  float A[36], g[6];
  float tr = 0.0f;
  for (int a = 0; a < 6; ++a) tr += S[a * 8 + a];
  const float jit = 1e-6f * tr / 6.0f + 1e-12f;
  for (int a = 0; a < 6; ++a) {
    g[a] = S[a * 8 + 6];
    for (int b = 0; b < 6; ++b) A[a * 6 + b] = S[a * 8 + b] + (a == b ? jit : 0.0f);
  }
  // Cholesky A = L L^T (lower), then L L^T x = g
  float L[36] = {0.0f};
  for (int j = 0; j < 6; ++j) {
    float s = A[j * 6 + j];
    for (int k = 0; k < j; ++k) s -= L[j * 6 + k] * L[j * 6 + k];
    const float ljj = sqrtf(s);
    L[j * 6 + j] = ljj;
    for (int i = j + 1; i < 6; ++i) {
      float t = A[i * 6 + j];
      for (int k = 0; k < j; ++k) t -= L[i * 6 + k] * L[j * 6 + k];
      L[i * 6 + j] = t / ljj;
    }
  }
  float y[6], xi[6];
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
    for (int k = 0; k < i; ++k) t -= L[i * 6 + k] * y[k];
    y[i] = t / L[i * 6 + i];
  }
  for (int i = 5; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < 6; ++k) t -= L[k * 6 + i] * xi[k];
    xi[i] = t / L[i * 6 + i];
  }
  float xsq = 0.0f;
  for (int i = 0; i < 6; ++i) {
    xi[i] *= p.damping;
    xsq += xi[i] * xi[i];
  }
  const bool small = xsq < p.conv_sq;
  bool conv_now = small, stall_now = false, trust = true;
  if (!fresh) {
    const float disp =
        sqrtf(xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2]) +
        p.lever * sqrtf(xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5]);
    trust = disp < p.trust_radius;
    conv_now = false;
    stall_now = small || !trust;
  }
  const bool step_ok = active && trust && !(small || fail_now);
  if (step_ok) {
    float pose[16], neg[6];
    for (int k = 0; k < 16; ++k) pose[k] = c[k];
    for (int k = 0; k < 6; ++k) neg[k] = -xi[k];
    se3_exp_left(neg, pose);
    for (int k = 0; k < 16; ++k) c[k] = pose[k];
  }
  if (active) {
    c[kConv] = conv_now ? 1.0f : 0.0f;
    c[kFail] = fail_now ? 1.0f : 0.0f;
    c[kStalled] = stall_now ? 1.0f : 0.0f;
    if (!stall_now) {                          // counted
      c[kEMean] = E / fmaxf(cnt, 1.0f);
      c[kCount] = truncf(cnt);
      c[kIters] = c[kIters] + 1.0f;
    }
  }
  if (active)
    for (int k = 0; k < 64; ++k) c[kS + k] = S[k];
}

// A frame's whole GN loop (see the header).  Dynamic shared memory: the
// block sum's rows [kSolveThreads][kRedStride], then, on chip, the camera
// points [3][tile] and the records [8][tile] when frozen steps follow.
__global__ void __launch_bounds__(kSolveThreads)
gn_solve_kernel(const __grid_constant__ GnParams p) {
  extern __shared__ float dyn[];
  __shared__ float group_sums[kSolveGroups][kTerms];
  __shared__ float S[64];
  __shared__ float c[kCarry];
  cg::grid_group grid = cg::this_grid();

  const int tid = threadIdx.x;
  const int begin = blockIdx.x * p.tile;
  const int count = max(0, min(p.tile, p.n - begin));
  const bool keep = p.regather_every > 1;     // frozen steps follow
  const float Kc[4] = {p.K[0], p.K[2], p.K[4], p.K[5]};
  float* red = dyn;
  float* s_cam = dyn + kSolveThreads * kRedStride;    // [3][tile]
  float* s_rec = s_cam + 3 * p.tile;                  // [8][tile]
  if (p.on_chip)
    for (int l = tid; l < count; l += kSolveThreads) {
      const float3 q = camera_point(p, Kc, begin + l);
      s_cam[l] = q.x; s_cam[p.tile + l] = q.y; s_cam[2 * p.tile + l] = q.z;
    }
  for (int k = tid; k < kCarry; k += kSolveThreads) c[k] = p.carry[k];
  __syncthreads();

  const int rounds = p.early_exit
      ? p.num_iterations
      : (p.num_iterations + p.regather_every - 1) / p.regather_every;
  int executed = 0;                           // steps that crossed a barrier
  for (int r = 0; r < rounds; ++r) {
    // the while_loop's test: budget left, neither converged nor failed
    if (p.early_exit && !(c[kIters] < static_cast<float>(p.num_iterations) &&
                          c[kConv] == 0.0f && c[kFail] == 0.0f))
      break;
    for (int k = 0; k < p.regather_every; ++k) {
      const bool fresh = k == 0;
      float P[12];
#pragma unroll
      for (int q = 0; q < 12; ++q) P[q] = c[q];
      const bool active = carry_active(c, fresh, p.num_iterations);
      __syncthreads();                        // every thread has read the carry
      if (!active) {                          // a masked no-op
        if (fresh && tid == 0) c[kStalled] = 0.0f;
        __syncthreads();
        continue;
      }
      float acc[kTerms];
#pragma unroll
      for (int q = 0; q < kTerms; ++q) acc[q] = 0.0f;
      // kPix pixels a thread at a time: their reads first, then their rows
      for (int l0 = tid; l0 < count; l0 += kSolveThreads * kPix) {
        float z[kPix], px[kPix], py[kPix], pz[kPix];
        Raw raw[kPix];
        Rec rec[kPix];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const int l = l0 + q * kSolveThreads;
          if (l >= count) continue;
          const float3 cam = p.on_chip
              ? make_float3(s_cam[l], s_cam[p.tile + l], s_cam[2 * p.tile + l])
              : camera_point(p, Kc, begin + l);
          z[q] = cam.z;
          world_point(P, cam, px[q], py[q], pz[q]);
          if (fresh) raw[q] = voxel_read(p, px[q], py[q], pz[q]);
          else rec[q] = p.on_chip ? load_record_smem(s_rec, p.tile, l)
                                  : load_record(p.records, begin + l);
        }
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const int l = l0 + q * kSolveThreads;
          if (l >= count) continue;
          if (fresh) {
            rec[q] = voxel_record(p, raw[q], z[q]);
            if (keep) {
              if (p.on_chip) store_record_smem(s_rec, p.tile, l, rec[q]);
              else store_record(p.records, begin + l, rec[q]);
            }
          }
          add_row(rec[q], px[q], py[q], pz[q], acc);
        }
      }
      const float mine = block_sum_rows<kSolveThreads, kSolveGroups>(acc, red, group_sums);
      float* part = p.partials + static_cast<int64_t>(executed & 1) * gridDim.x * kTerms;
      if (tid < kTerms) part[blockIdx.x * kTerms + tid] = mine;
      grid.sync();
      sum_partials<kSolveGroups>(part, gridDim.x, group_sums, S);
      if (tid == 0) solve_step(p, c, fresh, S);
      __syncthreads();
      ++executed;
    }
  }
  // with no step run, no barrier has yet shown that every block read the
  // carry before block 0 writes it
  if (executed == 0) grid.sync();
  if (blockIdx.x == 0)
    for (int k = tid; k < kCarry; k += kSolveThreads) p.carry[k] = c[k];
}

// An empty cooperative kernel on gn_solve's grid that crosses `barriers`
// grid barriers: the latency floor of a frame's loop.
__global__ void __launch_bounds__(kSolveThreads)
gn_barrier_kernel(int barriers) {
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < barriers; ++k) grid.sync();
}

// a ticket drawn: the add releases this thread's (and, after a barrier, its
// block's) writes and acquires those of the blocks that drew before
__device__ __forceinline__ unsigned ticket_add(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// a chunk of the block's records tile into its stage of the ring: one bulk
// copy on the stage's mbarrier
__device__ __forceinline__ void gram_chunk(const GnParams& p, float4* ring, uint64_t* full,
                                           int begin, int count, int c) {
  const int s = c % kGramStages;
  const int px = min(kGramChunk, count - c * kGramChunk);
  const uint32_t bytes = static_cast<uint32_t>(px) * 32u;
  mbar_arrive_expect_tx(&full[s], bytes);
  bulk_load(ring + 2 * kGramChunk * s, p.records + 8 * (static_cast<int64_t>(begin) +
                                                         c * kGramChunk),
            bytes, &full[s]);
}

// the depths of this thread's pixels of chunk c (and their rows and columns)
__device__ __forceinline__ void gram_depths(const GnParams& p, int begin, int count, int c,
                                            int (&row)[kGramPix], int (&col)[kGramPix],
                                            float (&z)[kGramPix]) {
#pragma unroll
  for (int q = 0; q < kGramPix; ++q) {
    const int l = c * kGramChunk + q * kGramThreads + threadIdx.x;
    if (l >= count) continue;
    const int i = begin + l;
    row[q] = i / p.w;
    col[q] = i - row[q] * p.w;
    z[q] = p.depth[row[q] * p.depth_rs + col[q] * p.depth_cs];
  }
}

// The masked Gram of frozen records at p.pose, written to p.gram_out (see
// the header): the block's tile of p.tile pixels, its records bulk-copied in
// chunks of kGramChunk pixels through a ring of kGramStages stages (the
// dynamic shared memory, then the block sum's rows), the depths of the next
// chunk loaded while this one is summed; the block's sums, the cluster's by
// its rank-0 block, the clusters' by the last cluster's.
__global__ void __launch_bounds__(kGramThreads, 2)
gn_gram_kernel(const __grid_constant__ GnParams p) {
  extern __shared__ __align__(128) unsigned char gram_dyn[];
  __shared__ uint64_t full[kGramStages];
  __shared__ float group_sums[kGramGroups][kTerms];
  __shared__ float bsum[kTerms];
  __shared__ float S[64];
  __shared__ int last;
  float4* ring = reinterpret_cast<float4*>(gram_dyn);   // [stages][chunk][2]
  const int tid = threadIdx.x;
  const int begin = blockIdx.x * p.tile;
  const int count = max(0, min(p.tile, p.n - begin));
  const int chunks = (count + kGramChunk - 1) / kGramChunk;
  if (tid == 0) {
    for (int s = 0; s < kGramStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
    for (int c = 0; c < chunks && c < kGramStages; ++c) gram_chunk(p, ring, full, begin, count, c);
  }
  __syncthreads();

  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  float P[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) P[k] = p.pose[k];
  const float Kc[4] = {p.K[0], p.K[2], p.K[4], p.K[5]};
  int row[kGramPix], col[kGramPix];
  float z[kGramPix];
  gram_depths(p, begin, count, 0, row, col, z);
  for (int c = 0; c < chunks; ++c) {
    int nrow[kGramPix], ncol[kGramPix];
    float nz[kGramPix];
    if (c + 1 < chunks) gram_depths(p, begin, count, c + 1, nrow, ncol, nz);
    const int s = c % kGramStages;
    mbar_wait(&full[s], (c / kGramStages) & 1);
    const float4* st = ring + 2 * kGramChunk * s;
#pragma unroll
    for (int q = 0; q < kGramPix; ++q) {
      const int l = q * kGramThreads + tid;         // in the chunk
      if (c * kGramChunk + l >= count) continue;
      const float4 a = st[2 * l], b = st[2 * l + 1];
      float px, py, pz;
      world_point(P, camera_point_rc(p, Kc, row[q], col[q], z[q]), px, py, pz);
      add_row(Rec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w != 0.0f}, px, py, pz, acc);
    }
    __syncthreads();                                // every thread is done with stage s
    if (tid == 0 && c + kGramStages < chunks) {
      fence_proxy_async();
      gram_chunk(p, ring, full, begin, count, c + kGramStages);
    }
#pragma unroll
    for (int q = 0; q < kGramPix; ++q) {
      row[q] = nrow[q];
      col[q] = ncol[q];
      z[q] = nz[q];
    }
  }
  // the ring is free: its first bytes hold the block sum's rows
  const float mine = block_sum_rows<kGramThreads, kGramGroups>(
      acc, reinterpret_cast<float*>(gram_dyn), group_sums);
  if (tid < kTerms) bsum[tid] = mine;

  // the cluster's sums, in rank order, by its rank-0 block from the blocks'
  // shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const unsigned rank = cluster.block_rank();
  const int Q = static_cast<int>(cluster.num_blocks());
  const int clusters = static_cast<int>(gridDim.x) / Q;
  if (rank == 0 && tid < kTerms) {
    float* sums = bsum;
    float v[kGramCluster];
#pragma unroll
    for (int r = 0; r < kGramCluster; ++r)
      v[r] = r < Q ? cluster.map_shared_rank(sums, r)[tid] : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kGramCluster; ++r)
      if (r < Q) s += v[r];
    p.partials[(blockIdx.x / Q) * kTerms + tid] = s;
  }
  // done with the peers' sums: arrive now, and wait (the peers wait there
  // until rank 0 has read their sums) only after the ticket
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (rank == 0) {
    __syncthreads();                           // the cluster's sums before the ticket
    if (tid == 0) {
      last = ticket_add(p.ticket) == static_cast<unsigned>(clusters - 1);
      if (last) atomicExch(p.ticket, 0u);      // ready for the next launch
    }
    __syncthreads();
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank != 0 || !last) return;

  // the last cluster's rank-0 block: the clusters' sums in cluster order
  sum_partials<1>(p.partials, clusters, group_sums, S);
  if (tid < 64) p.gram_out[tid] = S[tid];
}

// An empty kernel of gn_gram's grid and clusters: its latency floor.
__global__ void __launch_bounds__(kGramThreads, 2) gn_gram_floor_kernel(const GnParams) {}

GnParams params(const GnArgs* a) {
  GnParams p;
  p.depth = a->depth;  p.depth_rs = a->depth_rs;  p.depth_cs = a->depth_cs;
  p.h = static_cast<int>(a->h);
  p.w = static_cast<int>(a->w);
  p.n = p.h * p.w;
  p.coord_stride = static_cast<float>(a->coord_stride);
  p.K = a->K;
  p.zmin = static_cast<float>(a->zmin);
  p.zmax = static_cast<float>(a->zmax);
  p.dist = a->dist;      p.dist_vs = a->dist_vs;
  p.grad = a->grad;      p.grad_vs = a->grad_vs;
  p.weight = a->weight;  p.weight_vs = a->weight_vs;
  p.X = static_cast<int>(a->X);
  p.Y = static_cast<int>(a->Y);
  p.Z = static_cast<int>(a->Z);
  p.ox = static_cast<float>(a->origin_x);
  p.oy = static_cast<float>(a->origin_y);
  p.oz = static_cast<float>(a->origin_z);
  p.h_vox = static_cast<float>(a->voxel);
  p.inv_h = 1.0f / p.h_vox;
  p.records = a->records;
  p.carry = a->carry;
  p.pose = a->pose;
  p.gram_out = a->gram_out;
  p.partials = a->partials;
  p.ticket = a->ticket;
  p.num_iterations = static_cast<int>(a->num_iterations);
  p.regather_every = static_cast<int>(a->regather_every);
  p.early_exit = static_cast<int>(a->early_exit);
  p.tile = 0;
  p.on_chip = static_cast<int>(a->on_chip);
  p.conv_sq = static_cast<float>(a->conv_threshold_sq);
  p.damping = static_cast<float>(a->damping);
  p.lever = static_cast<float>(a->lever);
  p.trust_radius = static_cast<float>(0.25 * a->voxel);
  return p;
}

// shared memory a pixel of gn_solve's tile takes on chip
int64_t tile_bytes(int64_t regather_every) { return regather_every > 1 ? 44 : 12; }

}  // namespace

// gn_solve's grid for n pixels on the current device: blocks = the SM count
// x the occupancy the runtime reports (for the tile that one block an SM
// would hold), and whether the tile stays on chip -> 0 or a CUDA error.
extern "C" int gn_solve_plan(int64_t n, int64_t regather_every, int64_t* blocks,
                             int64_t* on_chip) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, gn_solve_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int64_t budget = static_cast<int64_t>(optin) - static_cast<int64_t>(fa.sharedSizeBytes);
  e = cudaFuncSetAttribute(gn_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(budget));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t want = kRedBytes + (n + sms - 1) / sms * tile_bytes(regather_every);
  const bool chip = want <= budget;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, gn_solve_kernel, kSolveThreads, static_cast<size_t>(chip ? want : kRedBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<int64_t>(sms) * occ;
  *on_chip = chip ? 1 : 0;
  return 0;
}

extern "C" int gn_solve(const GnArgs* a, void* stream) {
  GnParams p = params(a);
  const int blocks = static_cast<int>(a->blocks);
  if (p.n < 1 || blocks < 1 || p.num_iterations < 1 || p.regather_every < 1 ||
      (!p.on_chip && p.regather_every > 1 && p.records == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.tile = (p.n + blocks - 1) / blocks;
  const size_t smem = static_cast<size_t>(
      kRedBytes + (p.on_chip ? int64_t{p.tile} * tile_bytes(p.regather_every) : 0));
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_solve_kernel), dim3(blocks), dim3(kSolveThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();                        // not sticky: clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gn_barriers(int64_t blocks, int64_t barriers, void* stream) {
  int b = static_cast<int>(barriers);
  void* args[] = {&b};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_barrier_kernel), dim3(static_cast<int>(blocks)),
      dim3(kSolveThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// gn_gram's kernel (or its empty twin) on the plan in a's cluster fields:
// blocks in clusters of `cluster`, tiles of `tile` pixels.
static int gram_launch(void (*kernel)(const GnParams), int smem, const GnArgs* a,
                       cudaStream_t stream) {
  GnParams p = params(a);
  if (p.n < 1 || a->cluster < 1 || a->cluster > kGramCluster || a->blocks < a->cluster ||
      a->blocks % a->cluster != 0 || a->tile < 1 || a->blocks * a->tile < p.n ||
      (reinterpret_cast<uintptr_t>(a->records) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tile = static_cast<int>(a->tile);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a->blocks));
  cfg.blockDim = dim3(kGramThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a->cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gn_gram(const GnArgs* a, void* stream) {
  return gram_launch(gn_gram_kernel, kGramSmem, a, static_cast<cudaStream_t>(stream));
}

extern "C" int gn_gram_floor(const GnArgs* a, void* stream) {
  return gram_launch(gn_gram_floor_kernel, 0, a, static_cast<cudaStream_t>(stream));
}
