// One Gauss-Newton step of the camera tracker for Hopper (sm_90a): one
// launch per step, the loop's carry held on the device.
//
// Replaces the JAX package's jit-fused tracker step: psgradientsdf_tpu/
// tracking/tracker.py `gn_step` (:112-157) with its records
// (`gather_records` :274-284, through core/volume.py `sdf_records_packed`
// :1007) and its Gram (`masked_gram` :286-301), which XLA fuses into a few
// device programs inside a lax.while_loop.  The port's plain version
// (ops/gn.py: frame_records, gram_plain, gn_update) is some sixty eager
// PyTorch ops a step.
//
// Per pixel of the (strided) depth map, one thread:
//   * backprojects the pixel (camera_points) and moves it by the pose;
//   * fresh step: finds the nearest voxel with the border test
//     (nearest_info), reads d, g and w in place through a pointer and a
//     voxel stride per field (a PackedVolume payload or the SoA fields, no
//     packed copy), forms ghat = g / max(|g|, 1e-12), the voxel centre c_v
//     and ok = inside & w > 0 & depth in range, and stores (d, ghat, c_v,
//     ok) in the [N, 8] record buffer when the caller keeps one (frozen
//     steps follow);
//   * frozen step: reads those records back;
//   * forms the row mask * [ghat, p x ghat, psi, 1], psi = d + ghat.(c_v - p),
//     and adds its 36 distinct products to the thread's sums.
// Each block reduces its threads' sums in a fixed order (warp shuffles, then
// the warps in order) into its own partial; the last block to finish (a
// __threadfence and a ticket, which it resets) adds the partials in block
// order.  No float atomics: a step gives the same bits on every run.
//
// The solve tail (kSolve, in that last block): the 8x8 S packs H = S[:6,:6],
// g = S[:6,6], E = S[6,6] and the count S[7,7]; add the relative jitter,
// factor the 6x6 system (Cholesky), solve, damp; then the small-step,
// trust-region and fresh-step rules and the masked carry update of gn_step,
// and pose <- se3_exp(-xi) @ pose.  A fresh step clears the round-local
// stall flag first.  A step whose carry is no longer active (converged,
// failed, stalled or out of budget) is a no-op, so its blocks skip the
// pixels.
//
// Without kSolve the kernel forms the Gram of frozen records at a given
// pose and writes S: the summed-Gram mesh tracker and the resident tracker
// keep their own PyTorch solve around it.
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
// Bound on the card: bytes.  Per pixel 4 bytes of depth and one 32-byte
// record sector (a fresh step), plus 32 bytes of frozen record written by a
// fresh step that keeps them and read by a frozen one: 11 MB at 640x480,
// 3.3 us at 3.35 TB/s.  A step is bound by launch latency before either.
//
// Plain C interface (loaded with ctypes): gn_step() and gn_gram() launch on
// the stream they are given, do not synchronise, allocate nothing and
// return cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

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
  float* records;        // [N, 8] (d, ghat, c_v, ok), or null
  int64_t fresh;
  float* carry;          // kSolve: the carry; else null
  const float* pose;     // without kSolve: [4, 4]
  float* gram_out;       // without kSolve: [8, 8]
  float* partials;       // [blocks, 36]
  unsigned int* ticket;  // one counter, 0 between launches
  int64_t num_iterations;
  double conv_threshold_sq, damping, lever;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 528;          // four a streaming multiprocessor
constexpr int kTerms = 36;               // distinct products of the 8x8 Gram
constexpr int kGroups = 7;               // final sum: 7 x 36 = 252 threads

// carry layout
constexpr int kConv = 16, kFail = 17, kStalled = 18, kEMean = 19, kCount = 20,
              kIters = 21, kS = 24;


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
  int fresh;
  float* carry;
  const float* pose;
  float* gram_out;
  float* partials;
  unsigned int* ticket;
  int num_iterations;
  float conv_sq, damping, lever, trust_radius;
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

// A pixel's Gram row g[8] (zero when masked): backprojection, the pose, and
// the fresh or the frozen record.  Returns false for a masked pixel.
__device__ __forceinline__ bool pixel_row(const GnParams& p, const float* P,
                                          int i, float g[8]) {
  const int row = i / p.w, col = i - (i / p.w) * p.w;
  const float z = p.depth[row * p.depth_rs + col * p.depth_cs];
  const float fx = p.K[0], cx = p.K[2], fy = p.K[4], cy = p.K[5];
  const float u = fmul(static_cast<float>(col), p.coord_stride);
  const float v = fmul(static_cast<float>(row), p.coord_stride);
  const float xc = fmul(fdiv(fsub(u, cx), fx), z);
  const float yc = fmul(fdiv(fsub(v, cy), fy), z);
  const float px = fadd(dot3(P[0], P[1], P[2], xc, yc, z), P[3]);
  const float py = fadd(dot3(P[4], P[5], P[6], xc, yc, z), P[7]);
  const float pz = fadd(dot3(P[8], P[9], P[10], xc, yc, z), P[11]);

  float d, gx, gy, gz, cvx, cvy, cvz;
  bool ok;
  if (p.fresh) {
    const bool valid_z = (z > p.zmin) & (z < p.zmax);
    // nearest_info: (p - origin) / h, strictly inside (0, dim - 1)
    const float fxv = fmul(fsub(px, p.ox), p.inv_h);
    const float fyv = fmul(fsub(py, p.oy), p.inv_h);
    const float fzv = fmul(fsub(pz, p.oz), p.inv_h);
    const bool inside = (fxv > 0.0f) & (fxv < static_cast<float>(p.X - 1)) &
                        (fyv > 0.0f) & (fyv < static_cast<float>(p.Y - 1)) &
                        (fzv > 0.0f) & (fzv < static_cast<float>(p.Z - 1));
    const int ix = min(max(static_cast<int>(floorf(fadd(fxv, 0.5f))), 0), p.X - 1);
    const int iy = min(max(static_cast<int>(floorf(fadd(fyv, 0.5f))), 0), p.Y - 1);
    const int iz = min(max(static_cast<int>(floorf(fadd(fzv, 0.5f))), 0), p.Z - 1);
    const int64_t lin = (static_cast<int64_t>(iz) * p.Y + iy) * p.X + ix;
    d = p.dist[lin * p.dist_vs];
    const float* gp = p.grad + lin * p.grad_vs;
    const float g0 = gp[0], g1 = gp[1], g2 = gp[2];
    const float wv = p.weight[lin * p.weight_vs];
    const float gn = fmaxf(sqrtf(fadd(fadd(fmul(g0, g0), fmul(g1, g1)), fmul(g2, g2))),
                           1e-12f);
    gx = fdiv(g0, gn); gy = fdiv(g1, gn); gz = fdiv(g2, gn);
    cvx = fadd(p.ox, fmul(p.h_vox, static_cast<float>(ix)));
    cvy = fadd(p.oy, fmul(p.h_vox, static_cast<float>(iy)));
    cvz = fadd(p.oz, fmul(p.h_vox, static_cast<float>(iz)));
    ok = inside & (wv > 0.0f) & valid_z;
    if (p.records != nullptr) {
      float4* rec = reinterpret_cast<float4*>(p.records) + 2 * static_cast<int64_t>(i);
      rec[0] = make_float4(d, gx, gy, gz);
      rec[1] = make_float4(cvx, cvy, cvz, ok ? 1.0f : 0.0f);
    }
  } else {
    const float4* rec = reinterpret_cast<const float4*>(p.records) + 2 * static_cast<int64_t>(i);
    const float4 a = rec[0], b = rec[1];
    d = a.x; gx = a.y; gy = a.z; gz = a.w;
    cvx = b.x; cvy = b.y; cvz = b.z;
    ok = b.w != 0.0f;
  }
  if (!ok) return false;
  const float psi = fadd(d, fadd(fadd(fmul(gx, fsub(cvx, px)), fmul(gy, fsub(cvy, py))),
                                 fmul(gz, fsub(cvz, pz))));
  g[0] = gx; g[1] = gy; g[2] = gz;
  g[3] = fsub(fmul(py, gz), fmul(pz, gy));
  g[4] = fsub(fmul(pz, gx), fmul(px, gz));
  g[5] = fsub(fmul(px, gy), fmul(py, gx));
  g[6] = psi;
  g[7] = 1.0f;
  return true;
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

// The blocks a step of n pixels launches (the partials buffer's rows): a
// function of n alone, so the sums run in the same order on every run.
int blocks_for(int n) {
  const int want = (n + kThreads - 1) / kThreads;
  return want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want);
}

// The solve and the masked carry update of gn_step (one thread).
__device__ void solve_step(const GnParams& p, const float* S) {
  float* c = p.carry;
  const bool fresh = p.fresh != 0;
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

template <bool kSolve>
__global__ void __launch_bounds__(kThreads)
gn_kernel(const __grid_constant__ GnParams p) {
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ float group_sums[kGroups][kTerms];
  __shared__ float S[64];
  __shared__ bool last;

  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

  const float* P = kSolve ? p.carry : p.pose;
  const bool run = !kSolve || carry_active(p.carry, p.fresh != 0, p.num_iterations);
  if (run) {
    float pose[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) pose[k] = P[k];
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n;
         i += gridDim.x * kThreads) {
      float g[8];
      if (!pixel_row(p, pose, i, g)) continue;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = a; b < 8; ++b) acc[k++] += g[a] * g[b];
    }
  }

  // the block's sums: a shuffle tree in each warp, then the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    p.partials[blockIdx.x * kTerms + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int t = atomicAdd(p.ticket, 1u);
    last = t == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: the partials in block order (seven interleaved groups,
  // then the groups in order)
  __threadfence();
  if (threadIdx.x < kGroups * kTerms) {
    const int k = threadIdx.x % kTerms, grp = threadIdx.x / kTerms;
    float s = 0.0f;
    for (int b = grp; b < static_cast<int>(gridDim.x); b += kGroups)
      s += __ldcg(p.partials + b * kTerms + k);
    group_sums[grp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.0f;
    for (int grp = 0; grp < kGroups; ++grp) s += group_sums[grp][threadIdx.x];
    // term k -> (a, b), a <= b
    int k = threadIdx.x, a = 0;
    while (k >= 8 - a) { k -= 8 - a; ++a; }
    const int b = a + k;
    S[a * 8 + b] = s;
    S[b * 8 + a] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *p.ticket = 0u;                            // ready for the next launch
    if (kSolve) {
      solve_step(p, S);
    } else {
      for (int k = 0; k < 64; ++k) p.gram_out[k] = S[k];
    }
  }
}

int launch(const GnArgs* a, void* stream, bool solve) {
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
  p.fresh = static_cast<int>(a->fresh);
  p.carry = a->carry;
  p.pose = a->pose;
  p.gram_out = a->gram_out;
  p.partials = a->partials;
  p.ticket = a->ticket;
  p.num_iterations = static_cast<int>(a->num_iterations);
  p.conv_sq = static_cast<float>(a->conv_threshold_sq);
  p.damping = static_cast<float>(a->damping);
  p.lever = static_cast<float>(a->lever);
  p.trust_radius = static_cast<float>(0.25 * a->voxel);
  const int blocks = blocks_for(p.n);
  if (solve) {
    gn_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    gn_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gn_blocks(int n) { return blocks_for(n); }

extern "C" int gn_step(const GnArgs* a, void* stream) { return launch(a, stream, true); }

extern "C" int gn_gram(const GnArgs* a, void* stream) { return launch(a, stream, false); }
