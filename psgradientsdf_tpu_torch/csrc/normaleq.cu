// The refinement's pose and light normal equations for Hopper (sm_90a): per
// keyframe, the weighted Gram matrix of a block's Jacobian rows and its
// gradient, summed over the surface voxels and the three channels.
//
//   pose_normal_eqs      H [F,6,6], g [F,6] of the pose block (SH and LED)
//   light_normal_eqs_sh  H [F,B,B], g [F,B] of the SH light block (B = 4, 9)
//
// pose_normal_eqs replaces the JAX package's psgradientsdf_tpu/refine/
// optimizer.py `_pose_normal_eqs` (:208) and its chunk loop in `_pose_core`
// (:222): refine/jacobians.py `image_pi_grad` (:44), `pose_jacobian_sh`
// (:72) or `pose_jacobian_led` (:84), then the einsums nfc,nfcb,nfcd->fbd
// and nfc,nfcb,nfc->fb.  light_normal_eqs_sh replaces refine/solvers.py
// `solve_light_sh`'s (:512) einsums nfc,ncb,ncd->fbd and nfc,ncb,nfc->fb
// (:526-527); its batched eigen-solve stays in PyTorch.  The port's eager
// chains ran both as cuBLAS products over [N,F,3,6] / [F,3N] operands that
// the chain first wrote to device memory (about 4 ms a call each at N =
// 49152, F = 40).
//
// Bound by bytes.  A pose pair (voxel, keyframe) reads g_img (24 bytes),
// p_cam, w and r (12 each): 60 bytes, 118 MB at N = 49152, F = 40, 0.035
// ms at 3.35 TB/s; a light pair reads w and r: 24 bytes, 0.014 ms.  The
// products are few (27 a pose pair-channel), so a kernel that reads each
// input once and writes nothing per pair is the whole design:
//
// *_tiles_kernel: the host plan (ops/normaleq._reduce_plan) cuts the N
//   voxels into tiles of V consecutive voxels and the F keyframes into
//   chunks of FB; block (tile, chunk) holds FB frame columns x R voxel lanes
//   (R FB <= kThreads).  Thread (lane, column) owns keyframe f of its column
//   and adds the pairs (n, f) for n = tile start + lane, + R, ... in order:
//   a warp's pairs are consecutive in the [N, F] layout (coalesced loads),
//   the thread's pose R_f stays in registers, and each pair's Jacobian row
//   is formed in registers (the image gradient composed with the
//   projection, -G R^T | G hat(p) and, under the LED, the translation's
//   near-field term) and never stored.  A thread sums its products in
//   float, one fused multiply-add each, over at most LANE_VOXELS voxels
//   (ops/normaleq; 3 x 32 products a sum); the R lanes of a column are then
//   added in double, in lane order, through shared memory, and the block
//   writes its partial sums [F, S] of its frames in double (S = 21 + 6 for
//   the pose, B (B + 1) / 2 + B for the light: H's upper triangle row by
//   row, then g).
// normaleq_reduce_kernel: a block of kReduceThreads a keyframe adds the
//   tiles' partials in a fixed order (thread (j, k) of ways = kReduceThreads
//   / S the tiles j, j + ways, ..., then the ways in order), rounds to float
//   and writes H (both triangles) and g.
//
// No atomics: every sum runs in one fixed order, so two runs give the same
// bits.  The products are those of the plain versions (w J_b times J_d for
// the pose, w times J_b J_d for the light; w r once); the plain versions
// sum them in float32 in cuBLAS's or the CPU's order, the kernels in short
// float runs and then in double, so the two agree to float32 rounding of
// the sums.  (Summing every product in double costs a conversion and a
// double FMA a product, and the B = 9 light's accumulators twice the
// registers: slower on the card, tools/normaleq_ab.py.)

#include <cuda_runtime.h>
#include <stdint.h>

struct ReducePlan {                 // ops/normaleq.ReducePlan, field for field
  int64_t frames;                   // FB: keyframe columns a block
  int64_t lanes;                    // R: voxel lanes a block
  int64_t chunks;                   // keyframe chunks (grid.y)
  int64_t voxels;                   // V: voxels a tile
  int64_t tiles;                    // tiles (grid.x)
};

struct PoseArgs {                   // ops/normaleq._PoseArgs
  const float* g_img;               // [N,F,3,2]
  const float* p_cam;               // [N,F,3]
  const float* w;                   // [N,F,3]
  const float* r;                   // [N,F,3]
  const float* poses;               // [F,4,4]
  const float* K;                   // [3,3]
  const float* albedo;              // [N,3] (LED)
  const float* grad;                // [N,3] (LED)
  const float* light;               // [3]   (LED)
  double* partial;                  // [tiles,F,27]
  float* H;                         // [F,6,6]
  float* g;                         // [F,6]
  int64_t n, f, led;
  ReducePlan plan;
};

struct LightArgs {                  // ops/normaleq._LightArgs
  const float* w;                   // [N,F,3]
  const float* r;                   // [N,F,3]
  const float* J;                   // [N,3,B]
  double* partial;                  // [tiles,F,S]
  float* H;                         // [F,B,B]
  float* g;                         // [F,B]
  int64_t n, f, basis;
  ReducePlan plan;
};

namespace {

constexpr int kThreads = 256;       // ops/normaleq.THREADS
constexpr int kReduceThreads = 1024;
constexpr int kPoseTerms = 27;      // ops/normaleq.POSE_TERMS

// the block's lanes' sums (each thread's S sums at [k][tid]) -> its partial
// sums of its chunk's frames, each column's lanes added in lane order
__device__ __forceinline__ void write_partials(const double* lane_sums, int S,
                                               const ReducePlan& plan, int64_t F,
                                               double* partial) {
  const int FB = static_cast<int>(plan.frames);
  const int R = static_cast<int>(plan.lanes);
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * FB;
  const int here = static_cast<int>(F - f0 < FB ? F - f0 : FB);
  double* out = partial + (static_cast<int64_t>(blockIdx.x) * F + f0) * S;
  for (int e = threadIdx.x; e < here * S; e += kThreads) {
    const int col = e / S, k = e - col * S;
    double s = 0.0;
    for (int l = 0; l < R; ++l) s += lane_sums[k * kThreads + l * FB + col];
    out[e] = s;
  }
}

template <bool kLed>
__global__ void __launch_bounds__(kThreads, 2) pose_tiles_kernel(PoseArgs a) {
  extern __shared__ double lane_sums[];          // [kPoseTerms][kThreads]
  const int tid = threadIdx.x;
  const int FB = static_cast<int>(a.plan.frames);
  const int R = static_cast<int>(a.plan.lanes);
  const int lane = tid / FB, col = tid - lane * FB;
  const int64_t f = static_cast<int64_t>(blockIdx.y) * FB + col;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * a.plan.voxels;
  const int64_t v1 = v0 + a.plan.voxels < a.n ? v0 + a.plan.voxels : a.n;
  float acc[kPoseTerms];
#pragma unroll
  for (int k = 0; k < kPoseTerms; ++k) acc[k] = 0.f;

  if (lane < R && f < a.f) {
    const float* __restrict__ g_img = a.g_img;
    const float* __restrict__ p_cam = a.p_cam;
    const float* __restrict__ wt = a.w;
    const float* __restrict__ rt = a.r;
    const float* P = a.poses + f * 16;
    float Rm[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rm[i][j] = __ldg(P + 4 * i + j);
    const float fx = __ldg(a.K), fy = __ldg(a.K + 4);
    float lx = 0.f, ly = 0.f, lz = 0.f;
    if (kLed) {
      lx = __ldg(a.light);
      ly = __ldg(a.light + 1);
      lz = __ldg(a.light + 2);
    }
    for (int64_t n = v0 + lane; n < v1; n += R) {
      const int64_t pair = n * a.f + f;
      const float2* gp = reinterpret_cast<const float2*>(g_img + pair * 6);
      const float2 g0 = __ldg(gp), g1 = __ldg(gp + 1), g2 = __ldg(gp + 2);
      const float px = __ldg(p_cam + pair * 3), py = __ldg(p_cam + pair * 3 + 1),
                  pz = __ldg(p_cam + pair * 3 + 2);
      const float w3[3] = {__ldg(wt + pair * 3), __ldg(wt + pair * 3 + 1),
                           __ldg(wt + pair * 3 + 2)};
      const float r3[3] = {__ldg(rt + pair * 3), __ldg(rt + pair * 3 + 1),
                           __ldg(rt + pair * 3 + 2)};
      // image_pi_grad: the image gradient composed with the projection
      const float zs = fabsf(pz) > 1e-12f ? pz : 1e-12f;
      const float zi = 1.0f / zs;
      const float zi2 = zi * zi;
      const float ax = fx * zi, ay = fy * zi;
      const float bx = fx * px * zi2, by = fy * py * zi2;
      // pose_jacobian_led's translation term: rho_c l_c (-n / L^3 + 3 (n.Rp)
      // Rp / L^5), n the normalized stored gradient, Rp = R p_cam
      float tv[3] = {0.f, 0.f, 0.f}, rho_l[3] = {0.f, 0.f, 0.f};
      if (kLed) {
        const float gx = __ldg(a.grad + n * 3), gy = __ldg(a.grad + n * 3 + 1),
                    gz = __ldg(a.grad + n * 3 + 2);
        const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
        const float nx = gx / gn, ny = gy / gn, nz = gz / gn;
        rho_l[0] = __ldg(a.albedo + n * 3) * lx;
        rho_l[1] = __ldg(a.albedo + n * 3 + 1) * ly;
        rho_l[2] = __ldg(a.albedo + n * 3 + 2) * lz;
        const float pn = fmaxf(sqrtf(px * px + py * py + pz * pz), 1e-12f);
        const float l3 = pn * pn * pn;
        const float l5 = l3 * pn * pn;
        float Rp[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) Rp[i] = Rm[i][0] * px + Rm[i][1] * py + Rm[i][2] * pz;
        const float nRp3 = 3.0f * (nx * Rp[0] + ny * Rp[1] + nz * Rp[2]);
        tv[0] = -nx / l3 + nRp3 * Rp[0] / l5;
        tv[1] = -ny / l3 + nRp3 * Rp[1] / l5;
        tv[2] = -nz / l3 + nRp3 * Rp[2] / l5;
      }
      const float gu3[3] = {g0.x, g1.x, g2.x}, gv3[3] = {g0.y, g1.y, g2.y};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gu = gu3[c], gv = gv3[c];
        const float G0 = gu * ax, G1 = gv * ay, G2 = -(gu * bx + gv * by);
        float J[6];
#pragma unroll
        for (int y = 0; y < 3; ++y) J[y] = -(G0 * Rm[y][0] + G1 * Rm[y][1] + G2 * Rm[y][2]);
        J[3] = G1 * pz - G2 * py;
        J[4] = G2 * px - G0 * pz;
        J[5] = G0 * py - G1 * px;
        if (kLed) {
#pragma unroll
          for (int y = 0; y < 3; ++y) J[y] += rho_l[c] * tv[y];
        }
        const float wc = w3[c];
        const float wr = wc * r3[c];
        int k = 0;
#pragma unroll
        for (int b = 0; b < 6; ++b) {
          const float wj = wc * J[b];
#pragma unroll
          for (int d = b; d < 6; ++d, ++k) acc[k] = fmaf(wj, J[d], acc[k]);
        }
#pragma unroll
        for (int b = 0; b < 6; ++b) acc[21 + b] = fmaf(J[b], wr, acc[21 + b]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPoseTerms; ++k) lane_sums[k * kThreads + tid] = acc[k];
  __syncthreads();
  write_partials(lane_sums, kPoseTerms, a.plan, a.f, a.partial);
}

template <int B>
__global__ void __launch_bounds__(kThreads, 2) light_tiles_kernel(LightArgs a) {
  constexpr int kH = B * (B + 1) / 2;
  constexpr int S = kH + B;
  extern __shared__ double lane_sums[];          // [S][kThreads]
  const int tid = threadIdx.x;
  const int FB = static_cast<int>(a.plan.frames);
  const int R = static_cast<int>(a.plan.lanes);
  const int lane = tid / FB, col = tid - lane * FB;
  const int64_t f = static_cast<int64_t>(blockIdx.y) * FB + col;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * a.plan.voxels;
  const int64_t v1 = v0 + a.plan.voxels < a.n ? v0 + a.plan.voxels : a.n;
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = 0.f;

  if (lane < R && f < a.f) {
    const float* __restrict__ wt = a.w;
    const float* __restrict__ rt = a.r;
    const float* __restrict__ Jt = a.J;
    for (int64_t n = v0 + lane; n < v1; n += R) {
      const int64_t pair = n * a.f + f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float wc = __ldg(wt + pair * 3 + c);
        const float wr = wc * __ldg(rt + pair * 3 + c);
        float j[B];
#pragma unroll
        for (int b = 0; b < B; ++b) j[b] = __ldg(Jt + (n * 3 + c) * B + b);
        int k = 0;
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
          for (int d = b; d < B; ++d, ++k) acc[k] = fmaf(wc, j[b] * j[d], acc[k]);
#pragma unroll
        for (int b = 0; b < B; ++b) acc[kH + b] = fmaf(wr, j[b], acc[kH + b]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) lane_sums[k * kThreads + tid] = acc[k];
  __syncthreads();
  write_partials(lane_sums, S, a.plan, a.f, a.partial);
}

// a block a keyframe: the tiles' partials [tiles,F,S] -> H [F,dim,dim] (both
// triangles) and g [F,dim], S = dim (dim + 1) / 2 + dim
__global__ void __launch_bounds__(kReduceThreads) normaleq_reduce_kernel(
    const double* __restrict__ partial, int64_t tiles, int64_t F, int dim,
    float* __restrict__ H, float* __restrict__ g) {
  __shared__ double sums[kReduceThreads];
  const int nH = dim * (dim + 1) / 2;
  const int S = nH + dim;
  const int ways = kReduceThreads / S;
  const int64_t f = blockIdx.x;
  const int tid = threadIdx.x;
  const int j = tid / S, k = tid - j * S;
  double s = 0.0;
  if (j < ways) {
#pragma unroll 4
    for (int64_t t = j; t < tiles; t += ways) s += partial[(t * F + f) * S + k];
  }
  sums[tid] = s;
  __syncthreads();
  if (tid >= S) return;
  double tot = 0.0;
  for (int q = 0; q < ways; ++q) tot += sums[q * S + tid];
  const float v = static_cast<float>(tot);
  if (tid >= nH) {
    g[f * dim + (tid - nH)] = v;
    return;
  }
  int b = 0, rest = tid;
  while (rest >= dim - b) {
    rest -= dim - b;
    ++b;
  }
  const int d = b + rest;
  H[(f * dim + b) * dim + d] = v;
  H[(f * dim + d) * dim + b] = v;
}

int reduce(const double* partial, const ReducePlan& plan, int64_t F, int dim, float* H,
           float* g, cudaStream_t stream) {
  normaleq_reduce_kernel<<<static_cast<unsigned>(F), kReduceThreads, 0, stream>>>(
      partial, plan.tiles, F, dim, H, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One call: the tile pass, then the reduction; returns the first CUDA error
// (0: both launched).
int pose_normal_eqs(const PoseArgs* a, cudaStream_t stream) {
  const size_t smem = sizeof(double) * kPoseTerms * kThreads;
  const dim3 grid(static_cast<unsigned>(a->plan.tiles), static_cast<unsigned>(a->plan.chunks));
  const auto kernel = a->led ? pose_tiles_kernel<true> : pose_tiles_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(a->partial, a->plan, a->f, 6, a->H, a->g, stream);
}

int light_normal_eqs_sh(const LightArgs* a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a->plan.tiles), static_cast<unsigned>(a->plan.chunks));
  const int B = static_cast<int>(a->basis);
  const size_t smem = sizeof(double) * (B * (B + 1) / 2 + B) * kThreads;
  if (B != 4 && B != 9) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = B == 4 ? light_tiles_kernel<4> : light_tiles_kernel<9>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(a->partial, a->plan, a->f, B, a->H, a->g, stream);
}

}  // extern "C"
