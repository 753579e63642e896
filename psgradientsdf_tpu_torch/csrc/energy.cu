// The refinement's four energies for Hopper (sm_90a): the photometric sum
// and the normal, Laplacian and albedo regularizer sums over a surface set,
// and the four energies (each sum over the surface count), in one launch.
//
// Replaces the JAX package's psgradientsdf_tpu/refine/optimizer.py
// `_energy_from_rd` (:60-73), one device program over refine/render.py
// `ps_energy` (:165), `normal_energy` (:175), `laplacian_energy` (:184) and
// `albedo_reg_energy` (:192).  The port's plain version (ops/energy.py
// `energy_sums_plain` over refine/render.py's *_sum terms) is a chain of
// about 40 eager ops and four reductions, evaluated after every block.
//
// energy_sums_kernel<LOSS, VEC>, the robust loss a template argument (its
// five kinds in the order of ops/energy.py's LOSS_KINDS), a persistent grid
// of `blocks` blocks (ops/energy.py energy_blocks: at most two an SM) of
// 512 threads in two roles fixed by the warp:
//   * 8 pair warps stream the (voxel, keyframe) pairs in groups of four:
//     a group's four mask bytes as one 32-bit load, its 48 bytes of r as
//     three 16-byte loads issued only where a mask byte is set (a group of
//     uncounted pairs moves no r).  Pair thread q of Q takes groups q,
//     q + Q, q + 2Q, ..., kUnroll groups a step, the masks of the next step
//     loaded before this step's arithmetic, so a step waits for one load.
//     A pair whose mask is set adds the sum over its 3 channels of rho(r)
//     (PS).  Where r or the mask does not lie on a 16- or 4-byte boundary
//     (a row slice of a larger tensor: VEC false), and for the last,
//     partial group, the same groups are read by scalar loads in the same
//     order: the order does not depend on alignment.
//   * 8 row warps take the voxel rows, row thread j of R rows j, j + R, ...,
//     two rows a step: a row whose `valid` is set adds (|fd_grad| - 1)^2
//     (normal), fd_laplacian^2 (Laplacian) and the sum over the channels of
//     the norm of the albedo's one-sided differences over the 3 axes
//     (albedo), each stencil neighbour read through its compact index or,
//     where the index is -1, from the problem's frozen constant
//     (gather_nbr).  Every load of a row is issued before its gathers,
//     whatever its `valid`: two rounds of loads a row.  The gathers overlap
//     the pair warps' stream.
// A term left out of `terms` is not evaluated and sums to 0.  A thread adds
// its values in double; each warp adds its lanes' sums by an xor butterfly,
// thread k of the block adds term k's warp sums in warp order and writes
// the block's partial into part[k][blocks]; the last block to finish,
// elected by an integer ticket, reads the partials with every thread (128
// threads a term, a fixed stride, then the butterfly and the warp order),
// writes the four sums as float (and, given the surface count, the four
// energies) and sets the ticket back to 0.  No float atomics: the order of
// every addition depends on the shapes and the block count alone, and two
// launches give the same bits.
//
// Bound on the card: bytes.  Every pair's mask byte is read and a counted
// pair's r (12 bytes); every row's valid byte, and a valid row's state and
// stencil once (dist 4, albedo 12, direction 12, indices 24 + 48,
// constants 12 + 36 + 24 bytes: 172); the eight results written.  At the
// main problem's N = 49152 slots, F = 40 keyframes, about 1.09 M counted
// pairs and 40588 valid rows that is 22 MB, 0.0066 ms at 3.35 TB/s
// (chip_smoke.py _energy_case computes it from each run's mask and valid).
// The arithmetic is a few dozen float operations a pair or row.  The
// uncounted pairs' r shares lines with the counted ones' and is mostly read
// all the same.
//
// Plain C interface (loaded with ctypes): energy_sums() launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// the launch's CUDA error as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The C interface's argument block: every field 8 bytes wide, in this
// order (ops/energy.py builds the same block with ctypes).
struct EnergyArgs {
  const float* r;                 // [N, F, 3]
  const uint8_t* mask;            // [N, F] bool
  const uint8_t* valid;           // [N] bool
  const float* dist;              // [N]
  const float* albedo;            // [N, 3]
  const float* nbr_dir;           // [N, 3]
  const int64_t* nbr_idx;         // [N, 3]
  const float* nbr_dist_const;    // [N, 3]
  const float* nbr_albedo_const;  // [N, 3 (axis), 3 (channel)]
  const int64_t* lap_idx;         // [N, 6]
  const float* lap_dist_const;    // [N, 6]
  double* part;                   // [4, blocks]
  int* ticket;                    // one int, 0 between launches
  float* out;                     // [8]: the sums, then the energies
  int64_t N, F, terms, loss, has_count, blocks;
  double lam, voxel, count;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPairThreads = 256;                         // warps 0-7
constexpr int kRowThreads = kThreads - kPairThreads;      // warps 8-15
constexpr int kUnroll = 2;                                // pair groups a step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPs = 1, kNormal = 2, kLaplacian = 4, kAlbedo = 8;
// the five robust losses, in the order of ops/energy.py's LOSS_KINDS
enum Loss { kL2 = 0, kCauchy = 1, kHuber = 2, kTukey = 3, kTruncL2 = 4 };

struct LossConsts {
  float inv_lam;   // 1 / lam, as PyTorch divides a tensor by a number
  float lam;
  float lam_sq;    // lam * lam, taken in double and rounded once
  float half_lam;  // 0.5 lam, likewise
};

// rho(r) of utils/robust.py loss_value
template <int LOSS>
__device__ __forceinline__ float rho(float r, const LossConsts& k) {
  if (LOSS == kCauchy) {
    const float t = __fmul_rn(r, k.inv_lam);
    return log1pf(__fmul_rn(t, t));
  } else if (LOSS == kTukey) {
    const float t = __fmul_rn(r, k.inv_lam);
    const float u = __fsub_rn(1.0f, __fmul_rn(t, t));
    const float v = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(u, u), u));
    return __fmul_rn(r, r) < k.lam_sq ? v : 1.0f;
  } else if (LOSS == kHuber) {
    const float sq = __fmul_rn(r, r);
    const float quad = __fmul_rn(0.5f, sq);
    const float lin = __fmul_rn(k.lam, __fsub_rn(fabsf(r), k.half_lam));
    return sq < k.lam_sq ? quad : lin;
  } else if (LOSS == kTruncL2) {
    float c = r;
    if (c < -k.lam) c = -k.lam;             // NaN stays NaN, as torch.clamp
    if (c > k.lam) c = k.lam;
    return __fmul_rn(c, c);
  }
  return __fmul_rn(r, r);
}

template <int LOSS>
__device__ __forceinline__ float pair_rho(float r0, float r1, float r2, const LossConsts& k) {
  return __fadd_rn(__fadd_rn(rho<LOSS>(r0, k), rho<LOSS>(r1, k)), rho<LOSS>(r2, k));
}

// Group g's mask bytes (byte j is pair j's): one 32-bit load on the
// vector path, else a byte a pair (0 past the last pair).
template <bool VEC>
__device__ __forceinline__ uint32_t group_mask(const EnergyArgs& a, int64_t g, int64_t full,
                                               int64_t pairs) {
  if (VEC && g < full) return __ldg(reinterpret_cast<const uint32_t*>(a.mask) + g);
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (4 * g + j < pairs) m |= static_cast<uint32_t>(__ldg(a.mask + 4 * g + j)) << (8 * j);
  return m;
}

// Group g's twelve floats of r where its mask has a byte set (else 0):
// three 16-byte loads on the vector path, else a float at a time for the
// pairs whose byte is set.
template <bool VEC>
__device__ __forceinline__ void group_r(const EnergyArgs& a, int64_t g, int64_t full,
                                        uint32_t m, float4 (&v)[3]) {
  v[0] = v[1] = v[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (m == 0) return;
  if (VEC && g < full) {
    const float4* p = reinterpret_cast<const float4*>(a.r) + 3 * g;
    v[0] = __ldg(p);
    v[1] = __ldg(p + 1);
    v[2] = __ldg(p + 2);
    return;
  }
  float x[12];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[3 * j + c] = (m >> (8 * j)) & 0xffu ? __ldg(a.r + 12 * g + 3 * j + c) : 0.0f;
  v[0] = make_float4(x[0], x[1], x[2], x[3]);
  v[1] = make_float4(x[4], x[5], x[6], x[7]);
  v[2] = make_float4(x[8], x[9], x[10], x[11]);
}

// a group's counted pairs added to acc, pair 0 first
template <int LOSS>
__device__ __forceinline__ void add_group(uint32_t m, const float4 (&v)[3],
                                          const LossConsts& k, double& acc) {
  if (m & 0xffu) acc += static_cast<double>(pair_rho<LOSS>(v[0].x, v[0].y, v[0].z, k));
  if (m & 0xff00u) acc += static_cast<double>(pair_rho<LOSS>(v[0].w, v[1].x, v[1].y, k));
  if (m & 0xff0000u) acc += static_cast<double>(pair_rho<LOSS>(v[1].z, v[1].w, v[2].x, k));
  if (m & 0xff000000u) acc += static_cast<double>(pair_rho<LOSS>(v[2].y, v[2].z, v[2].w, k));
}

// PS: pair thread q of Q over the groups q, q + Q, ..., in that order
template <int LOSS, bool VEC>
__device__ __forceinline__ double ps_stream(const EnergyArgs& a, int64_t q, int64_t Q) {
  LossConsts k;
  k.lam = static_cast<float>(a.lam);
  k.inv_lam = __fdiv_rn(1.0f, k.lam);
  k.lam_sq = static_cast<float>(a.lam * a.lam);
  k.half_lam = static_cast<float>(0.5 * a.lam);
  const int64_t pairs = a.N * a.F;
  const int64_t groups = (pairs + 3) / 4, full = pairs / 4;
  double acc = 0.0;
  uint32_t m[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t g = q + u * Q;
    m[u] = g < groups ? group_mask<VEC>(a, g, full, pairs) : 0u;
  }
  for (int64_t g0 = q; g0 < groups; g0 += kUnroll * Q) {
    float4 v[kUnroll][3];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) group_r<VEC>(a, g0 + u * Q, full, m[u], v[u]);
    uint32_t next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + (kUnroll + u) * Q;
      next[u] = g < groups ? group_mask<VEC>(a, g, full, pairs) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add_group<LOSS>(m[u], v[u], k, acc);
      m[u] = next[u];
    }
  }
  return acc;
}

// A row's three regularizer terms (0 where its term is left out or the row
// is not valid): the row's own values and indices read first, whatever its
// `valid`, then the neighbours' gathers of a valid row.
struct RowTerms {
  float normal, laplacian, albedo;
};

__device__ __forceinline__ RowTerms row_terms(const EnergyArgs& a, int64_t n, int terms,
                                              float inv_h, float inv_h2) {
  RowTerms t = {0.0f, 0.0f, 0.0f};
  const bool ok = a.valid[n] != 0;
  const float d0 = a.dist[n];
  if (terms & kNormal) {
    int64_t m[3];
    float dir[3], dc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      m[i] = a.nbr_idx[3 * n + i];
      dir[i] = a.nbr_dir[3 * n + i];
      dc[i] = a.nbr_dist_const[3 * n + i];
    }
    float g[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float dn = ok && m[i] >= 0 ? a.dist[m[i]] : dc[i];
      g[i] = __fmul_rn(__fmul_rn(dir[i], __fsub_rn(dn, d0)), inv_h);
    }
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                              __fmul_rn(g[2], g[2]));
    const float e = __fsub_rn(__fsqrt_rn(s), 1.0f);
    t.normal = ok ? __fmul_rn(e, e) : 0.0f;
  }
  if (terms & kLaplacian) {
    int64_t m[6];
    float dc[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      m[i] = a.lap_idx[6 * n + i];
      dc[i] = a.lap_dist_const[6 * n + i];
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) s = __fadd_rn(s, ok && m[i] >= 0 ? a.dist[m[i]] : dc[i]);
    const float l = __fmul_rn(__fsub_rn(s, __fmul_rn(6.0f, d0)), inv_h2);
    t.laplacian = ok ? __fmul_rn(l, l) : 0.0f;
  }
  if (terms & kAlbedo) {
    int64_t m[3];
    float dir[3], a0[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      m[i] = a.nbr_idx[3 * n + i];
      dir[i] = a.nbr_dir[3 * n + i];
      a0[i] = a.albedo[3 * n + i];
    }
    float sq[3] = {0.0f, 0.0f, 0.0f};       // per channel, over the axes
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float an = ok && m[i] >= 0 ? a.albedo[3 * m[i] + ch]
                                         : a.nbr_albedo_const[9 * n + 3 * i + ch];
        const float g = __fmul_rn(__fmul_rn(dir[i], __fsub_rn(an, a0[ch])), inv_h);
        sq[ch] = __fadd_rn(sq[ch], __fmul_rn(g, g));
      }
    }
    const float e = __fadd_rn(__fadd_rn(__fsqrt_rn(sq[0]), __fsqrt_rn(sq[1])), __fsqrt_rn(sq[2]));
    t.albedo = ok ? e : 0.0f;
  }
  return t;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

template <int LOSS, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
energy_sums_kernel(EnergyArgs a) {
  __shared__ double wsum[kWarps][4];
  __shared__ int last;
  const int terms = static_cast<int>(a.terms);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks = static_cast<int>(gridDim.x);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};

  if (threadIdx.x < kPairThreads) {
    if (terms & kPs)
      acc[0] = ps_stream<LOSS, VEC>(a, static_cast<int64_t>(blockIdx.x) * kPairThreads + threadIdx.x,
                                    static_cast<int64_t>(blocks) * kPairThreads);
  } else if (terms & (kNormal | kLaplacian | kAlbedo)) {
    const float inv_h = __fdiv_rn(1.0f, static_cast<float>(a.voxel));
    const float inv_h2 = __fdiv_rn(1.0f, static_cast<float>(a.voxel * a.voxel));
    const int64_t R = static_cast<int64_t>(blocks) * kRowThreads;
    for (int64_t n = static_cast<int64_t>(blockIdx.x) * kRowThreads +
                     (threadIdx.x - kPairThreads);
         n < a.N; n += 2 * R) {
      const RowTerms t0 = row_terms(a, n, terms, inv_h, inv_h2);
      const RowTerms t1 = n + R < a.N ? row_terms(a, n + R, terms, inv_h, inv_h2)
                                      : RowTerms{0.0f, 0.0f, 0.0f};
      acc[1] += static_cast<double>(t0.normal);
      acc[2] += static_cast<double>(t0.laplacian);
      acc[3] += static_cast<double>(t0.albedo);
      acc[1] += static_cast<double>(t1.normal);
      acc[2] += static_cast<double>(t1.laplacian);
      acc[3] += static_cast<double>(t1.albedo);
    }
  }

  // the block's partials: each warp's butterfly, then the warps in order
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) wsum[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][k];
    a.part[static_cast<int64_t>(k) * blocks + blockIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: term k's partials by threads 128 k .. 128 k + 127, a
  // thread blocks j, j + 128, ..., then the butterfly and the four warps
  {
    const int k = threadIdx.x / 128, j = threadIdx.x % 128;
    double s = 0.0;
    for (int b = j; b < blocks; b += 128) s += __ldcg(a.part + static_cast<int64_t>(k) * blocks + b);
    s = warp_sum(s);
    if (lane == 0) wsum[warp][0] = s;
    __syncthreads();
    if (threadIdx.x < 4) {
      const int kk = threadIdx.x;
      double t = 0.0;
      for (int w = 4 * kk; w < 4 * kk + 4; ++w) t += wsum[w][0];
      const float sum = static_cast<float>(t);
      a.out[kk] = sum;
      if (a.has_count) a.out[4 + kk] = __fdiv_rn(sum, static_cast<float>(a.count));
    }
  }
  if (threadIdx.x == 0) *a.ticket = 0;
}

template <int LOSS>
cudaError_t launch(const EnergyArgs* a, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(a->r) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a->mask) % 4 == 0;
  const unsigned blocks = static_cast<unsigned>(a->blocks);
  if (vec)
    energy_sums_kernel<LOSS, true><<<blocks, kThreads, 0, stream>>>(*a);
  else
    energy_sums_kernel<LOSS, false><<<blocks, kThreads, 0, stream>>>(*a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int energy_sums(const EnergyArgs* a, void* stream) {
  if (a->N < 0 || a->F < 0 || a->blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->loss) {
    case kL2: return static_cast<int>(launch<kL2>(a, s));
    case kCauchy: return static_cast<int>(launch<kCauchy>(a, s));
    case kHuber: return static_cast<int>(launch<kHuber>(a, s));
    case kTukey: return static_cast<int>(launch<kTukey>(a, s));
    case kTruncL2: return static_cast<int>(launch<kTruncL2>(a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
