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
// energy_sums_kernel<LOSS>, the robust loss a template argument (its five
// kinds in the order of ops/energy.py's LOSS_KINDS), a grid of `blocks`
// blocks of 256 threads, the grid striding over:
//   1. the (voxel, keyframe) pairs, where rd.mask is set: sum over the 3
//      channels of rho(r) (PS);
//   2. the voxel rows whose `valid` is set: (|fd_grad| - 1)^2 (normal),
//      fd_laplacian^2 (Laplacian) and the sum over the channels of the
//      norm of the albedo's one-sided differences over the 3 axes (albedo),
//      each stencil neighbour read through its compact index or, where the
//      index is -1, from the problem's frozen constant (gather_nbr).
// A term left out of `terms` is not evaluated and sums to 0.  A thread
// adds its values in double; a block adds its threads' in a fixed tree and
// writes its four partials; the last block to finish, elected by an
// integer ticket, adds the partials in block order, writes the four sums
// as float (and, given the surface count, the four energies) and sets the
// ticket back to 0.  No float atomics: a call's bits depend on its inputs
// and its block count alone.
//
// Bound on the card: bytes.  A pair reads r (12 bytes) and its mask byte;
// a row its state and stencil (dist, albedo, direction, indices and
// constants: 173 bytes).  At N = 49152, F = 40 that is 34 MB, 0.010 ms at
// 3.35 TB/s.  The arithmetic is a few dozen float operations a pair or
// row.  The design's aim is one launch with no intermediate in device
// memory, where the plain chain makes some 40 launches and writes its
// [N, F] and [N, 3, 3] intermediates.
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
  double* part;                   // [blocks, 4]
  int* ticket;                    // one int, 0 between launches
  float* out;                     // [8]: the sums, then the energies
  int64_t N, F, terms, loss, has_count, blocks;
  double lam, voxel, count;
};

namespace {

constexpr int kThreads = 256;
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
__global__ void __launch_bounds__(kThreads)
energy_sums_kernel(EnergyArgs a) {
  __shared__ double red[4][kThreads];
  __shared__ int last;
  const int64_t N = a.N, F = a.F;
  const int terms = static_cast<int>(a.terms);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};

  if (terms & kPs) {
    LossConsts k;
    k.lam = static_cast<float>(a.lam);
    k.inv_lam = __fdiv_rn(1.0f, k.lam);
    k.lam_sq = static_cast<float>(a.lam * a.lam);
    k.half_lam = static_cast<float>(0.5 * a.lam);
    for (int64_t p = first; p < N * F; p += stride) {
      if (!a.mask[p]) continue;
      const float* r = a.r + 3 * p;
      const float s = __fadd_rn(__fadd_rn(rho<LOSS>(r[0], k), rho<LOSS>(r[1], k)),
                                rho<LOSS>(r[2], k));
      acc[0] += static_cast<double>(s);
    }
  }

  if (terms & (kNormal | kLaplacian | kAlbedo)) {
    const float inv_h = __fdiv_rn(1.0f, static_cast<float>(a.voxel));
    const float inv_h2 = __fdiv_rn(1.0f, static_cast<float>(a.voxel * a.voxel));
    for (int64_t n = first; n < N; n += stride) {
      if (!a.valid[n]) continue;
      const float d0 = a.dist[n];
      if (terms & kNormal) {
        float g[3];
        for (int i = 0; i < 3; ++i) {
          const int64_t m = a.nbr_idx[3 * n + i];
          const float dn = m >= 0 ? a.dist[m] : a.nbr_dist_const[3 * n + i];
          g[i] = __fmul_rn(__fmul_rn(a.nbr_dir[3 * n + i], __fsub_rn(dn, d0)), inv_h);
        }
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                                  __fmul_rn(g[2], g[2]));
        const float e = __fsub_rn(__fsqrt_rn(s), 1.0f);
        acc[1] += static_cast<double>(__fmul_rn(e, e));
      }
      if (terms & kLaplacian) {
        float s = 0.0f;
        for (int i = 0; i < 6; ++i) {
          const int64_t m = a.lap_idx[6 * n + i];
          s = __fadd_rn(s, m >= 0 ? a.dist[m] : a.lap_dist_const[6 * n + i]);
        }
        const float l = __fmul_rn(__fsub_rn(s, __fmul_rn(6.0f, d0)), inv_h2);
        acc[2] += static_cast<double>(__fmul_rn(l, l));
      }
      if (terms & kAlbedo) {
        float sq[3] = {0.0f, 0.0f, 0.0f};     // per channel, over the axes
        for (int i = 0; i < 3; ++i) {
          const int64_t m = a.nbr_idx[3 * n + i];
          const float dir = a.nbr_dir[3 * n + i];
          for (int ch = 0; ch < 3; ++ch) {
            const float an = m >= 0 ? a.albedo[3 * m + ch]
                                    : a.nbr_albedo_const[9 * n + 3 * i + ch];
            const float g = __fmul_rn(__fmul_rn(dir, __fsub_rn(an, a.albedo[3 * n + ch])),
                                      inv_h);
            sq[ch] = __fadd_rn(sq[ch], __fmul_rn(g, g));
          }
        }
        const float e = __fadd_rn(__fadd_rn(__fsqrt_rn(sq[0]), __fsqrt_rn(sq[1])),
                                  __fsqrt_rn(sq[2]));
        acc[3] += static_cast<double>(e);
      }
    }
  }

  for (int k = 0; k < 4; ++k) red[k][threadIdx.x] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int k = 0; k < 4; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) a.part[4 * blockIdx.x + k] = red[k][0];
    __threadfence();
    last = atomicAdd(a.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    const volatile double* p = a.part;
    double s = 0.0;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) s += p[4 * b + k];
    const float sum = static_cast<float>(s);
    a.out[k] = sum;
    if (a.has_count) a.out[4 + k] = __fdiv_rn(sum, static_cast<float>(a.count));
  }
  if (threadIdx.x == 0) *a.ticket = 0;
}

template <int LOSS>
cudaError_t launch(const EnergyArgs* a, cudaStream_t stream) {
  energy_sums_kernel<LOSS><<<static_cast<unsigned>(a->blocks), kThreads, 0, stream>>>(*a);
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
