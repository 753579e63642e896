// The refinement's pose and light normal equations for Hopper (sm_90a): per
// keyframe, the weighted Gram matrix of a block's Jacobian rows and its
// gradient, summed over the surface voxels and the three channels.
//
//   pose_normal_eqs      H [F,6,6], g [F,6] of the pose block (SH and LED)
//   light_normal_eqs_sh  H [F,B,B], g [F,B] of the SH light block (B = 4, 9)
//   light_normal_eqs_led H [3], g [3] of the LED light block
//
// pose_normal_eqs replaces the JAX package's psgradientsdf_tpu/refine/
// optimizer.py `_pose_normal_eqs` (:208) and its chunk loop in `_pose_core`
// (:222): refine/jacobians.py `image_pi_grad` (:44), `pose_jacobian_sh`
// (:72) or `pose_jacobian_led` (:84), then the einsums nfc,nfcb,nfcd->fbd
// and nfc,nfcb,nfc->fb.  light_normal_eqs_sh replaces refine/solvers.py
// `solve_light_sh`'s (:512) einsums nfc,ncb,ncd->fbd and nfc,ncb,nfc->fb
// (:526-527); its batched eigen-solve stays in PyTorch.
// light_normal_eqs_led replaces refine/solvers.py `solve_light_led`'s (:538)
// two einsums nfc,nfc->c over refine/jacobians.py `light_jacobian_led`
// (:161); its damped 3-element solve stays in PyTorch.  It is the last
// section of this file (light_led_kernel): simpler than the tiles above.
//
// Bound by bytes.  A pose pair (voxel, keyframe) reads g_img (24 bytes),
// p_cam, w and r (12 each): 60 bytes, 118 MB at N = 49152, F = 40, 0.035
// ms at 3.35 TB/s; a light pair reads w and r: 24 bytes, 0.014 ms.  The
// products are few (27 a pose pair-channel), so the kernel streams each
// input once, writes nothing per pair, and is ONE launch a call:
//
// *_tiles_kernel, block (tile, chunk) of a host plan (ops/normaleq.
//   _reduce_plan): the tile's voxels x the chunk's FB keyframe columns.
//   - A producer warp stages the tile's inputs into a ring of `stages`
//     shared-memory buffers, `stage_voxels` voxels each, by bulk
//     asynchronous copies (cp.async.bulk) that complete on the buffer's
//     mbarrier: a stage of a pair array [N,F,...] is one contiguous span
//     (one span a voxel row of the chunk's pairs where F is cut into
//     chunks), of a voxel array [N,...] one span.  A span's 16-byte-aligned
//     body is one bulk copy; its ragged head and tail (an unaligned base, a
//     tile ending at N) the producer's lanes load themselves.  The span
//     sits in its region at its address modulo 16, so the body is aligned
//     there too.  Tiles and stages are multiples of 4 voxels, so an aligned
//     base gives whole bodies.
//   - 256 consumer threads, FB columns x R voxel lanes: thread (lane,
//     column) owns keyframe f of its column and adds the pairs (n, f) for
//     the stage's voxels lane, lane + R, ... in order, each pair's Jacobian
//     terms formed in registers and never stored.  It sums them in float,
//     over runs of at most kLaneVoxels voxels, each run then added in
//     double into its slot of `sums` [S][256] in shared memory (S = 27 for
//     the pose, B (B + 1) / 2 + B for the light).  Consecutive threads read
//     consecutive pairs, 12 or 24 bytes apart: no bank conflict.
//   - The pose's rows are a = -R G + (under the LED) the translation's
//     near-field term and b = G x p (G: the image gradient composed with
//     the projection, image_pi_grad).  Under the LED a thread forms them
//     and sums w a a^T-style products directly (H's upper triangle row by
//     row, then g).  Under SH it sums the pair's factors instead, W = sum_c
//     w G G^T, u = sum_c w r G and their products with p's cross-product
//     matrix (27 sums, about two thirds of the operations), and the last
//     block turns them by R_f in double (write_column).  The light sums w
//     J_b J_d and w r J_b directly.
//   - The epilogue: a column's lanes are added in double, where FB < 32
//     first within each warp by a butterfly of shuffles (the warp holds
//     32 / FB lanes of each column), then across the warps (or where FB >=
//     32 across all lanes) through `sums` in a column-fastest order: no
//     bank conflict.  The tile's column sums stay in `sums` [S][FB].
//   - The reduction over tiles: the grid is cut into clusters of `cluster`
//     blocks along the tiles; after a cluster barrier, block rank q adds
//     the cluster's sums of its slice of the keyframe columns from every
//     block's shared memory (distributed shared memory, in rank order) and
//     writes them, coalesced, to partial [chunks][clusters][S][FB] in
//     double.  Then an integer ticket (one a chunk and rank, drawn with
//     release and acquire order, as __threadfence() around an atomicAdd)
//     elects the last of the chunk's rank-q blocks, which adds its columns
//     over every cluster in cluster order (coherent loads: the other
//     blocks wrote them in this launch), rounds to float, writes H (both
//     triangles from one sum) and g, and resets its ticket to 0 for the
//     next call.
//
// No float atomics: every sum runs in one fixed order, whichever block
// finishes last, so two runs give the same bits.  The plain versions sum
// their float products in float32 in cuBLAS's or the CPU's order, the
// kernel sums float products in short float runs and then in double (and
// the SH pose factors the products), so the two agree to float32 rounding
// of the sums.  (Summing every product in double costs a conversion and a
// double FMA a product, and the B = 9 light's accumulators twice the
// registers: slower on the card, tools/normaleq_ab.py.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "stencil.cuh"

namespace cg = cooperative_groups;

struct NormalEqPlan {               // ops/normaleq.NormalEqPlan, field for field
  int64_t frames;                   // FB: keyframe columns a block
  int64_t lanes;                    // R: voxel lanes a block
  int64_t chunks;                   // keyframe chunks (grid.y)
  int64_t voxels;                   // voxels a tile
  int64_t tiles;                    // tiles (grid.x), a multiple of cluster
  int64_t cluster;                  // blocks a cluster
  int64_t stage_voxels;             // voxels a stage
  int64_t stages;                   // buffers of the ring
  int64_t rows;                     // 1: a pair array's stage is one span a voxel row
  int64_t stage_bytes;              // bytes a buffer
  int64_t ring;                     // offset of the ring (0, or after the sums)
  int64_t barriers;                 // offset of the barriers (after the ring and the sums)
  int64_t smem;                     // dynamic shared memory a block
  int64_t offset[6];                // each staged array's region within a buffer
  int64_t pitch[6];                 // bytes from one voxel's row to the next's there
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
  double* partial;                  // [chunks, clusters, 27, FB]
  unsigned* tickets;                // [chunks, cluster], 0 between calls
  float* H;                         // [F,6,6]
  float* g;                         // [F,6]
  int64_t n, f, led;
  NormalEqPlan plan;
};

struct LightArgs {                  // ops/normaleq._LightArgs
  const float* w;                   // [N,F,3]
  const float* r;                   // [N,F,3]
  const float* J;                   // [N,3,B]
  double* partial;                  // [chunks, clusters, S, FB]
  unsigned* tickets;                // [chunks, cluster], 0 between calls
  float* H;                         // [F,B,B]
  float* g;                         // [F,B]
  int64_t n, f, basis;
  NormalEqPlan plan;
};

struct LightLedArgs {               // ops/normaleq._LightLedArgs
  const float* w;                   // [N,F,3]
  const float* r;                   // [N,F,3]
  const int32_t* idx_xyz;           // [N,3] voxel coordinates
  const float* dist;                // [N]
  const float* grad;                // [N,3] the stored gradient
  const float* albedo;              // [N,3]
  const float* poses;               // [F,4,4]
  double* partial;                  // [6, blocks]
  unsigned* ticket;                 // one, 0 between calls
  float* H;                         // [3]
  float* g;                         // [3]
  int64_t n, f, blocks;
  double origin_x, origin_y, origin_z, grid_voxel;
  // the rest of the host plan (ops/normaleq.led_plan)
  int64_t unit_voxels;              // voxels a warp's unit (at most 32)
  int64_t smem;                     // dynamic shared memory a block
};

namespace {

constexpr int kConsumers = 256;               // ops/normaleq.THREADS
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kPoseTerms = 27;                // ops/normaleq.POSE_TERMS
constexpr int kLaneVoxels = 32;               // ops/normaleq.LANE_VOXELS
constexpr int kRegisterTerms = 27;            // ops/normaleq.REGISTER_TERMS

// ------------------------------------------------------------ staged arrays

// One staged input: a pair array [N,F,...] (`eb` bytes a pair) or a voxel
// array [N,...] (`eb` bytes a voxel, one "column").
struct Staged {
  const unsigned char* base;
  int64_t stride;                   // bytes a voxel in device memory
  int64_t col0;                     // bytes of a row before the chunk's first pair
  int64_t width;                    // bytes of a row the chunk reads
  int64_t offset, pitch;            // its region in a buffer; bytes a voxel row there
  bool rows;                        // one span a voxel row (else one a stage)
};

__device__ __forceinline__ Staged staged(const void* base, int64_t eb, bool pair, int i,
                                         const NormalEqPlan& p, int64_t F, int64_t f0,
                                         int64_t here) {
  Staged s;
  s.base = static_cast<const unsigned char*>(base);
  s.rows = pair && p.rows != 0;
  s.stride = pair ? F * eb : eb;
  s.col0 = s.rows ? f0 * eb : 0;
  s.width = pair ? here * eb : eb;
  s.offset = p.offset[i];
  s.pitch = p.pitch[i];
  return s;
}

// the address in device memory of voxel n's row of the chunk's pairs
__device__ __forceinline__ uintptr_t row_global(const Staged& a, int64_t n) {
  return reinterpret_cast<uintptr_t>(a.base) + n * a.stride + a.col0;
}

// span k of array a's stage [n0, n0 + nv): its start, bytes and place
__device__ __forceinline__ void span_of(const Staged& a, unsigned char* sb, int64_t n0, int nv,
                                        int k, uintptr_t& g, int64_t& bytes,
                                        unsigned char*& s) {
  g = row_global(a, n0 + k);
  bytes = a.rows ? a.width : nv * a.stride;
  s = sb + a.offset + static_cast<int64_t>(k) * a.pitch + (g & 15);
}

// Where a consumer finds its pairs of an array in a staged buffer: a span
// sits at its address modulo 16, one span a stage (voxel row v at base + v
// pitch) or one a voxel row (each row at its own address modulo 16); the
// thread's column `colb` bytes into the row.  Uniform over the block.
struct Rows {
  const unsigned char* base;        // row 0 of the stage
  uint32_t pitch;                   // bytes from one row to the next in the buffer
  uint32_t lo, stride;              // one span a row: row 0's device address, bytes a row
  bool rows;

  __device__ __forceinline__ const float* at(int v, int colb) const {
    const uint32_t shift = rows ? ((lo + v * stride) & 15u) : 0u;
    return reinterpret_cast<const float*>(base + (v * pitch + shift + colb));
  }
};

__device__ __forceinline__ Rows rows_of(const Staged& a, const unsigned char* sb, int64_t n0) {
  const uintptr_t g = row_global(a, n0);
  Rows r;
  r.rows = a.rows;
  r.pitch = static_cast<uint32_t>(a.pitch);
  r.lo = static_cast<uint32_t>(g);
  r.stride = static_cast<uint32_t>(a.stride);
  r.base = sb + a.offset + (a.rows ? 0 : (g & 15));
  return r;
}

// A span [g, g + bytes) splits into a head up to the first 16-byte boundary,
// a body of whole 16-byte chunks (one bulk copy) and a tail.
__device__ __forceinline__ void span_parts(uintptr_t g, int64_t bytes, int64_t& head,
                                           int64_t& body) {
  head = static_cast<int64_t>((16 - (g & 15)) & 15);
  if (head > bytes) head = bytes;
  body = (bytes - head) & ~static_cast<int64_t>(15);
}

// The producer warp stages [n0, n0 + nv) of its arrays into buffer sb: lane
// 0 arrives on `full` expecting the bodies' bytes, the lanes issue the bulk
// copies of their spans and load the ragged ends themselves, and lane 0
// arrives again (full counts two arrivals).
template <int kArrays>
__device__ void produce(const Staged (&arr)[kArrays], unsigned char* sb, int64_t n0, int nv,
                        uint64_t* full, int lane) {
  uint32_t bodies = 0;
#pragma unroll
  for (int i = 0; i < kArrays; ++i) {
    const int spans = arr[i].rows ? nv : 1;
    for (int k = lane; k < spans; k += 32) {
      uintptr_t g;
      int64_t bytes, head, body;
      unsigned char* s;
      span_of(arr[i], sb, n0, nv, k, g, bytes, s);
      span_parts(g, bytes, head, body);
      bodies += static_cast<uint32_t>(body);
    }
  }
  bodies = __reduce_add_sync(0xffffffffu, bodies);
  if (lane == 0) mbar_arrive_expect_tx(full, bodies);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kArrays; ++i) {
    const int spans = arr[i].rows ? nv : 1;
    for (int k = lane; k < spans; k += 32) {
      uintptr_t g;
      int64_t bytes, head, body;
      unsigned char* s;
      span_of(arr[i], sb, n0, nv, k, g, bytes, s);
      span_parts(g, bytes, head, body);
      const unsigned char* gp = reinterpret_cast<const unsigned char*>(g);
      if (body > 0) bulk_load(s + head, gp + head, static_cast<uint32_t>(body), full);
      for (int64_t o = 0; o < bytes - body; o += 4) {
        const int64_t at = o < head ? o : o + body;
        *reinterpret_cast<float*>(s + at) = __ldg(reinterpret_cast<const float*>(gp + at));
      }
    }
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// The block's shared memory: sums [S][kConsumers] (double) at 0, the ring at
// plan.ring (0 where the threads keep their sums in registers until the
// loop ends: the sums then take the ring's place), then at plan.barriers
// the full and empty barriers of each buffer and a flag.
struct Block {
  double* sums;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  int* flag;
};

__device__ __forceinline__ Block block_smem(unsigned char* smem, const NormalEqPlan& p) {
  Block b;
  b.sums = reinterpret_cast<double*>(smem);
  b.ring = smem + p.ring;
  b.full = reinterpret_cast<uint64_t*>(smem + p.barriers);
  b.empty = b.full + p.stages;
  b.flag = reinterpret_cast<int*>(b.empty + p.stages);
  return b;
}

// thread 0 makes the barriers (the producer starts right after; each
// consumer zeroes its own sums before its loop)
__device__ __forceinline__ void block_init(const Block& b, const NormalEqPlan& p) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&b.full[i], 2);
      mbar_init(&b.empty[i], kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
}

// A consumer's double sums of its float runs: in registers (S <=
// kRegisterTerms, the ring then larger), stored into `sums` [S][tid] after
// the loop; or in its slots of `sums` throughout.
template <int S>
struct RegisterSums {
  double v[S];

  __device__ __forceinline__ explicit RegisterSums(double*) {
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] = 0.0;
  }
  __device__ __forceinline__ void flush(float (&acc)[S]) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      v[k] += static_cast<double>(acc[k]);
      acc[k] = 0.f;
    }
  }
  __device__ __forceinline__ void store(double* sums) const {
#pragma unroll
    for (int k = 0; k < S; ++k) sums[k * kConsumers + threadIdx.x] = v[k];
  }
};

template <int S>
struct SharedSums {
  double* s;

  __device__ __forceinline__ explicit SharedSums(double* sums) : s(sums) {
#pragma unroll
    for (int k = 0; k < S; ++k) s[k * kConsumers + threadIdx.x] = 0.0;
  }
  // six sums at a time (the empty asm keeps the next six's loads after
  // these stores): all of them in flight would take 2 S registers beside
  // the run's S, and B = 9 spilled
  __device__ __forceinline__ void flush(float (&acc)[S]) {
#pragma unroll
    for (int k0 = 0; k0 < S; k0 += 6) {
#pragma unroll
      for (int k = k0; k < k0 + 6 && k < S; ++k) {
        s[k * kConsumers + threadIdx.x] += static_cast<double>(acc[k]);
        acc[k] = 0.f;
      }
      asm volatile("" ::: "memory");
    }
  }
  __device__ __forceinline__ void store(double*) const {}
};

template <int S>
using Sums = std::conditional_t<(S <= kRegisterTerms), RegisterSums<S>, SharedSums<S>>;

// The producer warp's part of a tile: every stage into the ring, a buffer
// refilled once its consumers have released it.
template <int kArrays>
__device__ void producer_loop(const Block& b, const NormalEqPlan& p, const Staged (&arr)[kArrays],
                              int64_t v0, int64_t v1) {
  const int lane = threadIdx.x & 31;
  const int SV = static_cast<int>(p.stage_voxels), D = static_cast<int>(p.stages);
  int j = 0;
  for (int64_t n0 = v0; n0 < v1; n0 += SV, ++j) {
    const int buf = j % D;
    if (j >= D) mbar_wait(&b.empty[buf], ((j / D) - 1) & 1);
    fence_proxy_async();
    const int nv = static_cast<int>(v1 - n0 < SV ? v1 - n0 : SV);
    produce(arr, b.ring + buf * p.stage_bytes, n0, nv, &b.full[buf], lane);
  }
}

constexpr int kMaxCluster = 8;      // ops/normaleq.CLUSTER

// a ticket drawn: the add releases this thread's (and, after a barrier, its
// block's) writes and acquires those of the blocks that drew before
__device__ __forceinline__ unsigned ticket_add(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(t) : "memory");
  return old;
}

// How the last block turns a keyframe's S sums (tot[k * kConsumers]) into H
// and g.  kDirect: H's upper triangle row by row, then g.  kPoseSH: the
// pose's factored sums (the pose SH kernel's accumulators), turned by the
// keyframe's rotation R in double: W = sum w G G^T (6), X = W C^T (9), C W
// C^T (6), u = sum w r G (3), C u (3), for a pair's Jacobian rows a = -R G,
// b = G x p = C G: H_aa = R W R^T, H_ab = -R X, H_bb = C W C^T, g_a = -R u,
// g_b = C u.
enum { kDirect = 0, kPoseSH = 1 };

template <int kDim, int kOut>
__device__ __forceinline__ void write_column(const double* tot, int64_t f, const float* poses,
                                             float* H, float* g) {
  float* Hf = H + f * kDim * kDim;
  float* gf = g + f * kDim;
  if constexpr (kOut == kDirect) {
    constexpr int kH = kDim * (kDim + 1) / 2;
    // a few entries in flight at a time: a whole unrolled row of loads
    // would hold B = 9's 54 sums in registers at once
#pragma unroll 1
    for (int b = 0, k = 0; b < kDim; ++b) {
#pragma unroll 3
      for (int d = b; d < kDim; ++d, ++k) {
        const float v = static_cast<float>(tot[k * kConsumers]);
        Hf[b * kDim + d] = v;
        Hf[d * kDim + b] = v;
      }
    }
#pragma unroll 3
    for (int b = 0; b < kDim; ++b) gf[b] = static_cast<float>(tot[(kH + b) * kConsumers]);
  } else {
    double R[3][3], W[3][3], X[3][3], HH[6][6], gg[6];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = static_cast<double>(__ldg(poses + f * 16 + 4 * i + j));
    const int sym[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        W[i][j] = tot[sym[i][j] * kConsumers];
        X[i][j] = tot[(6 + 3 * i + j) * kConsumers];
      }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      double RW[3];
#pragma unroll
      for (int l = 0; l < 3; ++l)
        RW[l] = R[i][0] * W[0][l] + R[i][1] * W[1][l] + R[i][2] * W[2][l];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        HH[i][j] = RW[0] * R[j][0] + RW[1] * R[j][1] + RW[2] * R[j][2];
        HH[i][3 + j] = -(R[i][0] * X[0][j] + R[i][1] * X[1][j] + R[i][2] * X[2][j]);
        HH[3 + i][3 + j] = tot[(15 + sym[i][j]) * kConsumers];
      }
      gg[i] = -(R[i][0] * tot[21 * kConsumers] + R[i][1] * tot[22 * kConsumers] +
                R[i][2] * tot[23 * kConsumers]);
      gg[3 + i] = tot[(24 + i) * kConsumers];
    }
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int d = b; d < 6; ++d) {
        const float v = static_cast<float>(HH[b][d]);
        Hf[b * 6 + d] = v;
        Hf[d * 6 + b] = v;
      }
      gf[b] = static_cast<float>(gg[b]);
    }
  }
}

// The epilogue and the reduction over tiles.  On entry each consumer's
// totals are in sums[k][tid]; every thread of the block calls this.
template <int S, int kDim, int kOut>
__device__ void finish(const Block& b, const NormalEqPlan& p, int64_t F, double* partial,
                       unsigned* tickets, const float* poses, float* H, float* g) {
  const int tid = threadIdx.x;
  const int FB = static_cast<int>(p.frames), R = static_cast<int>(p.lanes);
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * FB;
  const int here = static_cast<int>(F - f0 < FB ? F - f0 : FB);
  double* sums = b.sums;
  // a column's lanes -> sums[k][col]
  if (FB < 32) {
    if (tid < kConsumers) {
#pragma unroll 3
      for (int k = 0; k < S; ++k) {
        double v = sums[k * kConsumers + tid];
        for (int o = FB; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if ((tid & 31) < FB) sums[k * kConsumers + tid] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < S * here; e += kThreads) {
      const int k = e / here, col = e - k * here;
      double v[kConsumerWarps];
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) v[w] = sums[k * kConsumers + 32 * w + col];
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) s += v[w];
      sums[k * kConsumers + col] = s;
    }
  } else {
    for (int e = tid; e < S * here; e += kThreads) {
      const int k = e / here, col = e - k * here;
      double s = 0.0;
      for (int l0 = 0; l0 < R; l0 += 8) {
        double v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = l0 + i < R ? sums[k * kConsumers + (l0 + i) * FB + col] : 0.0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (l0 + i < R) s += v[i];
      }
      sums[k * kConsumers + col] = s;
    }
  }
  // this rank's slice of the columns: the cluster's sums, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int Q = static_cast<int>(p.cluster);
  const int q = static_cast<int>(cluster.block_rank());
  const int64_t K = p.tiles / Q;
  const int64_t kc = blockIdx.x / Q;
  const int per = (here + Q - 1) / Q;
  const int c0 = q * per;
  const int nq = c0 >= here ? 0 : (c0 + per < here ? per : here - c0);
  const int64_t chunk_base = static_cast<int64_t>(blockIdx.y) * K * S * FB;
  for (int e = tid; e < S * nq; e += kThreads) {
    const int k = e / nq, col = c0 + e - k * nq;
    double v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      v[r] = r < Q ? cluster.map_shared_rank(sums, r)[k * kConsumers + col] : 0.0;
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < Q) s += v[r];
    partial[chunk_base + (kc * S + k) * FB + col] = s;
  }
  // done with the peers' sums: arrive now, and wait (for the peers to be
  // done with this block's) only after the ticket, before this block's sums
  // are written again or it exits
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();                  // the block's partials before thread 0's ticket
  if (tid == 0) {
    const unsigned last = ticket_add(tickets + blockIdx.y * Q + q) == K - 1;
    if (last) atomicExch(tickets + blockIdx.y * Q + q, 0u);
    *b.flag = static_cast<int>(last);
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (!*b.flag) return;
  // the last rank-q block: its columns over every cluster, in cluster order
  for (int e = tid; e < S * nq; e += kThreads) {
    const int k = e / nq, col = c0 + e - k * nq;
    const double* src = partial + chunk_base + k * FB + col;
    double s = 0.0;
    for (int64_t c = 0; c < K; c += 16) {
      double v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = c + i < K ? __ldcg(src + (c + i) * S * FB) : 0.0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c + i < K) s += v[i];
    }
    sums[k * kConsumers + col] = s;
  }
  __syncthreads();
  for (int col = c0 + tid; col < c0 + nq; col += kThreads)
    write_column<kDim, kOut>(sums + col, f0 + col, poses, H, g);
}

template <bool kLed>
__global__ void __launch_bounds__(kThreads, 1) pose_tiles_kernel(PoseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kArrays = kLed ? 6 : 4;
  const NormalEqPlan& p = a.plan;
  const Block b = block_smem(smem, p);
  const int tid = threadIdx.x;
  const int FB = static_cast<int>(p.frames), R = static_cast<int>(p.lanes);
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * FB;
  const int64_t here = a.f - f0 < FB ? a.f - f0 : FB;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * p.voxels;
  const int64_t v1 = v0 + p.voxels < a.n ? v0 + p.voxels : a.n;
  Staged arr[kArrays];
  arr[0] = staged(a.g_img, 24, true, 0, p, a.f, f0, here);
  arr[1] = staged(a.p_cam, 12, true, 1, p, a.f, f0, here);
  arr[2] = staged(a.w, 12, true, 2, p, a.f, f0, here);
  arr[3] = staged(a.r, 12, true, 3, p, a.f, f0, here);
  if constexpr (kLed) {
    arr[4] = staged(a.albedo, 12, false, 4, p, a.f, f0, here);
    arr[5] = staged(a.grad, 12, false, 5, p, a.f, f0, here);
  }
  block_init(b, p);

  if (tid >= kConsumers) {
    producer_loop(b, p, arr, v0, v1);
    __syncthreads();
  } else {
    const int lane = tid / FB, col = tid - lane * FB;
    const bool active = lane < R && col < here;
    const int64_t f = f0 + col;
    float acc[kPoseTerms];
#pragma unroll
    for (int k = 0; k < kPoseTerms; ++k) acc[k] = 0.f;
    Sums<kPoseTerms> tot(b.sums);
    float Rm[3][3] = {};
    float fx = 0.f, fy = 0.f, lx = 0.f, ly = 0.f, lz = 0.f;
    if (active) {
      if constexpr (kLed) {
        const float* P = a.poses + f * 16;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) Rm[i][j] = __ldg(P + 4 * i + j);
        lx = __ldg(a.light);
        ly = __ldg(a.light + 1);
        lz = __ldg(a.light + 2);
      }
      fx = __ldg(a.K);
      fy = __ldg(a.K + 4);
    }
    const int SV = static_cast<int>(p.stage_voxels), D = static_cast<int>(p.stages);
    int run = 0, j = 0;
    for (int64_t n0 = v0; n0 < v1; n0 += SV, ++j) {
      const int buf = j % D;
      mbar_wait(&b.full[buf], (j / D) & 1);
      const unsigned char* sb = b.ring + buf * p.stage_bytes;
      const int nv = static_cast<int>(v1 - n0 < SV ? v1 - n0 : SV);
      if (active) {
        const Rows rg = rows_of(arr[0], sb, n0), rp = rows_of(arr[1], sb, n0),
                   rw = rows_of(arr[2], sb, n0), rr = rows_of(arr[3], sb, n0);
        for (int v = lane; v < nv; v += R) {
          const float2* gp = reinterpret_cast<const float2*>(rg.at(v, 24 * col));
          const float* pc = rp.at(v, 12 * col);
          const float* wt = rw.at(v, 12 * col);
          const float* rt = rr.at(v, 12 * col);
          const float2 g0 = gp[0], g1 = gp[1], g2 = gp[2];
          const float px = pc[0], py = pc[1], pz = pc[2];
          const float w3[3] = {wt[0], wt[1], wt[2]};
          const float r3[3] = {rt[0], rt[1], rt[2]};
          // image_pi_grad: the image gradient composed with the projection.
          // Quotients as products with correctly rounded reciprocals: an
          // IEEE division takes a slow path on some masked pairs' values
          // (a third of the LED kernel's time on the LED run's problem)
          const float zs = fabsf(pz) > 1e-12f ? pz : 1e-12f;
          const float zi = __frcp_rn(zs);
          const float zi2 = zi * zi;
          const float ax = fx * zi, ay = fy * zi;
          const float bx = fx * px * zi2, by = fy * py * zi2;
          const float gu3[3] = {g0.x, g1.x, g2.x}, gv3[3] = {g0.y, g1.y, g2.y};
          if constexpr (!kLed) {
            // the factored sums (write_column kPoseSH): this pair's W = sum_c
            // w G G^T and u = sum_c w r G, then X = W C^T, C X and C u
            float W00 = 0.f, W01 = 0.f, W02 = 0.f, W11 = 0.f, W12 = 0.f, W22 = 0.f;
            float u0 = 0.f, u1 = 0.f, u2 = 0.f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float gu = gu3[c], gv = gv3[c];
              const float G0 = gu * ax, G1 = gv * ay, G2 = -(gu * bx + gv * by);
              const float wc = w3[c];
              const float wr = wc * r3[c];
              const float wG0 = wc * G0, wG1 = wc * G1, wG2 = wc * G2;
              W00 = fmaf(wG0, G0, W00);
              W01 = fmaf(wG0, G1, W01);
              W02 = fmaf(wG0, G2, W02);
              W11 = fmaf(wG1, G1, W11);
              W12 = fmaf(wG1, G2, W12);
              W22 = fmaf(wG2, G2, W22);
              u0 = fmaf(wr, G0, u0);
              u1 = fmaf(wr, G1, u1);
              u2 = fmaf(wr, G2, u2);
            }
            const float Wm[3][3] = {{W00, W01, W02}, {W01, W11, W12}, {W02, W12, W22}};
            float X[3][3];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              X[i][0] = Wm[i][1] * pz - Wm[i][2] * py;
              X[i][1] = Wm[i][2] * px - Wm[i][0] * pz;
              X[i][2] = Wm[i][0] * py - Wm[i][1] * px;
            }
            acc[0] += W00;
            acc[1] += W01;
            acc[2] += W02;
            acc[3] += W11;
            acc[4] += W12;
            acc[5] += W22;
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int l = 0; l < 3; ++l) acc[6 + 3 * i + l] += X[i][l];
            // C X, upper: rows C_0 = (0, pz, -py), C_1 = (-pz, 0, px),
            // C_2 = (py, -px, 0)
            acc[15] = fmaf(pz, X[1][0], fmaf(-py, X[2][0], acc[15]));
            acc[16] = fmaf(pz, X[1][1], fmaf(-py, X[2][1], acc[16]));
            acc[17] = fmaf(pz, X[1][2], fmaf(-py, X[2][2], acc[17]));
            acc[18] = fmaf(-pz, X[0][1], fmaf(px, X[2][1], acc[18]));
            acc[19] = fmaf(-pz, X[0][2], fmaf(px, X[2][2], acc[19]));
            acc[20] = fmaf(py, X[0][2], fmaf(-px, X[1][2], acc[20]));
            acc[21] += u0;
            acc[22] += u1;
            acc[23] += u2;
            acc[24] = fmaf(pz, u1, fmaf(-py, u2, acc[24]));
            acc[25] = fmaf(px, u2, fmaf(-pz, u0, acc[25]));
            acc[26] = fmaf(py, u0, fmaf(-px, u1, acc[26]));
          } else {
            // pose_jacobian_led's translation term: rho_c l_c (-n / L^3 + 3
            // (n.Rp) Rp / L^5), n the normalized stored gradient, Rp = R p_cam
            const float* al = rows_of(arr[4], sb, n0).at(v, 0);
            const float* gr = rows_of(arr[5], sb, n0).at(v, 0);
            const float gx = gr[0], gy = gr[1], gz = gr[2];
            const float gn = fmaxf(sqrtf(gx * gx + gy * gy + gz * gz), 1e-12f);
            const float ign = __frcp_rn(gn);
            const float nx = gx * ign, ny = gy * ign, nz = gz * ign;
            const float rho_l[3] = {al[0] * lx, al[1] * ly, al[2] * lz};
            const float pn = fmaxf(sqrtf(px * px + py * py + pz * pz), 1e-12f);
            const float l3 = pn * pn * pn;
            const float l5 = l3 * pn * pn;
            float Rp[3];
#pragma unroll
            for (int i = 0; i < 3; ++i) Rp[i] = Rm[i][0] * px + Rm[i][1] * py + Rm[i][2] * pz;
            const float nRp3 = 3.0f * (nx * Rp[0] + ny * Rp[1] + nz * Rp[2]);
            const float il3 = __frcp_rn(l3), il5 = __frcp_rn(l5);
            const float tv[3] = {-nx * il3 + nRp3 * Rp[0] * il5, -ny * il3 + nRp3 * Rp[1] * il5,
                                 -nz * il3 + nRp3 * Rp[2] * il5};
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float gu = gu3[c], gv = gv3[c];
              const float G0 = gu * ax, G1 = gv * ay, G2 = -(gu * bx + gv * by);
              float J[6];
#pragma unroll
              for (int y = 0; y < 3; ++y)
                J[y] = -(G0 * Rm[y][0] + G1 * Rm[y][1] + G2 * Rm[y][2]) + rho_l[c] * tv[y];
              J[3] = G1 * pz - G2 * py;
              J[4] = G2 * px - G0 * pz;
              J[5] = G0 * py - G1 * px;
              const float wc = w3[c];
              const float wr = wc * r3[c];
              int k = 0;
#pragma unroll
              for (int bb = 0; bb < 6; ++bb) {
                const float wj = wc * J[bb];
#pragma unroll
                for (int d = bb; d < 6; ++d, ++k) acc[k] = fmaf(wj, J[d], acc[k]);
              }
#pragma unroll
              for (int bb = 0; bb < 6; ++bb) acc[21 + bb] = fmaf(J[bb], wr, acc[21 + bb]);
            }
          }
          if (++run == kLaneVoxels) {
            tot.flush(acc);
            run = 0;
          }
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&b.empty[buf]);
    }
    tot.flush(acc);
    __syncthreads();                // the ring is free: the sums may take its place
    tot.store(b.sums);
  }
  __syncthreads();
  finish<kPoseTerms, 6, kLed ? kDirect : kPoseSH>(b, p, a.f, a.partial, a.tickets, a.poses,
                                                  a.H, a.g);
}

template <int B>
__global__ void __launch_bounds__(kThreads, 1) light_tiles_kernel(LightArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kH = B * (B + 1) / 2;
  constexpr int S = kH + B;
  const NormalEqPlan& p = a.plan;
  const Block b = block_smem(smem, p);
  const int tid = threadIdx.x;
  const int FB = static_cast<int>(p.frames), R = static_cast<int>(p.lanes);
  const int64_t f0 = static_cast<int64_t>(blockIdx.y) * FB;
  const int64_t here = a.f - f0 < FB ? a.f - f0 : FB;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * p.voxels;
  const int64_t v1 = v0 + p.voxels < a.n ? v0 + p.voxels : a.n;
  Staged arr[3];
  arr[0] = staged(a.w, 12, true, 0, p, a.f, f0, here);
  arr[1] = staged(a.r, 12, true, 1, p, a.f, f0, here);
  arr[2] = staged(a.J, 12 * B, false, 2, p, a.f, f0, here);
  block_init(b, p);

  if (tid >= kConsumers) {
    producer_loop(b, p, arr, v0, v1);
    __syncthreads();
  } else {
    const int lane = tid / FB, col = tid - lane * FB;
    const bool active = lane < R && col < here;
    float acc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = 0.f;
    Sums<S> tot(b.sums);
    const int SV = static_cast<int>(p.stage_voxels), D = static_cast<int>(p.stages);
    int run = 0, j = 0;
    for (int64_t n0 = v0; n0 < v1; n0 += SV, ++j) {
      const int buf = j % D;
      mbar_wait(&b.full[buf], (j / D) & 1);
      const unsigned char* sb = b.ring + buf * p.stage_bytes;
      const int nv = static_cast<int>(v1 - n0 < SV ? v1 - n0 : SV);
      if (active) {
        const Rows rw = rows_of(arr[0], sb, n0), rr = rows_of(arr[1], sb, n0),
                   rj = rows_of(arr[2], sb, n0);
        for (int v = lane; v < nv; v += R) {
          const float* wt = rw.at(v, 12 * col);
          const float* rt = rr.at(v, 12 * col);
          const float* Jt = rj.at(v, 0);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float wc = wt[c];
            const float wr = wc * rt[c];
            float jc[B];
#pragma unroll
            for (int bb = 0; bb < B; ++bb) jc[bb] = Jt[c * B + bb];
            int k = 0;
#pragma unroll
            for (int bb = 0; bb < B; ++bb) {
              const float wj = wc * jc[bb];
#pragma unroll
              for (int d = bb; d < B; ++d, ++k) acc[k] = fmaf(wj, jc[d], acc[k]);
            }
#pragma unroll
            for (int bb = 0; bb < B; ++bb) acc[kH + bb] = fmaf(wr, jc[bb], acc[kH + bb]);
          }
          if (++run == kLaneVoxels) {
            tot.flush(acc);
            run = 0;
          }
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&b.empty[buf]);
    }
    tot.flush(acc);
    __syncthreads();                // the ring is free: the sums may take its place
    tot.store(b.sums);
  }
  __syncthreads();
  finish<S, B, kDirect>(b, p, a.f, a.partial, a.tickets, nullptr, a.H, a.g);
}

// the launch: grid (tiles, chunks) in clusters of plan.cluster blocks
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(a.plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.plan.tiles), static_cast<unsigned>(a.plan.chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.plan.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.plan.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// clusters of `cluster` blocks of `kernel` the card holds at once
template <typename Args>
int active_clusters(void (*kernel)(Args), int64_t smem, int cluster, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// ------------------------------------------------------------ the LED light
//
// light_led_kernel<WIDE>: `blocks` blocks of kLedWarps warps (ops/normaleq.
// led_plan: one wave, from N, F and the SM count).  A warp's unit is
// `unit_voxels` (UV <= 32) consecutive voxels, whose pairs are one
// contiguous span of w and of r; warp gw of the grid takes the units gw,
// gw + warps, ...
//   - The keyframes' rotations and translations are staged once a block
//     into shared memory, component-major ([12][F]: no bank conflict).
//   - The voxel once: lane v forms voxel v's terms of the unit, the
//     normalized stored gradient ghat, the surface point c - d ghat and the
//     albedo (nine floats, every operation an _rn intrinsic in the plain
//     chain's order, stencil.cuh); the pairs' lanes take them by shuffles.
//     The next unit's voxel state is loaded while this one's pairs compute.
//   - The pairs: a lane reads its pair's w and r from device memory, a
//     step's 32 pairs one contiguous span, in an order that does not depend
//     on the base's alignment (a row slice of the mesh takes the same
//     path).  Under WIDE = false (F <= 32) a step of the warp takes
//     V = 32 / F whole voxels, lane l the pair (l / F, l % F), so a lane's
//     keyframe is fixed and its pose sits in registers; under WIDE a step
//     takes the unit's next 32 pairs (a lane's voxel and keyframe advanced
//     by 32 pairs a step), each pose read from shared memory.  A pair forms
//     p = R^T (x - t), R p, refl = (ghat . R p) / max(|p|, 1e-12)^3 and
//     J_c = refl rho_c as
//     refine/jacobians.py light_jacobian_led does (the first design's bits),
//     and adds w J J and w J r of each channel in double.  Every pair is
//     taken, as the plain sums take them (w is 0 off the mask).
//   - The sums: a lane's six doubles in its order, each warp's lanes by an
//     xor butterfly, the warps in order into partial[k][block] by thread
//     0, whose integer ticket's add releases them; the last block, elected
//     so, reads the partials with six warps (a term each, lanes striding
//     over the blocks, the butterfly), writes H and g as floats and resets
//     the ticket.
// Bound by bytes: w and r (24 bytes a pair), the voxel's state once.  The
// first design took a thread a pair: a 64-bit division, the voxel's
// state reloaded and its ghat and point formed again for each of its F
// pairs, w and r as scalar loads at a 12-byte stride, a shared-memory tree.

constexpr int kLedWarps = 8;                  // ops/normaleq.LED_WARPS
constexpr int kLedThreads = 32 * kLedWarps;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The LED block's shared memory: the poses [12][F], the warps' sums and the
// flag (ops/normaleq.led_plan computes the same size)
struct LedSmem {
  float* pose;
  double* wsum;
  unsigned* last;
};

__device__ __forceinline__ LedSmem led_smem(unsigned char* smem, const LightLedArgs& a) {
  LedSmem m;
  m.pose = reinterpret_cast<float*>(smem);
  m.wsum = reinterpret_cast<double*>(m.pose + 12 * a.f);   // 48 F bytes: 16-byte aligned
  m.last = reinterpret_cast<unsigned*>(m.wsum + 6 * kLedWarps);
  return m;
}

// The six sums of one pair: x, ghat, rho its voxel's terms, R, t its
// keyframe's pose, wp and rp its w and r.
__device__ __forceinline__ void led_pair(const float (&x)[3], const float (&gh)[3],
                                         const float (&rho)[3], const float (&R)[9],
                                         const float (&t)[3], const float* wp, const float* rp,
                                         double (&acc)[6]) {
  const float dx[3] = {fsub(x[0], t[0]), fsub(x[1], t[1]), fsub(x[2], t[2])};
  float p[3], Rp[3];
  rot(R, dx, true, p);
  rot(R, p, false, Rp);
  const float pn = clamp_min(norm3(p), 1e-12f);
  const float refl = fdiv(dot3(gh, Rp), fmul(fmul(pn, pn), pn));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float J = fmul(refl, rho[c]);
    const float wJ = fmul(wp[c], J);
    acc[c] += static_cast<double>(fmul(wJ, J));
    acc[3 + c] += static_cast<double>(fmul(wJ, rp[c]));
  }
}

// A voxel's state as loaded: the stored gradient, dist, coordinates, albedo
struct LedVoxel {
  float g[3], d, rho[3];
  int idx[3];
};

__device__ __forceinline__ LedVoxel led_voxel_load(const LightLedArgs& a, int64_t n) {
  LedVoxel v;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v.g[i] = __ldg(a.grad + 3 * n + i);
    v.rho[i] = __ldg(a.albedo + 3 * n + i);
    v.idx[i] = __ldg(a.idx_xyz + 3 * n + i);
  }
  v.d = __ldg(a.dist + n);
  return v;
}

template <bool WIDE>
__global__ void __launch_bounds__(kLedThreads, 2)
light_led_kernel(LightLedArgs a) {
  extern __shared__ __align__(16) unsigned char led_shared[];
  const LedSmem m = led_smem(led_shared, a);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t N = a.n;
  const int F = static_cast<int>(a.f);
  const int UV = static_cast<int>(a.unit_voxels);
  const float o[3] = {static_cast<float>(a.origin_x), static_cast<float>(a.origin_y),
                      static_cast<float>(a.origin_z)};
  const float h = static_cast<float>(a.grid_voxel);

  const int64_t units = N > 0 && F > 0 ? (N + UV - 1) / UV : 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kLedWarps;
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * kLedWarps + warp;
  // the first unit's voxel state in flight before the block's set-up
  LedVoxel next{};
  if (u0 < units && lane < UV && u0 * UV + lane < N) next = led_voxel_load(a, u0 * UV + lane);

  // component k (R row-major, then t) of keyframe f's pose at m.pose[k F + f]
  for (int i = t; i < 12 * F; i += kLedThreads) {
    const int k = i / F, f = i - k * F;
    m.pose[i] = __ldg(a.poses + 16 * f + (k < 9 ? 4 * (k / 3) + k % 3 : 4 * (k - 9) + 3));
  }
  __syncthreads();

  // a NARROW lane's place in a step and its keyframe's pose, once
  const int Fd = F > 0 ? F : 1;
  const int V = WIDE ? 1 : 32 / Fd;
  const int lv = WIDE ? 0 : lane / Fd, lf = WIDE ? lane : lane - lv * Fd;
  const bool lane_on = WIDE || lane < V * F;
  float R[9], tr[3];
  if (!WIDE) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = lane_on ? m.pose[k * F + lf] : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) tr[i] = lane_on ? m.pose[(9 + i) * F + lf] : 0.0f;
  }

  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t u = u0; u < units; u += stride) {
    const int64_t n0 = u * UV;
    const int nv = static_cast<int>(N - n0 < UV ? N - n0 : UV);
    // lane v's voxel terms: ghat, the surface point, the albedo
    const LedVoxel cur = next;
    float gh[3], x[3];
    normalize(cur.g, gh);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float c = fadd(o[i], fmul(h, static_cast<float>(cur.idx[i])));
      x[i] = fsub(c, fmul(cur.d, gh[i]));
    }
    const int64_t un = u + stride;
    if (un < units && lane < UV && un * UV + lane < N) next = led_voxel_load(a, un * UV + lane);

    const float* wb = a.w + 3 * n0 * F;
    const float* rb = a.r + 3 * n0 * F;
    if (!WIDE) {
      for (int v0 = 0; v0 < nv; v0 += V) {
        const int v = v0 + lv;
        const bool on = lane_on && v < nv;
        // the pair's w and r first, then its voxel's terms
        float wp[3] = {0.0f, 0.0f, 0.0f}, rp[3] = {0.0f, 0.0f, 0.0f};
        if (on) {
          const int q = 3 * (v * F + lf);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            wp[c] = wb[q + c];
            rp[c] = rb[q + c];
          }
        }
        float vx[3], vg[3], vr[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          vx[i] = __shfl_sync(0xffffffffu, x[i], v & 31);
          vg[i] = __shfl_sync(0xffffffffu, gh[i], v & 31);
          vr[i] = __shfl_sync(0xffffffffu, cur.rho[i], v & 31);
        }
        if (on) led_pair(vx, vg, vr, R, tr, wp, rp, acc);
      }
    } else {
      // a step: the unit's next 32 pairs, lane l pair q0 + l of voxel v,
      // keyframe f (advanced by 32 a step: F > 32 wraps at most once)
      int v = 0, f = lane;
      for (int q0 = 0; q0 < nv * F; q0 += 32) {
        float vx[3], vg[3], vr[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          vx[i] = __shfl_sync(0xffffffffu, x[i], v & 31);
          vg[i] = __shfl_sync(0xffffffffu, gh[i], v & 31);
          vr[i] = __shfl_sync(0xffffffffu, cur.rho[i], v & 31);
        }
        if (v < nv) {
          float Rf[9], tf[3];
#pragma unroll
          for (int k = 0; k < 9; ++k) Rf[k] = m.pose[k * F + f];
#pragma unroll
          for (int i = 0; i < 3; ++i) tf[i] = m.pose[(9 + i) * F + f];
          const int q = 3 * (q0 + lane);
          led_pair(vx, vg, vr, Rf, tf, wb + q, rb + q, acc);
        }
        f += 32;
        if (f >= F) {
          f -= F;
          ++v;
        }
      }
    }
  }

  // the block's partials: each warp's butterfly, then the warps in order
  const int B = static_cast<int>(gridDim.x);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) m.wsum[warp * 6 + k] = v;
  }
  __syncthreads();
  if (t == 0) {
    for (int k = 0; k < 6; ++k) {
      double s = 0.0;
      for (int w = 0; w < kLedWarps; ++w) s += m.wsum[w * 6 + k];
      a.partial[static_cast<int64_t>(k) * B + blockIdx.x] = s;
    }
    // the ticket's add releases the partials and acquires the others'
    *m.last = ticket_add(a.ticket) == static_cast<unsigned>(B - 1);
  }
  __syncthreads();
  if (!*m.last) return;
  // the last block (thread 0's add acquired the partials, the barrier
  // orders its threads' reads after it): term k by warp k, its lanes over
  // the blocks
  if (warp < 6) {
    double s = 0.0;
    for (int b = lane; b < B; b += 32) s += __ldcg(a.partial + static_cast<int64_t>(warp) * B + b);
    s = warp_sum(s);
    if (lane == 0) (warp < 3 ? a.H : a.g)[warp % 3] = static_cast<float>(s);
  }
  if (t == 0) *a.ticket = 0;
}

// an empty kernel on light_led_kernel's grid, block and shared memory: the
// launch's floor (timed beside it, counted nowhere)
__global__ void light_led_floor_kernel(LightLedArgs) {}

// light_led_kernel's launch, or (empty) its floor's
int light_led_launch(const LightLedArgs* a, cudaStream_t stream, bool empty) {
  if (a->n < 0 || a->f < 0 || a->blocks <= 0 || a->unit_voxels < 1 || a->unit_voxels > 32 ||
      a->smem < 48 * a->f + 8 * 6 * kLedWarps + 4)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(LightLedArgs) = empty ? light_led_floor_kernel
                                 : a->f > 32 ? light_led_kernel<true> : light_led_kernel<false>;
  // past the default 48 KB only (F > 1015 keyframes), so the main paths'
  // launches make no runtime call of it
  if (a->smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(a->smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(a->blocks), kLedThreads, static_cast<size_t>(a->smem), stream>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One call, one launch; returns the CUDA error (0: launched).
int pose_normal_eqs(const PoseArgs* a, cudaStream_t stream) {
  return launch(a->led ? pose_tiles_kernel<true> : pose_tiles_kernel<false>, *a, stream);
}

int light_normal_eqs_sh(const LightArgs* a, cudaStream_t stream) {
  if (a->basis != 4 && a->basis != 9) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a->basis == 4 ? light_tiles_kernel<4> : light_tiles_kernel<9>, *a, stream);
}

int light_normal_eqs_led(const LightLedArgs* a, cudaStream_t stream) {
  return light_led_launch(a, stream, false);
}

int light_led_floor(const LightLedArgs* a, cudaStream_t stream) {
  return light_led_launch(a, stream, true);
}

// kernel: 0 the SH pose, 1 the LED pose, 2 the light B = 4, 3 B = 9 -> *out
// clusters of `cluster` blocks with `smem` bytes each the card holds at
// once; returns the CUDA error
int normaleq_active_clusters(int kernel, int64_t smem, int cluster, int* out) {
  switch (kernel) {
    case 0: return active_clusters(pose_tiles_kernel<false>, smem, cluster, out);
    case 1: return active_clusters(pose_tiles_kernel<true>, smem, cluster, out);
    case 2: return active_clusters(light_tiles_kernel<4>, smem, cluster, out);
    case 3: return active_clusters(light_tiles_kernel<9>, smem, cluster, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
