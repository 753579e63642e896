// A draft of the culled fusion's cull and compaction as ONE thread-block
// cluster (at most 16 blocks on neighbouring SMs), timed against the
// package's cooperative kernel by tools/cull_ab.py; on no path.
//
// The same plan as psgradientsdf_tpu_torch/csrc/cull.cu's
// cull_compact_kernel (whose helpers it includes), with three changes: an
// ordinary launch (cudaLaunchKernelEx with a cluster dimension, no
// cooperative launch), cluster.sync() in place of the grid barriers, and
// the row maxima and the blocks' counts kept in each block's shared memory
// and read by the others through distributed shared memory, so nothing but
// the outputs goes to device memory.  Its risk: the whole depth image is
// read by 16 SMs at most.
//
// Built by tools/cull_ab.py with nvcc into a library of the package's C
// interface: cull_compact(args, stream), the block count (the cluster's
// size) taken from args->blocks.

#define cull_compact cull_compact_cooperative
#include "../psgradientsdf_tpu_torch/csrc/cull.cu"
#undef cull_compact

namespace {

constexpr int kMaxCluster = 16;

template <bool kCull>
__global__ void __launch_bounds__(kThreads)
cull_cluster_kernel(const __grid_constant__ Params p, int rows_per_block) {
  extern __shared__ unsigned smem[];       // words, row maxima, tables
  unsigned* words = smem;
  float* rmax = reinterpret_cast<float*>(smem + p.run / 32);
  float* st = rmax + rows_per_block;
  __shared__ PassCameras cams;
  __shared__ Tally tally;
  __shared__ int grid_facts[3];
  __shared__ int part[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int begin = min(rank * p.run, p.n);
  const int end = min(begin + p.run, p.n);
  const int groups = (end - begin + 31) / 32;

  if constexpr (kCull) {
    load_cameras(p, 0, min(p.pass, p.frames), cams);
    // the block's share of the row maxima, into its own shared memory
    const int r0 = rank * rows_per_block;
    for (int r = warp; r < rows_per_block; r += kWarps) {
      if (r0 + r >= p.frames * p.H) break;
      const float m = row_maximum(p, p.depth + static_cast<int64_t>(r0 + r) * p.W);
      if (lane == 0) rmax[r] = m;
    }
    for (int g = threadIdx.x; g < groups; g += kThreads) words[g] = 0u;
    cluster.sync();

    const int table = p.levels * p.H;
    for (int k0 = 0; k0 < p.frames; k0 += p.pass) {
      const int kn = min(p.pass, p.frames - k0);
      if (k0 > 0) {
        __syncthreads();
        load_cameras(p, k0, kn, cams);
      }
      // level 0 through distributed shared memory, then the levels
      for (int i = threadIdx.x; i < kn * p.H; i += kThreads) {
        const int f = i / p.H;
        const int row = k0 * p.H + i;
        const float* src = cluster.map_shared_rank(rmax, row / rows_per_block);
        st[f * table + i - f * p.H] = src[row % rows_per_block];
      }
      __syncthreads();
      build_levels(p, kn, st);
      const int sweep = min(kThreads, groups * 32);
      const int slices = kThreads / max(sweep, 32);
      const int slice = threadIdx.x / max(sweep, 32);
      if (slice < slices) {
        const int li = threadIdx.x - slice * sweep;
        for (int base = 0; base < groups * 32; base += sweep) {
          const int g = (base + li) >> 5;
          if (g >= groups) continue;
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

  const int per_warp = (groups + kWarps - 1) / kWarps;
  const int w_begin = min(warp * per_warp, groups);
  const int w_end = min(w_begin + per_warp, groups);
  tally_words(p, words, begin, w_begin, w_end, tally);
  if (threadIdx.x == 0) {
    part[0] = tally.block_count;
    part[1] = tally.block_first;
  }
  cluster.sync();

  // the blocks' counts through distributed shared memory, a lane a block
  if (warp == 0) {
    int before = 0, total = 0, f = p.n;
    if (lane < static_cast<int>(cluster.num_blocks())) {
      const int* other = cluster.map_shared_rank(part, lane);
      total = other[0];
      before = lane < rank ? other[0] : 0;
      f = other[1];
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
  // no block leaves while another may still read its shared memory
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  ranked_writes(p, words, begin, w_begin, w_end, tally, grid_facts);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <bool kCull>
cudaError_t launch_cluster(const Params& p, int blocks, int rows_per_block, int smem,
                           cudaStream_t stream) {
  auto kernel = cull_cluster_kernel<kCull>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p, rows_per_block);
}

}  // namespace

extern "C" int cull_compact(const CullCompactArgs* a, void* stream) {
  Params p;
  const bool cull = a->cull != 0;
  const int blocks = static_cast<int>(a->blocks);
  if (blocks > kMaxCluster || !make_params(a, blocks, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = cull ? p.frames * p.H : 0;
  const int rows_per_block = (rows + blocks - 1) / blocks;
  const int smem =
      (p.run / 32 + rows_per_block + (cull ? p.pass * p.levels * p.H : 0)) * 4;
  cudaError_t e = cull ? launch_cluster<true>(p, blocks, rows_per_block, smem,
                                              static_cast<cudaStream_t>(stream))
                       : launch_cluster<false>(p, blocks, rows_per_block, smem,
                                               static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
