// Grid barriers with a two-value sum, side by side, for tools/distcg_tune.py:
// an empty cooperative kernel of 512 threads a block crosses `barriers`
// barriers of one kind.
//   kind 0  grid.sync alone;
//   kind 1  dist_cg's (csrc/distcg.cu barrier_sum): the block's partials to
//           warp 0, thread 0 writes them and arrives on one counter
//           (red.release.gpu), warp 0 polls it (ld.acquire.gpu), then reads
//           all blocks' partials in one parallel load;
//   kind 2  grid.sync, then the same load of the partials;
//   kind 3  each block's partials as 64-bit words tagged with the barrier's
//           number (a release fence, relaxed stores); thread i of every
//           block polls block i's words (relaxed loads, an acquire fence).
// Plain C interface: run_barriers() launches on the stream it is given and
// returns 0 or the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// the block's sums of g[2] -> every lane of warp 0
__device__ void block_sum(const float (&g)[2], float (&out)[2], float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = 0; q < 2; ++q) {
    const float v = warp_sum(g[q]);
    if (lane == 0) buf[2 * warp + q] = v;
  }
  __syncthreads();
  if (warp == 0)
    for (int q = 0; q < 2; ++q) out[q] = warp_sum(lane < kWarps ? buf[2 * lane + q] : 0.0f);
}

// warp 0 reads all blocks' partials and sums them -> every thread
__device__ void grid_sum(const float* part, int blocks, float (&out)[2], float* bc) {
  if (threadIdx.x < 32) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int i = threadIdx.x; i < blocks; i += 32) {
      s0 += __ldcg(part + 2 * i);
      s1 += __ldcg(part + 2 * i + 1);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (threadIdx.x == 0) {
      bc[0] = s0;
      bc[1] = s1;
    }
  }
  __syncthreads();
  out[0] = bc[0];
  out[1] = bc[1];
}

__global__ void __launch_bounds__(kThreads, 1)
barrier_kernel(uint64_t* slots, float* part, uint32_t* counter, int blocks, int barriers,
               int kind) {
  __shared__ float buf[2 * kWarps + 4];
  float* bc = buf + 2 * kWarps;
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x < 4)
    slots[(threadIdx.x >> 1) * blocks * 2 + 2 * blockIdx.x + (threadIdx.x & 1)] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *counter = 0;
  grid.sync();
  float g[2] = {1.0f, static_cast<float>(threadIdx.x)}, mine[2], out[2];
  for (int e = 1; e <= barriers; ++e) {
    float* pp = part + static_cast<size_t>(e & 1) * blocks * 2;
    if (kind == 0) {
      grid.sync();
      continue;
    }
    if (kind == 1 || kind == 2) {
      block_sum(g, mine, buf);
      if (threadIdx.x == 0) {
        pp[2 * blockIdx.x] = mine[0];
        pp[2 * blockIdx.x + 1] = mine[1];
      }
      if (kind == 1) {
        if (threadIdx.x < 32) {
          if (threadIdx.x == 0)
            asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
          const uint32_t want = static_cast<uint32_t>(e) * blocks;
          uint32_t v;
          do {
            asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
          } while (v < want);
        }
      } else {
        grid.sync();
      }
      grid_sum(pp, blocks, out, bc);
    } else {
      uint64_t* set = slots + static_cast<size_t>(e & 1) * blocks * 2;
      block_sum(g, mine, buf);
      if (threadIdx.x == 0) {
        asm volatile("fence.acq_rel.gpu;" ::: "memory");
        for (int q = 0; q < 2; ++q)
          asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(set + 2 * blockIdx.x + q),
                       "l"((static_cast<uint64_t>(e) << 32) | __float_as_uint(mine[q]))
                       : "memory");
      }
      float q0 = 0.0f, q1 = 0.0f;
      for (int i = threadIdx.x; i < blocks; i += kThreads) {
        uint64_t w0, w1;
        do {
          asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w0) : "l"(set + 2 * i) : "memory");
          asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w1) : "l"(set + 2 * i + 1) : "memory");
        } while (static_cast<uint32_t>(w0 >> 32) != static_cast<uint32_t>(e) ||
                 static_cast<uint32_t>(w1 >> 32) != static_cast<uint32_t>(e));
        q0 += __uint_as_float(static_cast<uint32_t>(w0));
        q1 += __uint_as_float(static_cast<uint32_t>(w1));
      }
      if (static_cast<int>(threadIdx.x) < blocks) asm volatile("fence.acq_rel.gpu;" ::: "memory");
      const float qq[2] = {q0, q1};
      block_sum(qq, out, buf);
      __syncthreads();
    }
    g[0] = out[0];
  }
}

}  // namespace

extern "C" int run_barriers(int blocks, int barriers, int kind, void* slots, void* part,
                            void* counter, void* stream) {
  void* args[] = {&slots, &part, &counter, &blocks, &barriers, &kind};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
