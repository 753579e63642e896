// The grid-wide sums and barriers of the package's cooperative CG kernels
// (csrc/distcg.cu dist_cg, csrc/albedo.cu albedo_block), one block an SM of
// kCgThreads threads.
//
// A barrier carries its sum: thread 0 writes the block's partials (at most
// S floats, S = 2 unless the kernel asks for more) into the barrier's set of
// p.part [2][blocks][S] and arrives on one counter (red.release.gpu), warp 0
// polls the counter (ld.acquire.gpu) until every block of this barrier has
// arrived, then reads all the partials in one parallel load and adds them
// in one fixed order, the same in every block, so every block holds the
// same sums and takes the same branch.  Two sets of partials, alternating, suffice: a block cannot write
// barrier e + 2's before every block has passed e + 1.  The counter is the
// only atomic and holds no value that is summed: two runs give the same
// bits.  The kernel's parameters `p` name the counter (p.counter), the
// partials (p.part) and the grid's blocks (p.blocks); barrier 0 is the
// kernel's one grid.sync, after which block 0 has set the counter to 0.
//
// Included by the .cu sources above; kernels.py hashes every csrc/*.cuh
// header into each CUDA library's name, so an edited header rebuilds them.

#pragma once

#include <stdint.h>

namespace {

constexpr int kCgThreads = 512;
constexpr int kCgWarps = kCgThreads / 32;
constexpr unsigned kSyncFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(kSyncFull, v, s);
  return v;
}

// The block's sum of every thread's g[q] in one fixed order (each warp's xor
// butterfly, then warp 0's butterfly over the warps' sums) -> out[q] in
// every lane of warp 0.  buf: [kCgWarps][S] floats of shared memory.  Each
// q is summed on its own: another K leaves the other sums' bits as they are.
template <int K, int S = 2>
__device__ __forceinline__ void block_sum(const float (&g)[K], float (&out)[K], float* buf) {
  static_assert(K <= S, "more sums than slots");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float v = warp_sum(g[q]);
    if (lane == 0) buf[S * warp + q] = v;
  }
  __syncthreads();
  if (warp == 0)
#pragma unroll
    for (int q = 0; q < K; ++q) out[q] = warp_sum(lane < kCgWarps ? buf[S * lane + q] : 0.0f);
}

// All blocks' partials part[blocks][S] summed in one fixed order, the same
// in every block (lane l of warp 0 adds blocks l, l + 32, ..., then the
// butterfly) -> out[q] in every thread.  Warp 0 reads them after its
// acquire; bc: K floats of shared memory.
template <int K, int S = 2>
__device__ __forceinline__ void grid_sum(const float* part, int blocks, float (&out)[K],
                                         float* bc) {
  if (threadIdx.x < 32) {
    float s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = 0.0f;
    for (int i = threadIdx.x; i < blocks; i += 32)
#pragma unroll
      for (int q = 0; q < K; ++q) s[q] += __ldcg(part + S * i + q);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      s[q] = warp_sum(s[q]);
      if (threadIdx.x == 0) bc[q] = s[q];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) out[q] = bc[q];
}

__device__ __forceinline__ void red_release(uint32_t* a, uint32_t v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(a), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* a) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}

// Grid barrier number `epoch` (1, 2, ...), warp 0's part: thread 0 writes
// the block's K partials (held by every lane of warp 0) into the epoch's
// set and arrives; every lane waits for all blocks' arrivals.  Call after a
// __syncthreads that follows the block's last writes to global memory; the
// block's other warps wait at the __syncthreads that follows.
template <int K, int S, class P>
__device__ __forceinline__ void arrive_and_wait(const P& p, uint32_t epoch,
                                                const float* mine) {
  if (threadIdx.x == 0) {
    float* part = p.part + static_cast<size_t>(epoch & 1) * p.blocks * S;
#pragma unroll
    for (int q = 0; q < K; ++q) part[S * blockIdx.x + q] = mine[q];
    red_release(p.counter, 1u);
  }
  const uint32_t want = epoch * static_cast<uint32_t>(p.blocks);
  while (ld_acquire(p.counter) < want) {
  }
}

// Barrier `epoch` and the grid's sums of each thread's g[q] -> out[q] in
// every thread.
template <int K, int S = 2, class P>
__device__ __forceinline__ void barrier_sum(const P& p, uint32_t epoch,
                                            const float (&g)[K], float (&out)[K], float* buf,
                                            float* bc) {
  float mine[K];
  block_sum<K, S>(g, mine, buf);
  if (threadIdx.x < 32) arrive_and_wait<K, S>(p, epoch, mine);
  grid_sum<K, S>(p.part + static_cast<size_t>(epoch & 1) * p.blocks * S, p.blocks, out, bc);
}

// Barrier `epoch` alone.
template <class P>
__device__ __forceinline__ void barrier(const P& p, uint32_t epoch) {
  __syncthreads();
  if (threadIdx.x < 32) arrive_and_wait<0, 2>(p, epoch, nullptr);
  __syncthreads();
}

// torch.clamp(v, min=1e-30): NaN passes through
__device__ __forceinline__ float clamp30(float v) { return v < 1e-30f ? 1e-30f : v; }

}  // namespace
