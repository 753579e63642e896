// The scan's preprocessing for Hopper (sm_90a): FALS normals and the LAPM
// sharpness of a chunk of frames, one launch each, nothing read back.
//
// Replaces the JAX package's psgradientsdf_tpu/tracking/stream.py
// `_preprocess` (:74-80), one device program a chunk over ops/normals.py
// `compute_normals` (:112) and ops/sharpness.py `modified_laplacian` (:47).
// The port's plain versions (ops/preprocess.py `fals_normals_plain`,
// `lapm_plain`) are eager chains: three box filters of a reflect pad and
// 2 (window - 1) shifted-slice adds each, the 3x3 solve, the norm and the
// division (about 90 ops), and two separable 3-tap filters, abs, add and a
// mean (about 25).
//
// fals_normals_kernel: a persistent grid over the units (32 x 32 output
//   tile, frame), tile-major with the frame fastest; block b of B takes the
//   units [b U / B, (b + 1) U / B) (ops/preprocess.py fals_plan: B fills the
//   SMs at the occupancy the window's shared memory allows), so a block
//   walks over frames of one tile, or of two.
//   0. On a new tile the block places the halo (r = window / 2 on each
//      side): the source row and column of each halo pixel, the reflect-101
//      border applied there (an overhang past the image's last padded row
//      or column clamped first: never read by an output); the three cache
//      planes x0n, y0n, nsi of the halo into shared memory (4-byte cp.async
//      copies), and each thread's four pixels of Q into registers.  All are
//      frame-independent.
//   1. Each frame's depth halo is brought into one of two shared buffers by
//      4-byte cp.async copies two units ahead, while the units before it
//      compute: a unit's work is [horizontal sums, barrier, vertical sums
//      and the solve, the next unit's weighted halo, barrier].
//   2. The three 1/z-weighted ray components x0n z_inv, y0n z_inv,
//      nsi z_inv of the halo (a pixel of the padded image is the product at
//      its reflected source pixel, as padding the product is).
//   3. Horizontal window sums of every halo row: a thread eight neighbouring
//      columns of one row (a warp's lanes on 32 rows of an odd pitch: no
//      bank conflict), each value read once and added to the sums it
//      belongs to; then vertical sums of those: a thread four neighbouring
//      rows of one column.  Each sum is acc = x[0]; acc += x[j], j = 1 ..
//      window - 1, in the plain version's order, every addition rounded
//      once: the sharing changes which thread adds, not the order.
//   4. n = Q b with the packed symmetric Q [H, W, 6], each product and sum
//      rounded once in the plain version's order, then n / max(|n|, 1e-20)
//      (NaN kept, as torch.clamp keeps it).
//   Every product, sum and quotient is an _rn intrinsic, so nvcc contracts
//   none of them into a fused multiply-add, and z_inv = 1 / d is the
//   correctly rounded quotient that PyTorch's reciprocal computes.  The
//   kernel's first design, a block a 32 x 8 tile of one frame, loaded 2.95
//   times its pixels at window 11 and read the cache again for each frame;
//   this tile loads 1.72 times them and the cache once a tile, and the
//   shared sums read a value about 2.25 (horizontal) and 3.5 (vertical)
//   times an output where each output read it 11 times.
//
// lapm_kernel: per frame, mean(|Lx| + |Ly|) of channel `chan` of a
//   [C, H, W, S] image (S = 3: the blue channel of RGB; S = 1: grey), with
//   Lx the [-1, 2, -1] filter along x and [0.25, 0.5, 0.25] along y, Ly the
//   transposed pair, reflect-101 borders, each filtered value computed as
//   the plain version computes it.  Block (band, strip, frame) of a host
//   plan (ops/preprocess.lapm_plan, a function of C, H, W, S and the SMs):
//   the band's rows of the strip's columns.
//   - A producer warp stages the strip's span of each row (its columns and
//     one neighbour on each side, all S channels: contiguous bytes) into a
//     ring of `depth` row buffers, from the row above the band to the row
//     below it (reflected at the image's edges), by one bulk asynchronous
//     copy a row (cp.async.bulk on the buffer's mbarrier) of the span's
//     16-byte-aligned body; its lanes load the ragged head and tail (at
//     most 12 bytes each) themselves.  The span sits in its buffer at its
//     address modulo 16.
//   - A consumer thread owns the columns x0 + t + k T (k < kLapmCols, T
//     consumer threads): neighbouring lanes read neighbouring pixels, S
//     words apart (no bank conflict).  The reflected neighbours' offsets
//     are placed once, before the rows.  For each staged row it computes
//     the x passes lap and gau of its columns once and keeps the last three
//     rows' in registers; from the third row on, the y pass of the row
//     between reads registers only.  Every tap is tap3's (k0 a + k1 b) + k2
//     c, each product and sum rounded once: the plain version's bits.
//   - A thread adds its pixels' |Lx| + |Ly| in double, rows in order, its
//     columns in order; each warp's lanes by an xor butterfly, the warps in
//     order into the block's partial.  The last block to finish, elected by
//     an integer ticket, reads the partials with all its threads (a warp a
//     frame, its lanes striding over the frame's partials, then the
//     butterfly) and divides by H W.  No float atomics: two runs give the
//     same bits.
//   The first design took a thread a pixel: a 64-bit division and
//   six reflections a pixel, nine loads a pixel straight from device memory
//   (each value loaded nine times), each row's x passes computed three
//   times, and about two blocks an SM.
//
// Bound on the card: bytes.  The normals read the depth (4 bytes a pixel
// and frame) and the cache once (x0n, y0n, nsi and Q: 36 bytes a pixel) and
// write 12 bytes a pixel and frame: a chunk of 8 frames of 640 x 480 is 50
// MB, 0.015 ms at 3.35 TB/s.  LAPM reads one float a pixel and frame (the
// blue channel, but its lines hold all three: 12 bytes a pixel move).  The
// design's aim is one launch each, with every intermediate in shared
// memory or registers.
//
// Plain C interface (loaded with ctypes): fals_normals() and lapm() launch
// on the stream they are given, do not synchronise, allocate nothing and
// return the launch's CUDA error as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

// The C interface's argument blocks: every field 8 bytes wide, in this
// order (ops/preprocess.py builds the same blocks with ctypes).
struct FalsArgs {
  const float* depth;  // [C, H, W]
  const float* x0n;    // [H, W]
  const float* y0n;    // [H, W]
  const float* nsi;    // [H, W]
  const float* Q;      // [H, W, 6]
  float* out;          // [C, H, W, 3]
  int64_t C, H, W, window;
  int64_t blocks;      // the persistent grid (ops/preprocess.py fals_plan)
};

struct LapmArgs {
  const float* img;    // frame c, pixel (y, x): img[c * frame + (y * W + x) * S + chan]
  float* out;          // [C]
  double* part;        // [C][bands * strips]
  int* ticket;         // one int, 0 between launches
  int64_t C, H, W, S, chan, frame, bands, rows_per_band;
  // the rest of the host plan (ops/preprocess.lapm_plan)
  int64_t strips, strip_cols;   // column strips a row, columns a strip
  int64_t threads;              // consumer threads a block (a multiple of 32)
  int64_t depth, pitch;         // row buffers of the ring, bytes a buffer
  int64_t smem;                 // dynamic shared memory a block
};

namespace {

constexpr int kTile = 32;          // the normals' output tile, 32 x 32
constexpr int kThreads = 256;
constexpr int kHCols = 8;          // horizontal sums a thread, neighbouring columns
constexpr int kVRows = 4;          // vertical sums a thread, neighbouring rows
constexpr int kHsPitch = kTile + 1;
constexpr int kLapmCols = 4;       // columns a consumer thread, ops/preprocess.LAPM_COLS
constexpr int kLapmMaxThreads = 1024;

// reflect-101 of an index in [-(n - 1), 2 n - 2]
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// The normals kernel's shared memory for a window, in floats (the layout
// of fals_normals_kernel; ops/preprocess.py fals_smem computes the same).
__host__ __device__ inline int fals_smem_floats(int window) {
  const int r = window / 2, P = kTile + 2 * r, Pp = P | 1;
  return 6 * P * Pp + 3 * P * kHsPitch + 2 * P * P + 2 * P;
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(s)), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// acc[k] = p[k s] + p[(k + 1) s] + ... + p[(k + window - 1) s] for k < K,
// each added left to right as the plain shifted-slice sums add (acc = x[0];
// acc += x[j]), every addition rounded once.  For window >= K each value is
// read once and added to every sum it belongs to, in the same order.
template <int K>
__device__ __forceinline__ void window_sums(const float* p, int s, int window,
                                            float (&acc)[K]) {
  if (window >= K) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const float v = p[m * s];
#pragma unroll
      for (int k = 0; k <= m; ++k) acc[k] = k == m ? v : __fadd_rn(acc[k], v);
    }
#pragma unroll 4
    for (int m = K; m < window; ++m) {
      const float v = p[m * s];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = __fadd_rn(acc[k], v);
    }
#pragma unroll
    for (int q = 0; q < K - 1; ++q) {
      const float v = p[(window + q) * s];
#pragma unroll
      for (int k = q + 1; k < K; ++k) acc[k] = __fadd_rn(acc[k], v);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float a = p[k * s];
      for (int j = 1; j < window; ++j) a = __fadd_rn(a, p[(k + j) * s]);
      acc[k] = a;
    }
  }
}

// i / n for 0 <= i < 4096 and 1 <= n <= 64, by a float product: the
// quotient's fraction lies at least 1 / (2 n) from the next integer, far
// beyond the product's rounding
__device__ __forceinline__ int small_div(int i, float inv_n) {
  return __float2int_rz((static_cast<float>(i) + 0.5f) * inv_n);
}

__global__ void __launch_bounds__(kThreads, 3)
fals_normals_kernel(FalsArgs a) {
  extern __shared__ float smem[];
  const int H = static_cast<int>(a.H), W = static_cast<int>(a.W), C = static_cast<int>(a.C);
  const int window = static_cast<int>(a.window), r = window / 2;
  const int P = kTile + 2 * r, Pp = P | 1;       // halo side, odd pitch
  const float inv_p = 1.0f / static_cast<float>(P);
  float* cache = smem;                           // [3][P][Pp] x0n, y0n, nsi
  float* wt = cache + 3 * P * Pp;                // [3][P][Pp] weighted
  float* hs = wt + 3 * P * Pp;                   // [3][P][kHsPitch] horizontal sums
  float* dep = hs + 3 * P * kHsPitch;            // [2][P][P] depth halos
  int* srow = reinterpret_cast<int*>(dep + 2 * P * P);   // [P] source row * W
  int* scol = srow + P;                                  // [P] source column
  const int tiles_x = (W + kTile - 1) / kTile;
  const int64_t units = static_cast<int64_t>(tiles_x) * ((H + kTile - 1) / kTile) * C;
  const int64_t u0 = blockIdx.x * units / gridDim.x;
  const int64_t u1 = (blockIdx.x + 1) * units / gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t frame = static_cast<int64_t>(H) * W;
  int x0 = 0, y0 = 0;
  float q[kVRows][6];

  // units x and y (< u1) of one tile
  auto same = [&](int64_t x, int64_t y) { return y < u1 && x / C == y / C; };

  // the depth halo of unit u into dep[u & 1], by 4-byte async copies
  auto fetch = [&](int64_t u) {
    const float* d = a.depth + (u % C) * frame;
    float* dst = dep + (u & 1) * P * P;
    for (int i = t; i < P * P; i += kThreads) {
      const int py = small_div(i, inv_p), px = i - py * P;
      cp_async4(dst + i, d + srow[py] + scol[px]);
    }
    cp_async_commit();
  };

  // 0. unit u's tile: its halo's sources (reflect-101, the overhang clamped
  //    first), its cache planes (async copies, committed with the first
  //    depth halo) and this thread's pixels of Q
  auto setup = [&](int64_t u) {
    const int64_t tile = u / C;
    x0 = static_cast<int>(tile % tiles_x) * kTile;
    y0 = static_cast<int>(tile / tiles_x) * kTile;
    if (t < P) {
      srow[t] = reflect101(min(y0 + t - r, H - 1 + r), H) * W;
    } else if (t < 2 * P) {
      scol[t - P] = reflect101(min(x0 + t - P - r, W - 1 + r), W);
    }
    const int x = x0 + lane;
#pragma unroll
    for (int k = 0; k < kVRows; ++k) {
      const int y = y0 + kVRows * warp + k;
      const bool in = x < W && y < H;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        q[k][j] = in ? __ldg(a.Q + (static_cast<int64_t>(y) * W + x) * 6 + j) : 0.0f;
    }
    __syncthreads();
    for (int i = t; i < P * P; i += kThreads) {
      const int py = small_div(i, inv_p), px = i - py * P;
      const int64_t p = static_cast<int64_t>(srow[py]) + scol[px];
      const int o = py * Pp + px;
      cp_async4(cache + o, a.x0n + p);
      cp_async4(cache + P * Pp + o, a.y0n + p);
      cp_async4(cache + 2 * P * Pp + o, a.nsi + p);
    }
  };

  // 2. the weighted components of unit u's halo
  auto weighting = [&](int64_t u) {
    const float* d = dep + (u & 1) * P * P;
    for (int i = t; i < P * P; i += kThreads) {
      const int py = small_div(i, inv_p), px = i - py * P;
      const float z = d[i];
      const float zi = z == 0.0f ? 0.0f : __fdiv_rn(1.0f, z);
      const int o = py * Pp + px;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) wt[ch * P * Pp + o] = __fmul_rn(cache[ch * P * Pp + o], zi);
    }
  };

  // 1. a new tile's first units: the setup, their depth halos, then wait
  //    for unit u's (the next one's stays in flight)
  auto start_tile = [&](int64_t u) {
    setup(u);
    fetch(u);
    if (same(u, u + 1)) {
      fetch(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    weighting(u);
    __syncthreads();
  };

  start_tile(u0);
  for (int64_t u = u0; u < u1; ++u) {
    const int c = static_cast<int>(u % C);
    // unit u + 2's depth halo in flight for the next two units' work
    const bool ahead = same(u, u + 1) && same(u + 1, u + 2);
    if (ahead) fetch(u + 2);

    // 3a. horizontal window sums: item (channel, column group, halo row),
    //     the row fastest so that a warp's lanes take neighbouring rows
    for (int i = t; i < 3 * (kTile / kHCols) * P; i += kThreads) {
      const int rest = small_div(i, inv_p), py = i - rest * P;
      const int g = rest % (kTile / kHCols), ch = rest / (kTile / kHCols);
      float acc[kHCols];
      window_sums<kHCols>(wt + ch * P * Pp + py * Pp + kHCols * g, 1, window, acc);
      float* o = hs + ch * P * kHsPitch + py * kHsPitch + kHCols * g;
#pragma unroll
      for (int k = 0; k < kHCols; ++k) o[k] = acc[k];
    }
    if (same(u, u + 1)) {
      if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
    }
    __syncthreads();

    // 3b. vertical window sums, rows kVRows warp .. + kVRows - 1 of column
    //     lane; 4. the solve and the normalisation
    {
      float b[3][kVRows];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        window_sums<kVRows>(hs + ch * P * kHsPitch + kVRows * warp * kHsPitch + lane,
                            kHsPitch, window, b[ch]);
      const int x = x0 + lane;
#pragma unroll
      for (int k = 0; k < kVRows; ++k) {
        const int y = y0 + kVRows * warp + k;
        if (x >= W || y >= H) continue;
        const float q11 = q[k][0], q12 = q[k][1], q13 = q[k][2];
        const float q22 = q[k][3], q23 = q[k][4], q33 = q[k][5];
        const float b0 = b[0][k], b1 = b[1][k], b2 = b[2][k];
        const float nx = __fadd_rn(__fadd_rn(__fmul_rn(b0, q11), __fmul_rn(b1, q12)),
                                   __fmul_rn(b2, q13));
        const float ny = __fadd_rn(__fadd_rn(__fmul_rn(b0, q12), __fmul_rn(b1, q22)),
                                   __fmul_rn(b2, q23));
        const float nz = __fadd_rn(__fadd_rn(__fmul_rn(b0, q13), __fmul_rn(b1, q23)),
                                   __fmul_rn(b2, q33));
        // torch.linalg.vector_norm over the last dim of 3 on the card: the
        // squares of elements 0 and 2 summed first, then element 1's
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(nz, nz)),
                                  __fmul_rn(ny, ny));
        float norm = __fsqrt_rn(s);
        if (norm < 1e-20f) norm = 1e-20f;      // NaN stays NaN
        float* o = a.out + (c * frame + static_cast<int64_t>(y) * W + x) * 3;
        o[0] = __fdiv_rn(nx, norm);
        o[1] = __fdiv_rn(ny, norm);
        o[2] = __fdiv_rn(nz, norm);
      }
    }

    // the next unit's weighted halo (its tile's setup first if it is new)
    if (same(u, u + 1)) {
      weighting(u + 1);
      __syncthreads();
    } else if (u + 1 < u1) {
      start_tile(u + 1);
    }
  }
}

// one separable 3-tap pass as the plain version writes it:
// (k0 a + k1 b) + k2 c, each product and sum rounded once
__device__ __forceinline__ float tap3(float k0, float k1, float k2,
                                      float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k0, a), __fmul_rn(k1, b)), __fmul_rn(k2, c));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// The LAPM block's shared memory: the ring of row buffers at 0, then the
// full and empty barriers of each buffer, the warps' sums and the flag
// (ops/preprocess.lapm_plan computes the same size).
struct LapmSmem {
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  double* wsum;
  int* last;
};

__device__ __forceinline__ LapmSmem lapm_smem(unsigned char* smem, const LapmArgs& a) {
  LapmSmem m;
  m.ring = smem;
  m.full = reinterpret_cast<uint64_t*>(smem + a.depth * a.pitch);
  m.empty = m.full + a.depth;
  m.wsum = reinterpret_cast<double*>(m.empty + a.depth);
  m.last = reinterpret_cast<int*>(m.wsum + 32);
  return m;
}

__global__ void __launch_bounds__(kLapmMaxThreads)
lapm_kernel(LapmArgs a) {
  extern __shared__ __align__(16) unsigned char lapm_shared[];
  const LapmSmem m = lapm_smem(lapm_shared, a);
  const int H = static_cast<int>(a.H), W = static_cast<int>(a.W);
  const int S = static_cast<int>(a.S), chan = static_cast<int>(a.chan);
  const int T = static_cast<int>(a.threads), D = static_cast<int>(a.depth);
  const int strips = static_cast<int>(a.strips);
  const int band = blockIdx.x / strips, strip = blockIdx.x - band * strips;
  const int c = blockIdx.y;
  const int y0 = band * static_cast<int>(a.rows_per_band);
  const int y1 = min(H, y0 + static_cast<int>(a.rows_per_band));
  const int x0 = strip * static_cast<int>(a.strip_cols);
  const int x1 = min(W, x0 + static_cast<int>(a.strip_cols));
  const int xs0 = max(x0 - 1, 0), xs1 = min(x1 + 1, W);  // the staged span's columns
  const int64_t bytes = static_cast<int64_t>(xs1 - xs0) * S * 4;
  const int rows = y1 - y0 + 2;                         // staged: the band and its halo
  const float* frame = a.img + static_cast<int64_t>(c) * a.frame;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // the span of staged row j in device memory
  auto span = [&](int j) {
    const int ys = reflect101(y0 - 1 + j, H);
    return reinterpret_cast<uintptr_t>(frame + (static_cast<int64_t>(ys) * W + xs0) * S);
  };

  if (t == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(&m.full[i], 2);
      mbar_init(&m.empty[i], T / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  double acc = 0.0;
  if (t >= T) {
    // the producer warp: row j into buffer j % D once its consumers have
    // released the row before it there
    for (int j = 0; j < rows; ++j) {
      const int buf = j % D;
      if (j >= D) mbar_wait(&m.empty[buf], ((j / D) - 1) & 1);
      fence_proxy_async();
      const uintptr_t g = span(j);
      unsigned char* s = m.ring + buf * a.pitch + (g & 15);
      int64_t head = static_cast<int64_t>((16 - (g & 15)) & 15);
      if (head > bytes) head = bytes;
      const int64_t body = (bytes - head) & ~static_cast<int64_t>(15);
      if (lane == 0) {
        mbar_arrive_expect_tx(&m.full[buf], static_cast<uint32_t>(body));
        if (body > 0)
          bulk_load(s + head, reinterpret_cast<const void*>(g + head),
                    static_cast<uint32_t>(body), &m.full[buf]);
      }
      // the ragged head and tail, a float a lane (at most three each)
      const int64_t o = 4 * lane < head ? 4 * lane : 4 * lane + body;
      if (4 * lane < bytes - body)
        *reinterpret_cast<float*>(s + o) = __ldg(reinterpret_cast<const float*>(g + o));
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.full[buf]);
    }
  } else {
    // a consumer: its columns' offsets in a staged span, neighbours
    // reflected at the image's first and last column
    bool on[kLapmCols];
    int ol[kLapmCols], oc[kLapmCols], orr[kLapmCols];
#pragma unroll
    for (int k = 0; k < kLapmCols; ++k) {
      const int x = x0 + t + k * T;
      on[k] = x < x1;
      const int xl = x == 0 ? 1 : x - 1, xr = x == W - 1 ? W - 2 : x + 1;
      ol[k] = ((xl - xs0) * S + chan) * 4;
      oc[k] = ((x - xs0) * S + chan) * 4;
      orr[k] = ((xr - xs0) * S + chan) * 4;
    }
    float lap[3][kLapmCols] = {}, gau[3][kLapmCols] = {};   // the last three rows' x passes
    for (int j = 0; j < rows; ++j) {
      const int buf = j % D;
      mbar_wait(&m.full[buf], (j / D) & 1);
      const unsigned char* s = m.ring + buf * a.pitch + (span(j) & 15);
#pragma unroll
      for (int k = 0; k < kLapmCols; ++k) {
        lap[0][k] = lap[1][k];
        lap[1][k] = lap[2][k];
        gau[0][k] = gau[1][k];
        gau[1][k] = gau[2][k];
        if (on[k]) {
          const float u = *reinterpret_cast<const float*>(s + ol[k]);
          const float v = *reinterpret_cast<const float*>(s + oc[k]);
          const float w = *reinterpret_cast<const float*>(s + orr[k]);
          lap[2][k] = tap3(-1.0f, 2.0f, -1.0f, u, v, w);
          gau[2][k] = tap3(0.25f, 0.5f, 0.25f, u, v, w);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&m.empty[buf]);
      if (j >= 2) {
#pragma unroll
        for (int k = 0; k < kLapmCols; ++k) {
          if (!on[k]) continue;
          const float lx = tap3(0.25f, 0.5f, 0.25f, lap[0][k], lap[1][k], lap[2][k]);
          const float ly = tap3(-1.0f, 2.0f, -1.0f, gau[0][k], gau[1][k], gau[2][k]);
          acc += static_cast<double>(__fadd_rn(fabsf(lx), fabsf(ly)));
        }
      }
    }
  }

  // the block's partial: each consumer warp's butterfly, the warps in order
  const int parts = static_cast<int>(a.bands) * strips;
  acc = warp_sum(acc);
  if (lane == 0 && t < T) m.wsum[warp] = acc;
  __syncthreads();
  if (t == 0) {
    double s = 0.0;
    for (int w = 0; w < T / 32; ++w) s += m.wsum[w];
    a.part[static_cast<int64_t>(c) * parts + blockIdx.x] = s;
    // the ticket's add releases the partial and acquires the others'
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(old) : "l"(a.ticket) : "memory");
    *m.last = old == parts * static_cast<int>(a.C) - 1;
  }
  __syncthreads();
  if (!*m.last) return;

  // the last block (thread 0's add acquired the partials, the barrier
  // orders its threads' reads after it): a warp a frame, its lanes over the
  // frame's partials
  const double hw = static_cast<double>(H) * static_cast<double>(W);
  for (int f = warp; f < static_cast<int>(a.C); f += blockDim.x / 32) {
    const double* p = a.part + static_cast<int64_t>(f) * parts;
    double s = 0.0;
    for (int k = lane; k < parts; k += 32) s += __ldcg(p + k);
    s = warp_sum(s);
    if (lane == 0) a.out[f] = static_cast<float>(s / hw);
  }
  if (t == 0) *a.ticket = 0;
}

// an empty kernel on lapm_kernel's grid, block and shared memory: the
// launch's floor (timed beside it, counted nowhere)
__global__ void lapm_floor_kernel(LapmArgs) {}

}  // namespace

// The normals kernel's blocks an SM at this window's shared memory (the
// host plan's input) -> 0 or the CUDA error.
extern "C" int fals_normals_occupancy(int64_t window, int64_t* blocks_per_sm) {
  const size_t smem = sizeof(float) * fals_smem_floats(static_cast<int>(window));
  cudaError_t e = cudaFuncSetAttribute(fals_normals_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fals_normals_kernel, kThreads, smem);
  *blocks_per_sm = n;
  return static_cast<int>(e);
}

extern "C" int fals_normals(const FalsArgs* a, void* stream) {
  const int r = static_cast<int>(a->window / 2);
  if (a->C <= 0 || a->H <= r || a->W <= r || a->window < 1 || a->window % 2 == 0 ||
      a->blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * fals_smem_floats(static_cast<int>(a->window));
  cudaError_t e = cudaFuncSetAttribute(fals_normals_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fals_normals_kernel<<<static_cast<unsigned>(a->blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// lapm_kernel's launch, or (empty) its floor's
static int lapm_launch(const LapmArgs* a, void* stream, bool empty) {
  if (a->C <= 0 || a->H < 2 || a->W < 2 || a->bands <= 0 || a->rows_per_band <= 0 ||
      a->strips <= 0 || a->strip_cols <= 0 || a->threads <= 0 || a->threads % 32 != 0 ||
      a->threads + 32 > kLapmMaxThreads || a->strip_cols > kLapmCols * a->threads ||
      a->depth <= 0 || a->pitch % 16 != 0 ||
      a->pitch < (a->strip_cols + 2) * a->S * 4 + 12)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(LapmArgs) = empty ? lapm_floor_kernel : lapm_kernel;
  // past the default 48 KB only (lapm_plan's strips stay under it), so the
  // scan's launches make no runtime call of it
  if (a->smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(a->smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(a->bands * a->strips), static_cast<unsigned>(a->C));
  kernel<<<grid, static_cast<unsigned>(a->threads + 32), static_cast<size_t>(a->smem),
           static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lapm(const LapmArgs* a, void* stream) { return lapm_launch(a, stream, false); }

extern "C" int lapm_floor(const LapmArgs* a, void* stream) {
  return lapm_launch(a, stream, true);
}
