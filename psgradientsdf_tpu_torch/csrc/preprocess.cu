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
// fals_normals_kernel: a block per 32 x 8 output tile of one frame.
//   1. The tile's rows and columns with a halo of r = window / 2 on each
//      side are loaded into shared memory as the three 1/z-weighted ray
//      components x0n z_inv, y0n z_inv, nsi z_inv, the reflect-101 border
//      applied on load (a pixel of the padded image is the product at its
//      reflected source pixel, as padding the product is).
//   2. Horizontal sums over the window of every halo row, for the tile's
//      32 columns, into shared memory; then vertical sums of those over the
//      window: acc = x[0]; acc += x[j], j = 1 .. window - 1, in the plain
//      version's order, every addition rounded once.
//   3. n = Q b with the packed symmetric Q [H, W, 6], each product and sum
//      rounded once in the plain version's order, then n / max(|n|, 1e-20)
//      (NaN kept, as torch.clamp keeps it).
//   Every product, sum and quotient is an _rn intrinsic, so nvcc contracts
//   none of them into a fused multiply-add, and z_inv = 1 / d is the
//   correctly rounded quotient that PyTorch's reciprocal computes.
//
// lapm_kernel: per frame, mean(|Lx| + |Ly|) of channel `chan` of a
//   [C, H, W, S] image (S = 3: the blue channel of RGB; S = 1: grey), with
//   Lx the [-1, 2, -1] filter along x and [0.25, 0.5, 0.25] along y, Ly the
//   transposed pair, reflect-101 borders, each filtered value computed as
//   the plain version computes it.  A block (band, frame) sums its band's
//   values in double, in a fixed order (a thread's pixels in turn, then a
//   tree over the threads); the last block to finish, elected by an integer
//   ticket, adds each frame's band sums in band order and divides by H W.
//   No float atomics: two runs give the same bits.
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
};

struct LapmArgs {
  const float* img;    // frame c, pixel (y, x): img[c * frame + (y * W + x) * S + chan]
  float* out;          // [C]
  double* part;        // [C * bands]
  int* ticket;         // one int, 0 between launches
  int64_t C, H, W, S, chan, frame, bands, rows_per_band;
};

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kLapmThreads = 256;

// reflect-101 of an index in [-(n - 1), 2 n - 2]
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(kThreads)
fals_normals_kernel(FalsArgs a) {
  extern __shared__ float smem[];
  const int H = static_cast<int>(a.H), W = static_cast<int>(a.W);
  const int window = static_cast<int>(a.window), r = window / 2;
  const int PH = kTileH + 2 * r, PW = kTileW + 2 * r;
  float* wt = smem;                         // [3][PH][PW] weighted components
  float* hs = smem + 3 * PH * PW;           // [3][PH][kTileW] horizontal sums
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int c = blockIdx.z;
  const float* depth = a.depth + static_cast<int64_t>(c) * H * W;
  const int t = threadIdx.y * kTileW + threadIdx.x;

  // 1. the weighted components of the tile and its halo, reflected on load
  //    (rows or columns past the image's last padded one are clamped: the
  //    tile's overhang, never read by an output)
  for (int i = t; i < PH * PW; i += kThreads) {
    const int py = i / PW, px = i - py * PW;
    const int sy = reflect101(min(y0 + py - r, H - 1 + r), H);
    const int sx = reflect101(min(x0 + px - r, W - 1 + r), W);
    const int64_t p = static_cast<int64_t>(sy) * W + sx;
    const float d = depth[p];
    const float zi = d == 0.0f ? 0.0f : __fdiv_rn(1.0f, d);
    wt[i] = __fmul_rn(a.x0n[p], zi);
    wt[PH * PW + i] = __fmul_rn(a.y0n[p], zi);
    wt[2 * PH * PW + i] = __fmul_rn(a.nsi[p], zi);
  }
  __syncthreads();

  // 2a. horizontal window sums of every halo row, in the plain order
  for (int i = t; i < 3 * PH * kTileW; i += kThreads) {
    const int ch = i / (PH * kTileW);
    const int rem = i - ch * PH * kTileW;
    const int py = rem / kTileW, tx = rem - py * kTileW;
    const float* row = wt + ch * PH * PW + py * PW + tx;
    float acc = row[0];
    for (int j = 1; j < window; ++j) acc = __fadd_rn(acc, row[j]);
    hs[i] = acc;
  }
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;

  // 2b. vertical window sums, in the plain order
  float b[3];
  for (int ch = 0; ch < 3; ++ch) {
    const float* col = hs + ch * PH * kTileW + ty * kTileW + tx;
    float acc = col[0];
    for (int i = 1; i < window; ++i) acc = __fadd_rn(acc, col[i * kTileW]);
    b[ch] = acc;
  }

  // 3. n = Q b, normalised
  const float* q = a.Q + (static_cast<int64_t>(y) * W + x) * 6;
  const float q11 = q[0], q12 = q[1], q13 = q[2], q22 = q[3], q23 = q[4], q33 = q[5];
  const float nx = __fadd_rn(__fadd_rn(__fmul_rn(b[0], q11), __fmul_rn(b[1], q12)),
                             __fmul_rn(b[2], q13));
  const float ny = __fadd_rn(__fadd_rn(__fmul_rn(b[0], q12), __fmul_rn(b[1], q22)),
                             __fmul_rn(b[2], q23));
  const float nz = __fadd_rn(__fadd_rn(__fmul_rn(b[0], q13), __fmul_rn(b[1], q23)),
                             __fmul_rn(b[2], q33));
  // torch.linalg.vector_norm over the last dim of 3 on the card: the
  // squares of elements 0 and 2 summed first, then element 1's
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(nz, nz)),
                            __fmul_rn(ny, ny));
  float norm = __fsqrt_rn(s);
  if (norm < 1e-20f) norm = 1e-20f;          // NaN stays NaN
  float* o = a.out + ((static_cast<int64_t>(c) * H + y) * W + x) * 3;
  o[0] = __fdiv_rn(nx, norm);
  o[1] = __fdiv_rn(ny, norm);
  o[2] = __fdiv_rn(nz, norm);
}

// one separable 3-tap pass as the plain version writes it:
// (k0 a + k1 b) + k2 c, each product and sum rounded once
__device__ __forceinline__ float tap3(float k0, float k1, float k2,
                                      float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k0, a), __fmul_rn(k1, b)), __fmul_rn(k2, c));
}

__global__ void __launch_bounds__(kLapmThreads)
lapm_kernel(LapmArgs a) {
  __shared__ double red[kLapmThreads];
  __shared__ int last;
  const int H = static_cast<int>(a.H), W = static_cast<int>(a.W);
  const int S = static_cast<int>(a.S);
  const int band = blockIdx.x, c = blockIdx.y;
  const int bands = static_cast<int>(a.bands);
  const float* img = a.img + static_cast<int64_t>(c) * a.frame + a.chan;
  const int ylo = band * static_cast<int>(a.rows_per_band);
  const int yhi = min(H, ylo + static_cast<int>(a.rows_per_band));
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < static_cast<int64_t>(yhi - ylo) * W; i += kLapmThreads) {
    const int y = ylo + static_cast<int>(i / W), x = static_cast<int>(i % W);
    const int xs[3] = {reflect101(x - 1, W), x, reflect101(x + 1, W)};
    const int ys[3] = {reflect101(y - 1, H), y, reflect101(y + 1, H)};
    float lap[3], gau[3];                   // the x passes of the three rows
    for (int k = 0; k < 3; ++k) {
      const float* row = img + static_cast<int64_t>(ys[k]) * W * S;
      const float u = row[xs[0] * S], v = row[xs[1] * S], w = row[xs[2] * S];
      lap[k] = tap3(-1.0f, 2.0f, -1.0f, u, v, w);
      gau[k] = tap3(0.25f, 0.5f, 0.25f, u, v, w);
    }
    const float lx = tap3(0.25f, 0.5f, 0.25f, lap[0], lap[1], lap[2]);
    const float ly = tap3(-1.0f, 2.0f, -1.0f, gau[0], gau[1], gau[2]);
    acc += static_cast<double>(__fadd_rn(fabsf(lx), fabsf(ly)));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kLapmThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.part[static_cast<int64_t>(c) * bands + band] = red[0];
    __threadfence();
    const int total = bands * static_cast<int>(a.C);
    last = atomicAdd(a.ticket, 1) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double hw = static_cast<double>(H) * static_cast<double>(W);
  for (int f = threadIdx.x; f < static_cast<int>(a.C); f += kLapmThreads) {
    const volatile double* p = a.part + static_cast<int64_t>(f) * bands;
    double s = 0.0;
    for (int k = 0; k < bands; ++k) s += p[k];
    a.out[f] = static_cast<float>(s / hw);
  }
  if (threadIdx.x == 0) *a.ticket = 0;
}

}  // namespace

extern "C" int fals_normals(const FalsArgs* a, void* stream) {
  const int r = static_cast<int>(a->window / 2);
  if (a->C <= 0 || a->H <= r || a->W <= r || a->window < 1 || a->window % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * 3 * (kTileH + 2 * r) * (kTileW + 2 * r + kTileW);
  cudaError_t e = cudaFuncSetAttribute(fals_normals_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((a->W + kTileW - 1) / kTileW),
                  static_cast<unsigned>((a->H + kTileH - 1) / kTileH),
                  static_cast<unsigned>(a->C));
  fals_normals_kernel<<<grid, dim3(kTileW, kTileH), smem,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lapm(const LapmArgs* a, void* stream) {
  if (a->C <= 0 || a->H < 2 || a->W < 2 || a->bands <= 0 || a->rows_per_band <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a->bands), static_cast<unsigned>(a->C));
  lapm_kernel<<<grid, kLapmThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
