// A 1x1 convolution with its frozen-BatchNorm epilogue (kernel K4) and a
// whole stride-1 identity ResNet bottleneck (kernel K5) for Hopper (sm_90a).
//
// Replaces: tools_dev/fused_resnet_experiment.py,
//   K4: `_kernel` via `_call` in the custom VJP `fused_matmul_bn_act`:
//       out = relu?((x @ w) * mul + add [+ residual])
//   K5: `_bottleneck_kernel` via `_bneck_fwd` in `fused_bottleneck`:
//       a1  = relu((x @ w1) * mul1 + add1)                      -> x's dtype
//       a2  = relu(conv3x3_pad1(a1, w2) * mul2 + add2)          -> x's dtype
//       out = relu((a2 @ w3) * mul3 + add3 + x)                 -> x's dtype
// Activations are NHWC rows: x is [n*h*w, C] (the row view of a
// channels-last tensor), w1 [C, F], w2 [9, F, F] (the 3x3 taps in
// dy*3+dx order, each [F_in, F_out]), w3 [F, C], every (mul, add) an f32
// per-channel pair.  Products are summed in f32 from f32 operands (a bf16
// product is exact in f32); the epilogues are f32 and round the product
// and the sum separately (no FMA contraction), like the plain PyTorch
// versions; a1, a2 and the output are rounded to x's dtype, as in the TPU
// kernel.  The backward passes of both are plain PyTorch functions, as
// they are plain XLA in the JAX package.
//
// What bounds them on the H100.  At ResNet-152 stage 3 over 280 images
// (54,880 rows, C = 1024, F = 256) one bottleneck is ~121 GFLOP against
// ~225 MB (f32) or ~112 MB (bf16) of x read and output written: far above
// the card's ratio of operations to bytes, so compute-bound.  These first
// versions sum on the CUDA cores in f32 (~67 TFLOP/s peak), not on the
// tensor cores; wgmma tiles are later work.  The unfused path's cost that
// K5 removes is memory traffic: conv outputs of 4F channels written and
// read back by separate BN, residual and ReLU passes.
//
// Design.  One routine, `tile_gemm`, sums a 4096-output tile (BM x BN =
// 32 x 128, or 64 x 64 when N <= 64) over K in chunks of 16: the block's
// 256 threads stage an f32 chunk of A (transposed, padded) and of B in
// shared memory, then each thread accumulates a 4 x 4 micro-tile in
// registers, and an epilogue functor consumes each finished sum.  A comes
// from a loader functor, so the same routine reads x from device memory
// (K4, conv1), a tap-shifted view of a1 in shared memory (conv2), or a2 in
// shared memory (conv3).
//   K4: one block per output tile; M need not be a multiple of BM.
//   K5: one launch per bottleneck and one block per (image, tile of TH
//   output rows).  The block computes a1 for its rows plus one halo row
//   above and below (recomputing conv1 there; halo rows outside the image
//   are conv2's zero padding), keeps a1 and a2 in shared memory in x's
//   dtype, runs the 3x3 as one product over K = 9F whose loader shifts by
//   the tap and reads zero past the left and right edges, and writes
//   conv3's output tile by tile, adding the residual read from x.  So a
//   block reads x and the weights and writes the output, and a1 and a2
//   never reach device memory.  The TPU kernel keeps whole images in VMEM;
//   a stage-1 image (56 x 56 x 64) does not fit in 227 KB of shared
//   memory, so the host picks TH per shape with a count of staged chunks,
//   first among the TH whose shared memory lets two blocks share an SM.
//   The weights stream through the staging buffers in 16-row chunks
//   (stage-3 w2 alone is 1.2 MB in bf16) and are read from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileOut = 4096;  // outputs per tile: 256 threads x a 4 x 4 micro-tile
constexpr int kBK = 16;         // K per staged chunk
constexpr int kNarrow = 64;     // BN when N <= 64 (then BM = 64)
constexpr int kWide = 128;      // BN otherwise (BM = 32)

template <int BN>
struct TileShape {
  static constexpr int BM = kTileOut / BN;
  static constexpr int kLdA = BM + 4;  // padded row of the transposed A chunk
  static constexpr int kStageFloats = kBK * kLdA + kBK * BN;
};
constexpr int kStageFloats = TileShape<kWide>::kStageFloats > TileShape<kNarrow>::kStageFloats
                                 ? TileShape<kWide>::kStageFloats
                                 : TileShape<kNarrow>::kStageFloats;
constexpr int kStageBytes = kStageFloats * 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the frozen-BN affine, rounded per operation like (acc * mul) + add in PyTorch
__device__ __forceinline__ float bn(float acc, float mul, float add) {
  return __fadd_rn(__fmul_rn(acc, mul), add);
}

// One output tile: sums over k in [0, K) of A(m, k) * b[k][n] for rows
// [m0, m0 + BM) and columns [n0, n0 + BN), then epi(m, n, sum) for each
// (m, n) inside [0, M) x [0, N).  A(m, k) = load_a(m, k) for m < M, k < K;
// b is a row-major [K, N] matrix in device memory.  Every thread of the
// block must call it with the same arguments.
template <int BN, typename TB, typename LoadA, typename Epi>
__device__ __forceinline__ void tile_gemm(int m0, int n0, int M, int N, int K, LoadA load_a,
                                          const TB* __restrict__ b, float* stage, Epi epi) {
  constexpr int BM = TileShape<BN>::BM;
  constexpr int LDA = TileShape<BN>::kLdA;
  float* As = stage;              // [kBK][LDA]: A chunk, transposed
  float* Bs = stage + kBK * LDA;  // [kBK][BN]
  const int tx = threadIdx.x % (BN / 4), ty = threadIdx.x / (BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous chunk (or the caller's last writes) is done
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int m = m0 + e / kBK, k = k0 + e % kBK;
      As[(e % kBK) * LDA + e / kBK] = (m < M && k < K) ? load_a(m, k) : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int k = k0 + e / BN, n = n0 + e % BN;
      Bs[e] = (k < K && n < N) ? to_f32(b[static_cast<long long>(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * LDA + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) epi(m, n, acc[i][j]);
    }
}

// The whole [M, N] product, tile by tile, with the tile shape for N.
template <typename TB, typename LoadA, typename Epi>
__device__ __forceinline__ void block_gemm(int M, int N, int K, LoadA load_a,
                                           const TB* __restrict__ b, float* stage, Epi epi) {
  if (N <= kNarrow) {
    for (int m0 = 0; m0 < M; m0 += TileShape<kNarrow>::BM)
      for (int n0 = 0; n0 < N; n0 += kNarrow)
        tile_gemm<kNarrow>(m0, n0, M, N, K, load_a, b, stage, epi);
  } else {
    for (int m0 = 0; m0 < M; m0 += TileShape<kWide>::BM)
      for (int n0 = 0; n0 < N; n0 += kWide)
        tile_gemm<kWide>(m0, n0, M, N, K, load_a, b, stage, epi);
  }
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
matmul_bn_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ mul, const float* __restrict__ add,
                     const T* __restrict__ residual, T* __restrict__ out, int M, int N, int K,
                     int relu) {
  __shared__ __align__(16) float stage[kStageFloats];
  tile_gemm<BN>(
      blockIdx.x * TileShape<BN>::BM, blockIdx.y * BN, M, N, K,
      [=](int m, int k) { return to_f32(x[static_cast<long long>(m) * K + k]); }, w, stage,
      [=](int m, int n, float acc) {
        const long long o = static_cast<long long>(m) * N + n;
        float y = bn(acc, mul[n], add[n]);
        if (residual != nullptr) y = __fadd_rn(y, to_f32(residual[o]));
        out[o] = from_f32<T>(relu ? fmaxf(y, 0.f) : y);
      });
}

template <typename T, int BN>
void launch_matmul_bn_act(const void* x, const void* w, const void* mul, const void* add,
                          const void* residual, void* out, int M, int N, int K, int relu,
                          cudaStream_t s) {
  const dim3 grid((M + TileShape<BN>::BM - 1) / TileShape<BN>::BM, (N + BN - 1) / BN);
  matmul_bn_act_kernel<T, BN><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<const T*>(residual), static_cast<T*>(out), M,
      N, K, relu);
}

template <typename T>
void dispatch_matmul_bn_act(const void* x, const void* w, const void* mul, const void* add,
                            const void* residual, void* out, int M, int N, int K, int relu,
                            cudaStream_t s) {
  if (N <= kNarrow)
    launch_matmul_bn_act<T, kNarrow>(x, w, mul, add, residual, out, M, N, K, relu, s);
  else
    launch_matmul_bn_act<T, kWide>(x, w, mul, add, residual, out, M, N, K, relu, s);
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

template <typename T>
struct Bottleneck {
  const T* x;
  const T* w1;
  const float* mul1;
  const float* add1;
  const T* w2;
  const float* mul2;
  const float* add2;
  const T* w3;
  const float* mul3;
  const float* add3;
  T* out;
  int h, w, c, f;  // image rows and columns, block channels, bottleneck width
  int tile_rows;   // output image rows per block
  int tiles;       // blocks per image
};

template <typename T>
__global__ void __launch_bounds__(kThreads) bottleneck_kernel(Bottleneck<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  const int wf = p.w * p.f;  // one image row of a1 or a2
  T* a1 = reinterpret_cast<T*>(smem + kStageBytes);  // [(tile_rows + 2) * w, f]
  T* a2 = a1 + (p.tile_rows + 2) * wf;               // [tile_rows * w, f]

  const int img = blockIdx.x / p.tiles;
  const int r0 = (blockIdx.x % p.tiles) * p.tile_rows;  // first output image row
  const int rows = min(p.tile_rows, p.h - r0);
  // a1's local row r holds image row r0 - 1 + r; conv1 fills the rows
  // inside the image, [lo, hi), and the rows outside stay zero (padding)
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, p.h);
  const long long img_row0 = static_cast<long long>(img) * p.h * p.w;  // x row of (img, 0, 0)
  if (r0 == 0)
    for (int e = threadIdx.x; e < wf; e += kThreads) a1[e] = from_f32<T>(0.f);
  if (r0 + rows == p.h)
    for (int e = threadIdx.x; e < wf; e += kThreads) a1[(rows + 1) * wf + e] = from_f32<T>(0.f);

  // conv1 (1x1) + bn1 + relu over the image rows [lo, hi)
  const T* x1 = p.x + (img_row0 + static_cast<long long>(lo) * p.w) * p.c;
  T* a1_lo = a1 + (lo - (r0 - 1)) * wf;
  block_gemm(
      (hi - lo) * p.w, p.f, p.c,
      [=](int m, int k) { return to_f32(x1[static_cast<long long>(m) * p.c + k]); }, p.w1,
      stage, [=](int m, int n, float acc) {
        a1_lo[m * p.f + n] = from_f32<T>(fmaxf(bn(acc, p.mul1[n], p.add1[n]), 0.f));
      });
  __syncthreads();

  // conv2 (3x3, stride 1, pad 1) + bn2 + relu as one product over
  // K = 9F: A(m, t*F + i) is channel i of a1 at output pixel m shifted by
  // tap t = dy*3 + dx, zero past the left and right edges
  const int m2 = rows * p.w;
  block_gemm(
      m2, p.f, 9 * p.f,
      [=](int m, int k) {
        const int tap = k / p.f, i = k - tap * p.f;
        const int dy = tap / 3, dx = tap - 3 * dy;
        const int tr = m / p.w;
        const int col = m - tr * p.w + dx - 1;
        if (col < 0 || col >= p.w) return 0.f;
        return to_f32(a1[((tr + dy) * p.w + col) * p.f + i]);
      },
      p.w2, stage, [=](int m, int n, float acc) {
        a2[m * p.f + n] = from_f32<T>(fmaxf(bn(acc, p.mul2[n], p.add2[n]), 0.f));
      });
  __syncthreads();

  // conv3 (1x1) + bn3 + residual + relu into this tile's output rows
  const long long row0 = img_row0 + static_cast<long long>(r0) * p.w;
  block_gemm(
      m2, p.c, p.f, [=](int m, int k) { return to_f32(a2[m * p.f + k]); }, p.w3, stage,
      [=](int m, int n, float acc) {
        const long long o = (row0 + m) * p.c + n;
        const float y = __fadd_rn(bn(acc, p.mul3[n], p.add3[n]), to_f32(p.x[o]));
        p.out[o] = from_f32<T>(fmaxf(y, 0.f));
      });
}

// staged chunks of one [M, N, K] product, the unit of work of tile_gemm
long long gemm_chunks(int M, int N, int K) {
  const int bn = N <= kNarrow ? kNarrow : kWide;
  const int bm = kTileOut / bn;
  return static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn) * ((K + kBK - 1) / kBK);
}

size_t bottleneck_smem(int tile_rows, int w, int f, size_t elem) {
  return kStageBytes + static_cast<size_t>(2 * tile_rows + 2) * w * f * elem;
}

// Output rows per block: the fewest staged chunks over one image (halo
// recompute and ragged tiles included) among the row counts whose shared
// memory is within `limit`; 0 if none fits.
int choose_tile_rows(int h, int w, int c, int f, size_t elem, size_t limit) {
  int best = 0;
  long long best_cost = LLONG_MAX;
  for (int th = 1; th <= h; ++th) {
    if (bottleneck_smem(th, w, f, elem) > limit) break;
    long long cost = 0;
    for (int r0 = 0; r0 < h; r0 += th) {
      const int rows = th < h - r0 ? th : h - r0;
      const int halo = (r0 + rows + 1 < h ? r0 + rows + 1 : h) - (r0 > 0 ? r0 - 1 : 0);
      cost += gemm_chunks(halo * w, f, c) + gemm_chunks(rows * w, f, 9 * f) +
              gemm_chunks(rows * w, c, f);
    }
    if (cost < best_cost) {
      best = th;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int launch_bottleneck(Bottleneck<T> p, int n, cudaStream_t s) {
  int dev = 0, per_sm = 0, per_block = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two blocks per SM if some tile fits so (1 KB of each block's shared
  // memory is reserved), else one
  int rows = choose_tile_rows(p.h, p.w, p.c, p.f, sizeof(T), per_sm / 2 - 1024);
  if (rows == 0) rows = choose_tile_rows(p.h, p.w, p.c, p.f, sizeof(T), per_block);
  if (rows == 0) return cudaErrorInvalidValue;
  p.tile_rows = rows;
  p.tiles = (p.h + rows - 1) / rows;
  const size_t smem = bottleneck_smem(rows, p.w, p.f, sizeof(T));
  err = cudaFuncSetAttribute(bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bottleneck_kernel<T><<<n * p.tiles, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bottleneck(const void* x, const void* w1, const void* mul1, const void* add1,
                        const void* w2, const void* mul2, const void* add2, const void* w3,
                        const void* mul3, const void* add3, void* out, int n, int h, int w,
                        int c, int f, cudaStream_t s) {
  Bottleneck<T> p;
  p.x = static_cast<const T*>(x);
  p.w1 = static_cast<const T*>(w1);
  p.mul1 = static_cast<const float*>(mul1);
  p.add1 = static_cast<const float*>(add1);
  p.w2 = static_cast<const T*>(w2);
  p.mul2 = static_cast<const float*>(mul2);
  p.add2 = static_cast<const float*>(add2);
  p.w3 = static_cast<const T*>(w3);
  p.mul3 = static_cast<const float*>(mul3);
  p.add3 = static_cast<const float*>(add3);
  p.out = static_cast<T*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.f = f;
  return launch_bottleneck(p, n, s);
}

}  // namespace

// x/out: [m, k] and [m, n] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1);
// w: [k, n] in x's dtype; mul/add: [n] f32; residual: [m, n] in x's dtype,
// or NULL.  Returns cudaGetLastError() after the launch.
extern "C" int macsa_matmul_bn_act(const void* x, const void* w, const void* mul,
                                   const void* add, const void* residual, void* out, int m,
                                   int n, int k, int relu, int bf16, void* stream) {
  if (m < 1 || n < 1 || k < 1 || (n + kNarrow - 1) / kNarrow > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch_matmul_bn_act<__nv_bfloat16>(x, w, mul, add, residual, out, m, n, k, relu, s);
  else
    dispatch_matmul_bn_act<float>(x, w, mul, add, residual, out, m, n, k, relu, s);
  return static_cast<int>(cudaGetLastError());
}

// x/out: [n*h*w, c] NHWC rows, contiguous, f32 (bf16 == 0) or bf16
// (bf16 == 1); w1: [c, f], w2: [9, f, f], w3: [f, c] in x's dtype;
// mul*/add*: f32 [f], [f], [c].  One launch.  Returns cudaErrorInvalidValue
// if no tile of output rows fits in shared memory, else cudaGetLastError().
extern "C" int macsa_fused_bottleneck(const void* x, const void* w1, const void* mul1,
                                      const void* add1, const void* w2, const void* mul2,
                                      const void* add2, const void* w3, const void* mul3,
                                      const void* add3, void* out, int n, int h, int w, int c,
                                      int f, int bf16, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || f < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bottleneck<__nv_bfloat16>(x, w1, mul1, add1, w2, mul2, add2, w3, mul3,
                                                   add3, out, n, h, w, c, f, s)
              : dispatch_bottleneck<float>(x, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3,
                                           out, n, h, w, c, f, s);
}
