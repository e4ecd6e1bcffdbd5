// The bf16 tensor-core variants of K4 (a 1x1 convolution with its
// frozen-BatchNorm epilogue) and K5 (a whole stride-1 identity ResNet
// bottleneck) for Hopper (sm_90a).  `fused_resnet.cu` holds the CUDA-core
// variants, which take f32 and every shape these do not; both files
// replace the same TPU kernels (tools_dev/fused_resnet_experiment.py,
// `_kernel` via `_call`, and `_bottleneck_kernel` via `_bneck_fwd`) and
// compute the same functions with the same rounding points:
//   K4: out = relu?((x @ w) * mul + add [+ residual])
//   K5: a1  = relu((x @ w1) * mul1 + add1)                      -> bf16
//       a2  = relu(conv3x3_pad1(a1, w2) * mul2 + add2)          -> bf16
//       out = relu((a2 @ w3) * mul3 + add3 + x)                 -> bf16
// with f32 sums, f32 epilogues that round the product and the sum
// separately, and one rounding to bf16 at a1, a2 and the output.  The
// tensor cores add each output's products in another order than the plain
// versions, so results agree to a bf16 ulp where a rounding flips, not to
// the bit.
//
// The product pipeline (both kernels).  A block is two warpgroups (256
// threads); each owns 64 rows of a 128-row block tile and keeps its f32
// accumulators in registers.  Products are `wgmma.mma_async` m64n{64,128}k16
// on bf16 operands.  Operand tiles of 64 k reach shared memory through a
// ring of stages filled by 16-byte `cp.async`, two tiles in flight beyond
// the one being multiplied; every thread starts its share of each tile's
// copies, so there is no producer warp and no register hand-over.  Tiles
// use the 128-byte swizzle:
//   A [128 m][64 k], k contiguous (x's own layout): row r at r*128 bytes,
//     16-byte chunk c at (c ^ (r & 7)); descriptor stride 1024 bytes per 8
//     rows; a k16 step advances the start address by 32 bytes;
//   B [64 k][NW n], n contiguous (w's own [K, N] layout, so no transposed
//     copy): per 64 columns an 8 KB block, k row at (k/8)*1024 + (k%8)*128,
//     chunk c at (c ^ (k & 7)); the descriptor's transpose bit is set,
//     leading offset 8192 (next 64 columns), stride 1024 (next 8 k); a k16
//     step advances the start address by 2048 bytes.
// A ragged last tile zero-fills its missing rows (`cp.async` with a source
// size of 0) and masks its stores.  An output tile leaves through an f32
// staging tile in shared memory, so that the residual is read and the
// output written 16 bytes a lane along a row (straight from the
// accumulators a lane touches 4 bytes of each of 8 rows, which cost K4's
// conv3 0.29 ms instead of 0.12 and K5 a third of its time).
//
// K4's bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at stage 3 of
// ResNet-152 over 280 images conv1 [54880, 1024] -> 256 moves 141 MB
// (0.042 ms) for 28.8 GFLOP (0.029 ms); conv3 [54880, 256] -> 1024 with a
// residual moves 253 MB (0.076 ms).  Memory-bound, so the design is about
// bytes in flight: a 128 x 128 tile with three stages of 32 KB lets two
// blocks share an SM, one block's epilogue (all its residual chunks
// fetched at once) running under the other's loads; column tiles of one
// row tile are neighbours in the grid, so x comes from device memory once
// and from L2 after that.
//
// K5's bound: one stage-3 block over 280 images is 122.3 GFLOP (0.124 ms)
// against 227 MB of x read, output written and weights read (0.068 ms):
// compute-bound on the tensor cores.  One launch per bottleneck and one
// block per (image, tile of TH output rows), a1 and a2 never in device
// memory:
//   * a1 is kept at a padded width WP = w + 1: one zero column serves as
//     the right edge of one image row and the left edge of the next, and
//     the halo rows outside the image stay zero.  Output position
//     m = r*WP + col then reads tap (dy, dx) of the 3x3 at a1 row
//     m + dy*WP + dx: nine products at constant row offsets.  A `wgmma`
//     descriptor cannot start at an arbitrary row of a swizzled tile, so
//     conv2 and conv3 feed A from registers: `ldmatrix` takes a row address
//     per lane, so a shift costs nothing, and rows are padded by 16 bytes
//     so that neither `ldmatrix` nor the epilogues' stores conflict on
//     banks.  Outputs at the padding column are computed and dropped.
//   * conv1 is recomputed on a one-row halo above and below (TH = 7 at
//     stage 3: 9 rows for 7, +29% of conv1, +7% of the block).
//   * Weights from L2, the reckoning: every block streams w1 + w2 + w3
//     (2.2 MB at stage 3) through the ring; with 2 blocks per image, 560
//     blocks move 1.25 GB per launch, ~0.2-0.25 ms at the L2's several
//     TB/s if nothing hid it.  Measured with the weight loads taken out:
//     0.09 of 0.55 ms at stage 3, 0.25 of 0.88 ms at stage 4 (8.9 MB a
//     block).  More rows per weight pass would cut it, but a1 (72 KB), a2
//     (66 KB, sharing its space with conv1's ring of x tiles) and the
//     weight ring (64 KB) fill the 227 KB of one SM at 128 rows; a cluster
//     with multicast loads is the next step and is not done here.
//   * Accumulators are 64 x 128 f32 per warpgroup (64 registers a thread),
//     so wider layers (F = 256, 512; C up to 2048) take several column
//     passes over the same A; the ring's loads run on across passes, so a
//     pass's first product finds its tiles in shared memory.  conv3's
//     staging tile takes a1's space, which is dead by then.
//   * The host picks TH (`ops/fused_resnet.py`, `wgmma_tile_rows`): the
//     most rows whose a1, a2 and rings fit, evened over the image.
//   * What is left: with every load and store taken out the stage-3 block
//     still takes 0.31 ms (barriers at every k-step, both warpgroups in
//     their epilogues at once, 560 blocks on 132 SMs: 4.2 waves run as 5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 256;        // two warpgroups
constexpr int kBM = 128;             // rows of a block tile, 64 per warpgroup
constexpr int kBK = 64;              // k per ring stage: one swizzled 128-byte row
constexpr int kStages = 4;           // ring depth of K5 (K4: kK4Stages)
constexpr int kATile = kBM * kBK * 2;

__device__ __forceinline__ uint64_t a_desc(uint32_t tile, int wg) {
  return make_desc(tile + wg * 64 * 128, 16, 1024);
}
__device__ __forceinline__ uint64_t b_desc(uint32_t tile) { return make_desc(tile, 8192, 1024); }
constexpr int kADescK16 = 32 >> 4;    // descriptor step of 16 k in an A tile
constexpr int kBDescK16 = 2048 >> 4;  // and in a B tile

// rows [row0, row0 + 128) x columns [k0, k0 + 64) of the row-major a[., ld]
// into an A tile; rows from `valid_rows` (>= 1) on are zero
__device__ __forceinline__ void load_a_tile(uint32_t tile, const bf16* __restrict__ a,
                                            long long row0, int valid_rows, int ld, int k0) {
#pragma unroll
  for (int i = 0; i < kBM * 8 / kThreads; ++i) {
    const int id = i * kThreads + threadIdx.x;
    const int r = id >> 3, c = id & 7;
    const bool ok = r < valid_rows;
    const bf16* src = a + (row0 + (ok ? r : 0)) * ld + k0 + c * 8;
    cp_async16(tile + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
  }
}

// rows [k0, k0 + 64) x columns [n0, n0 + NW) of the row-major b[., ld] into a B tile
template <int NW>
__device__ __forceinline__ void load_b_tile(uint32_t tile, const bf16* __restrict__ b, int ld,
                                            int k0, int n0) {
  constexpr int kChunks = NW / 8;  // per k row
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
    const int id = i * kThreads + threadIdx.x;
    const int k = id / kChunks, c = id % kChunks;
    const bf16* src = b + static_cast<long long>(k0 + k) * ld + n0 + c * 8;
    cp_async16(tile + (c >> 3) * 8192 + (k >> 3) * 1024 + (k & 7) * 128 +
                   (((c & 7) ^ (k & 7)) << 4),
               src, true);
  }
}

// the frozen-BN affine, rounded per operation like (acc * mul) + add in PyTorch
__device__ __forceinline__ float bn(float acc, float mul, float add) {
  return __fadd_rn(__fmul_rn(acc, mul), add);
}

// A stream of `passes` x `steps` operand tiles through a ring of STAGES
// slots, `steps` k-steps per pass into one accumulator, then epi(acc, pass).
// load(t, slot) starts tile t's copies; step(acc, pass, ks, slot) starts the
// pass's ks-th products on the tile in `slot` and commits them, leaving at
// most PENDING (0 or 1) groups of products in flight, so STAGES - 1 - PENDING
// tiles are in flight beyond the one in use.  Every thread of the block
// calls it with the same arguments.  The loads run ahead across passes.
// The k loop is written out twice over, so that a step whose A fragments
// live in registers gets other registers than the step still in flight.
template <int NW, int STAGES, int PENDING, typename Load, typename Step, typename Epi>
__device__ __forceinline__ void run_phase(int passes, int steps, Load load, Step step, Epi epi) {
  constexpr int kAhead = STAGES - 1 - PENDING;
  const int total = passes * steps;
  for (int t = 0; t < kAhead; ++t) {
    if (t < total) load(t, t);
    cp_async_commit();
  }
  int t = 0;
  for (int pass = 0; pass < passes; ++pass) {
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    auto one_step = [&](int ks) {
      cp_async_wait<kAhead - 1>();  // this thread's copies of tile t have landed
      fence_async_proxy();
      // everyone's copies of tile t have landed, and everyone's products on
      // tile t - 1 - PENDING are done, so its slot can be filled again
      __syncthreads();
      const int ahead = t + kAhead;
      if (ahead < total) load(ahead, ahead % STAGES);
      cp_async_commit();
      step(acc, pass, ks, t % STAGES);
      ++t;
    };
    for (int ks = 0; ks < steps; ks += 2) {
      one_step(ks);
      if (ks + 1 < steps) one_step(ks + 1);
    }
    wgmma::wait<0>();
    epi(acc, pass);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// the four k16 products of one stage, A and B from shared memory
template <int NW, int PENDING>
__device__ __forceinline__ void products_ss(float (&acc)[NW / 2], uint32_t a_tile,
                                            uint32_t b_tile, int wg, bool first) {
  const uint64_t da = a_desc(a_tile, wg), db = b_desc(b_tile);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma::Op<NW>::ss(acc, da + kk * kADescK16, db + kk * kBDescK16, !(first && kk == 0));
  wgmma::commit();
  wgmma::wait<PENDING>();
}

// the four k16 products of one stage, A from this lane's `ldmatrix` row
// address (64 k contiguous from there), B from shared memory; the step
// before it may still be in flight
template <int NW>
__device__ __forceinline__ void products_rs(float (&acc)[NW / 2], uint32_t a_addr,
                                            uint32_t b_tile, bool first) {
  uint32_t frag[kBK / 16][4];
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) ldmatrix_x4(frag[kk], a_addr + kk * 32);
  const uint64_t db = b_desc(b_tile);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma::Op<NW>::rs(acc, frag[kk], db + kk * kBDescK16, !(first && kk == 0));
  wgmma::commit();
  wgmma::wait<1>();
}

// The accumulator's rows and columns of this thread: rows lo and lo + 8 of
// the warpgroup's 64, columns 8j + col2 and the next for j = 0 .. NW/8.
struct Fragment {
  int wg, row_lo, col2;
  __device__ Fragment() {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    wg = threadIdx.x >> 7;
    row_lo = wg * 64 + warp * 16 + (lane >> 2);
    col2 = (lane & 3) * 2;
  }
};

// The staging tile of an output tile: f32 [128][NW + 8] (the residual is
// added in f32 before the one rounding; 8 floats of padding keep a
// half-warp's 8-byte stores on distinct banks).
template <int NW>
constexpr int kOutStageBytes = kBM * (NW + 8) * 4;

// bn(acc) of this thread's accumulators into the staging tile
template <int NW>
__device__ __forceinline__ void stage_bn(float* stage, const float (&acc)[NW / 2],
                                         const Fragment& frag, const float* __restrict__ mul,
                                         const float* __restrict__ add) {
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int n = 8 * j + frag.col2;
    const float2 mu = *reinterpret_cast<const float2*>(mul + n);
    const float2 ad = *reinterpret_cast<const float2*>(add + n);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(stage + (frag.row_lo + 8 * half) * (NW + 8) + n) = make_float2(
          bn(acc[4 * j + 2 * half], mu.x, ad.x), bn(acc[4 * j + 2 * half + 1], mu.y, ad.y));
  }
}

// The 16-byte chunks of a 128 x NW output tile are dealt to the block's
// threads in turn, NW / 16 to each.  The residual chunks are fetched first,
// all at once, so that their latency is paid once a tile.
template <int NW>
struct OutChunks {
  static constexpr int kPerRow = NW / 8;
  static constexpr int kPerThread = kBM * kPerRow / kThreads;
  static __device__ __forceinline__ int row(int i) {
    return (i * kThreads + threadIdx.x) / kPerRow;
  }
  static __device__ __forceinline__ int col(int i) {
    return ((i * kThreads + threadIdx.x) % kPerRow) * 8;
  }
};

// 8 staged values [+ the 8 bf16 of `residual`] -> relu? -> 8 bf16 at `out`
__device__ __forceinline__ void finish8(const float* staged, bool has_residual, uint4 residual,
                                        bf16* out, bool relu) {
  const float4 lo = *reinterpret_cast<const float4*>(staged);
  const float4 hi = *reinterpret_cast<const float4*>(staged + 4);
  float y[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (has_residual) {
    const bf162* r2 = reinterpret_cast<const bf162*>(&residual);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[2 * i] = __fadd_rn(y[2 * i], __low2float(r2[i]));
      y[2 * i + 1] = __fadd_rn(y[2 * i + 1], __high2float(r2[i]));
    }
  }
  uint4 packed;
  bf162* o2 = reinterpret_cast<bf162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o2[i] = relu ? __floats2bfloat162_rn(fmaxf(y[2 * i], 0.f), fmaxf(y[2 * i + 1], 0.f))
                 : __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
  *reinterpret_cast<uint4*>(out) = packed;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// Memory-bound, so two blocks share an SM (one's epilogue under the other's
// loads): three stages, the products waited for at each step, two tiles in
// flight beyond the one in use.
constexpr int kK4Stages = 3;
template <int NW>
constexpr int k4_smem() { return kAlign + kK4Stages * (kATile + NW * kBK * 2); }

template <int NW>
__global__ void __launch_bounds__(kThreads, 2)
matmul_bn_act_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const float* __restrict__ mul, const float* __restrict__ add,
                           const bf16* __restrict__ residual, bf16* __restrict__ out, int M, int N,
                           int K, int relu) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kStage = kATile + NW * kBK * 2;
  const uint32_t ring = smem_u32(aligned_smem(smem_raw));
  // column tiles of one row tile are neighbours: they share x through L2
  const int n_tiles = N / NW;
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * NW;
  const int valid_rows = min(kBM, M - m0);
  const Fragment frag;
  float* stage = reinterpret_cast<float*>(aligned_smem(smem_raw));  // the ring, once it is idle
  static_assert(kOutStageBytes<NW> <= kK4Stages * kStage, "the output tile fits in the ring");

  run_phase<NW, kK4Stages, 0>(
      1, K / kBK,
      [&](int t, int slot) {
        load_a_tile(ring + slot * kStage, x, m0, valid_rows, K, t * kBK);
        load_b_tile<NW>(ring + slot * kStage + kATile, w, N, t * kBK, n0);
      },
      [&](float (&acc)[NW / 2], int, int ks, int slot) {
        products_ss<NW, 0>(acc, ring + slot * kStage, ring + slot * kStage + kATile, frag.wg,
                           ks == 0);
      },
      [&](float (&acc)[NW / 2], int) {
        __syncthreads();  // the other warpgroup's products no longer read the ring
        stage_bn<NW>(stage, acc, frag, mul + n0, add + n0);
        using Chunks = OutChunks<NW>;
        uint4 res[Chunks::kPerThread];
        if (residual != nullptr) {
#pragma unroll
          for (int i = 0; i < Chunks::kPerThread; ++i)
            if (Chunks::row(i) < valid_rows)
              res[i] = *reinterpret_cast<const uint4*>(
                  residual + static_cast<long long>(m0 + Chunks::row(i)) * N + n0 +
                  Chunks::col(i));
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < Chunks::kPerThread; ++i) {
          const int row = Chunks::row(i), col = Chunks::col(i);
          if (row < valid_rows)
            finish8(stage + row * (NW + 8) + col, residual != nullptr, res[i],
                    out + static_cast<long long>(m0 + row) * N + n0 + col, relu != 0);
        }
      });
}

template <int NW>
int launch_matmul_bn_act_wgmma(const void* x, const void* w, const void* mul, const void* add,
                               const void* residual, void* out, int M, int N, int K, int relu,
                               cudaStream_t s) {
  const long long blocks = static_cast<long long>((M + kBM - 1) / kBM) * (N / NW);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(matmul_bn_act_wgmma_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         k4_smem<NW>());
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_bn_act_wgmma_kernel<NW><<<static_cast<unsigned>(blocks), kThreads, k4_smem<NW>(), s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<const bf16*>(residual),
      static_cast<bf16*>(out), M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

struct Bottleneck {
  const bf16* x;
  const bf16* w1;
  const float* mul1;
  const float* add1;
  const bf16* w2;
  const float* mul2;
  const float* add2;
  const bf16* w3;
  const float* mul3;
  const float* add3;
  bf16* out;
  int h, w, c;    // image rows and columns, block channels
  int tile_rows;  // output image rows per block
  int tiles;      // blocks per image
};

constexpr int kWeightTile = 128 * kBK * 2;  // a B tile of up to 128 columns
constexpr int kRingB = kStages * kWeightTile;
constexpr int kRingA = kStages * kATile;
constexpr int kOutStage = kOutStageBytes<128>;  // conv3's output tile, in a1's space

// Shared memory of one block, after alignment: the weight ring; a2
// [tile_rows * WP, F] sharing its space with conv1's ring of x tiles; a1
// [(tile_rows + 2) * WP + 2, F] sharing its space with conv3's f32 output
// staging tile.  Rows of a1 and a2 are F * 2 + 16 bytes.
__host__ __device__ inline int row_bytes(int f) { return f * 2 + 16; }
__host__ __device__ inline int a2_bytes(int tile_rows, int w, int f) {
  const int need = tile_rows * (w + 1) * row_bytes(f);
  return need > kRingA ? need : kRingA;
}
__host__ __device__ inline int a1_bytes(int tile_rows, int w, int f) {
  const int need = ((tile_rows + 2) * (w + 1) + 2) * row_bytes(f);
  return need > kOutStage ? need : kOutStage;
}
inline long long k5_smem(int tile_rows, int w, int f) {
  return static_cast<long long>(kAlign) + kRingB + a2_bytes(tile_rows, w, f) +
         a1_bytes(tile_rows, w, f);
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_wgmma_kernel(Bottleneck p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int NW = F < 128 ? F : 128;  // accumulator width of conv1 and conv2
  constexpr int NW3 = 128;               // and of conv3
  constexpr int RB = F * 2 + 16;
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* a2 = smem + kRingB;
  uint8_t* a1 = a2 + a2_bytes(p.tile_rows, p.w, F);
  const uint32_t ring_b = smem_u32(smem), ring_a = smem_u32(a2);
  const uint32_t a1_addr = smem_u32(a1), a2_addr = ring_a;
  const Fragment frag;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  // this lane's row of a warp's 16 x 16 A fragment, and its k offset in bytes
  const int ld_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_koff = (lane >> 4) * 16;

  const int wp = p.w + 1;
  const int img = blockIdx.x / p.tiles;
  const int r0 = (blockIdx.x % p.tiles) * p.tile_rows;  // first output image row
  const int rows = min(p.tile_rows, p.h - r0);
  // a1's row rr holds image row r0 - 1 + rr; conv1 fills the rows inside
  // the image, [lo, hi); the others and the padding column stay zero
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, p.h);
  const long long img_row0 = static_cast<long long>(img) * p.h * p.w;  // x row of (img, 0, 0)

  {
    const int n16 = a1_bytes(p.tile_rows, p.w, F) / 16;
    uint4* dst = reinterpret_cast<uint4*>(a1);
    for (int e = threadIdx.x; e < n16; e += kThreads) dst[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // conv1 (1x1) + bn1 + relu over the image rows [lo, hi): x's rows are
  // contiguous in device memory; pixel (pr, col) lands at a1 row
  // (lo - r0 + 1 + pr) * WP + 1 + col
  {
    const int m1 = (hi - lo) * p.w;
    const long long x_row0 = img_row0 + static_cast<long long>(lo) * p.w;
    const int a1_row0 = (lo - r0 + 1) * wp + 1;
    constexpr int kColPasses = F / NW;
    const int steps = p.c / kBK;
    run_phase<NW, kStages, 1>(
        ((m1 + kBM - 1) / kBM) * kColPasses, steps,
        [&](int t, int slot) {
          const int ks = t % steps, pass = t / steps;
          const int mt = pass / kColPasses, pn = pass % kColPasses;
          load_a_tile(ring_a + slot * kATile, p.x, x_row0 + mt * kBM, min(kBM, m1 - mt * kBM),
                      p.c, ks * kBK);
          load_b_tile<NW>(ring_b + slot * kWeightTile, p.w1, F, ks * kBK, pn * NW);
        },
        [&](float (&acc)[NW / 2], int, int ks, int slot) {
          products_ss<NW, 1>(acc, ring_a + slot * kATile, ring_b + slot * kWeightTile, frag.wg,
                             ks == 0);
        },
        [&](float (&acc)[NW / 2], int pass) {
          const int mt = pass / kColPasses, n0 = (pass % kColPasses) * NW;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = mt * kBM + frag.row_lo + 8 * half;
            if (m >= m1) continue;
            const int pr = m / p.w;
            uint8_t* row = a1 + (a1_row0 + pr * wp + (m - pr * p.w)) * RB;
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int n = n0 + 8 * j + frag.col2;
              const float y0 = fmaxf(bn(acc[4 * j + 2 * half], p.mul1[n], p.add1[n]), 0.f);
              const float y1 =
                  fmaxf(bn(acc[4 * j + 2 * half + 1], p.mul1[n + 1], p.add1[n + 1]), 0.f);
              *reinterpret_cast<bf162*>(row + n * 2) = __floats2bfloat162_rn(y0, y1);
            }
          }
        });
  }

  // conv2 (3x3, stride 1, pad 1) + bn2 + relu: output position m = r*WP + col
  // (col = WP - 1 is the padding column, computed and never used) sums nine
  // products, tap (dy, dx) reading a1 from row m + dy*WP + dx
  const int m2 = rows * wp;
  const int m_tiles2 = (m2 + kBM - 1) / kBM;
  {
    constexpr int kColPasses = F / NW;
    constexpr int kStepsPerTap = F / kBK;
    run_phase<NW, kStages, 1>(
        m_tiles2 * kColPasses, 9 * kStepsPerTap,
        [&](int t, int slot) {
          const int ks = t % (9 * kStepsPerTap), pn = (t / (9 * kStepsPerTap)) % kColPasses;
          load_b_tile<NW>(ring_b + slot * kWeightTile, p.w2, F, ks * kBK, pn * NW);
        },
        [&](float (&acc)[NW / 2], int pass, int ks, int slot) {
          const int mb = (pass / kColPasses) * kBM + frag.wg * 64;
          if (mb >= m2) return;  // a warpgroup with no rows
          const int tap = ks / kStepsPerTap, kf = (ks % kStepsPerTap) * kBK;
          const int m = min(mb + ld_row, m2 - 1);
          const int src = m + (tap / 3) * wp + tap % 3;
          products_rs<NW>(acc, a1_addr + src * RB + kf * 2 + ld_koff,
                          ring_b + slot * kWeightTile, ks == 0);
        },
        [&](float (&acc)[NW / 2], int pass) {
          const int mt = pass / kColPasses, n0 = (pass % kColPasses) * NW;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = mt * kBM + frag.row_lo + 8 * half;
            if (m >= m2) continue;
            uint8_t* row = a2 + m * RB;
#pragma unroll
            for (int j = 0; j < NW / 8; ++j) {
              const int n = n0 + 8 * j + frag.col2;
              const float y0 = fmaxf(bn(acc[4 * j + 2 * half], p.mul2[n], p.add2[n]), 0.f);
              const float y1 =
                  fmaxf(bn(acc[4 * j + 2 * half + 1], p.mul2[n + 1], p.add2[n + 1]), 0.f);
              *reinterpret_cast<bf162*>(row + n * 2) = __floats2bfloat162_rn(y0, y1);
            }
          }
        });
  }

  // conv3 (1x1) + bn3 + residual + relu into this tile's output rows
  {
    const int col_passes = p.c / NW3;
    constexpr int kSteps = F / kBK;
    const long long out_row0 = img_row0 + static_cast<long long>(r0) * p.w;
    run_phase<NW3, kStages, 1>(
        m_tiles2 * col_passes, kSteps,
        [&](int t, int slot) {
          const int ks = t % kSteps, pn = (t / kSteps) % col_passes;
          load_b_tile<NW3>(ring_b + slot * kWeightTile, p.w3, p.c, ks * kBK, pn * NW3);
        },
        [&](float (&acc)[NW3 / 2], int pass, int ks, int slot) {
          const int mb = (pass / col_passes) * kBM + frag.wg * 64;
          if (mb >= m2) return;
          const int m = min(mb + ld_row, m2 - 1);
          products_rs<NW3>(acc, a2_addr + m * RB + ks * kBK * 2 + ld_koff,
                           ring_b + slot * kWeightTile, ks == 0);
        },
        [&](float (&acc)[NW3 / 2], int pass) {
          // a1 is dead: its space stages the tile.  The k-steps' barriers
          // separate this pass's writes from the last pass's reads.
          const int mt = pass / col_passes, n0 = (pass % col_passes) * NW3;
          float* stage = reinterpret_cast<float*>(a1);
          stage_bn<NW3>(stage, acc, frag, p.mul3 + n0, p.add3 + n0);
          using Chunks = OutChunks<NW3>;
          uint4 res[Chunks::kPerThread];
          long long offset[Chunks::kPerThread];  // of the chunk in x and out, or -1
#pragma unroll
          for (int i = 0; i < Chunks::kPerThread; ++i) {
            const int m = mt * kBM + Chunks::row(i);
            const int r = m / wp, col = m - r * wp;
            offset[i] = (m < m2 && col < p.w)  // col == w is the padding column
                            ? (out_row0 + r * p.w + col) * p.c + n0 + Chunks::col(i)
                            : -1;
            if (offset[i] >= 0) res[i] = *reinterpret_cast<const uint4*>(p.x + offset[i]);
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < Chunks::kPerThread; ++i)
            if (offset[i] >= 0)
              finish8(stage + Chunks::row(i) * (NW3 + 8) + Chunks::col(i), true, res[i],
                      p.out + offset[i], true);
        });
  }
}

template <int F>
int launch_bottleneck_wgmma(const Bottleneck& p, int n, cudaStream_t s) {
  const long long smem = k5_smem(p.tile_rows, p.w, F);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n) * p.tiles;
  if (smem > limit || blocks > INT32_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bottleneck_wgmma_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bottleneck_wgmma_kernel<F><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4 on the tensor cores (128-column tiles, or 64 where n is no multiple of
// 128).  x [m, k], w [k, n], residual (or NULL) and out
// [m, n]: bf16, contiguous, 16-byte aligned; mul/add: [n] f32; k and n
// multiples of 64.  Returns cudaErrorInvalidValue for other shapes, else
// cudaGetLastError() after the launch.
extern "C" int macsa_matmul_bn_act_wgmma(const void* x, const void* w, const void* mul,
                                         const void* add, const void* residual, void* out, int m,
                                         int n, int k, int relu, void* stream) {
  if (m < 1 || n < 64 || k < 64 || n % 64 || k % 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 128 == 0)
    return launch_matmul_bn_act_wgmma<128>(x, w, mul, add, residual, out, m, n, k, relu, s);
  return launch_matmul_bn_act_wgmma<64>(x, w, mul, add, residual, out, m, n, k, relu, s);
}

// K5 on the tensor cores.  x/out: [n*h*w, c] NHWC rows, bf16, contiguous,
// 16-byte aligned; w1 [c, f], w2 [9, f, f], w3 [f, c] bf16; mul*/add*: f32
// [f], [f], [c]; f one of 64, 128, 256, 512; c a multiple of 128;
// tile_rows output image rows per block, as `wgmma_tile_rows` of
// ops/fused_resnet.py picks them.  One launch.  Returns
// cudaErrorInvalidValue for other shapes or a tile that does not fit in
// shared memory, else cudaGetLastError().
extern "C" int macsa_fused_bottleneck_wgmma(const void* x, const void* w1, const void* mul1,
                                            const void* add1, const void* w2, const void* mul2,
                                            const void* add2, const void* w3, const void* mul3,
                                            const void* add3, void* out, int n, int h, int w,
                                            int c, int f, int tile_rows, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 128 || c % 128 || tile_rows < 1 || tile_rows > h)
    return cudaErrorInvalidValue;
  Bottleneck p;
  p.x = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w1);
  p.mul1 = static_cast<const float*>(mul1);
  p.add1 = static_cast<const float*>(add1);
  p.w2 = static_cast<const bf16*>(w2);
  p.mul2 = static_cast<const float*>(mul2);
  p.add2 = static_cast<const float*>(add2);
  p.w3 = static_cast<const bf16*>(w3);
  p.mul3 = static_cast<const float*>(mul3);
  p.add3 = static_cast<const float*>(add3);
  p.out = static_cast<bf16*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.tile_rows = tile_rows;
  p.tiles = (h + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 64: return launch_bottleneck_wgmma<64>(p, n, s);
    case 128: return launch_bottleneck_wgmma<128>(p, n, s);
    case 256: return launch_bottleneck_wgmma<256>(p, n, s);
    case 512: return launch_bottleneck_wgmma<512>(p, n, s);
    default: return cudaErrorInvalidValue;
  }
}
