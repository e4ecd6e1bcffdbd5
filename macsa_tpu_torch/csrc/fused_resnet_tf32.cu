// The f32 tensor-core variants ("tf32x3") of K4 (a 1x1 convolution with its
// frozen-BatchNorm epilogue) and K5 (a whole stride-1 identity ResNet
// bottleneck) for Hopper (sm_90a).  `fused_resnet.cu` holds the CUDA-core
// variants (f32 and bf16 at every other shape), `fused_resnet_wgmma.cu` the
// bf16 tensor-core ones; all three replace the same TPU kernels
// (tools_dev/fused_resnet_experiment.py, `_kernel` via `_call`, and
// `_bottleneck_kernel` via `_bneck_fwd`) and compute the same functions with
// the same rounding points:
//   K4: out = relu?((x @ w) * mul + add [+ residual])
//   K5: a1  = relu((x @ w1) * mul1 + add1)
//       a2  = relu(conv3x3_pad1(a1, w2) * mul2 + add2)
//       out = relu((a2 @ w3) * mul3 + add3 + x)
// with f32 sums, f32 epilogues that round the product and the sum
// separately (no FMA contraction), the residual added in f32, and a1, a2
// and the output in f32.
//
// Three TF32 products for one f32 product (`tf32x3.cuh`): every operand is
// split into big = tf32(x) and small = tf32(x - big), rounded to nearest,
// ties away, and each f32 product is small*big + big*small + big*big, three
// TF32 products in that order, summed in f32.  One TF32 product keeps 11
// bits of each operand and misses the f32 tolerances (K4 1e-5, K5 1e-4 of
// max|ref|); three keep about 22.  The tensor cores' own sums truncate, so
// every 16 k of products go into a zeroed partial sum that is added to the
// accumulators with an f32 add, rounded to nearest: summed over all of K
// (2,304 at conv2 of stage 3) 35 stage-3 blocks in a row miss 1e-4.
//
// What bounds them on an H100 (495 TFLOP/s TF32 on the tensor cores, so
// 165 TFLOP/s of f32 products at three TF32 products each; 67 TFLOP/s f32
// on the CUDA cores; 3.35 TB/s).  At ResNet-152 stage 3 over 280 images
// (54,880 rows, C = 1024, F = 256) one bottleneck is 122.3 GFLOP (0.741 ms
// as 3xTF32, 1.825 ms on the CUDA cores) against 454 MB of x read, output
// written and weights read (0.136 ms): bound by its products.  K4's convs
// are 28.77 GFLOP each (0.174 ms as 3xTF32) against 282 MB (conv1) and
// 507 MB (conv3 with its residual): bound by their products too.
//
// K4 (no caller on the main path) multiplies with `mma.sync.m16n8k8`, whose
// B fragment reads w's own [K, N] rows, split in registers.  A block is 8
// warps.  A phase is a product [M, K] x [K, N] walked in passes of PH x PW
// outputs; a pass is WM x WN warps (`Pass`), each warp MT m16 tiles by 4 n8
// tiles, its f32 accumulators in registers.  K goes through a ring of two
// stages of 16 k in shared memory, filled by 16-byte `cp.async`.  A stage
// holds a B chunk [16][PW + 8] and an A chunk [PH][16 + 4]; the padding keeps
// every fragment read free of bank conflicts (`ldmatrix.x4` A fragments, B's
// lane 4g + t on bank 8t + g).  Outputs leave through a per-warp f32 staging
// tile [32][32 + 8], 16 bytes a lane along rows.  One block per output tile:
// 112 x 256 for N a multiple of 256 (Pass<8, 7>), else 128 x 64.  Each TF32
// product pass adds about 0.11 ms to its conv1 (~260 TFLOP/s, `mma.sync`'s
// TF32 rate on this card: `ablate_resnet.py`).
//
// K5 multiplies with `wgmma.mma_async` m64nNk8 TF32, at the card's full
// TF32 rate.  TF32 `wgmma` reads B from shared memory only K-major ([n][k],
// k contiguous) and the weights are [K, N], N contiguous; and a B operand in
// shared memory cannot be split on its way to the tensor cores.  So the
// weights are split once a call, before the bottleneck kernel, by
// `tf32_weight_planes_kernel`: each of w1 [C, F], w2 [9F, F] (its own tap
// order) and w3 [F, C] becomes its big and small TF32 planes, transposed to
// K-major, in tiles of NB = min(N, 256) columns by 16 k laid out as the ring
// wants them (64-byte rows, 64-byte swizzle: chunk c of row n at chunk
// c ^ ((n >> 1) & 3)), in the order the passes read them, k permuted within
// a tile so that a lane's A values for both k8 steps are 16 contiguous
// bytes.  A tile is then one contiguous copy, and no block splits a weight.
// At stage 3 that reads 4.5 MB and writes 8.9 MB a call.
//   * One launch per bottleneck and one block (two warpgroups and a producer
//     warp, 288 threads) per TILE rows of the [n*h*w, C] rows
//     (`tf32x3_tile_rows`: the most multiples of 64 that fit, 64 at stage
//     3), running across image rows and images.  a1 covers the tile and a
//     halo of w + 1 rows each side (conv1 recomputes it; its rows outside
//     the images are never read), plus one zero row; a2 takes a1's first
//     rows once conv2 is done (its own rows at F = 512, where conv2 takes two
//     column passes over all of a1).  Both stay in shared memory in f32,
//     rows of F + 16 floats, so that a quarter warp's 16-byte loads of two
//     neighbouring rows fall on other banks.
//   * conv2 is nine tap-shifted products, K = 9F: output row i reads tap
//     (dy, dx) at a1 row i + dy*w + dx, or the zero row where the tap leaves
//     its image (a row and column test per lane, once a tap).
//   * A comes from registers, split there: two 16-byte loads of a lane's
//     rows a chunk, from its warp's ring of x rows for conv1 (each warp
//     copies its own 16 rows with `cp.async`), from a1 at tap-shifted rows
//     for conv2, from a2 for conv3.  Each k8 is three m64nNk8 products
//     (small*big, big*small, big*big) into a 16-k partial.
//   * A pass is 64 rows x 256 columns (each warpgroup 128, N = 128) for a
//     conv at least 256 wide, else 128 rows x N (each warpgroup an m64 tile).
//   * The weights reach shared memory through a ring of three stages of 16 k,
//     each one weight tile, fed by one bulk copy (`cp.async.bulk`, the Tensor
//     Memory Accelerator) on `mbarrier`s from a producer warp beside the two
//     warpgroups, which refills a stage as soon as both have released it: no
//     block-wide barrier per k-step, and the copies run as far ahead as the
//     ring allows.  Refilled by a consumer thread after its own products,
//     the copies came late, and the warpgroups waited for their tiles.
//   * conv3's epilogue writes the output straight from the accumulators,
//     8 bytes a lane (a quad of lanes fills a 32-byte sector), the residual
//     read the same way.
// What holds it back (`ablate_resnet.py`, stage 3 over 280 images, 1.89 ms
// against a 0.741 ms bound): conv1 computes 128 rows for a 64-row tile (a
// halo of 30); the two warpgroups take each chunk in step, so the adds of a
// partial, the next chunk's A loads and splits and the barrier waits run
// while the tensor cores idle (the products alone cost 0.4-0.6 ms); conv3's
// stores 0.3 ms, unhidden.  At 288 threads a thread has 168 registers, too
// few to load the next chunk's A before the wait (that spills).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "tf32x3.cuh"
#include "wgmma_ops.cuh"

namespace {

using hopper::aligned_smem;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::kAlign;
using hopper::ldmatrix_x4;
using hopper::smem_u32;
using tf32x3::FragA;
using tf32x3::mma_tf32;
using tf32x3::Split;
using tf32x3::split;
using tf32x3::split_a;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kNT = 4;            // n8 tiles a warp: 32 columns
constexpr int kBK = 16;           // k per ring stage
constexpr int kLdA = kBK + 4;     // floats a row of an A chunk
constexpr int kRingStage = 6464;  // floats a ring stage: the largest A + B chunk (Pass<8, 7>)
constexpr int kRingStages = 2;
constexpr int kRingFloats = kRingStages * kRingStage;
constexpr int kStageRows = 32;    // a warp's output staging tile: two m16 tiles
constexpr int kStageLd = 32 + 8;  // by its 32 columns, padded
constexpr int kStagingFloats = kWarps * kStageRows * kStageLd;

// A pass of WM x WN warps, each MT m16 tiles by kNT n8 tiles: PH x PW outputs.
template <int WN, int MT>
struct Pass {
  static constexpr int kWN = WN;
  static constexpr int kMT = MT;
  static constexpr int kWM = kWarps / WN;
  static constexpr int kPW = WN * kNT * 8;
  static constexpr int kPH = kWM * MT * 16;
  static constexpr int kLdB = kPW + 8;  // floats a row of a B chunk
  static constexpr int kBFloats = kBK * kLdB;
  static constexpr int kAFloats = kPH * kLdA;
  static_assert(kWM * WN == kWarps, "the warps tile the pass");
  static_assert(kBFloats <= kRingStage, "a stage holds the B chunk");
};
static_assert(Pass<8, 7>::kBFloats + Pass<8, 7>::kAFloats == kRingStage, "the ring's stage");

// the frozen-BN affine, rounded per operation like (acc * mul) + add in PyTorch
__device__ __forceinline__ float bn(float acc, float mul, float add) {
  return __fadd_rn(__fmul_rn(acc, mul), add);
}

// One ring stage's products, k in [a_k, a_k + 16) of A: tile i's A fragment
// by one `ldmatrix.x4` from this lane's row address smem[a_off[i] + k]
// (its four 8 x 4 matrices are the fragment's four registers: lane l
// gives row (l & 7) + 8 ((l >> 3) & 1) at column 4 (l >> 4), `Lane`), its
// B elements at smem[b_off + k' * LDB + 8j] (b_off holding t * LDB + g and
// the warp's columns).  Tiles from `tiles` on are skipped.  B's fragments
// are split once for all tiles; then tile by tile, each k8 step's A
// fragment is split and its small*big products of the 4 n8 tiles go
// first, then big*small, then big*big, into a zeroed partial sum that is
// added to the tile's accumulators in f32 at the end of the stage.  The
// tensor cores' own sums truncate; so they span 16 k of one stage, and K
// is summed with f32 adds, rounded to nearest: 35 stage-3 blocks in a row
// (the fused runner) stay within 1e-4 of the plain path.
template <int MT, int LDB>
__device__ __forceinline__ void stage_products(float (&acc)[MT][kNT][4], const float* smem,
                                               const int (&a_off)[MT], int a_k, int b_off,
                                               int tiles) {
  constexpr int kSteps = kBK / 8;
  const uint32_t base = smem_u32(smem);
  Split b0[kSteps][kNT], b1[kSteps][kNT];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      b0[kk][j] = split(smem[b_off + kk * 8 * LDB + j * 8]);
      b1[kk][j] = split(smem[b_off + (kk * 8 + 4) * LDB + j * 8]);
    }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= tiles) continue;
    float part[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, base + (a_off[i] + a_k + kk * 8) * 4);
      const FragA a = split_a(__uint_as_float(r[0]), __uint_as_float(r[1]),
                              __uint_as_float(r[2]), __uint_as_float(r[3]));
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(part[j], a.small, b0[kk][j].big, b1[kk][j].big);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(part[j], a.big, b0[kk][j].small, b1[kk][j].small);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_tf32(part[j], a.big, b0[kk][j].big, b1[kk][j].big);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[j][e]);
  }
}

// This lane's place in a pass: its fragment rows g, g + 8 and columns
// 2t, 2t + 1 (B: row t, column g), and the row and column of its
// `ldmatrix` address.
template <class P>
struct Lane {
  int g, t, wm, wn, warp, lane, ld_row, ld_col;
  __device__ Lane() {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    g = lane >> 2;
    t = lane & 3;
    wm = warp / P::kWN;
    wn = warp % P::kWN;
    ld_row = (lane & 7) + 8 * ((lane >> 3) & 1);
    ld_col = 4 * (lane >> 4);
  }
  // output row (within the phase) of tile i, half h, of pass mp
  __device__ int row(int mp, int i, int h) const {
    return mp * P::kPH + (wm + P::kWM * i) * 16 + g + 8 * h;
  }
  // the row of tile i of pass mp whose address this lane gives `ldmatrix`
  __device__ int ld_m(int mp, int i) const {
    return mp * P::kPH + (wm + P::kWM * i) * 16 + ld_row;
  }
};

// A phase: passes over an [m_rows, n_cols] output, `stages` ring stages of
// K each.  load(mp, np, s, slot) starts the copies of a stage into ring slot
// `slot`; a_rows(mp, s, slot, off) fills this lane's A offsets for the
// stage and returns the k of its first column; epi(mp, np, acc, tiles) takes
// a finished pass.  The copies run kRingStages - 1 stages ahead of the
// products, across passes.  Every thread of the block calls it with the
// same arguments.
template <class P, typename Load, typename ARows, typename Epi>
__device__ __forceinline__ void run_phase(float* smem, int m_rows, int n_cols, int stages,
                                          Load load, ARows a_rows, Epi epi) {
  constexpr int MT = P::kMT;
  constexpr int kAhead = kRingStages - 1;
  const Lane<P> ln;
  const int m_passes = (m_rows + P::kPH - 1) / P::kPH;
  const int n_passes = (n_cols + P::kPW - 1) / P::kPW;
  const int total = m_passes * n_passes * stages;
  auto load_stage = [&](int u) {  // the u-th stage of the phase
    if (u < total) {
      const int pass = u / stages;
      load(pass / n_passes, pass % n_passes, u % stages, u % kRingStages);
    }
    cp_async_commit();
  };
  for (int u = 0; u < kAhead; ++u) load_stage(u);
  int tt = 0;
  for (int pass = 0; pass < m_passes * n_passes; ++pass) {
    const int mp = pass / n_passes, np = pass % n_passes;
    // this pass's m16 tiles, and this warp's (tiles wm, wm + WM, ...)
    const int pass_tiles = min(P::kPH / 16, (m_rows - mp * P::kPH + 15) / 16);
    const int mine = ln.wm < pass_tiles ? (pass_tiles - ln.wm + P::kWM - 1) / P::kWM : 0;
    const int tiles = np * P::kPW + ln.wn * 32 < n_cols ? mine : 0;
    float acc[MT][kNT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int s = 0; s < stages; ++s, ++tt) {
      cp_async_wait<kAhead - 1>();  // this thread's copies of stage tt have landed
      // everyone's have, and everyone's products on stage tt - 1 are done,
      // so its slot takes stage tt + kAhead
      __syncthreads();
      load_stage(tt + kAhead);
      const int slot = tt % kRingStages;
      int off[MT];
      const int a_k = a_rows(mp, s, slot, off);
      const int b_off = slot * kRingStage + ln.t * P::kLdB + ln.wn * 32 + ln.g;
      stage_products<MT, P::kLdB>(acc, smem, off, a_k, b_off, tiles);
    }
    epi(mp, np, acc, tiles);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// rows [k0, k0 + 16) x columns [n0, n0 + PW) of the row-major w[., ld] into
// the B chunk at dst; columns from n_cols on are zero
template <class P>
__device__ __forceinline__ void load_b(float* dst, const float* __restrict__ w, int ld, int n_cols,
                                       int k0, int n0) {
  constexpr int kPerRow = P::kPW / 4;
#pragma unroll
  for (int id = threadIdx.x; id < kBK * kPerRow; id += kThreads) {
    const int k = id / kPerRow, c = id % kPerRow;
    const bool ok = n0 + c * 4 < n_cols;
    cp_async16(smem_u32(dst + k * P::kLdB + c * 4),
               ok ? w + static_cast<long long>(k0 + k) * ld + n0 + c * 4 : w, ok);
  }
}

// rows [m0, m0 + PH) x columns [k0, k0 + 16) of the row-major x[., ld] into
// the A chunk at dst; rows from m_rows on are zero
template <class P>
__device__ __forceinline__ void load_a(float* dst, const float* __restrict__ x, int ld, int m_rows,
                                       int m0, int k0) {
  static_assert(P::kBFloats + P::kAFloats <= kRingStage, "a stage holds both chunks");
  for (int id = threadIdx.x; id < P::kPH * 4; id += kThreads) {
    const int r = id >> 2, c = id & 3;
    const bool ok = m0 + r < m_rows;
    cp_async16(smem_u32(dst + r * kLdA + c * 4),
               ok ? x + static_cast<long long>(m0 + r) * ld + k0 + c * 4 : x, ok);
  }
}

// this lane's `ldmatrix` addresses into a stage's A chunk
template <class P>
__device__ __forceinline__ void chunk_rows(const Lane<P>& ln, int slot, int (&off)[P::kMT]) {
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
    off[i] = slot * kRingStage + P::kBFloats + ln.ld_m(0, i) * kLdA + ln.ld_col;
}

// bn(acc) [+ residual] -> relu? of a pass into device memory: output row m
// (< m_rows) of the pass to row row0 + m of out[., ld], columns from col0.
// Two m16 tiles at a time go through this warp's staging tile, then leave
// as 16-byte chunks along rows (lane: chunk lane & 7 of rows lane >> 3,
// + 4, ..., + 28), the residual chunks fetched first, all at once.
template <class P>
__device__ __forceinline__ void store_out(float* staging, const float (&acc)[P::kMT][kNT][4],
                                          int tiles, int mp, int np, int m_rows,
                                          const float* __restrict__ mul,
                                          const float* __restrict__ add,
                                          const float* __restrict__ residual,
                                          float* __restrict__ out, long long row0, int ld,
                                          int col0, bool relu) {
  constexpr int MT = P::kMT;
  const Lane<P> ln;
  float* st = staging + ln.warp * kStageRows * kStageLd;
  const int cb = col0 + np * P::kPW + ln.wn * 32;  // the warp's first column
  const int chunk = (ln.lane & 7) * 4;
#pragma unroll
  for (int i0 = 0; i0 < MT; i0 += 2) {
    if (i0 >= tiles) continue;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int i = i0 + ii;
      if (i >= MT || i >= tiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = j * 8 + 2 * ln.t;
          *reinterpret_cast<float2*>(st + (ii * 16 + ln.g + 8 * h) * kStageLd + n) =
              make_float2(bn(acc[i][j][2 * h], mul[cb + n], add[cb + n]),
                          bn(acc[i][j][2 * h + 1], mul[cb + n + 1], add[cb + n + 1]));
        }
    }
    __syncwarp();
    float4 res[8];
    int rows[8];  // the output row of each chunk, or -1
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = (ln.lane >> 3) + 4 * q;
      const int i = i0 + (r >> 4);
      const int m = mp * P::kPH + (ln.wm + P::kWM * i) * 16 + (r & 15);
      rows[q] = i < MT && i < tiles && m < m_rows ? m : -1;
      if (residual != nullptr && rows[q] >= 0)
        res[q] = *reinterpret_cast<const float4*>(residual + (row0 + rows[q]) * ld + cb + chunk);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (rows[q] < 0) continue;
      const int r = (ln.lane >> 3) + 4 * q;
      float4 y = *reinterpret_cast<const float4*>(st + r * kStageLd + chunk);
      if (residual != nullptr) {
        y.x = __fadd_rn(y.x, res[q].x);
        y.y = __fadd_rn(y.y, res[q].y);
        y.z = __fadd_rn(y.z, res[q].z);
        y.w = __fadd_rn(y.w, res[q].w);
      }
      if (relu) {
        y.x = fmaxf(y.x, 0.f);
        y.y = fmaxf(y.y, 0.f);
        y.z = fmaxf(y.z, 0.f);
        y.w = fmaxf(y.w, 0.f);
      }
      *reinterpret_cast<float4*>(out + (row0 + rows[q]) * ld + cb + chunk) = y;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <class P>
constexpr int k4_smem() { return (kRingFloats + kStagingFloats) * 4; }

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
matmul_bn_act_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ mul, const float* __restrict__ add,
                            const float* __restrict__ residual, float* __restrict__ out, int M,
                            int N, int K, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (N + P::kPW - 1) / P::kPW;
  const int m0 = (blockIdx.x / n_tiles) * P::kPH, n0 = (blockIdx.x % n_tiles) * P::kPW;
  const int rows = min(P::kPH, M - m0);
  const float* xb = x + static_cast<long long>(m0) * K;
  const Lane<P> ln;
  run_phase<P>(
      smem, rows, min(P::kPW, N - n0), K / kBK,
      [&](int, int, int s, int slot) {
        float* stage = smem + slot * kRingStage;
        load_b<P>(stage, w, N, N, s * kBK, n0);
        load_a<P>(stage + P::kBFloats, xb, K, rows, 0, s * kBK);
      },
      [&](int, int, int slot, int (&off)[P::kMT]) {
        chunk_rows<P>(ln, slot, off);
        return 0;
      },
      [&](int mp, int np, const float (&acc)[P::kMT][kNT][4], int tiles) {
        store_out<P>(smem + kRingFloats, acc, tiles, mp, np, rows, mul, add, residual, out, m0, N,
                     n0, relu != 0);
      });
}

template <class P>
int launch_matmul_bn_act(const void* x, const void* w, const void* mul, const void* add,
                         const void* residual, void* out, int M, int N, int K, int relu,
                         cudaStream_t s) {
  const long long blocks =
      static_cast<long long>((M + P::kPH - 1) / P::kPH) * ((N + P::kPW - 1) / P::kPW);
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(matmul_bn_act_tf32x3_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         k4_smem<P>());
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_bn_act_tf32x3_kernel<P><<<static_cast<unsigned>(blocks), kThreads, k4_smem<P>(), s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(mul),
      static_cast<const float*>(add), static_cast<const float*>(residual),
      static_cast<float*>(out), M, N, K, relu);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

constexpr int kPlaneRow = kBK * 4;  // bytes of a plane row: 16 k of one column
constexpr int kMaxNB = 256;         // columns of a weight tile
constexpr int kStages = 3;          // the weight ring's depth
constexpr int kBTile = kMaxNB * kPlaneRow * 2;  // a stage: a weight tile's big and small planes
constexpr int kXSlots = 3;                      // a warp's ring of conv1's x rows
constexpr int kK5Threads = kThreads + 32;        // two warpgroups and the producer warp
constexpr int kXRing = kXSlots * 16 * kPlaneRow;  // bytes of it: 16 rows of 16 k a slot

// the columns of a weight tile of a conv N wide
__host__ __device__ inline int plane_cols(int n) { return n < kMaxNB ? n : kMaxNB; }

// Shared memory of one block, in bytes: the alignment slack; the weight
// ring; each warp's ring of x rows; a1, its tile_rows + 2w + 2 rows and the
// zero row, then a2's own tile_rows rows where conv2 takes several column
// passes (F > 256; else a2 takes a1's first rows once conv2 is done), rows
// of 4F + 64 bytes; the ring's barriers.
__host__ __device__ inline int a1_rows(int tile_rows, int w) { return tile_rows + 2 * w + 2; }
__host__ __device__ inline int a2_rows(int tile_rows, int f) { return f > kMaxNB ? tile_rows : 0; }
__host__ __device__ inline long long k5_smem(int tile_rows, int w, int f) {
  return kAlign + static_cast<long long>(kStages) * kBTile + kWarps * kXRing +
         (a1_rows(tile_rows, w) + 1LL + a2_rows(tile_rows, f)) * (4 * f + 64) + 2 * kStages * 8;
}

// The weight planes: w [k, n] (n contiguous) as tiles of nb = plane_cols(n)
// columns by 16 k, column tile by column tile and k by k within one; a tile
// is the big plane then the small one, [nb][16] K-major with the 64-byte
// swizzle (16-byte chunk c of row j at chunk c ^ ((j >> 1) & 3)).  Within a
// tile's 16 k, place 4c + e of a row holds k = c + 4e: a `wgmma` k8 step s
// then takes k 4t + 2s and 4t + 2s + 1 from the A fragment's lane t, four
// k in a row for two steps, one 16-byte load of an A row.  A thread takes
// one chunk of both planes, split as the register split of `tf32x3.cuh`
// (a thread a 64-byte row, 4 chunks, was slower: a quarter of the threads).
struct PlaneJob {
  const float* w;
  float* planes;
  int k, n;
};

__global__ void __launch_bounds__(kThreads) tf32_weight_planes_kernel(PlaneJob j0, PlaneJob j1,
                                                                      PlaneJob j2) {
  const PlaneJob j = blockIdx.y == 0 ? j0 : blockIdx.y == 1 ? j1 : j2;
  const int nb = plane_cols(j.n), k_tiles = j.k / kBK;
  const long long chunks = static_cast<long long>(j.k) * j.n / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < chunks;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int col = static_cast<int>(i % nb);  // neighbouring threads read neighbouring columns
    const long long rest = i / nb;
    const int c = static_cast<int>(rest % 4);
    const long long tile = rest / 4;
    const int np = static_cast<int>(tile / k_tiles), kt = static_cast<int>(tile % k_tiles);
    const float* src = j.w + static_cast<long long>(kt * kBK + c) * j.n + np * nb + col;
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split s = split(src[4LL * e * j.n]);
      big[e] = s.big;
      small[e] = s.small;
    }
    float* dst = j.planes + tile * nb * 2 * kBK + col * kBK + 4 * (c ^ ((col >> 1) & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + nb * kBK) = make_uint4(small[0], small[1], small[2], small[3]);
  }
}

int launch_planes(const float* w1, const float* w2, const float* w3, float* planes, int c, int f,
                  cudaStream_t s) {
  const PlaneJob j1{w1, planes, c, f};
  const PlaneJob j2{w2, planes + 2LL * c * f, 9 * f, f};
  const PlaneJob j3{w3, planes + 2LL * (c + 9LL * f) * f, f, c};
  const long long most = (c > 9 * f ? c : 9 * f) * static_cast<long long>(f) / 4;  // chunks
  const long long blocks = (most + kThreads - 1) / kThreads;
  tf32_weight_planes_kernel<<<dim3(static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 3),
                              kThreads, 0, s>>>(j1, j2, j3);
  return static_cast<int>(cudaGetLastError());
}

// mbarriers and bulk copies, in PTX
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the barrier's phase of this parity has completed; a copy or an
// arrival that never comes fails the launch rather than hang the card
constexpr int kSpinLimit = 1 << 26;
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == kSpinLimit) __trap();
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// `wgmma` descriptor of a K-major tile with the 64-byte swizzle: rows of 64
// bytes, 8-row groups 512 bytes apart; 8 k further is 32 bytes further
__device__ __forceinline__ uint64_t desc_k64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
constexpr int kDescK8 = 32 >> 4;

struct Bottleneck {
  const float* x;
  const float* mul1;
  const float* add1;
  const float* mul2;
  const float* add2;
  const float* mul3;
  const float* add3;
  const float* planes;  // w1's, w2's and w3's planes, in that order
  float* out;
  int rows;       // n * h * w: rows of x and out
  int h, w, c;    // image rows and columns, block channels
  int tile_rows;  // rows of x a block: output pixels, across image rows and images
};

// One conv of a block as the ring streams it: passes of 64 * (2 / wn) rows
// by nb columns, the pass's weight tile in `chunks` tiles of 16 k.  With
// wn = 2 the warpgroups take the pass's two column halves of one m64 tile,
// else each one m64 tile of all nb columns.
struct Conv {
  const float* planes;
  int nb, wn, m_tiles, m_passes, n_passes, chunks;
  int first;  // the block's index of the conv's first chunk
  __device__ Conv(const float* planes_, int rows, int n_out, int k, int first_)
      : planes(planes_),
        nb(plane_cols(n_out)),
        wn(n_out >= kMaxNB ? 2 : 1),
        m_tiles((rows + 63) / 64),
        m_passes((m_tiles + 2 / wn - 1) / (2 / wn)),
        n_passes(n_out / nb),
        chunks(k / kBK),
        first(first_) {}
  __device__ __forceinline__ int end() const { return first + m_passes * n_passes * chunks; }
  // the weight tile of the conv's v-th chunk
  __device__ __forceinline__ const float* tile(int v) const {
    const int pass = v / chunks, kc = v - pass * chunks;
    return planes + static_cast<long long>((pass % n_passes) * chunks + kc) * nb * 2 * kBK;
  }
};

// The weight ring: stage u % kStages takes chunk u's weight tile.  full[s]
// completes when its bytes have landed (one arrival, with the byte count);
// empty[s] when the 8 warps of the two warpgroups are done with it.
struct Ring {
  uint32_t base, full, empty;  // shared addresses: stage 0, the barriers
  __device__ __forceinline__ uint32_t slot(int u) const { return base + (u % kStages) * kBTile; }
  __device__ __forceinline__ void wait_full(int u) const {
    mbar_wait(full + 8 * (u % kStages), (u / kStages) & 1);
  }
  __device__ __forceinline__ void release(int u) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (u % kStages));
  }
};

// A block's three convs and the copy of chunk u's weight tile, issued by
// the producer warp once the two warpgroups are done with the stage's last
// chunk (the convs chosen by value, so that all of it stays in registers)
struct Block {
  Conv c1, c2, c3;
  Ring ring;
  __device__ __forceinline__ void load(int u) const {
    if (u >= c3.end()) return;
    const Conv cn = u < c2.first ? c1 : u < c3.first ? c2 : c3;
    const uint32_t dst = ring.slot(u), full = ring.full + 8 * (u % kStages);
    if (u >= kStages) mbar_wait(ring.empty + 8 * (u % kStages), (u / kStages - 1) & 1);
    const int bytes = cn.nb * 2 * kPlaneRow;
    const float* tile = cn.tile(u - cn.first);
    mbar_expect_tx(full, bytes);
    bulk_copy(dst, tile, bytes, full);
  }
};

// A lane's A rows g and g + 8 of its warp's 16 for a 16-k chunk: the k
// 4t .. 4t + 3 in the planes' order, 16 bytes a row
struct RawA {
  float4 lo, hi;
};

// 16 k of an A fragment, split: two k8 steps of big and small
struct FragK16 {
  uint32_t big[2][4], small[2][4];
};

// step s takes k 4t + 2s (registers 0, 1) and 4t + 2s + 1 (2, 3)
__device__ __forceinline__ void split_rows(FragK16& f, const RawA& r) {
  const float lo[4] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w}, hi[4] = {r.hi.x, r.hi.y, r.hi.z, r.hi.w};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const FragA a = split_a(lo[2 * s], hi[2 * s], lo[2 * s + 1], hi[2 * s + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.big[s][e] = a.big[e];
      f.small[s][e] = a.small[e];
    }
  }
}

// 16 k of products into the zeroed partial: for each k8 small*big,
// big*small, big*big (B: the big and small planes' descriptors)
template <int NW>
__device__ __forceinline__ void chunk_products(float (&part)[NW / 2], const FragK16& a,
                                               uint64_t big, uint64_t small) {
  wgmma::fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    wgmma::OpTf32<NW>::rs(part, a.small[s], big + s * kDescK8, s);  // s = 0 overwrites
    wgmma::OpTf32<NW>::rs(part, a.big[s], small + s * kDescK8, 1);
    wgmma::OpTf32<NW>::rs(part, a.big[s], big + s * kDescK8, 1);
  }
  wgmma::commit();
}

// This thread's accumulator rows (of the warpgroup's 64) and columns: d[4j
// + 2h + e] is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
// Its A rows are the same two, its A columns 4 (lane % 4) .. + 3.
struct Lane4 {
  int row, t;
  __device__ __forceinline__ Lane4()
      : row(16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)), t(threadIdx.x & 3) {}
};

// The passes of one conv, NW columns a warpgroup.  src.pass(m_tile) starts
// a pass of the warpgroup's m64 tile, src.fetch(kc) its copies of chunk kc
// (where A comes from device memory), src.read(kc) reads this lane's A rows
// of chunk kc; epi(acc, m_tile, n0, busy) takes a finished pass (busy: the
// warpgroup had an m64 tile in it).  Every thread of the block calls it.
template <int NW, typename Src, typename Epi>
__device__ __forceinline__ void run_conv(const Block& bk, const Conv cv, Src& src, Epi epi) {
  const int wg = threadIdx.x >> 7;
  const Ring& ring = bk.ring;
  int u = cv.first;
  for (int pass = 0; pass < cv.m_passes * cv.n_passes; ++pass) {
    const int mp = pass / cv.n_passes, np = pass - mp * cv.n_passes;
    const int m_tile = cv.wn == 2 ? mp : 2 * mp + wg;
    const int col = cv.wn == 2 ? wg * NW : 0;  // the warpgroup's first column of the tile
    const bool busy = m_tile < cv.m_tiles;
    float acc[NW / 2], part[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = part[i] = 0.f;
    if (busy) src.pass(m_tile);
    for (int kc = 0; kc < cv.chunks; ++kc) {
      ring.wait_full(u + kc);
      if (busy) {
        FragK16 a;
        split_rows(a, src.read(kc));
        const uint32_t b = ring.slot(u + kc) + col * kPlaneRow;
        chunk_products<NW>(part, a, desc_k64(b), desc_k64(b + cv.nb * kPlaneRow));
        src.fetch(kc + 2);
      }
      // unconditional, so that every read of the partial follows a wait (a
      // warpgroup without a tile adds zeros it never stores)
      wgmma::wait<0>();
      ring.release(u + kc);
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    u += cv.chunks;
    epi(acc, m_tile, np * cv.nb + col, busy);
  }
}

// relu(bn(acc)) of a warpgroup's tile into shared-memory rows below `limit`
template <int NW>
__device__ __forceinline__ void store_rows(float* dst, int ld, const float (&acc)[NW / 2],
                                           int m_tile, int n0, int limit,
                                           const float* __restrict__ mul,
                                           const float* __restrict__ add) {
  const Lane4 ln;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = m_tile * 64 + ln.row + 8 * h;
    if (i >= limit) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int n = n0 + 8 * j + 2 * ln.t;
      *reinterpret_cast<float2*>(dst + i * ld + n) =
          make_float2(fmaxf(bn(acc[4 * j + 2 * h], mul[n], add[n]), 0.f),
                      fmaxf(bn(acc[4 * j + 2 * h + 1], mul[n + 1], add[n + 1]), 0.f));
    }
  }
}

// conv1's A: x rows x0 + i (rows outside x read any row of x, never kept),
// each warp copying its own 16 rows of each chunk into its ring, 16 bytes a
// lane: a lane copies what it reads, so no barrier orders them
struct XRows {
  const float* x;
  long long x0;
  int rows, c, chunks;
  float* ring;  // this warp's: kXSlots slots of 16 rows by 16 k
  const float *lo, *hi;
  __device__ __forceinline__ float* at(int kc) const {  // this lane's row g of chunk kc's slot
    return ring + (kc % kXSlots) * 16 * kBK + ((threadIdx.x & 31) >> 2) * kBK +
           4 * (threadIdx.x & 3);
  }
  __device__ __forceinline__ void pass(int m_tile) {
    const Lane4 ln;
    auto row = [&](int i) {
      long long q = x0 + m_tile * 64 + i;
      q = q < 0 ? 0 : q >= rows ? rows - 1 : q;
      return x + q * c + 4 * ln.t;
    };
    lo = row(ln.row);
    hi = row(ln.row + 8);
    fetch(0);
    fetch(1);
  }
  __device__ __forceinline__ void fetch(int kc) {
    if (kc < chunks) {
      cp_async16(smem_u32(at(kc)), lo + kc * kBK, true);
      cp_async16(smem_u32(at(kc) + 8 * kBK), hi + kc * kBK, true);
    }
    cp_async_commit();  // a group a chunk, empty past the last: read() waits for all but one
  }
  __device__ __forceinline__ RawA read(int kc) const {
    cp_async_wait<1>();  // this lane's copies of chunk kc have landed
    const float* d = at(kc);
    return {*reinterpret_cast<const float4*>(d), *reinterpret_cast<const float4*>(d + 8 * kBK)};
  }
};

// conv2's A: output row i (row m0 + i of x, pixel (r, col) of its image)
// reads tap (dy, dx) at a1 row i + dy*w + dx, or the zero row where
// r + dy - 1 or col + dx - 1 leaves the image
struct TapRows {
  const float* a1;
  int ld, zero_row, tile_rows, h, w, rows, tap_chunks;
  long long m0;
  int i[2], r[2], col[2], tap;
  bool inside[2];
  const float* at[2];
  __device__ __forceinline__ void pass(int m_tile) {
    const Lane4 ln;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      i[e] = m_tile * 64 + ln.row + 8 * e;
      const long long q = m0 + i[e];
      inside[e] = i[e] < tile_rows && q < rows;
      col[e] = static_cast<int>(q % w);
      r[e] = static_cast<int>((q / w) % h);
    }
    tap = -1;
  }
  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ RawA read(int kc) {
    const int t = kc / tap_chunks;
    if (t != tap) {
      tap = t;
      const int dy = t / 3, dx = t - 3 * dy;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = inside[e] && r[e] + dy >= 1 && r[e] + dy <= h && col[e] + dx >= 1 &&
                        col[e] + dx <= w;
        at[e] = a1 + (ok ? i[e] + dy * w + dx : zero_row) * ld + 4 * (threadIdx.x & 3);
      }
    }
    const int k = (kc - t * tap_chunks) * kBK;
    return {*reinterpret_cast<const float4*>(at[0] + k),
            *reinterpret_cast<const float4*>(at[1] + k)};
  }
};

// conv3's A: a2 rows (the tile's last row past it, never kept)
struct A2Rows {
  const float* a2;
  int ld, tile_rows;
  const float *lo, *hi;
  __device__ __forceinline__ void pass(int m_tile) {
    const Lane4 ln;
    const int i = m_tile * 64 + ln.row;
    lo = a2 + min(i, tile_rows - 1) * ld + 4 * ln.t;
    hi = a2 + min(i + 8, tile_rows - 1) * ld + 4 * ln.t;
  }
  __device__ __forceinline__ void fetch(int) {}
  __device__ __forceinline__ RawA read(int kc) const {
    return {*reinterpret_cast<const float4*>(lo + kc * kBK),
            *reinterpret_cast<const float4*>(hi + kc * kBK)};
  }
};

// the two warpgroups' own barrier (the producer warp keeps to its loop)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The two warpgroups' work: conv1, conv2 and conv3 of the block's tile
template <int F>
__device__ __forceinline__ void consumers(const Bottleneck& p, const Block& bk, float* a1,
                                          float* a2, float* xring, int r1, long long m0) {
  constexpr int NW = F < 256 ? F : 128;  // conv1's and conv2's columns a warpgroup; conv3's 128
  constexpr int LD = F + 16;             // floats a row of a1 and a2
  // conv1 (1x1) + bn1 + relu: a1 row j from x row x0 + j, x0 the tile's
  // first row less w + 1
  {
    XRows src{p.x, m0 - p.w - 1, p.rows, p.c, bk.c1.chunks,
                 xring + (threadIdx.x >> 5) * kXRing / 4};
    run_conv<NW>(bk, bk.c1, src, [&](const float (&acc)[NW / 2], int m_tile, int n0, bool busy) {
      if (busy) store_rows<NW>(a1, LD, acc, m_tile, n0, r1, p.mul1, p.add1);
    });
  }
  consumers_sync();

  // conv2 (3x3, stride 1, pad 1) + bn2 + relu
  {
    TapRows src{a1, LD, r1, p.tile_rows, p.h, p.w, p.rows, F / kBK, m0};
    run_conv<NW>(bk, bk.c2, src, [&](const float (&acc)[NW / 2], int m_tile, int n0, bool busy) {
      consumers_sync();  // where a2 takes a1's rows, every conv2 read of a1 is done
      if (busy) store_rows<NW>(a2, LD, acc, m_tile, n0, p.tile_rows, p.mul2, p.add2);
    });
  }
  consumers_sync();

  // conv3 (1x1) + bn3 + residual + relu, straight from the accumulators to
  // this tile's rows of out
  A2Rows src{a2, LD, p.tile_rows};
  run_conv<128>(bk, bk.c3, src, [&](const float (&acc)[64], int m_tile, int n0, bool busy) {
    if (!busy) return;
    const Lane4 ln;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = m_tile * 64 + ln.row + 8 * h;
      if (i >= p.tile_rows || m0 + i >= p.rows) continue;
      const long long off = (m0 + i) * p.c + n0 + 2 * ln.t;
      float2 res[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) res[j] = *reinterpret_cast<const float2*>(p.x + off + 8 * j);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * ln.t;
        const float y0 = __fadd_rn(bn(acc[4 * j + 2 * h], p.mul3[n], p.add3[n]), res[j].x);
        const float y1 =
            __fadd_rn(bn(acc[4 * j + 2 * h + 1], p.mul3[n + 1], p.add3[n + 1]), res[j].y);
        *reinterpret_cast<float2*>(p.out + off + 8 * j) =
            make_float2(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
      }
    }
  });
}

template <int F>
__global__ void __launch_bounds__(kK5Threads, 1) bottleneck_tf32x3_kernel(Bottleneck p) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int LD = F + 16;  // floats a row of a1 and a2: rows g, g + 1 on other banks
  uint8_t* smem = aligned_smem(smem_raw);
  const int r1 = a1_rows(p.tile_rows, p.w);  // a1's rows; row r1 is zero
  float* xring = reinterpret_cast<float*>(smem + kStages * kBTile);
  float* a1 = xring + kWarps * kXRing / 4;
  float* a2 = a1 + (a2_rows(p.tile_rows, F) > 0 ? (r1 + 1) * LD : 0);
  const uint32_t bars = smem_u32(a1 + (r1 + 1 + a2_rows(p.tile_rows, F)) * LD);
  const long long m0 = static_cast<long long>(blockIdx.x) * p.tile_rows;  // the tile's first row

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // before their first use
  }
  for (int e = threadIdx.x; e < F; e += kK5Threads) a1[r1 * LD + e] = 0.f;
  __syncthreads();

  const float* planes2 = p.planes + 2LL * p.c * F;
  const Conv c1(p.planes, r1, F, p.c, 0);
  const Conv c2(planes2, p.tile_rows, F, 9 * F, c1.end());
  const Conv c3(planes2 + 18LL * F * F, p.tile_rows, p.c, F, c2.end());
  const Block bk{c1, c2, c3, {smem_u32(smem), bars, bars + 8 * kStages}};
  if (threadIdx.x >= kThreads) {  // the producer warp: each weight tile as soon as its slot is free
    if (threadIdx.x == kThreads)
      for (int u = 0; u < c3.end(); ++u) bk.load(u);
  } else {
    consumers<F>(p, bk, a1, a2, xring, r1, m0);
  }
}

template <int F>
int launch_bottleneck(const Bottleneck& p, cudaStream_t s) {
  const long long smem = k5_smem(p.tile_rows, p.w, F);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (p.rows + p.tile_rows - 1LL) / p.tile_rows;
  if (smem > limit || blocks > INT32_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bottleneck_tf32x3_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bottleneck_tf32x3_kernel<F><<<static_cast<unsigned>(blocks), kK5Threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool k5_width(int f) { return f == 64 || f == 128 || f == 256 || f == 512; }

}  // namespace

// K4 in f32 on the tensor cores.  x [m, k], w [k, n], residual (or NULL)
// and out [m, n]: f32, contiguous, 16-byte aligned; mul/add: [n] f32; k and
// n multiples of 64.  Returns cudaErrorInvalidValue for other shapes, else
// cudaGetLastError() after the launch.
extern "C" int macsa_matmul_bn_act_tf32x3(const void* x, const void* w, const void* mul,
                                          const void* add, const void* residual, void* out, int m,
                                          int n, int k, int relu, void* stream) {
  if (m < 1 || n < 64 || k < 64 || n % 64 || k % 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 256 == 0)
    return launch_matmul_bn_act<Pass<8, 7>>(x, w, mul, add, residual, out, m, n, k, relu, s);
  return launch_matmul_bn_act<Pass<2, 2>>(x, w, mul, add, residual, out, m, n, k, relu, s);
}

// K5's weight planes alone (`tf32_weight_planes_kernel`): w1 [c, f], w2 [9,
// f, f], w3 [f, c] f32, contiguous; planes: 2 (2cf + 9f^2) f32, 16-byte
// aligned.  Returns cudaErrorInvalidValue for other shapes, else
// cudaGetLastError() after the launch.
extern "C" int macsa_tf32_weight_planes(const void* w1, const void* w2, const void* w3,
                                        void* planes, int c, int f, void* stream) {
  if (c < 128 || c % 128 || !k5_width(f)) return cudaErrorInvalidValue;
  return launch_planes(static_cast<const float*>(w1), static_cast<const float*>(w2),
                       static_cast<const float*>(w3), static_cast<float*>(planes), c, f,
                       static_cast<cudaStream_t>(stream));
}

// K5 in f32 on the tensor cores: the weight planes, then the bottleneck, two
// launches.  x/out: [n*h*w, c] NHWC rows, f32, contiguous, 16-byte aligned;
// w1 [c, f], w2 [9, f, f], w3 [f, c] f32; mul*/add*: f32 [f], [f], [c];
// planes: scratch of 2 (2cf + 9f^2) f32, 16-byte aligned; f one of 64,
// 128, 256, 512; c a multiple of 128; tile_rows rows of x a block, as
// `tf32x3_tile_rows` of ops/fused_resnet.py picks them.  Returns
// cudaErrorInvalidValue for other shapes or a tile whose shared memory
// (`k5_smem`) does not fit in a block, else cudaGetLastError().
extern "C" int macsa_fused_bottleneck_tf32x3(const void* x, const void* w1, const void* mul1,
                                             const void* add1, const void* w2, const void* mul2,
                                             const void* add2, const void* w3, const void* mul3,
                                             const void* add3, void* out, void* planes, int n,
                                             int h, int w, int c, int f, int tile_rows,
                                             void* stream) {
  const long long rows = static_cast<long long>(n) * h * w;
  if (n < 1 || h < 1 || w < 1 || c < 128 || c % 128 || !k5_width(f) || tile_rows < 1 ||
      rows > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_planes(static_cast<const float*>(w1), static_cast<const float*>(w2),
                                static_cast<const float*>(w3), static_cast<float*>(planes), c, f,
                                s);
  if (err != cudaSuccess) return err;
  Bottleneck p;
  p.x = static_cast<const float*>(x);
  p.mul1 = static_cast<const float*>(mul1);
  p.add1 = static_cast<const float*>(add1);
  p.mul2 = static_cast<const float*>(mul2);
  p.add2 = static_cast<const float*>(add2);
  p.mul3 = static_cast<const float*>(mul3);
  p.add3 = static_cast<const float*>(add3);
  p.planes = static_cast<const float*>(planes);
  p.out = static_cast<float*>(out);
  p.rows = static_cast<int>(rows);
  p.h = h;
  p.w = w;
  p.c = c;
  p.tile_rows = tile_rows;
  switch (f) {
    case 64: return launch_bottleneck<64>(p, s);
    case 128: return launch_bottleneck<128>(p, s);
    case 256: return launch_bottleneck<256>(p, s);
    default: return launch_bottleneck<512>(p, s);
  }
}
