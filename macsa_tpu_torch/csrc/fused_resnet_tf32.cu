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
// split in registers into big = tf32(x) and small = tf32(x - big), rounded
// to nearest, ties away, and each f32 product is small*big + big*small +
// big*big, three `mma.sync.m16n8k8` TF32 products in that order, summed in
// f32.  One TF32 product keeps 11 bits of each operand and misses the f32
// tolerances (K4 1e-5, K5 1e-4 of max|ref|); three keep about 22.  Nothing
// is split in memory: operands reach shared memory as f32.
//
// What bounds them on an H100 (495 TFLOP/s TF32 on the tensor cores, so
// 165 TFLOP/s of f32 products at three TF32 products each; 67 TFLOP/s f32
// on the CUDA cores; 3.35 TB/s).  At ResNet-152 stage 3 over 280 images
// (54,880 rows, C = 1024, F = 256) one bottleneck is 122.3 GFLOP (0.741 ms
// as 3xTF32, 1.825 ms on the CUDA cores) against 454 MB of x read, output
// written and weights read (0.136 ms): bound by its products.  K4's convs
// are 28.77 GFLOP each (0.174 ms as 3xTF32) against 282 MB (conv1) and
// 507 MB (conv3 with its residual): bound by their products too.
// `mma.sync` rather than `wgmma`: `wgmma` takes TF32 operands from shared
// memory only K-major, and the weights are [K, N] with N contiguous; an
// m16n8k8 B fragment reads a row-major [k][n] tile as it stands.  What
// holds them back on the card (`ablate_resnet.py`): each TF32 product
// pass adds about 0.11 ms to K4's conv1 (~260 TFLOP/s, `mma.sync`'s TF32
// rate here) and 0.62 ms to K5 at stage 3; the splits, the copies, the
// barriers and the epilogues overlap the products only in part, and at
// stage 4 (17.8 MB of weights a block for 28 output rows) the weight
// stream from L2 takes a fifth of the time.
//
// The product pipeline (both kernels).  A block is 8 warps.  A phase is a
// product [M, K] x [K, N] walked in passes of PH x PW outputs; a pass is
// WM x WN warps (`Pass`), each warp MT m16 tiles (tiles wm, wm + WM, ...,
// so that the warps of a ragged pass stay even) by 4 n8 tiles (32
// columns), its f32 accumulators in registers.  K goes through a ring of
// two stages of 16 k in shared memory, filled by 16-byte `cp.async`: the
// next stage's copies are issued before this stage's products.  A stage
// holds a B chunk [16][PW + 8] (w's own [K, N] rows, columns past N zero)
// and, where A comes from device memory, an A chunk [PH][16 + 4] (rows past
// M zero).  The padding keeps every fragment read free of bank conflicts:
// an A fragment is one `ldmatrix.x4` whose 8 rows of 16 bytes a matrix lie
// an odd number of 16-byte units apart (rows of 20 or F + 4 floats), and
// B's lane 4g + t reads bank 8t + g.  B's fragments are split once a stage
// for the warp's MT tiles, an A fragment where it is read.  Each stage's
// products go into a zeroed partial sum that is added to the accumulators
// in f32: the tensor cores' own sums truncate, so they span 16 k and not
// all of K (2,304 at conv2 of stage 3), which keeps 35 stage-3 blocks in a
// row (the fused runner) within 1e-4 of the plain path.
// Outputs to device memory leave through a per-warp f32 staging tile of two
// m16 tiles [32][32 + 8], read back 16 bytes a lane along rows (a row of a
// warp's columns is 128 contiguous bytes), the residual read the same way.
//   K4: one block per output tile of one pass: 112 x 256 for N a multiple
//   of 256 (Pass<8, 7>), else 128 x 64 (Pass<2, 2>); ragged M masked.
//   K5: one launch per bottleneck and one block per (image, tile of TH
//   output rows), the structure of the other two variants:
//   * conv1 recomputes a one-row halo above and below; halo rows outside
//     the image are zero.  a1 [(TH + 2) * w + 1][F + 4] and a2 [TH * w][F + 4]
//     stay in shared memory in f32; a1's last pixel row is zero.
//   * conv2 is nine tap-shifted products over a1, K = 9F in w2's own
//     [9F, F] order.  A lane's row for output pixel m at tap (dy, dx) is a1
//     pixel m + dy*w + dx - 1, or the zero pixel where the column leaves
//     the image: computed when the tap changes (every F / 16 stages), so
//     the shift costs nothing in the products.
//   * conv3 reads a2, adds the residual from x and writes the output
//     through the staging tiles, which take a1's space (dead by then).
//   * Weights stream from L2 in their own layout, one plane, once a block
//     for each conv at stages 2 to 4 (a pass holds all of a tile's rows).
//   * TH comes from the host (`ops/fused_resnet.py`, `tf32x3_tile_rows`):
//     the most rows whose ring, a1 and a2 fit in a block's 227 KB
//     (`k5_smem`, the same formula as `tf32x3_bottleneck_smem`), evened
//     over the image: 5 at stage 3 (three tiles, conv1 on 18 rows for 14).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
#include "tf32x3.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
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

// relu(bn(acc)) of a pass into shared-memory rows: output row m (< m_rows)
// to smem[(dst_row0 + m) * ldp + column]
template <class P>
__device__ __forceinline__ void store_rows(float* smem, const float (&acc)[P::kMT][kNT][4],
                                           int tiles, int mp, int np, int m_rows, int dst_row0,
                                           int ldp, const float* __restrict__ mul,
                                           const float* __restrict__ add) {
  const Lane<P> ln;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i) {
    if (i >= tiles) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = ln.row(mp, i, h);
      if (m >= m_rows) continue;
      float* dst = smem + (dst_row0 + m) * ldp;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = np * P::kPW + ln.wn * 32 + j * 8 + 2 * ln.t;
        *reinterpret_cast<float2*>(dst + n) =
            make_float2(fmaxf(bn(acc[i][j][2 * h], mul[n], add[n]), 0.f),
                        fmaxf(bn(acc[i][j][2 * h + 1], mul[n + 1], add[n + 1]), 0.f));
      }
    }
  }
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

struct Bottleneck {
  const float* x;
  const float* w1;
  const float* mul1;
  const float* add1;
  const float* w2;
  const float* mul2;
  const float* add2;
  const float* w3;
  const float* mul3;
  const float* add3;
  float* out;
  int h, w, c;    // image rows and columns, block channels
  int tile_rows;  // output image rows per block
  int tiles;      // blocks per image
};

// Shared memory of one block, in floats: the ring; a1 [(tile_rows + 2) * w
// + 1][f + 4], no smaller than conv3's staging tiles, which take its space;
// a2 [tile_rows * w][f + 4].
__host__ __device__ inline long long a1_floats(int tile_rows, int w, int f) {
  const long long need = ((tile_rows + 2LL) * w + 1) * (f + 4);
  return need > kStagingFloats ? need : kStagingFloats;
}
__host__ __device__ inline long long k5_smem(int tile_rows, int w, int f) {
  const long long a2 = static_cast<long long>(tile_rows) * w * (f + 4);
  return (kRingFloats + a1_floats(tile_rows, w, f) + a2) * 4;
}

// The passes of each conv at width F: conv1 and conv2 min(F, 256) columns
// wide, conv1 at most 128 rows of x a pass (its A chunk; 7 m16 tiles a warp
// at F >= 256, where a stage-3 tile's conv1 has 98 rows); conv2 and conv3
// up to 7 m16 tiles a warp, 5 at F >= 256 (a stage-3 tile's 70 rows: fewer
// accumulators, `ablate_resnet.py`); conv3 256 columns.
template <int F>
struct K5Passes {
  static constexpr int kWN = F < 256 ? F / 32 : 8;
  static constexpr int kMT = F < 256 ? 7 : 5;
  using Conv1 = Pass<kWN, F == 64 ? 2 : F == 128 ? 4 : 7>;
  using Conv2 = Pass<kWN, kMT>;
  using Conv3 = Pass<8, kMT>;
};

template <int F>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_tf32x3_kernel(Bottleneck p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDP = F + 4;  // floats a pixel row of a1, a2
  const int w = p.w;
  const int a1 = kRingFloats;  // offsets in floats
  const int a2 = a1 + static_cast<int>(a1_floats(p.tile_rows, w, F));
  const int zero_pixel = (p.tile_rows + 2) * w;  // a1's last pixel row

  const int img = blockIdx.x / p.tiles;
  const int r0 = (blockIdx.x % p.tiles) * p.tile_rows;  // first output image row
  const int rows = min(p.tile_rows, p.h - r0);
  // a1's local row rr holds image row r0 - 1 + rr; conv1 fills the rows
  // inside the image, [lo, hi); the others stay zero
  const int lo = max(r0 - 1, 0), hi = min(r0 + rows + 1, p.h);
  const long long img_row0 = static_cast<long long>(img) * p.h * w;  // x row of (img, 0, 0)
  {
    float4* dst = reinterpret_cast<float4*>(smem + a1);
    const int n4 = (a2 - a1) / 4;
    for (int e = threadIdx.x; e < n4; e += kThreads) dst[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // conv1 (1x1) + bn1 + relu over the image rows [lo, hi): x's rows are
  // contiguous, and so are their a1 pixels, from local row lo - r0 + 1
  {
    using P = typename K5Passes<F>::Conv1;
    const int m1 = (hi - lo) * w;
    const float* x1 = p.x + (img_row0 + static_cast<long long>(lo) * w) * p.c;
    const int a1_row0 = (lo - r0 + 1) * w;
    const Lane<P> ln;
    run_phase<P>(
        smem, m1, F, p.c / kBK,
        [&](int mp, int np, int s, int slot) {
          float* stage = smem + slot * kRingStage;
          load_b<P>(stage, p.w1, F, F, s * kBK, np * P::kPW);
          load_a<P>(stage + P::kBFloats, x1, p.c, m1, mp * P::kPH, s * kBK);
        },
        [&](int, int, int slot, int (&off)[P::kMT]) {
          chunk_rows<P>(ln, slot, off);
          return 0;
        },
        [&](int mp, int np, const float (&acc)[P::kMT][kNT][4], int tiles) {
          store_rows<P>(smem + a1, acc, tiles, mp, np, m1, a1_row0, LDP, p.mul1, p.add1);
        });
  }

  // conv2 (3x3, stride 1, pad 1) + bn2 + relu: output pixel m = r*w + col
  // sums nine products, tap (dy, dx) reading a1 pixel m + dy*w + dx - 1, or
  // the zero pixel where col + dx - 1 leaves the image
  const int m2 = rows * w;
  {
    using P = typename K5Passes<F>::Conv2;
    constexpr int kStagesPerTap = F / kBK;
    const Lane<P> ln;
    int tap_off[P::kMT];
    int cur_tap = -1;
    run_phase<P>(
        smem, m2, F, 9 * kStagesPerTap,
        [&](int, int np, int s, int slot) {
          load_b<P>(smem + slot * kRingStage, p.w2, F, F, s * kBK, np * P::kPW);
        },
        [&](int mp, int s, int, int (&off)[P::kMT]) {
          const int tap = s / kStagesPerTap;
          if (s == 0 || tap != cur_tap) {
            cur_tap = tap;
            const int dy = tap / 3, dx = tap - 3 * dy;
#pragma unroll
            for (int i = 0; i < P::kMT; ++i) {
              const int m = ln.ld_m(mp, i);
              int pixel = zero_pixel;
              if (m < m2) {
                const int col = m % w + dx - 1;
                if (col >= 0 && col < w) pixel = m + dy * w + dx - 1;
              }
              tap_off[i] = a1 + pixel * LDP + ln.ld_col;
            }
          }
#pragma unroll
          for (int i = 0; i < P::kMT; ++i) off[i] = tap_off[i];
          return (s - tap * kStagesPerTap) * kBK;
        },
        [&](int mp, int np, const float (&acc)[P::kMT][kNT][4], int tiles) {
          store_rows<P>(smem + a2, acc, tiles, mp, np, m2, 0, LDP, p.mul2, p.add2);
        });
  }

  // conv3 (1x1) + bn3 + residual + relu into this tile's output rows,
  // through staging tiles in a1's space
  {
    using P = typename K5Passes<F>::Conv3;
    const long long out_row0 = img_row0 + static_cast<long long>(r0) * w;
    const Lane<P> ln;
    run_phase<P>(
        smem, m2, p.c, F / kBK,
        [&](int, int np, int s, int slot) {
          load_b<P>(smem + slot * kRingStage, p.w3, p.c, p.c, s * kBK, np * P::kPW);
        },
        [&](int mp, int s, int, int (&off)[P::kMT]) {
#pragma unroll
          for (int i = 0; i < P::kMT; ++i)
            off[i] = a2 + min(ln.ld_m(mp, i), m2 - 1) * LDP + ln.ld_col;
          return s * kBK;
        },
        [&](int mp, int np, const float (&acc)[P::kMT][kNT][4], int tiles) {
          store_out<P>(smem + a1, acc, tiles, mp, np, m2, p.mul3, p.add3, p.x, p.out, out_row0,
                       p.c, 0, true);
        });
  }
}

template <int F>
int launch_bottleneck(const Bottleneck& p, int n, cudaStream_t s) {
  const long long smem = k5_smem(p.tile_rows, p.w, F);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(n) * p.tiles;
  if (smem > limit || blocks > INT32_MAX) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(bottleneck_tf32x3_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bottleneck_tf32x3_kernel<F><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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

// K5 in f32 on the tensor cores.  x/out: [n*h*w, c] NHWC rows, f32,
// contiguous, 16-byte aligned; w1 [c, f], w2 [9, f, f], w3 [f, c] f32;
// mul*/add*: f32 [f], [f], [c]; f one of 64, 128, 256, 512; c a multiple of
// 128; tile_rows output image rows per block, as `tf32x3_tile_rows` of
// ops/fused_resnet.py picks them.  One launch.  Returns
// cudaErrorInvalidValue for other shapes or a tile whose shared memory
// (`k5_smem`) does not fit in a block, else cudaGetLastError().
extern "C" int macsa_fused_bottleneck_tf32x3(const void* x, const void* w1, const void* mul1,
                                             const void* add1, const void* w2, const void* mul2,
                                             const void* add2, const void* w3, const void* mul3,
                                             const void* add3, void* out, int n, int h, int w,
                                             int c, int f, int tile_rows, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 128 || c % 128 || tile_rows < 1 || tile_rows > h)
    return cudaErrorInvalidValue;
  Bottleneck p;
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.mul1 = static_cast<const float*>(mul1);
  p.add1 = static_cast<const float*>(add1);
  p.w2 = static_cast<const float*>(w2);
  p.mul2 = static_cast<const float*>(mul2);
  p.add2 = static_cast<const float*>(add2);
  p.w3 = static_cast<const float*>(w3);
  p.mul3 = static_cast<const float*>(mul3);
  p.add3 = static_cast<const float*>(add3);
  p.out = static_cast<float*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.tile_rows = tile_rows;
  p.tiles = (h + tile_rows - 1) / tile_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 64: return launch_bottleneck<64>(p, n, s);
    case 128: return launch_bottleneck<128>(p, n, s);
    case 256: return launch_bottleneck<256>(p, n, s);
    case 512: return launch_bottleneck<512>(p, n, s);
    default: return cudaErrorInvalidValue;
  }
}
