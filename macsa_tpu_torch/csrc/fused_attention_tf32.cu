// The f32 tensor-core variant ("tf32x3") of K1, fused multi-head
// self-attention with dropout, forward and backward, for Hopper (sm_90a) at
// head width 64, any row length.
//
// Replaces: macsa_tpu/ops/fused_attention.py, `_fwd_kernel` (forward) and
// `_bwd_kernel` (backward) with the in-kernel dropout of `_keep_mask`, for
// f32 operands.  `fused_attention.cu` (the CUDA-core variant, head width
// 32) states the function; this file computes the same one: softmax of the
// scaled scores plus the additive mask row, keys >= L dropped exactly, the
// per-row logsumexp stored for the backward, the dropout mask of
// `attention_dropout.cuh` drawn at each accumulator element's own
// (b, h, i, j), the backward's row term rowsum(dp * p) as the TPU kernel
// takes it (not rowsum(g * out)), and no atomics, so two calls give the
// same bits.
//
// Three TF32 products for one f32 product (`tf32x3.cuh`, shared with the
// f32 K4 and K5).  Every f32 operand x of a product is split in registers
// into big = tf32(x) and small = tf32(x - big), both rounded to nearest,
// ties away (`tf32`), and the product is small*big + big*small + big*big,
// each term an `mma.sync.m16n8k8` TF32 product accumulated in f32
// (small*small, about 2^-22 of the product, is left out).  One TF32 product keeps 11 bits of
// each operand and misses the f32 tolerance of the output (1e-5 absolute)
// by two orders of magnitude; three keep about 22 and hold it.  There is no
// one-product mode.  Exponentials, the mask, the scale and the row terms
// stay f32 on the CUDA cores.
//
// Layout: q/k/v/g/out/dq/dk/dv are [B, L, H*64] f32, read and written in
// place (one head's row is 256 bytes at offset h * 256 of a row of H * 256
// bytes); mask is the [B, L] additive f32 row; lse and row_term are
// [B, H, L] f32.
//
// What bounds them on an H100 (3.35 TB/s; 495 TFLOP/s TF32 on the tensor
// cores, so 165 TFLOP/s of f32 products at three TF32 products each; 67
// TFLOP/s f32 on the CUDA cores) at the train shape, B = 48 views, L = 170,
// H = 12, D = 64: the forward is 4 B H L^2 D = 4.261 GFLOP (0.0258 ms at
// 3xTF32) and moves q, k, v, the output and the mask row once, 100.3 MB
// (0.0299 ms): byte-bound; the backward is 10 B H L^2 D = 10.65 GFLOP
// (0.0646 ms at 3xTF32) and moves 176.3 MB (0.0526 ms): bound by its
// products.  These kernels recompute: the scores twice in the backward's
// dq launch and once more in its dk/dv launch.  What holds them back on the
// card is their products (`ablate_attention.py tf32x3`): the backward takes
// 9 tile products a (query tile, key tile) pair where 5 would do (the
// row-term walk, and dq in a launch of its own, since no block may add into
// another's dq), each as three `mma.sync`; with one TF32 product it would
// take about 0.40 ms at the train shape instead of 0.64, without its
// exponentials 0.56, without its tile copies 0.56.
//
// Fragments (PTX ISA, m16n8k8 .tf32): lane = 4 g + t.  A (16 x 8, row):
// element e at row g + 8 (e & 1), column t + 4 (e >> 1).  B (8 x 8, col):
// element e at row t + 4 e, column g.  C (16 x 8): element e at row
// g + 8 (e >> 1), column 2 t + (e & 1).  A product's accumulators are not
// an A fragment (columns 2t, 2t + 1 against t, t + 4), so P (or dS) feeds
// the next product with its 8 columns relabelled inside each slice: A's
// column t is key 2t, column t + 4 is key 2t + 1, and B's rows are read in
// the same order (`product_acc`).  The sum is the same.
//
// Tiles are f32 in shared memory with rows of 64 + 4 floats: the four
// floats of padding put the 32 lanes of every fragment read on 32
// different banks, in either role (rows as m or n, or rows as k).  They
// arrive by 16-byte `cp.async` copies, rows past L zero-filled.
//
// Forward (`attention_fwd_tf32_kernel`): one block of 4 warps per (64-query
// tile, head, batch row), 16 query rows a warp, Q's split fragments held in
// registers.  Key tiles of 64 (K, V and the mask row's 64 values) go through
// a two-stage ring in shared memory, the next tile's copies issued before
// this tile's products; an online softmax (running max and sum, two
// shuffles across the four lanes that share a row) takes every length.
// Backward, two launches:
//   1. dq (`attention_bwd_dq_tf32_kernel`): one block per 64-query tile,
//      shaped like the forward, Q and g held in shared memory; it walks the
//      key tiles twice: the row term rowsum(dp * p) (also stored for launch
//      2), then ds = p (dp - row term) and dq += ds K.
//   2. dk/dv (`attention_bwd_dkdv_tf32_kernel`): one block per 64-key tile,
//      K and V held; it walks the query tiles with the transposed tiles
//      S^T = K Q^T and dP^T = V g^T (keys as rows), so that pd^T and ds^T
//      leave the accumulators as the A operand of dV += pd^T g and
//      dK += ds^T Q.  Each query tile's lse, row term and dropout row hash
//      ride in its stage of the ring.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_dropout.cuh"
#include "hopper_tiles.cuh"
#include "tf32x3.cuh"

namespace {

using attention::Dropout;
using attention::row_key;
using tf32x3::FragA;
using tf32x3::mma_tf32;
using tf32x3::Split;
using tf32x3::split;
using tf32x3::split_a;

constexpr int kD = 64;                     // head width
constexpr int kTile = 64;                  // rows a block owns, and rows of a walked tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = kTile / kWarps;  // one m16 row block a warp
constexpr int kSlices = 8;                 // 8-wide slices of 64 columns (n) or rows (k)
constexpr int kStride = kD + 4;            // floats a row of a tile in shared memory
constexpr int kTileFloats = kTile * kStride;
constexpr int kChunks = kD / 4;            // 16-byte copies a row
static_assert(kWarpRows == 16 && kSlices * 8 == kD && kSlices * 8 == kTile,
              "a warp owns one m16 block; a tile is 8 slices of 8 both ways");
constexpr unsigned kFull = 0xffffffffu;

// shared memory (floats): the forward's stage is a K tile, a V tile and the
// mask row's values; the dq launch holds Q and g besides; the dk/dv launch
// holds K and V and stages Q, g and the queries' lse, row term and hash
constexpr int kFwdStage = 2 * kTileFloats + kTile;
constexpr int kFwdSmem = 2 * kFwdStage * 4;
constexpr int kDqSmem = (2 * kTileFloats + 2 * kFwdStage) * 4;
constexpr int kDkdvStage = 2 * kTileFloats + 3 * kTile;
constexpr int kDkdvSmem = (2 * kTileFloats + 2 * kDkdvStage) * 4;

// c[n] += a b[n] in f32 for the 8 output slices of one k step: the two small
// terms first, the big one last, each term over all 8 slices before the
// next, so that no product waits for the one before it.  The small terms go
// in the order of the untransposed product: with `kTransposed` (S^T = K Q^T,
// dP^T = V g^T, whose A is the B of S = Q K^T and dP = g V^T) big*small
// first, so that every element sums the same terms in the same order and
// the dk/dv launch sees the dq launch's scores and dP bit for bit.
template <bool kTransposed>
__device__ __forceinline__ void mma3(float (&c)[kSlices][4], const FragA& a,
                                     const Split (&b0)[kSlices], const Split (&b1)[kSlices]) {
#pragma unroll
  for (int n = 0; n < kSlices; ++n) {
    if (kTransposed) {
      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);
    } else {
      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);
    }
  }
#pragma unroll
  for (int n = 0; n < kSlices; ++n) {
    if (kTransposed) {
      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);
    } else {
      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);
    }
  }
#pragma unroll
  for (int n = 0; n < kSlices; ++n) mma_tf32(c[n], a.big, b0[n].big, b1[n].big);
}

// the A fragment of rows [m0, m0 + 16), columns [8 kk, 8 kk + 8) of a tile
__device__ __forceinline__ FragA load_a(const float* tile, int m0, int kk, int lane) {
  const float* p = tile + (m0 + (lane >> 2)) * kStride + kk * 8 + (lane & 3);
  return split_a(p[0], p[8 * kStride], p[4], p[8 * kStride + 4]);
}

// acc[n] += A B^T over the 64 columns of both: A's 16 rows as `a(kk)` gives
// their fragments, B's rows [8n, 8n + 8) from a tile.  S = Q K^T, dP = g V^T
// and the transposed S^T = K Q^T, dP^T = V g^T (`kTransposed`).
template <bool kTransposed, typename AFrag>
__device__ __forceinline__ void product_rows(float (&acc)[kSlices][4], AFrag a,
                                             const float* b_tile, int lane) {
  const float* b = b_tile + (lane >> 2) * kStride + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) {
    const FragA f = a(kk);
    Split b0[kSlices], b1[kSlices];
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
      b0[n] = split(b[n * 8 * kStride + kk * 8]);
      b1[n] = split(b[n * 8 * kStride + kk * 8 + 4]);
    }
    mma3<kTransposed>(acc, f, b0, b1);
  }
}

// acc[n] += P B[:, 8n:8n + 8) over the 64 rows of B: P is 16 x 64, held as the
// accumulators of `product_rows`, fed as A with each slice's columns
// relabelled (A's column t is P's column 2t, t + 4 is 2t + 1) and B's rows
// read in that order.  P V, dq += ds K, dv += pd^T g, dk += ds^T Q.
__device__ __forceinline__ void product_acc(float (&acc)[kSlices][4],
                                            const float (&p)[kSlices][4], const float* b_tile,
                                            int lane) {
  const float* b = b_tile + 2 * (lane & 3) * kStride + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) {
    const FragA f = split_a(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
    Split b0[kSlices], b1[kSlices];
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
      b0[n] = split(b[kk * 8 * kStride + n * 8]);
      b1[n] = split(b[kk * 8 * kStride + kStride + n * 8]);
    }
    mma3<false>(acc, f, b0, b1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

struct Geometry {
  long long hd, base;  // row stride H*D; offset of (b, 0, h*D)
  const float* mrow;   // mask row b
  long long stat;      // offset of (b, h, 0) in lse / row_term
};

__device__ __forceinline__ Geometry geometry(const float* mask, int b, int h, int L, int H) {
  Geometry g;
  g.hd = static_cast<long long>(H) * kD;
  g.base = static_cast<long long>(b) * L * g.hd + static_cast<long long>(h) * kD;
  g.mrow = mask + static_cast<long long>(b) * L;
  g.stat = (static_cast<long long>(b) * H + h) * L;
  return g;
}

// rows [r0, r0 + 64) of x's head slice into a tile, asynchronously; zeros past L
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ x,
                                          const Geometry& g, int r0, int L) {
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks, i = r0 + r;
    hopper::cp_async16(hopper::smem_u32(tile + r * kStride + 4 * c),
                       x + g.base + static_cast<long long>(i < L ? i : 0) * g.hd + 4 * c, i < L);
  }
}

// the next tile's copies (if any) are in flight; wait for this tile's
__device__ __forceinline__ void wait_tile(bool next_in_flight) {
  if (next_in_flight) {
    hopper::cp_async_wait<1>();
  } else {
    hopper::cp_async_wait<0>();
  }
  __syncthreads();
}

// element e of a warp's accumulator slice n: row (within the warp's 16) and column
__device__ __forceinline__ int acc_row(int lane, int e) { return (lane >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int lane, int n, int e) {
  return 8 * n + 2 * (lane & 3) + (e & 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ lse, int L, int H,
                          float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  auto k_tile = [&](int s) { return smem + s * kFwdStage; };
  auto v_tile = [&](int s) { return smem + s * kFwdStage + kTileFloats; };
  auto m_vals = [&](int s) { return smem + s * kFwdStage + 2 * kTileFloats; };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = threadIdx.x / 32 * kWarpRows;
  const Geometry g = geometry(mask, b, h, L, H);
  const int tiles = (L + kTile - 1) / kTile;

  auto fetch = [&](int s, int k0) {
    load_tile(k_tile(s), k, g, k0, L);
    load_tile(v_tile(s), v, g, k0, L);
    if (threadIdx.x < kTile) {
      const int j = k0 + threadIdx.x;
      m_vals(s)[threadIdx.x] = j < L ? g.mrow[j] : 0.f;
    }
  };

  // Q lands in stage 1's K tile and is read into split fragments before the
  // walk fetches key tile 1 there
  load_tile(k_tile(1), q, g, q0, L);
  fetch(0, 0);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  FragA qf[kSlices];
#pragma unroll
  for (int kk = 0; kk < kSlices; ++kk) qf[kk] = load_a(k_tile(1), m0, kk, lane);
  __syncthreads();

  float m[2], l[2], o[kSlices][4];
  uint32_t key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    key[r] = drop.on ? row_key(drop.seed, b, h, q0 + m0 + acc_row(lane, 2 * r)) : 0u;
  }
  zero(o);

  for (int t = 0; t < tiles; ++t) {
    const bool ahead = t + 1 < tiles;
    if (ahead) {
      fetch((t + 1) & 1, (t + 1) * kTile);
      hopper::cp_async_commit();
    }
    wait_tile(ahead);
    const int st = t & 1, k0 = t * kTile;
    const float* mv = m_vals(st);

    float s[kSlices][4];
    zero(s);
    product_rows<false>(s, [&](int kk) { return qf[kk]; }, k_tile(st), lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = acc_col(lane, n, e);
        s[n][e] = k0 + c < L ? s[n][e] * scale + mv[c] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: key 0 is < L
      corr[r] = expf(m[r] - m_new);                      // 0 on the first tile
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[n][e] - m[r]);  // 0 past L
        l[r] += p;                             // every exponential, kept or not
        float pd = p;
        if (drop.on)
          pd = drop.keep(key[r], k0 + acc_col(lane, n, e)) ? p * drop.inv_keep : 0.f;
        s[n][e] = pd;
        o[n][e] *= corr[r];
      }
    }
    product_acc(o, s, v_tile(st), lane);
    __syncthreads();  // this stage is read before the next tile's copies refill it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + m0 + acc_row(lane, 2 * r);
    const float total = quad_sum(l[r]);
    if (i >= L) continue;
    const float inv = 1.f / total;
    float* row = out + g.base + i * g.hd + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kSlices; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0) lse[g.stat + i] = m[r] + logf(total);
  }
}

// ---------------------------------------------------------------------------
// backward launch 1: dq, and the row term rowsum(dp * p) for launch 2
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ mask,
                             const float* __restrict__ gout, const float* __restrict__ lse,
                             float* __restrict__ row_term, float* __restrict__ dq, int L, int H,
                             float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;
  float* g_tile = smem + kTileFloats;
  float* ring = smem + 2 * kTileFloats;
  auto k_tile = [&](int s) { return ring + s * kFwdStage; };
  auto v_tile = [&](int s) { return ring + s * kFwdStage + kTileFloats; };
  auto m_vals = [&](int s) { return ring + s * kFwdStage + 2 * kTileFloats; };

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = threadIdx.x / 32 * kWarpRows;
  const Geometry g = geometry(mask, b, h, L, H);
  const int tiles = (L + kTile - 1) / kTile;

  auto fetch = [&](int s, int k0) {
    load_tile(k_tile(s), k, g, k0, L);
    load_tile(v_tile(s), v, g, k0, L);
    if (threadIdx.x < kTile) {
      const int j = k0 + threadIdx.x;
      m_vals(s)[threadIdx.x] = j < L ? g.mrow[j] : 0.f;
    }
  };

  load_tile(q_tile, q, g, q0, L);
  load_tile(g_tile, gout, g, q0, L);
  fetch(0, 0);
  hopper::cp_async_commit();

  float row_lse[2], rsum[2] = {0.f, 0.f}, acc[kSlices][4];
  uint32_t key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + m0 + acc_row(lane, 2 * r);
    row_lse[r] = i < L ? lse[g.stat + i] : 0.f;
    key[r] = drop.on ? row_key(drop.seed, b, h, i) : 0u;
  }
  zero(acc);

  // walk 1 (t < tiles): the row term; walk 2: ds, then dq += ds K
  for (int t = 0; t < 2 * tiles; ++t) {
    const bool ahead = t + 1 < 2 * tiles;
    if (ahead) {
      fetch((t + 1) & 1, (t + 1) % tiles * kTile);
      hopper::cp_async_commit();
    }
    wait_tile(ahead);
    const int st = t & 1, k0 = t % tiles * kTile;
    const float* mv = m_vals(st);

    float s[kSlices][4], dp[kSlices][4];
    zero(s);
    zero(dp);
    product_rows<false>(s, [&](int kk) { return load_a(q_tile, m0, kk, lane); },
                        k_tile(st), lane);
    product_rows<false>(dp, [&](int kk) { return load_a(g_tile, m0, kk, lane); },
                        v_tile(st), lane);
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = acc_col(lane, n, e), j = k0 + c;
        const float p = j < L ? expf(s[n][e] * scale + mv[c] - row_lse[r]) : 0.f;
        float d = dp[n][e];
        if (drop.on) d = drop.keep(key[r], j) ? d * drop.inv_keep : 0.f;
        if (t < tiles) {
          rsum[r] = fmaf(d, p, rsum[r]);
        } else {
          s[n][e] = p * (d - rsum[r]);
        }
      }
    }
    if (t >= tiles) product_acc(acc, s, k_tile(st), lane);
    if (t == tiles - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rsum[r] = quad_sum(rsum[r]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + m0 + acc_row(lane, 2 * r);
    if (i >= L) continue;
    float* row = dq + g.base + i * g.hd + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kSlices; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    if ((lane & 3) == 0) row_term[g.stat + i] = rsum[r];
  }
}

// ---------------------------------------------------------------------------
// backward launch 2: dk and dv for a tile of 64 keys
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ mask,
                               const float* __restrict__ gout, const float* __restrict__ lse,
                               const float* __restrict__ row_term, float* __restrict__ dk,
                               float* __restrict__ dv, int L, int H, float scale, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* k_tile = smem;
  float* v_tile = smem + kTileFloats;
  float* ring = smem + 2 * kTileFloats;
  auto q_tile = [&](int s) { return ring + s * kDkdvStage; };
  auto g_tile = [&](int s) { return ring + s * kDkdvStage + kTileFloats; };
  // a stage's queries: lse, row term, dropout row hash (as bits)
  auto lse_vals = [&](int s) { return ring + s * kDkdvStage + 2 * kTileFloats; };
  auto term_vals = [&](int s) { return lse_vals(s) + kTile; };
  auto hash_vals = [&](int s) { return reinterpret_cast<uint32_t*>(lse_vals(s) + 2 * kTile); };

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, m0 = threadIdx.x / 32 * kWarpRows;
  const Geometry g = geometry(mask, b, h, L, H);
  const int tiles = (L + kTile - 1) / kTile;

  auto fetch = [&](int s, int i0) {
    load_tile(q_tile(s), q, g, i0, L);
    load_tile(g_tile(s), gout, g, i0, L);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      lse_vals(s)[threadIdx.x] = i < L ? lse[g.stat + i] : 0.f;
      term_vals(s)[threadIdx.x] = i < L ? row_term[g.stat + i] : 0.f;
      hash_vals(s)[threadIdx.x] = drop.on ? row_key(drop.seed, b, h, i) : 0u;
    }
  };

  load_tile(k_tile, k, g, k0, L);
  load_tile(v_tile, v, g, k0, L);
  fetch(0, 0);
  hopper::cp_async_commit();

  float mj[2];
  bool jvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + m0 + acc_row(lane, 2 * r);
    jvalid[r] = j < L;
    mj[r] = jvalid[r] ? g.mrow[j] : 0.f;
  }
  float acc_k[kSlices][4], acc_v[kSlices][4];
  zero(acc_k);
  zero(acc_v);

  for (int t = 0; t < tiles; ++t) {
    const bool ahead = t + 1 < tiles;
    if (ahead) {
      fetch((t + 1) & 1, (t + 1) * kTile);
      hopper::cp_async_commit();
    }
    wait_tile(ahead);
    const int st = t & 1, i0 = t * kTile;
    const float *lv = lse_vals(st), *tv = term_vals(st);
    const uint32_t* hv = hash_vals(st);

    // rows are keys, columns queries
    float s[kSlices][4], dp[kSlices][4];
    zero(s);
    zero(dp);
    product_rows<true>(s, [&](int kk) { return load_a(k_tile, m0, kk, lane); },
                       q_tile(st), lane);
    product_rows<true>(dp, [&](int kk) { return load_a(v_tile, m0, kk, lane); },
                       g_tile(st), lane);
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = acc_col(lane, n, e);
        const float p =
            (i0 + c < L && jvalid[r]) ? expf(s[n][e] * scale + mj[r] - lv[c]) : 0.f;
        float pd = p, d = dp[n][e];
        if (drop.on) {
          const bool kept = drop.keep(hv[c], k0 + m0 + acc_row(lane, e));
          pd = kept ? p * drop.inv_keep : 0.f;
          d = kept ? d * drop.inv_keep : 0.f;
        }
        s[n][e] = pd;
        dp[n][e] = p * (d - tv[c]);
      }
    }
    product_acc(acc_v, s, g_tile(st), lane);
    product_acc(acc_k, dp, q_tile(st), lane);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!jvalid[r]) continue;
    const long long off = g.base + (k0 + m0 + acc_row(lane, 2 * r)) * g.hd + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kSlices; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(acc_k[n][2 * r] * scale, acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

bool bad_geometry(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// K1's forward in f32 on the tensor cores.  q/k/v/out: [B, L, H*64] f32,
// contiguous, 16-byte aligned; mask: [B, L] f32; lse: [B, H, L] f32, or
// NULL when no backward follows.  Dropout as in `macsa_fused_attention_fwd`.
// Returns cudaGetLastError() after the launch.
extern "C" int macsa_fused_attention_fwd_tf32x3(const void* q, const void* k, const void* v,
                                                const void* mask, void* out, void* lse, int B,
                                                int L, int H, int dropout,
                                                unsigned keep_threshold, float inv_keep,
                                                unsigned seed, void* stream) {
  if (bad_geometry(B, L, H)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_fwd_tf32_kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_tf32_kernel<<<dim3((L + kTile - 1) / kTile, H, B), kThreads, kFwdSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), L, H,
      1.0f / sqrtf(static_cast<float>(kD)),
      attention::make_dropout(dropout, keep_threshold, inv_keep, seed));
  return static_cast<int>(cudaGetLastError());
}

// K1's backward in f32 on the tensor cores, two launches on `stream`.
// g/dq/dk/dv like q; lse: the forward's [B, H, L] f32 row logsumexp;
// row_term: [B, H, L] f32 scratch.  Returns the first launch error, or
// cudaSuccess.
extern "C" int macsa_fused_attention_bwd_tf32x3(const void* q, const void* k, const void* v,
                                                const void* mask, const void* g,
                                                const void* lse, void* row_term, void* dq,
                                                void* dk, void* dv, int B, int L, int H,
                                                int dropout, unsigned keep_threshold,
                                                float inv_keep, unsigned seed, void* stream) {
  if (bad_geometry(B, L, H) || row_term == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attention_bwd_dq_tf32_kernel, kDqSmem);
  if (err == cudaSuccess) err = allow_smem(attention_bwd_dkdv_tf32_kernel, kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(kD));
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k);
  const float *vp = static_cast<const float*>(v), *gp = static_cast<const float*>(g);
  const float *mp = static_cast<const float*>(mask), *lp = static_cast<const float*>(lse);
  attention_bwd_dq_tf32_kernel<<<grid, kThreads, kDqSmem, s>>>(
      qp, kp, vp, mp, gp, lp, static_cast<float*>(row_term), static_cast<float*>(dq), L, H,
      scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_tf32_kernel<<<grid, kThreads, kDkdvSmem, s>>>(
      qp, kp, vp, mp, gp, lp, static_cast<const float*>(row_term), static_cast<float*>(dk),
      static_cast<float*>(dv), L, H, scale, drop);
  return static_cast<int>(cudaGetLastError());
}
