// The bf16 tensor-core variant of K1, fused multi-head self-attention with
// dropout, forward and backward, for Hopper (sm_90a) at head width 64.
// `fused_attention.cu` holds the CUDA-core variant, which takes f32, head
// width 32 and the backward of rows longer than 192; both files replace the
// same TPU kernels (macsa_tpu/ops/fused_attention.py, `_fwd_kernel` and
// `_bwd_kernel`) and compute the same function with the same rounding
// points (see that file's header): f32 scores and softmax, the dropped
// probabilities rounded to bf16 before P V and dV, ds rounded to bf16
// before dQ and dK, f32 sums, and the same dropout mask, the keyed hash of
// (seed, b, h, i, j) of `attention_dropout.cuh`.  The tensor cores add each
// product's terms in another order than the plain versions, so results
// agree to a bf16 ulp where a rounding flips, not to the bit.
//
// Layout: q/k/v/g/out/dq/dk/dv are [B, L, H*64] bf16, read and written in
// place: one head's row is 64 bf16 = 128 bytes at offset h * 128 of a row of
// H * 128 bytes, exactly one row of a 128-byte-swizzled tile
// (`hopper_tiles.cuh`), fetched by eight 16-byte `cp.async`.  Rows past L
// are zero-filled.  The same tile bytes serve every operand role: K-major
// (rows are M or N, d is k) for S = Q K^T and dP = g V^T and their
// transposes, MN-major (rows are k, d is N) for P V, dV = Pd^T g,
// dK = ds^T Q and dQ = ds K.
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16) at the train
// shape, B = 48 views, L = 170, H = 12, D = 64: the forward is 4 B H L^2 D
// = 4.261 GFLOP (0.0043 ms) and moves q, k, v, the output and the mask row,
// 50.17 MB (0.0150 ms); the backward is 10 B H L^2 D = 10.65 GFLOP
// (0.0108 ms) and moves q, k, v, g, dq, dk, dv, the mask row and f32 row
// terms, 88.55 MB (0.0264 ms).  Both byte-bound, and so small that what is
// left once the products are on the tensor cores is load latency, the
// number of waves of blocks, and the exponentials and hashes of the
// softmax on the CUDA cores (B H L^2 = 16.6 M elements a pass).
//
// `wgmma` (m64nNk16) rather than `mma.sync`: the tiles in shared memory
// are read by the tensor cores directly through descriptors, whatever role
// an operand plays, so no `ldmatrix` pass and no transposed copy exists;
// the price is that L = 170 pads to 192 keys, not 176.
//
// Forward: one block of one warpgroup per (64-query tile, head, batch
// row); three blocks share an SM (58 KB of shared memory and at most 168
// registers each), so one block's loads run under another's softmax.  Q
// (8 KB), then K, then V (24 KB each for up to 192 keys) are fetched as
// three groups of copies; S = Q K^T for all 192 keys starts when Q and K
// have landed, V still in flight.  Scale, mask row and the key >= L cut
// (-inf) are applied to the accumulators; the row max and sum take two
// shuffles across the four lanes that share a row, once a row; the hash is
// drawn at each accumulator element's own (i, j); P is rounded to bf16 in
// registers, which is already the A fragment layout of P V.  The output
// tile is staged in Q's space and leaves 16 bytes a lane.  With an lse
// pointer the row logsumexp is stored for the backward.  Rows longer than
// 192 keys walk the keys 192 at a time with a running max and sum.
//
// Backward, one launch and no atomics: one block of three warpgroups per
// (head, batch row) holds Q, K, V and g of the head (4 x 24 KB), so every
// sum a gradient needs is taken inside the block, in a fixed order, and
// two calls give the same bits.  L <= 192.
//   pass 1: warpgroup w owns queries [64w, 64w + 64) and walks the keys 64
//     at a time: S and dP tiles, p = exp(s - lse), the row term
//     rowsum(dp * p) (from dp * p as the TPU kernel takes it, not from
//     g * out) by a quad reduction, kept in shared memory;
//   pass 2: warpgroup w owns keys [64w, 64w + 64) and walks the queries 64
//     at a time with the TRANSPOSED tiles S^T = K Q^T and dP^T = V g^T
//     (keys as M), so that pd^T and ds^T leave the accumulators as the A
//     fragments of dV += pd^T g and dK += ds^T Q; ds^T also goes to shared
//     memory as bf16 (72 KB for 192 x 192);
//   pass 3: warpgroup w owns queries again: dQ = ds K with A read from the
//     ds^T tiles MN-major (the descriptor's transpose bit), all keys in one
//     chain of products.
// The scores are computed twice (pass 1 and pass 2) instead of the three
// times of the CUDA-core variant, and the row term never leaves the block.
// dq, dk and dv are staged in the dead Q, g and V tiles and leave 16 bytes
// a lane.  172 KB of shared memory: one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_dropout.cuh"
#include "hopper_tiles.cuh"
#include "wgmma_ops.cuh"

namespace {

using namespace hopper;
using attention::Dropout;
using attention::row_key;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kD = 64;                    // head width: one 128-byte tile row
constexpr int kRowBytes = kD * 2;
constexpr int kTile = 64;                 // rows a warpgroup owns
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kWG = 128;                  // threads of a warpgroup
constexpr int kBwdRows = 192;             // the longest row the backward holds
constexpr int kBwdThreads = kBwdRows / kTile * kWG;
constexpr unsigned kFull = 0xffffffffu;

// the sum / max over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + rows) of a head slice x (x points at (b, 0, h*64); `hd`
// elements a row) into the swizzled tile at `tile`; rows >= L are zero.
// Every thread of the block takes its share.
__device__ __forceinline__ void load_rows(uint32_t tile, const bf16* __restrict__ x, long long hd,
                                          int r0, int rows, int L, int threads) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += threads) {
    const int r = idx >> 3, c = idx & 7, i = r0 + r;
    const bool ok = i < L;
    cp_async16(tile + swizzled(r, c), x + (ok ? i : 0) * hd + c * 8, ok);
  }
}

// This thread's share of a 64 x 64 f32 accumulator, times `factor` (two
// factors: rows lo and lo + 8), as bf16 into the swizzled tile at `tile`.
__device__ __forceinline__ void stage_tile(uint8_t* tile, const float (&acc)[32], float f_lo,
                                           float f_hi, int row_lo, int col2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swizzled(row_lo, j) + col2 * 2) =
        pack_bf16(acc[4 * j] * f_lo, acc[4 * j + 1] * f_lo);
    *reinterpret_cast<uint32_t*>(tile + swizzled(row_lo + 8, j) + col2 * 2) =
        pack_bf16(acc[4 * j + 2] * f_hi, acc[4 * j + 3] * f_hi);
  }
}

// rows [r0, r0 + rows) of a staged tile to the head slice `out`, 16 bytes a
// lane, rows >= L skipped
__device__ __forceinline__ void store_rows(const uint8_t* tile, bf16* __restrict__ out,
                                           long long hd, int r0, int rows, int L, int threads) {
  for (int idx = threadIdx.x; idx < rows * 8; idx += threads) {
    const int r = idx >> 3, c = idx & 7, i = r0 + r;
    if (i < L)
      *reinterpret_cast<uint4*>(out + i * hd + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swizzled(r, c));
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int NK>
constexpr int fwd_smem() { return kAlign + kTileBytes + 2 * NK * kRowBytes + NK * 4; }

// NK: keys per pass (64, 128 or 192)
template <int NK>
__global__ void __launch_bounds__(kWG, 3)
attention_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                           float scale, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = aligned_smem(smem_raw);
  uint8_t* k_tile = q_tile + kTileBytes;
  uint8_t* v_tile = k_tile + NK * kRowBytes;
  float* mrow = reinterpret_cast<float*>(v_tile + NK * kRowBytes);  // mask row, -inf past L
  const uint32_t q_addr = smem_u32(q_tile), k_addr = smem_u32(k_tile), v_addr = smem_u32(v_tile);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long hd = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * kD;
  const int row_lo = warp * 16 + (lane >> 2), col2 = (lane & 3) * 2;
  const int i_lo = q0 + row_lo, i_hi = i_lo + 8;  // this thread's two queries

  load_rows(q_addr, q + base, hd, q0, kTile, L, kWG);

  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint32_t key_lo = drop.on ? row_key(drop.seed, b, h, i_lo) : 0u;
  const uint32_t key_hi = drop.on ? row_key(drop.seed, b, h, i_hi) : 0u;

  for (int k0 = 0; k0 < L; k0 += NK) {
    if (k0 > 0) __syncthreads();  // the pass before has read its K, V and mask row
    load_rows(k_addr, k + base, hd, k0, NK, L, kWG);
    cp_async_commit();  // Q (first pass) and K
    load_rows(v_addr, v + base, hd, k0, NK, L, kWG);
    cp_async_commit();  // V
    for (int j = threadIdx.x; j < NK; j += kWG)
      mrow[j] = k0 + j < L ? mask[static_cast<long long>(b) * L + k0 + j] : -INFINITY;
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();  // Q, K and the mask row are there; V may still be in flight

    float s[NK / 2];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma::Op<NK>::template ss<0, 0>(s, desc_k(q_addr) + kk * kDescK16,
                                       desc_k(k_addr) + kk * kDescK16, kk > 0);
    wgmma::commit();
    wgmma::wait<0>();

    // scale, mask row, the key >= L cut, and the row max
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const float2 mk = *reinterpret_cast<const float2*>(mrow + 8 * j + col2);
      s[4 * j] = fmaf(s[4 * j], scale, mk.x);
      s[4 * j + 1] = fmaf(s[4 * j + 1], scale, mk.y);
      s[4 * j + 2] = fmaf(s[4 * j + 2], scale, mk.x);
      s[4 * j + 3] = fmaf(s[4 * j + 3], scale, mk.y);
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx_lo = quad_max(mx_lo);  // finite: key 0 is < L
    mx_hi = quad_max(mx_hi);
    const float corr_lo = __expf(m_lo - mx_lo), corr_hi = __expf(m_hi - mx_hi);  // 0 at first

    // the exponentials, their sum (kept or not), dropout, and P as bf16 A fragments
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t pf[NK / 16][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __expf(s[4 * j + e] - (e < 2 ? mx_lo : mx_hi));
      sum_lo += p[0] + p[1];
      sum_hi += p[2] + p[3];
      if (drop.on) {
        const int key = k0 + 8 * j + col2;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = drop.keep(e < 2 ? key_lo : key_hi, key + (e & 1)) ? p[e] * drop.inv_keep : 0.f;
      }
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    l_lo = l_lo * corr_lo + quad_sum(sum_lo);
    l_hi = l_hi * corr_hi + quad_sum(sum_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    if (k0 > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= corr_lo;
        o[4 * j + 1] *= corr_lo;
        o[4 * j + 2] *= corr_hi;
        o[4 * j + 3] *= corr_hi;
      }
    }

    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // V is there
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma::Op<64>::rs(o, pf[kk], desc_mn(v_addr) + kk * kDescMnK16, 1);
    wgmma::commit();
    wgmma::wait<0>();
  }

  // every product of the block is done: Q's space stages the output tile
  stage_tile(q_tile, o, 1.f / l_lo, 1.f / l_hi, row_lo, col2);
  if (lse != nullptr && (lane & 3) == 0) {
    const long long stat = (static_cast<long long>(b) * H + h) * L;
    if (i_lo < L) lse[stat + i_lo] = m_lo + logf(l_lo);
    if (i_hi < L) lse[stat + i_hi] = m_hi + logf(l_hi);
  }
  __syncthreads();
  store_rows(q_tile, out + base, hd, q0, kTile, L, kWG);
}

template <int NK>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
               int B, int L, int H, Dropout drop, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_wgmma_kernel<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         fwd_smem<NK>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  attention_fwd_wgmma_kernel<NK><<<grid, kWG, fwd_smem<NK>(), s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), L, H,
      1.0f / sqrtf(static_cast<float>(kD)), drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kHeadBytes = kBwdRows * kRowBytes;  // one of Q, K, V, g; one ds^T query tile
constexpr int kBwdSmem = kAlign + 4 * kHeadBytes + (kBwdRows / kTile) * kHeadBytes +
                         4 * kBwdRows * 4;

// p, the dropped p and the dropped dp of one (query i, key j) from its S
// and dP accumulator elements; `mk` is the mask row at j, `rkey` the hash
// of (seed, b, h, i)
struct Element {
  float p, pd, dp;
};
__device__ __forceinline__ Element element(float s, float dpd, float scale, float mk, float lse_i,
                                           const Dropout& drop, uint32_t rkey, int j) {
  Element e;
  e.p = __expf(fmaf(s, scale, mk) - lse_i);  // 0 for a key or a query >= L
  e.pd = e.p;
  e.dp = dpd;
  if (drop.on) {
    const bool keep = drop.keep(rkey, j);
    e.pd = keep ? e.p * drop.inv_keep : 0.f;
    e.dp = keep ? dpd * drop.inv_keep : 0.f;
  }
  return e;
}

__global__ void __launch_bounds__(kBwdThreads, 1)
attention_bwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ mask,
                           const bf16* __restrict__ gout, const float* __restrict__ lse,
                           bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int L, int H, float scale, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = aligned_smem(smem_raw);
  uint8_t* k_tile = q_tile + kHeadBytes;
  uint8_t* v_tile = k_tile + kHeadBytes;
  uint8_t* g_tile = v_tile + kHeadBytes;
  uint8_t* dst_tile = g_tile + kHeadBytes;  // ds^T: per 64 queries a [192 keys][64 queries] tile
  float* lse_s = reinterpret_cast<float*>(dst_tile + (kBwdRows / kTile) * kHeadBytes);
  float* term_s = lse_s + kBwdRows;   // rowsum(dp * p) per query
  float* mrow = term_s + kBwdRows;    // mask row, -inf past L
  uint32_t* rkey = reinterpret_cast<uint32_t*>(mrow + kBwdRows);  // the hash of (seed, b, h, i)
  const uint32_t q_addr = smem_u32(q_tile), k_addr = smem_u32(k_tile), v_addr = smem_u32(v_tile);
  const uint32_t g_addr = smem_u32(g_tile), dst_addr = smem_u32(dst_tile);

  const int h = blockIdx.x, b = blockIdx.y;
  const int wg = threadIdx.x / kWG, lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const long long hd = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * kD;
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  const int tiles = (L + kTile - 1) / kTile, rows = tiles * kTile;
  const int row_lo = warp * 16 + (lane >> 2), col2 = (lane & 3) * 2;
  const bool active = wg < tiles;  // this warpgroup has rows
  const int own = wg * kTileBytes;  // its tile's offset in a head

  load_rows(q_addr, q + base, hd, 0, rows, L, kBwdThreads);
  load_rows(k_addr, k + base, hd, 0, rows, L, kBwdThreads);
  load_rows(v_addr, v + base, hd, 0, rows, L, kBwdThreads);
  load_rows(g_addr, gout + base, hd, 0, rows, L, kBwdThreads);
  cp_async_commit();
  for (int i = threadIdx.x; i < kBwdRows; i += kBwdThreads) {
    const bool ok = i < L;
    lse_s[i] = ok ? lse[stat + i] : INFINITY;  // p = exp(. - inf) = 0 for a query >= L
    mrow[i] = ok ? mask[static_cast<long long>(b) * L + i] : -INFINITY;
    rkey[i] = drop.on ? row_key(drop.seed, b, h, i) : 0u;
  }
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();

  // pass 1: the row term of this warpgroup's 64 queries
  if (active) {
    const int i_lo = wg * kTile + row_lo, i_hi = i_lo + 8;
    const float lse_lo = lse_s[i_lo], lse_hi = lse_s[i_hi];
    const uint32_t key_lo = rkey[i_lo], key_hi = rkey[i_hi];
    float term_lo = 0.f, term_hi = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      float s[32], dp[32];
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma::Op<64>::ss<0, 0>(s, desc_k(q_addr + own) + kk * kDescK16,
                                desc_k(k_addr + kt * kTileBytes) + kk * kDescK16, kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma::Op<64>::ss<0, 0>(dp, desc_k(g_addr + own) + kk * kDescK16,
                                desc_k(v_addr + kt * kTileBytes) + kk * kDescK16, kk > 0);
      wgmma::commit();
      wgmma::wait<0>();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kt * kTile + 8 * j + col2;
        const float2 mk = *reinterpret_cast<const float2*>(mrow + key);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Element el = element(s[4 * j + e], dp[4 * j + e], scale, e & 1 ? mk.y : mk.x,
                                     e < 2 ? lse_lo : lse_hi, drop, e < 2 ? key_lo : key_hi,
                                     key + (e & 1));
          if (e < 2) term_lo = fmaf(el.dp, el.p, term_lo);
          else term_hi = fmaf(el.dp, el.p, term_hi);
        }
      }
    }
    term_lo = quad_sum(term_lo);
    term_hi = quad_sum(term_hi);
    if ((lane & 3) == 0) {
      term_s[i_lo] = term_lo;
      term_s[i_hi] = term_hi;
    }
  }
  __syncthreads();

  // pass 2: dk and dv of this warpgroup's 64 keys, from the transposed tiles
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (active) {
    const int j_lo = wg * kTile + row_lo, j_hi = j_lo + 8;  // this thread's two keys
    const float mk_lo = mrow[j_lo], mk_hi = mrow[j_hi];
    for (int qt = 0; qt < tiles; ++qt) {
      float s[32], dp[32];
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma::Op<64>::ss<0, 0>(s, desc_k(k_addr + own) + kk * kDescK16,
                                desc_k(q_addr + qt * kTileBytes) + kk * kDescK16, kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma::Op<64>::ss<0, 0>(dp, desc_k(v_addr + own) + kk * kDescK16,
                                desc_k(g_addr + qt * kTileBytes) + kk * kDescK16, kk > 0);
      wgmma::commit();
      wgmma::wait<0>();
      uint32_t pdf[4][4], dsf[4][4];
      uint8_t* ds_out = dst_tile + qt * kHeadBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = qt * kTile + 8 * j + col2;  // this column pair's first query
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + i);
        const float2 tm = *reinterpret_cast<const float2*>(term_s + i);
        const uint2 rk = *reinterpret_cast<const uint2*>(rkey + i);
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Element el = element(s[4 * j + e], dp[4 * j + e], scale, e < 2 ? mk_lo : mk_hi,
                                     e & 1 ? ls.y : ls.x, drop, e & 1 ? rk.y : rk.x,
                                     e < 2 ? j_lo : j_hi);
          pd[e] = el.pd;
          ds[e] = el.p * (el.dp - (e & 1 ? tm.y : tm.x));
        }
        pdf[j >> 1][(j & 1) * 2] = pack_bf16(pd[0], pd[1]);
        pdf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);
        const uint32_t ds_lo = pack_bf16(ds[0], ds[1]), ds_hi = pack_bf16(ds[2], ds[3]);
        dsf[j >> 1][(j & 1) * 2] = ds_lo;
        dsf[j >> 1][(j & 1) * 2 + 1] = ds_hi;
        *reinterpret_cast<uint32_t*>(ds_out + swizzled(j_lo, j) + col2 * 2) = ds_lo;
        *reinterpret_cast<uint32_t*>(ds_out + swizzled(j_hi, j) + col2 * 2) = ds_hi;
      }
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma::Op<64>::rs(acc_v, pdf[kk], desc_mn(g_addr + qt * kTileBytes) + kk * kDescMnK16, 1);
        wgmma::Op<64>::rs(acc_k, dsf[kk], desc_mn(q_addr + qt * kTileBytes) + kk * kDescMnK16, 1);
      }
      wgmma::commit();
      wgmma::wait<0>();
    }
  }
  fence_async_proxy();  // ds^T was written with plain stores
  __syncthreads();      // ds^T is whole; Q, V and g are read no more

  // pass 3: dq of this warpgroup's 64 queries; dk, dv and dq staged in the
  // dead g, V and Q tiles
  if (active) {
    stage_tile(v_tile + own, acc_v, 1.f, 1.f, row_lo, col2);
    stage_tile(g_tile + own, acc_k, scale, scale, row_lo, col2);
    float acc_q[32];
    wgmma::fence();
    for (int kk = 0; kk < rows / 16; ++kk)
      wgmma::Op<64>::ss<1, 1>(acc_q, desc_mn(dst_addr + wg * kHeadBytes) + kk * kDescMnK16,
                              desc_mn(k_addr) + kk * kDescMnK16, kk > 0);
    wgmma::commit();
    wgmma::wait<0>();
    stage_tile(q_tile + own, acc_q, scale, scale, row_lo, col2);
  }
  __syncthreads();
  store_rows(q_tile, dq + base, hd, 0, rows, L, kBwdThreads);
  store_rows(g_tile, dk + base, hd, 0, rows, L, kBwdThreads);
  store_rows(v_tile, dv + base, hd, 0, rows, L, kBwdThreads);
}

bool bad_geometry(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

}  // namespace

// K1's forward on the tensor cores.  q/k/v/out: [B, L, H*64] bf16,
// contiguous, 16-byte aligned; mask: [B, L] f32; lse: [B, H, L] f32, or NULL
// when no backward follows.  Dropout as in `macsa_fused_attention_fwd`.
// Returns cudaGetLastError() after the launch.
extern "C" int macsa_fused_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* mask, void* out, void* lse, int B,
                                               int L, int H, int dropout,
                                               unsigned keep_threshold, float inv_keep,
                                               unsigned seed, void* stream) {
  if (bad_geometry(B, L, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  if (L <= 64) return launch_fwd<64>(q, k, v, mask, out, lse, B, L, H, drop, s);
  if (L <= 128) return launch_fwd<128>(q, k, v, mask, out, lse, B, L, H, drop, s);
  return launch_fwd<192>(q, k, v, mask, out, lse, B, L, H, drop, s);
}

// K1's backward on the tensor cores, one launch.  g/dq/dk/dv like q; lse:
// the forward's [B, H, L] f32 row logsumexp; L <= 192 (a head's q, k, v and
// g stay in one block's shared memory), else cudaErrorInvalidValue.
extern "C" int macsa_fused_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* mask, const void* g, const void* lse,
                                               void* dq, void* dk, void* dv, int B, int L, int H,
                                               int dropout, unsigned keep_threshold,
                                               float inv_keep, unsigned seed, void* stream) {
  if (bad_geometry(B, L, H) || L > kBwdRows) return cudaErrorInvalidValue;
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_wgmma_kernel<<<dim3(H, B), kBwdThreads, kBwdSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, H, 1.0f / sqrtf(static_cast<float>(kD)), drop);
  return static_cast<int>(cudaGetLastError());
}
