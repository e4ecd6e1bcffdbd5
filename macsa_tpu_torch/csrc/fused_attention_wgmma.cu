// The bf16 tensor-core variant of K1, fused multi-head self-attention with
// dropout, forward and backward, for Hopper (sm_90a) at head width 64, any
// row length.  `fused_attention.cu` holds the CUDA-core variant, which
// takes f32 and head width 32; both files replace the same TPU kernels
// (macsa_tpu/ops/fused_attention.py, `_fwd_kernel` and `_bwd_kernel`) and
// compute the same function with the same rounding points (see that file's
// header): f32 scores and softmax, the dropped probabilities rounded to
// bf16 before P V and dV, ds rounded to bf16 before dQ and dK, f32 sums,
// and the same dropout mask, the keyed hash of (seed, b, h, i, j) of
// `attention_dropout.cuh`.  The tensor cores add each product's terms in
// another order than the plain versions, so results agree to a bf16 ulp
// where a rounding flips, not to the bit.
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
// terms, 88.55 MB (0.0264 ms).  At EF-CapTrRoBERTa's L = 256: 9.664 GFLOP
// and 75.55 MB forward (0.0226 ms), 24.16 GFLOP and 133.3 MB backward
// (0.0398 ms).  All byte-bound, and so small that what is left once the
// products are on the tensor cores is load latency, the number of waves of
// blocks, and the exponentials and hashes of the softmax on the CUDA cores
// (B H L^2 = 16.6 M elements a pass at 170 rows).
//
// `wgmma` (m64nNk16) rather than `mma.sync`: the tiles in shared memory
// are read by the tensor cores directly through descriptors, whatever role
// an operand plays, so no `ldmatrix` pass and no transposed copy exists;
// the price is that L = 170 pads to 192 keys, not 176.
//
// Forward: one block of one warpgroup per (64-query tile, head, batch
// row).  Up to 192 rows the block holds the whole row of keys
// (`attention_fwd_wgmma_kernel`, 64, 128 or 192 keys, the narrowest that
// takes L); three blocks share an SM (58 KB of shared memory and at most
// 168 registers each), so one block's loads run under another's softmax.
// Q (8 KB), then K, then V are fetched as three groups of copies; S = Q K^T
// starts when Q and K have landed, V still in flight.  Scale, mask row and
// the key >= L cut (-inf) are applied to the accumulators; the row max and
// sum take two shuffles across the four lanes that share a row; the hash is
// drawn at each accumulator element's own (i, j); P is rounded to bf16 in
// registers, which is already the A fragment layout of P V.  The output
// tile is staged in Q's space and leaves 16 bytes a lane.  With an lse
// pointer the row logsumexp is stored for the backward.
// Past 192 rows (`attention_fwd_ring_kernel`) the keys are walked
// kRingKeys = 64 at a time, so 256 rows are 256 keys and not two passes of
// 192 (384), with a running max and sum; each pass's K, V and mask row sit
// in one stage of a two-stage ring in shared memory, and the next pass's
// copies are issued before this pass's products, so they land under its
// softmax.  42 KB of shared memory and 96 registers: five blocks an SM
// (128-key passes at three blocks an SM, and three stages, measured slower:
// `ablate_attention.py`).
//
// Backward up to 192 rows, one launch and no atomics
// (`attention_bwd_wgmma_kernel`): one block of three warpgroups per (head,
// batch row) holds Q, K, V and g of the head (4 x 24 KB), so every sum a
// gradient needs is taken inside the block, in a fixed order, and two calls
// give the same bits.
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
//
// Backward past 192 rows, two launches and no atomics: a head no longer
// fits one block, so the work is split as the CUDA-core variant splits it,
// and tiles stream through a two-stage ring instead of being held.  One
// warpgroup a block, 51 KB of shared memory, every sum in a fixed order:
// two calls give the same bits.  Launch 1 fits 128 registers, four blocks
// an SM; launch 2 needs 158, three (at 128 it spills).  A third stage, and
// half the streamed copies, measured no faster: the time is the products
// and the softmax of three passes over the scores, not the loads.
//   launch 1, dQ (`attention_bwd_dq_kernel`): one block per (64-query
//     tile, head, batch row) holds its Q and g tiles; the K and V tiles of
//     64 keys and their mask row stream through the ring, walked twice:
//     walk (a) forms S and dP and sums the row term rowsum(dp * p) (pass
//     1's body), which it stores to [B, H, L] f32 for launch 2; walk (b)
//     forms them again, ds = p (dp - row term) rounded to bf16 in
//     registers (already the A fragment), and dQ += ds K with K read
//     MN-major.
//   launch 2, dK and dV (`attention_bwd_dkdv_kernel`): one block per
//     (64-key tile, head, batch row) holds its K and V tiles; the Q and g
//     tiles of 64 queries, with their lse, row term and row hash, stream
//     through the ring: pass 2's body on the transposed tiles, without the
//     ds^T stores.
// The scores are computed three times (walks (a) and (b), launch 2), as in
// the CUDA-core variant, but on the tensor cores.

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
constexpr int kBwdRows = 192;             // the longest row the one-launch backward holds
constexpr int kBwdThreads = kBwdRows / kTile * kWG;
constexpr int kRingKeys = 64;             // keys a forward pass takes past kBwdRows rows
constexpr int kFwdStages = 2;             // the depth of the ring forward's ring
constexpr int kBwdStages = 2;             // and of the streaming backward's
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

// The streaming kernels' rings of STAGES stages: tile t sits in stage
// t % STAGES.  The copies of tiles 0 .. STAGES - 2 are issued before the
// loop, one group each; at step t, `ring_wait` returns once tile t has
// landed and every thread is done with tile t - 1, whose stage the copies
// of tile t + STAGES - 1 then refill (one group, empty past the last tile)
// while tile t is computed.
template <int STAGES>
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<STAGES - 2>();
  fence_async_proxy();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The running state of a block's forward: this thread's two query rows'
// max and sum, and its share of the 64 x 64 output accumulator.
struct ForwardState {
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[32] = {};
};

// One pass of the forward over keys [k0, k0 + NK): S = Q K^T, scale, mask
// row (`mrow`, -inf past L) and the row max; the exponentials, their sum
// (kept or not), dropout, and P as bf16 A fragments; the running max and
// sum; then, once `v_ready()` returns, o += P V.
template <int NK, typename VReady>
__device__ __forceinline__ void forward_pass(ForwardState& st, uint32_t q_addr, uint32_t k_addr,
                                             uint32_t v_addr, const float* mrow, int k0,
                                             float scale, const Dropout& drop, uint32_t key_lo,
                                             uint32_t key_hi, int col2, VReady v_ready) {
  float s[NK / 2];
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma::Op<NK>::template ss<0, 0>(s, desc_k(q_addr) + kk * kDescK16,
                                     desc_k(k_addr) + kk * kDescK16, kk > 0);
  wgmma::commit();
  wgmma::wait<0>();

  float mx_lo = st.m_lo, mx_hi = st.m_hi;
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
  const float corr_lo = __expf(st.m_lo - mx_lo), corr_hi = __expf(st.m_hi - mx_hi);  // 0 at first

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
  st.l_lo = st.l_lo * corr_lo + quad_sum(sum_lo);
  st.l_hi = st.l_hi * corr_hi + quad_sum(sum_hi);
  st.m_lo = mx_lo;
  st.m_hi = mx_hi;
  if (k0 > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st.o[4 * j] *= corr_lo;
      st.o[4 * j + 1] *= corr_lo;
      st.o[4 * j + 2] *= corr_hi;
      st.o[4 * j + 3] *= corr_hi;
    }
  }

  v_ready();
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma::Op<64>::rs(st.o, pf[kk], desc_mn(v_addr) + kk * kDescMnK16, 1);
  wgmma::commit();
  wgmma::wait<0>();
}

// Every product of the block is done: Q's space stages the output tile
// (each warp overwrites only the rows its own products read), the row
// logsumexp goes to `lse` if there is one, the tile to `out`.
__device__ __forceinline__ void finish_forward(const ForwardState& st, uint8_t* q_tile,
                                               bf16* __restrict__ out, float* __restrict__ lse,
                                               long long hd, long long stat, int q0, int L,
                                               int row_lo, int col2, int lane) {
  stage_tile(q_tile, st.o, 1.f / st.l_lo, 1.f / st.l_hi, row_lo, col2);
  const int i_lo = q0 + row_lo, i_hi = i_lo + 8;
  if (lse != nullptr && (lane & 3) == 0) {
    if (i_lo < L) lse[stat + i_lo] = st.m_lo + logf(st.l_lo);
    if (i_hi < L) lse[stat + i_hi] = st.m_hi + logf(st.l_hi);
  }
  __syncthreads();
  store_rows(q_tile, out, hd, q0, kTile, L, kWG);
}

template <int NK>
constexpr int fwd_smem() { return kAlign + kTileBytes + 2 * NK * kRowBytes + NK * 4; }

// NK: the keys of the row, padded (64, 128 or 192); L <= NK
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
  load_rows(k_addr, k + base, hd, 0, NK, L, kWG);
  cp_async_commit();  // Q and K
  load_rows(v_addr, v + base, hd, 0, NK, L, kWG);
  cp_async_commit();  // V
  for (int j = threadIdx.x; j < NK; j += kWG)
    mrow[j] = j < L ? mask[static_cast<long long>(b) * L + j] : -INFINITY;
  cp_async_wait<1>();
  fence_async_proxy();
  __syncthreads();  // Q, K and the mask row are there; V may still be in flight

  ForwardState st;
  const uint32_t key_lo = drop.on ? row_key(drop.seed, b, h, i_lo) : 0u;
  const uint32_t key_hi = drop.on ? row_key(drop.seed, b, h, i_hi) : 0u;
  forward_pass<NK>(st, q_addr, k_addr, v_addr, mrow, 0, scale, drop, key_lo, key_hi, col2, [] {
    cp_async_wait<0>();
    fence_async_proxy();
    __syncthreads();  // V is there
  });
  finish_forward(st, q_tile, out + base, lse, hd, (static_cast<long long>(b) * H + h) * L, q0, L,
                 row_lo, col2, lane);
}

template <int NK>
constexpr int fwd_ring_smem() {
  return kAlign + kTileBytes + kFwdStages * (2 * NK * kRowBytes + NK * 4);
}

// NK keys a pass (NK <= kWG: one mask value a thread), any L
template <int NK>
__global__ void __launch_bounds__(kWG, 5)
attention_fwd_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ mask,
                          bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                          float scale, Dropout drop) {
  static_assert(NK <= kWG, "one mask value a thread");
  constexpr int kStageBytes = 2 * NK * kRowBytes;  // K, then V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = aligned_smem(smem_raw);
  float* mrows = reinterpret_cast<float*>(q_tile + kTileBytes + kFwdStages * kStageBytes);
  const uint32_t q_addr = smem_u32(q_tile), ring = q_addr + kTileBytes;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long hd = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * kD;
  const int row_lo = warp * 16 + (lane >> 2), col2 = (lane & 3) * 2;
  const int i_lo = q0 + row_lo, i_hi = i_lo + 8;
  const float* mask_b = mask + static_cast<long long>(b) * L;
  // this thread's value of the mask row of the pass from key k0: -inf past L
  auto mask_at = [&](int k0) {
    const int j = k0 + threadIdx.x;
    return j < L ? mask_b[j] : -INFINITY;
  };
  const int passes = (L + NK - 1) / NK;
  auto load_pass = [&](int t) {  // pass t's copies, one group
    if (t < passes) {
      const uint32_t kv = ring + t % kFwdStages * kStageBytes;
      load_rows(kv, k + base, hd, t * NK, NK, L, kWG);
      load_rows(kv + NK * kRowBytes, v + base, hd, t * NK, NK, L, kWG);
    }
    cp_async_commit();
  };

  load_rows(q_addr, q + base, hd, q0, kTile, L, kWG);  // in pass 0's group
  for (int t = 0; t < kFwdStages - 1; ++t) {
    load_pass(t);
    if (t < passes && threadIdx.x < NK) mrows[t * NK + threadIdx.x] = mask_at(t * NK);
  }

  ForwardState st;
  const uint32_t key_lo = drop.on ? row_key(drop.seed, b, h, i_lo) : 0u;
  const uint32_t key_hi = drop.on ? row_key(drop.seed, b, h, i_hi) : 0u;
  for (int t = 0; t < passes; ++t) {
    const int stage = t % kFwdStages, ahead = t + kFwdStages - 1;
    ring_wait<kFwdStages>();
    load_pass(ahead);
    const bool fill = ahead < passes && threadIdx.x < NK;
    const float mask_ahead = fill ? mask_at(ahead * NK) : 0.f;  // stored after this pass
    const uint32_t k_addr = ring + stage * kStageBytes;
    forward_pass<NK>(st, q_addr, k_addr, k_addr + NK * kRowBytes, mrows + stage * NK, t * NK,
                     scale, drop, key_lo, key_hi, col2, [] {});
    if (fill) mrows[ahead % kFwdStages * NK + threadIdx.x] = mask_ahead;
  }
  finish_forward(st, q_tile, out + base, lse, hd, (static_cast<long long>(b) * H + h) * L, q0, L,
                 row_lo, col2, lane);
}

template <typename Kernel>
int launch_fwd_kernel(Kernel kernel, int smem, const void* q, const void* k, const void* v,
                      const void* mask, void* out, void* lse, int B, int L, int H, Dropout drop,
                      cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kWG, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), static_cast<float*>(lse), L, H,
      1.0f / sqrtf(static_cast<float>(kD)), drop);
  return static_cast<int>(cudaGetLastError());
}

template <int NK>
int launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
               int B, int L, int H, Dropout drop, cudaStream_t s) {
  return launch_fwd_kernel(attention_fwd_wgmma_kernel<NK>, fwd_smem<NK>(), q, k, v, mask, out,
                           lse, B, L, H, drop, s);
}

template <int NK>
int launch_fwd_ring(const void* q, const void* k, const void* v, const void* mask, void* out,
                    void* lse, int B, int L, int H, Dropout drop, cudaStream_t s) {
  return launch_fwd_kernel(attention_fwd_ring_kernel<NK>, fwd_ring_smem<NK>(), q, k, v, mask,
                           out, lse, B, L, H, drop, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kHeadBytes = kBwdRows * kRowBytes;  // one of Q, K, V, g; one ds^T query tile
constexpr int kBwdSmem = kAlign + 4 * kHeadBytes + (kBwdRows / kTile) * kHeadBytes +
                         4 * kBwdRows * 4;
// the streaming backward: two held tiles, a ring of two tiles a stage, and
// a stage's vectors (launch 1: the mask row; launch 2: lse, row term, hash)
constexpr int kRingVec = 3 * kTile;  // 4-byte values a stage
constexpr int kBwdRingSmem = kAlign + 2 * kTileBytes + kBwdStages * 2 * kTileBytes +
                             kBwdStages * kRingVec * 4;

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

// S = A_s B_s^T and dP = A_d B_d^T of one 64 x 64 tile pair, every operand
// a K-major tile (rows are M or N, the head's 64 values k)
__device__ __forceinline__ void tile_products(float (&s)[32], float (&dp)[32], uint32_t a_s,
                                              uint32_t b_s, uint32_t a_d, uint32_t b_d) {
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma::Op<64>::ss<0, 0>(s, desc_k(a_s) + kk * kDescK16, desc_k(b_s) + kk * kDescK16, kk > 0);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma::Op<64>::ss<0, 0>(dp, desc_k(a_d) + kk * kDescK16, desc_k(b_d) + kk * kDescK16, kk > 0);
  wgmma::commit();
  wgmma::wait<0>();
}

// Query tile by key tile (rows queries, columns keys k0 + 8j + col2, the
// mask row of the tile at `mrow`): the dropped dp * p of each element, or,
// with `term` (the row terms of the thread's two queries), ds = p (dp -
// term) as bf16 A fragments of dQ += ds K.
template <bool kDs>
__device__ __forceinline__ void query_tile_walk(const float (&s)[32], const float (&dp)[32],
                                                const float* mrow, int k0, int col2, float scale,
                                                float lse_lo, float lse_hi, const Dropout& drop,
                                                uint32_t key_lo, uint32_t key_hi, float& term_lo,
                                                float& term_hi, uint32_t (&dsf)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + 8 * j + col2;
    const float2 mk = *reinterpret_cast<const float2*>(mrow + 8 * j + col2);
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Element el = element(s[4 * j + e], dp[4 * j + e], scale, e & 1 ? mk.y : mk.x,
                                 e < 2 ? lse_lo : lse_hi, drop, e < 2 ? key_lo : key_hi,
                                 key + (e & 1));
      if (kDs) {
        ds[e] = el.p * (el.dp - (e < 2 ? term_lo : term_hi));
      } else if (e < 2) {
        term_lo = fmaf(el.dp, el.p, term_lo);
      } else {
        term_hi = fmaf(el.dp, el.p, term_hi);
      }
    }
    if (kDs) {
      dsf[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
  }
}

// Key tile by query tile, on the transposed tiles S^T and dP^T (rows the
// thread's keys j_lo and j_hi with their mask values, columns the queries
// of the tile whose lse, row term and row hash start at `lse_t`, `term_t`,
// `rkey_t`): pd^T and ds^T as bf16 A fragments of dV += pd^T g and
// dK += ds^T Q, and, with `ds_out`, ds^T into that swizzled tile at rows
// j_lo and j_hi.
template <bool kStoreDsT>
__device__ __forceinline__ void key_tile_walk(const float (&s)[32], const float (&dp)[32],
                                              const float* lse_t, const float* term_t,
                                              const uint32_t* rkey_t, float mk_lo, float mk_hi,
                                              int j_lo, int j_hi, int col2, float scale,
                                              const Dropout& drop, uint32_t (&pdf)[4][4],
                                              uint32_t (&dsf)[4][4], uint8_t* ds_out) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = 8 * j + col2;  // this column pair's first query in the tile
    const float2 ls = *reinterpret_cast<const float2*>(lse_t + i);
    const float2 tm = *reinterpret_cast<const float2*>(term_t + i);
    const uint2 rk = *reinterpret_cast<const uint2*>(rkey_t + i);
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
    if (kStoreDsT) {
      *reinterpret_cast<uint32_t*>(ds_out + swizzled(j_lo, j) + col2 * 2) = ds_lo;
      *reinterpret_cast<uint32_t*>(ds_out + swizzled(j_hi, j) + col2 * 2) = ds_hi;
    }
  }
}

// acc += A B for the four k steps of a 64-deep tile: A the bf16 fragments,
// B the MN-major tile at `b_tile`
__device__ __forceinline__ void add_fragment_products(float (&acc)[32], const uint32_t (&a)[4][4],
                                                      uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma::Op<64>::rs(acc, a[kk], desc_mn(b_tile) + kk * kDescMnK16, 1);
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
    uint32_t unused[4][4];
    for (int kt = 0; kt < tiles; ++kt) {
      float s[32], dp[32];
      tile_products(s, dp, q_addr + own, k_addr + kt * kTileBytes, g_addr + own,
                    v_addr + kt * kTileBytes);
      query_tile_walk<false>(s, dp, mrow + kt * kTile, kt * kTile, col2, scale, lse_lo, lse_hi,
                             drop, key_lo, key_hi, term_lo, term_hi, unused);
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
      tile_products(s, dp, k_addr + own, q_addr + qt * kTileBytes, v_addr + own,
                    g_addr + qt * kTileBytes);
      uint32_t pdf[4][4], dsf[4][4];
      const int i0 = qt * kTile;
      key_tile_walk<true>(s, dp, lse_s + i0, term_s + i0, rkey + i0, mk_lo, mk_hi, j_lo, j_hi,
                          col2, scale, drop, pdf, dsf, dst_tile + qt * kHeadBytes);
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

// Launch 1 of the streaming backward: dQ and the row term of one 64-query
// tile.  Tile t of the ring is key tile t % tiles: walk (a) for t < tiles,
// walk (b) after.
__global__ void __launch_bounds__(kWG, 4)
attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ mask,
                        const bf16* __restrict__ gout, const float* __restrict__ lse,
                        float* __restrict__ row_term, bf16* __restrict__ dq, int L, int H,
                        float scale, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = aligned_smem(smem_raw);
  float* mrows = reinterpret_cast<float*>(q_tile + 2 * kTileBytes + kBwdStages * 2 * kTileBytes);
  const uint32_t q_addr = smem_u32(q_tile), g_addr = q_addr + kTileBytes;
  const uint32_t ring = g_addr + kTileBytes;  // stage s: K at ring + s * 2 tiles, V after it

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long hd = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * kD;
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  const int row_lo = warp * 16 + (lane >> 2), col2 = (lane & 3) * 2;
  const int i_lo = q0 + row_lo, i_hi = i_lo + 8;  // this thread's two queries
  const int tiles = (L + kTile - 1) / kTile, walked = 2 * tiles;
  const float* mask_b = mask + static_cast<long long>(b) * L;
  auto mask_at = [&](int k0) {  // this thread's value of a key tile's mask row
    const int j = k0 + threadIdx.x;
    return j < L ? mask_b[j] : -INFINITY;
  };
  auto key0 = [&](int t) { return (t < tiles ? t : t - tiles) * kTile; };  // step t's keys
  auto load_tile = [&](int t) {  // step t's copies, one group
    if (t < walked) {
      const uint32_t kv = ring + t % kBwdStages * 2 * kTileBytes;
      load_rows(kv, k + base, hd, key0(t), kTile, L, kWG);
      load_rows(kv + kTileBytes, v + base, hd, key0(t), kTile, L, kWG);
    }
    cp_async_commit();
  };

  load_rows(q_addr, q + base, hd, q0, kTile, L, kWG);  // in step 0's group
  load_rows(g_addr, gout + base, hd, q0, kTile, L, kWG);
  for (int t = 0; t < kBwdStages - 1; ++t) {
    load_tile(t);
    if (t < walked && threadIdx.x < kTile) mrows[t * kTile + threadIdx.x] = mask_at(key0(t));
  }
  const float lse_lo = i_lo < L ? lse[stat + i_lo] : INFINITY;  // p = 0 for a query >= L
  const float lse_hi = i_hi < L ? lse[stat + i_hi] : INFINITY;
  const uint32_t key_lo = drop.on ? row_key(drop.seed, b, h, i_lo) : 0u;
  const uint32_t key_hi = drop.on ? row_key(drop.seed, b, h, i_hi) : 0u;

  float term_lo = 0.f, term_hi = 0.f, acc_q[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_q[i] = 0.f;
  for (int t = 0; t < walked; ++t) {
    const int stage = t % kBwdStages, ahead = t + kBwdStages - 1, k0 = key0(t);
    ring_wait<kBwdStages>();
    load_tile(ahead);
    const bool fill = ahead < walked && threadIdx.x < kTile;
    const float mask_ahead = fill ? mask_at(key0(ahead)) : 0.f;  // stored after this tile
    const uint32_t k_addr = ring + stage * 2 * kTileBytes;
    float s[32], dp[32];
    tile_products(s, dp, q_addr, k_addr, g_addr, k_addr + kTileBytes);
    uint32_t dsf[4][4];
    if (t < tiles) {  // walk (a): the row term
      query_tile_walk<false>(s, dp, mrows + stage * kTile, k0, col2, scale, lse_lo, lse_hi, drop,
                             key_lo, key_hi, term_lo, term_hi, dsf);
      if (t + 1 == tiles) {
        term_lo = quad_sum(term_lo);
        term_hi = quad_sum(term_hi);
        if ((lane & 3) == 0) {
          if (i_lo < L) row_term[stat + i_lo] = term_lo;
          if (i_hi < L) row_term[stat + i_hi] = term_hi;
        }
      }
    } else {  // walk (b): dQ += ds K
      query_tile_walk<true>(s, dp, mrows + stage * kTile, k0, col2, scale, lse_lo, lse_hi, drop,
                            key_lo, key_hi, term_lo, term_hi, dsf);
      wgmma::fence();
      add_fragment_products(acc_q, dsf, k_addr);
      wgmma::commit();
      wgmma::wait<0>();
    }
    if (fill) mrows[ahead % kBwdStages * kTile + threadIdx.x] = mask_ahead;
  }
  // each warp's products read only its own rows of Q: its rows stage dQ
  stage_tile(q_tile, acc_q, scale, scale, row_lo, col2);
  __syncthreads();
  store_rows(q_tile, dq + base, hd, q0, kTile, L, kWG);
}

// Launch 2 of the streaming backward: dK and dV of one 64-key tile, the
// query tiles streamed with their lse, row term (from launch 1) and row hash.
__global__ void __launch_bounds__(kWG, 3)
attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ mask,
                          const bf16* __restrict__ gout, const float* __restrict__ lse,
                          const float* __restrict__ row_term, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int L, int H, float scale, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_tile = aligned_smem(smem_raw);
  uint8_t* v_tile = k_tile + kTileBytes;
  float* vecs = reinterpret_cast<float*>(v_tile + kTileBytes + kBwdStages * 2 * kTileBytes);
  const uint32_t k_addr = smem_u32(k_tile), v_addr = k_addr + kTileBytes;
  const uint32_t ring = v_addr + kTileBytes;  // stage s: Q at ring + s * 2 tiles, g after it

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long hd = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * kD;
  const long long stat = (static_cast<long long>(b) * H + h) * L;
  const int row_lo = warp * 16 + (lane >> 2), col2 = (lane & 3) * 2;
  const int j_lo = j0 + row_lo, j_hi = j_lo + 8;  // this thread's two keys
  const int tiles = (L + kTile - 1) / kTile;
  // a stage's vectors: lse (+inf past L: p = 0), row term, row hash of 64
  // queries; thread t < 64 brings query t's lse and hash, thread t >= 64
  // query t - 64's row term
  const int vq = threadIdx.x & (kTile - 1);
  const bool vlse = threadIdx.x < kTile;
  auto vec_at = [&](int i0) {
    const int i = i0 + vq;
    if (vlse) return i < L ? lse[stat + i] : INFINITY;
    return i < L ? row_term[stat + i] : 0.f;
  };
  auto put_vec = [&](int t, float x) {  // into step t's stage
    float* vec = vecs + t % kBwdStages * kRingVec;
    vec[(vlse ? 0 : kTile) + vq] = x;
    if (vlse)
      reinterpret_cast<uint32_t*>(vec)[2 * kTile + vq] =
          drop.on ? row_key(drop.seed, b, h, t * kTile + vq) : 0u;
  };
  auto load_tile = [&](int t) {  // step t's copies, one group
    if (t < tiles) {
      const uint32_t qg = ring + t % kBwdStages * 2 * kTileBytes;
      load_rows(qg, q + base, hd, t * kTile, kTile, L, kWG);
      load_rows(qg + kTileBytes, gout + base, hd, t * kTile, kTile, L, kWG);
    }
    cp_async_commit();
  };

  load_rows(k_addr, k + base, hd, j0, kTile, L, kWG);  // in step 0's group
  load_rows(v_addr, v + base, hd, j0, kTile, L, kWG);
  for (int t = 0; t < kBwdStages - 1; ++t) {
    load_tile(t);
    if (t < tiles) put_vec(t, vec_at(t * kTile));
  }
  const float* mask_b = mask + static_cast<long long>(b) * L;
  const float mk_lo = j_lo < L ? mask_b[j_lo] : -INFINITY;
  const float mk_hi = j_hi < L ? mask_b[j_hi] : -INFINITY;

  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;
  for (int qt = 0; qt < tiles; ++qt) {
    const int stage = qt % kBwdStages, ahead = qt + kBwdStages - 1;
    ring_wait<kBwdStages>();
    load_tile(ahead);
    const float vec_ahead = ahead < tiles ? vec_at(ahead * kTile) : 0.f;  // stored after the tile
    const uint32_t qg = ring + stage * 2 * kTileBytes;
    const float* vec = vecs + stage * kRingVec;
    const uint32_t* rkey = reinterpret_cast<const uint32_t*>(vec) + 2 * kTile;
    float s[32], dp[32];
    tile_products(s, dp, k_addr, qg, v_addr, qg + kTileBytes);
    uint32_t pdf[4][4], dsf[4][4];
    key_tile_walk<false>(s, dp, vec, vec + kTile, rkey, mk_lo, mk_hi, j_lo, j_hi, col2, scale, drop,
                         pdf, dsf, nullptr);
    wgmma::fence();
    add_fragment_products(acc_v, pdf, qg + kTileBytes);
    add_fragment_products(acc_k, dsf, qg);
    wgmma::commit();
    wgmma::wait<0>();
    if (ahead < tiles) put_vec(ahead, vec_ahead);
  }
  // each warp's products read only its own rows of K and V: they stage dK, dV
  stage_tile(k_tile, acc_k, scale, scale, row_lo, col2);
  stage_tile(v_tile, acc_v, 1.f, 1.f, row_lo, col2);
  __syncthreads();
  store_rows(k_tile, dk + base, hd, j0, kTile, L, kWG);
  store_rows(v_tile, dv + base, hd, j0, kTile, L, kWG);
}

bool bad_geometry(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

int launch_bwd_streamed(const void* q, const void* k, const void* v, const void* mask,
                        const void* g, const void* lse, void* row_term, void* dq, void* dk,
                        void* dv, int B, int L, int H, Dropout drop, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdRingSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdRingSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(kD));
  attention_bwd_dq_kernel<<<grid, kWG, kBwdRingSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<float*>(row_term), static_cast<bf16*>(dq), L,
      H, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<<<grid, kWG, kBwdRingSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(row_term),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, H, scale, drop);
  return static_cast<int>(cudaGetLastError());
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
  if (L <= 192) return launch_fwd<192>(q, k, v, mask, out, lse, B, L, H, drop, s);
  return launch_fwd_ring<kRingKeys>(q, k, v, mask, out, lse, B, L, H, drop, s);
}

// K1's backward on the tensor cores.  g/dq/dk/dv like q; lse: the
// forward's [B, H, L] f32 row logsumexp; row_term: [B, H, L] f32 scratch
// for rows longer than kBwdRows (may be NULL up to there).  Up to kBwdRows
// one launch holds a head in a block; past it two launches stream the
// tiles.  Returns cudaGetLastError() after the (last) launch.
extern "C" int macsa_fused_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                               const void* mask, const void* g, const void* lse,
                                               void* row_term, void* dq, void* dk, void* dv,
                                               int B, int L, int H, int dropout,
                                               unsigned keep_threshold, float inv_keep,
                                               unsigned seed, void* stream) {
  if (bad_geometry(B, L, H)) return cudaErrorInvalidValue;
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > kBwdRows) {
    if (row_term == nullptr) return cudaErrorInvalidValue;
    return launch_bwd_streamed(q, k, v, mask, g, lse, row_term, dq, dk, dv, B, L, H, drop, s);
  }
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_wgmma_kernel<<<dim3(H, B), kBwdThreads, kBwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, H, 1.0f / sqrtf(static_cast<float>(kD)), drop);
  return static_cast<int>(cudaGetLastError());
}

// The streaming two-launch backward at any L, whatever the length: what
// `macsa_fused_attention_bwd_wgmma` runs past kBwdRows rows, callable at
// shorter rows to measure it beside the one-launch kernel.  The port's
// wrappers never call it.
extern "C" int macsa_fused_attention_bwd_wgmma_streamed(
    const void* q, const void* k, const void* v, const void* mask, const void* g,
    const void* lse, void* row_term, void* dq, void* dk, void* dv, int B, int L, int H,
    int dropout, unsigned keep_threshold, float inv_keep, unsigned seed, void* stream) {
  if (bad_geometry(B, L, H) || row_term == nullptr) return cudaErrorInvalidValue;
  return launch_bwd_streamed(q, k, v, mask, g, lse, row_term, dq, dk, dv, B, L, H,
                             attention::make_dropout(dropout, keep_threshold, inv_keep, seed),
                             static_cast<cudaStream_t>(stream));
}
