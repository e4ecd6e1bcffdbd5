// Fused multi-head self-attention with dropout, forward and backward
// (kernel K1) for Hopper (sm_90a): the CUDA-core variant.
//
// Replaces: macsa_tpu/ops/fused_attention.py, `_fwd_kernel` (forward) and
// `_bwd_kernel` (backward), both wired by `_call` into the custom VJP
// `fused_self_attention`, with the in-kernel dropout of `_keep_mask`.
// Per batch row and head:
//   p   = softmax(q k^T / sqrt(d) + mask_row)           (f32)
//   pd  = keep ? p / (1 - rate) : 0                      (dropout after softmax)
//   out = pd v
// and for the cotangent g:
//   dv = pd^T g,  dp = keep ? (g v^T) / (1 - rate) : 0,
//   ds = p * (dp - rowsum(dp * p)),  dq = ds k scale,  dk = ds^T q scale
// with keys >= L dropped exactly, f32 accumulation, and the TPU kernel's
// rounding points: the dropped probs are rounded to the V dtype before
// P @ V and dV, and ds to the Q dtype before dQ and dK.
//
// Dropout mask: a keyed 32-bit hash of (seed, b, h, i, j) alone,
//   bits = mix(mix(mix(mix(mix(seed) ^ b) ^ h) ^ i) ^ j),  keep = bits >= threshold,
// so the forward (query tiles) and the backward (query and key tiles) draw
// the same bits whatever block computes an element.  Hopper blocks run in
// no order, so the TPU kernel's draw-in-a-fixed-order stream does not carry
// over.  The hash lives in `attention_dropout.cuh`; `dropout_bits` in
// ops/fused_attention.py is the same function.
//
// Layout: q/k/v/g/out/dq/dk/dv are [B, L, H*D] (the projections' own layout);
// element x[b, i, h*D + c] is read in place, so no head transpose runs
// around the kernels.  mask is the [B, L] additive f32 row, broadcast over
// heads and queries.  lse and row_term are [B, H, L] f32.
//
// What bounds them on the H100 (3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores): the forward is 4 B H L^2 D operations, the backward
// 10 B H L^2 D (the scores again, dP, dV, dQ, dK), over q, k, v, the output
// (or g, dq, dk, dv), the mask row and f32 row terms moved once each.  These
// CUDA-core kernels recompute: the forward reads K and V once per query tile,
// the backward forms the scores and dP three times (~22 B H L^2 D of
// products in all), so they are bound by shared-memory traffic and FMA
// throughput, not by device memory.
// They are the variant for head width 32, f32 or bf16, at any length, which
// no path of the port reaches (`chip_smoke.py` phase k1_head_width_32 holds
// them to their plain versions); at head width 64 bf16 runs the tensor-core
// variant of `fused_attention_wgmma.cu` and f32 the three-TF32-product one
// of `fused_attention_tf32.cu`, at any length, both ways (picked by
// `attention_variant` in ops/fused_attention.py).
//
// Design.  Forward: one block per (query tile of 32 rows, head, batch row);
// 4 warps, each owning 8 query rows.  The block walks the keys in tiles of
// 32 (one key per lane) with an online softmax (running max and sum per
// row, accumulator rescaled per tile).  The running sum takes every
// exponential; only the accumulator takes the kept ones, scaled.  With an
// lse pointer it also stores each row's logsumexp for the backward.
// Backward, two launches and no atomics, so sums are deterministic:
//   1. dq: one block per (query tile, head, row), shaped like the forward.
//      A first walk over the key tiles sums rowsum(dp * p) per query (as
//      the TPU kernel does, not from the rounded output), which it also
//      stores for launch 2; a second walk forms ds and accumulates dq.
//   2. dk/dv: one block per (key tile of 32, head, row); each warp owns 8
//      keys and the lanes walk the queries, 32 per tile.
// Scores and probabilities are recomputed from q, k and the saved row
// logsumexp.  Tiles are f32 in shared memory (< 48 KB, no opt-in needed):
// rows that a warp reads as float4 broadcasts, and transposed tiles with
// one column of padding, so per-lane reads and the transposing stores are
// free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_dropout.cuh"

namespace {

using attention::Dropout;
using attention::row_key;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTile = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kBlockK = 32;                   // keys (or queries) per walked tile: one per lane
static_assert(kTile == kBlockK, "a block's rows and a walked tile are both 32 wide");
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the rounding point of a product's operand
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Geometry {
  long long hd, base;  // row stride H*D; offset of (b, 0, h*D)
  const float* mrow;   // mask row b
  long long stat;      // offset of (b, h, 0) in lse / row_term
};

template <int D>
__device__ __forceinline__ Geometry geometry(const float* mask, int b, int h, int L, int H) {
  Geometry g;
  g.hd = static_cast<long long>(H) * D;
  g.base = static_cast<long long>(b) * L * g.hd + static_cast<long long>(h) * D;
  g.mrow = mask + static_cast<long long>(b) * L;
  g.stat = (static_cast<long long>(b) * H + h) * L;
  return g;
}

// rows [r0, r0 + 32) of x (head slice) into dst[r][c] as f32, zeros past L
template <typename T, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D], const T* __restrict__ x,
                                          const Geometry& g, int r0, int L) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = r0 + r;
    dst[r][c] = i < L ? to_f32(x[g.base + i * g.hd + c]) : 0.f;
  }
}

// rows [r0, r0 + 32) of x transposed into dst[c][r], zeros past L
template <typename T, int D>
__device__ __forceinline__ void load_cols(float (*dst)[kBlockK + 1], const T* __restrict__ x,
                                          const Geometry& g, int r0, int L) {
  for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, i = r0 + r;
    dst[c][r] = i < L ? to_f32(x[g.base + i * g.hd + c]) : 0.f;
  }
}

// s[r] = rows[row0 + r] . cols[:, lane] for the warp's 8 rows
template <int D>
__device__ __forceinline__ void dot_rows(float (&s)[kRowsPerWarp], const float (*rows)[D],
                                         const float (*cols)[kBlockK + 1], int row0, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    const float c0 = cols[c][lane], c1 = cols[c + 1][lane];
    const float c2 = cols[c + 2][lane], c3 = cols[c + 3][lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 x4 = *reinterpret_cast<const float4*>(&rows[row0 + r][c]);
      s[r] = fmaf(x4.x, c0, s[r]);
      s[r] = fmaf(x4.y, c1, s[r]);
      s[r] = fmaf(x4.z, c2, s[r]);
      s[r] = fmaf(x4.w, c3, s[r]);
    }
  }
}

// acc[r][t] += sum_jj w[r][jj] * x(jj, lane + 32 t) over the 32 entries of a tile,
// where x(jj, c) = cols[c][jj] (a transposed tile)
template <int D>
__device__ __forceinline__ void accumulate_cols(float (&acc)[kRowsPerWarp][D / 32],
                                                const float (*w)[kBlockK],
                                                const float (*cols)[kBlockK + 1], int lane) {
#pragma unroll 2
  for (int jj = 0; jj < kBlockK; jj += 4) {
    float xv[4][D / 32];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int t = 0; t < D / 32; ++t) xv[u][t] = cols[lane + 32 * t][jj + u];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(&w[r][jj]);
#pragma unroll
      for (int t = 0; t < D / 32; ++t) {
        acc[r][t] = fmaf(w4.x, xv[0][t], acc[r][t]);
        acc[r][t] = fmaf(w4.y, xv[1][t], acc[r][t]);
        acc[r][t] = fmaf(w4.z, xv[2][t], acc[r][t]);
        acc[r][t] = fmaf(w4.w, xv[3][t], acc[r][t]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int L, int H,
                     float scale, Dropout drop) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDPL = D / 32;  // accumulator columns per lane
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ float kt[D][kBlockK + 1];  // K tile, transposed and padded
  __shared__ float vs[kBlockK][D];
  __shared__ __align__(16) float ps[kWarps][kRowsPerWarp][kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Geometry g = geometry<D>(mask, b, h, L, H);
  const int row0 = warp * kRowsPerWarp;

  load_rows<T, D>(qs, q, g, q0, L);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
  uint32_t key[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    key[r] = drop.on ? row_key(drop.seed, b, h, q0 + row0 + r) : 0u;
#pragma unroll
    for (int t = 0; t < kDPL; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D, j = k0 + r;
      const long long off = g.base + j * g.hd + c;
      kt[c][r] = j < L ? to_f32(k[off]) : 0.f;
      vs[r][c] = j < L ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;  // this lane's key
    const bool valid = j < L;
    const float mj = valid ? g.mrow[j] : 0.f;
    float s[kRowsPerWarp];
    dot_rows<D>(s, qs, kt, row0, lane);

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale + mj : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // finite: lane 0's key is < L
      const float corr = expf(m[r] - m_new);          // 0 on the first tile
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);  // every exponential, kept or not
      m[r] = m_new;
      float pd = p;
      if (drop.on) pd = drop.keep(key[r], j) ? p * drop.inv_keep : 0.f;
      ps[warp][r][lane] = round_to<T>(pd);  // probs in the V dtype
#pragma unroll
      for (int t = 0; t < kDPL; ++t) acc[r][t] *= corr;
    }
    __syncwarp();

#pragma unroll 2
    for (int jj = 0; jj < kBlockK; jj += 4) {
      float vv[4][kDPL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int t = 0; t < kDPL; ++t) vv[u][t] = vs[jj + u][lane + 32 * t];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&ps[warp][r][jj]);
#pragma unroll
        for (int t = 0; t < kDPL; ++t) {
          acc[r][t] = fmaf(p4.x, vv[0][t], acc[r][t]);
          acc[r][t] = fmaf(p4.y, vv[1][t], acc[r][t]);
          acc[r][t] = fmaf(p4.z, vv[2][t], acc[r][t]);
          acc[r][t] = fmaf(p4.w, vv[3][t], acc[r][t]);
        }
      }
    }
    __syncwarp();  // ps is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + row0 + r;
    if (i >= L) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int t = 0; t < kDPL; ++t)
      out[g.base + i * g.hd + lane + 32 * t] = from_f32<T>(acc[r][t] * inv);
    if (lse != nullptr && lane == 0) lse[g.stat + i] = m[r] + logf(l[r]);
  }
}

// Backward launch 1: dq, and the row term rowsum(dp * p) for launch 2.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        const T* __restrict__ gout, const float* __restrict__ lse,
                        float* __restrict__ row_term, T* __restrict__ dq, int L, int H,
                        float scale, Dropout drop) {
  constexpr int kDPL = D / 32;
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float gs[kTile][D];
  __shared__ float kt[D][kBlockK + 1];
  __shared__ float vt[D][kBlockK + 1];
  __shared__ __align__(16) float dss[kWarps][kRowsPerWarp][kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Geometry g = geometry<D>(mask, b, h, L, H);
  const int row0 = warp * kRowsPerWarp;

  load_rows<T, D>(qs, q, g, q0, L);
  load_rows<T, D>(gs, gout, g, q0, L);

  float row_lse[kRowsPerWarp], rsum[kRowsPerWarp];
  uint32_t key[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + row0 + r;
    row_lse[r] = i < L ? lse[g.stat + i] : 0.f;
    rsum[r] = 0.f;
    key[r] = drop.on ? row_key(drop.seed, b, h, i) : 0u;
  }

  // p and dp of this lane's key for the warp's rows
  auto probs = [&](int j, float (&p)[kRowsPerWarp], float (&dp)[kRowsPerWarp]) {
    const bool valid = j < L;
    const float mj = valid ? g.mrow[j] : 0.f;
    float s[kRowsPerWarp];
    dot_rows<D>(s, qs, kt, row0, lane);
    dot_rows<D>(dp, gs, vt, row0, lane);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      p[r] = valid ? expf(s[r] * scale + mj - row_lse[r]) : 0.f;
      if (drop.on) dp[r] = drop.keep(key[r], j) ? dp[r] * drop.inv_keep : 0.f;
    }
  };

  // walk 1: the row term
  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    load_cols<T, D>(kt, k, g, k0, L);
    load_cols<T, D>(vt, v, g, k0, L);
    __syncthreads();
    float p[kRowsPerWarp], dp[kRowsPerWarp];
    probs(k0 + lane, p, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) rsum[r] = fmaf(dp[r], p[r], rsum[r]);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) rsum[r] = warp_sum(rsum[r]);

  // walk 2: ds, then dq += ds k
  float acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int t = 0; t < kDPL; ++t) acc[r][t] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    load_cols<T, D>(kt, k, g, k0, L);
    load_cols<T, D>(vt, v, g, k0, L);
    __syncthreads();
    float p[kRowsPerWarp], dp[kRowsPerWarp];
    probs(k0 + lane, p, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      dss[warp][r][lane] = round_to<T>(p[r] * (dp[r] - rsum[r]));
    __syncwarp();
    accumulate_cols<D>(acc, dss[warp], kt, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + row0 + r;
    if (i >= L) continue;
#pragma unroll
    for (int t = 0; t < kDPL; ++t)
      dq[g.base + i * g.hd + lane + 32 * t] = from_f32<T>(acc[r][t] * scale);
    if (lane == 0) row_term[g.stat + i] = rsum[r];
  }
}

// Backward launch 2: dk and dv for a tile of 32 keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          const T* __restrict__ gout, const float* __restrict__ lse,
                          const float* __restrict__ row_term, T* __restrict__ dk,
                          T* __restrict__ dv, int L, int H, float scale, Dropout drop) {
  constexpr int kDPL = D / 32;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];
  __shared__ float qt[D][kBlockK + 1];
  __shared__ float gt[D][kBlockK + 1];
  __shared__ __align__(16) float pds[kWarps][kRowsPerWarp][kBlockK];
  __shared__ __align__(16) float dss[kWarps][kRowsPerWarp][kBlockK];
  __shared__ float lse_s[kBlockK], rt_s[kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Geometry g = geometry<D>(mask, b, h, L, H);
  const int row0 = warp * kRowsPerWarp;  // this warp's keys: k0 + row0 + r

  load_rows<T, D>(ks, k, g, k0, L);
  load_rows<T, D>(vs, v, g, k0, L);

  float mj[kRowsPerWarp];
  bool jvalid[kRowsPerWarp];
  float acc_k[kRowsPerWarp][kDPL], acc_v[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int j = k0 + row0 + r;
    jvalid[r] = j < L;
    mj[r] = jvalid[r] ? g.mrow[j] : 0.f;
#pragma unroll
    for (int t = 0; t < kDPL; ++t) acc_k[r][t] = acc_v[r][t] = 0.f;
  }

  for (int i0 = 0; i0 < L; i0 += kBlockK) {
    __syncthreads();
    load_cols<T, D>(qt, q, g, i0, L);
    load_cols<T, D>(gt, gout, g, i0, L);
    if (tid < kBlockK) {
      const int i = i0 + tid;
      lse_s[tid] = i < L ? lse[g.stat + i] : 0.f;
      rt_s[tid] = i < L ? row_term[g.stat + i] : 0.f;
    }
    __syncthreads();

    const int i = i0 + lane;  // this lane's query
    const bool ivalid = i < L;
    const float lse_i = lse_s[lane], rt_i = rt_s[lane];
    const uint32_t key = drop.on ? row_key(drop.seed, b, h, i) : 0u;
    float s[kRowsPerWarp], dpd[kRowsPerWarp];
    dot_rows<D>(s, ks, qt, row0, lane);
    dot_rows<D>(dpd, vs, gt, row0, lane);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = (ivalid && jvalid[r]) ? expf(s[r] * scale + mj[r] - lse_i) : 0.f;
      float pd = p, dp = dpd[r];
      if (drop.on) {
        const bool kp = drop.keep(key, k0 + row0 + r);
        pd = kp ? p * drop.inv_keep : 0.f;
        dp = kp ? dp * drop.inv_keep : 0.f;
      }
      pds[warp][r][lane] = round_to<T>(pd);
      dss[warp][r][lane] = round_to<T>(p * (dp - rt_i));
    }
    __syncwarp();
    accumulate_cols<D>(acc_v, pds[warp], gt, lane);
    accumulate_cols<D>(acc_k, dss[warp], qt, lane);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!jvalid[r]) continue;
    const long long off = g.base + (k0 + row0 + r) * g.hd;
#pragma unroll
    for (int t = 0; t < kDPL; ++t) {
      dk[off + lane + 32 * t] = from_f32<T>(acc_k[r][t] * scale);
      dv[off + lane + 32 * t] = from_f32<T>(acc_v[r][t]);
    }
  }
}

template <typename T, int D>
void launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* out,
                void* lse, int B, int L, int H, Dropout drop, cudaStream_t stream) {
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  attention_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), L, H,
      1.0f / sqrtf(static_cast<float>(D)), drop);
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* mask, const void* g,
               const void* lse, void* row_term, void* dq, void* dk, void* dv, int B, int L,
               int H, Dropout drop, cudaStream_t stream) {
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k);
  const T *vp = static_cast<const T*>(v), *gp = static_cast<const T*>(g);
  const float* mp = static_cast<const float*>(mask);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, mp, gp, static_cast<const float*>(lse), static_cast<float*>(row_term),
      static_cast<T*>(dq), L, H, scale, drop);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  attention_bwd_dkdv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, mp, gp, static_cast<const float*>(lse), static_cast<const float*>(row_term),
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

bool bad_geometry(int B, int L, int H) {
  return B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535;
}

}  // namespace

// q/k/v/out: [B, L, H*D] contiguous, D = 32, f32 (bf16 == 0) or bf16 (bf16 == 1);
// mask: [B, L] f32; lse: [B, H, L] f32, or NULL when no backward follows.
// Dropout when `dropout` != 0: keep iff bits >= keep_threshold, kept probs
// scaled by inv_keep.  Returns cudaGetLastError() after the launch.
extern "C" int macsa_fused_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, void* lse, int B,
                                         int L, int H, int D, int bf16, int dropout,
                                         unsigned keep_threshold, float inv_keep,
                                         unsigned seed, void* stream) {
  if (bad_geometry(B, L, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  if (D != 32) return cudaErrorInvalidValue;
  bf16 ? launch_fwd<__nv_bfloat16, 32>(q, k, v, mask, out, lse, B, L, H, drop, s)
       : launch_fwd<float, 32>(q, k, v, mask, out, lse, B, L, H, drop, s);
  return static_cast<int>(cudaGetLastError());
}

// g/dq/dk/dv: [B, L, H*D] like q; lse: the forward's [B, H, L] f32 row
// logsumexp; row_term: [B, H, L] f32 scratch.  Two launches on `stream`.
// Returns the first launch error, or cudaSuccess.
extern "C" int macsa_fused_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* mask, const void* g, const void* lse,
                                         void* row_term, void* dq, void* dk, void* dv, int B,
                                         int L, int H, int D, int bf16, int dropout,
                                         unsigned keep_threshold, float inv_keep,
                                         unsigned seed, void* stream) {
  if (bad_geometry(B, L, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = attention::make_dropout(dropout, keep_threshold, inv_keep, seed);
  if (D != 32) return cudaErrorInvalidValue;
  return bf16 ? launch_bwd<__nv_bfloat16, 32>(q, k, v, mask, g, lse, row_term, dq, dk, dv, B,
                                              L, H, drop, s)
              : launch_bwd<float, 32>(q, k, v, mask, g, lse, row_term, dq, dk, dv, B, L, H,
                                      drop, s);
}
