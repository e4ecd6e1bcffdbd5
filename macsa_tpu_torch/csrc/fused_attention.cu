// Fused multi-head self-attention forward (kernel K1) for Hopper (sm_90a).
//
// Replaces: macsa_tpu/ops/fused_attention.py, `_fwd_kernel` (wired by `_call`
// into `fused_self_attention`), at dropout rate 0.  Per batch row and head:
//   out = softmax(q k^T / sqrt(d) + mask_row) v
// with the softmax in f32, keys >= L dropped exactly, and the probabilities
// rounded to the V dtype before P @ V, as the TPU kernel does.
//
// Layout: q/k/v/out are [B, L, H*D] (the projections' own layout); element
// x[b, i, h*D + j] is read in place, so no head transpose runs around it.
// mask is the [B, L] additive f32 row, broadcast over heads and queries.
//
// What bounds it on the H100: at the serving shape (B*A = 48 views, L = 170,
// H = 12, D = 64) one layer is ~2.1 GFLOP and reads ~6 MB in bf16, far
// below what the tensor cores could do, so this simple version is bound by
// shared-memory traffic on the CUDA cores, not by device memory.
//
// Design: one block per (query tile of 32 rows, head, batch row); 4 warps,
// each owning 8 query rows.  The block walks the keys in tiles of 32 (one
// key per lane) with an online softmax (running max and sum per row,
// accumulator rescaled per tile), so shared memory stays at ~28 KB for any
// L up to max_position_embeddings and no opt-in attribute is needed.
// Scores and accumulators are f32.  K is stored transposed with one column
// of padding so that both the tile store and the per-lane reads are free of
// bank conflicts; q rows and per-warp probabilities are read as float4
// broadcasts.  wgmma/TMA tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                     // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int L, int H, float scale) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDPL = D / 32;  // accumulator columns per lane
  __shared__ __align__(16) float qs[kBlockQ][D];
  __shared__ float kt[D][kBlockK + 1];  // K tile, transposed and padded
  __shared__ float vs[kBlockK][D];
  __shared__ __align__(16) float ps[kWarps][kRowsPerWarp][kBlockK];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long hd = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * L * hd + static_cast<long long>(h) * D;
  const float* mrow = mask + static_cast<long long>(b) * L;
  const int row0 = warp * kRowsPerWarp;

  for (int idx = tid; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, c = idx % D, i = q0 + r;
    qs[r][c] = i < L ? to_f32(q[base + i * hd + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kDPL; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = tid; idx < kBlockK * D; idx += kWarps * 32) {
      const int r = idx / D, c = idx % D, j = k0 + r;
      const long long off = base + j * hd + c;
      kt[c][r] = j < L ? to_f32(k[off]) : 0.f;
      vs[r][c] = j < L ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;  // this lane's key
    const bool valid = j < L;
    const float mj = valid ? mrow[j] : 0.f;

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float k0v = kt[c][lane], k1v = kt[c + 1][lane];
      const float k2v = kt[c + 2][lane], k3v = kt[c + 3][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[row0 + r][c]);
        s[r] = fmaf(q4.x, k0v, s[r]);
        s[r] = fmaf(q4.y, k1v, s[r]);
        s[r] = fmaf(q4.z, k2v, s[r]);
        s[r] = fmaf(q4.w, k3v, s[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale + mj : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));  // finite: lane 0's key is < L
      const float corr = expf(m[r] - m_new);          // 0 on the first tile
      const float p = valid ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      ps[warp][r][lane] = to_f32(from_f32<T>(p));  // probs in the V dtype
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
      out[base + i * hd + lane + 32 * t] = from_f32<T>(acc[r][t] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            int B, int L, int H, cudaStream_t stream) {
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  attention_fwd_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<T*>(out), L, H,
      1.0f / sqrtf(static_cast<float>(D)));
}

}  // namespace

// q/k/v/out: [B, L, H*D] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1);
// mask: [B, L] f32.  Returns cudaGetLastError() after the launch.
extern "C" int macsa_fused_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int B, int L,
                                         int H, int D, int bf16, void* stream) {
  if (B < 1 || L < 1 || H < 1 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    bf16 ? launch<__nv_bfloat16, 64>(q, k, v, mask, out, B, L, H, s)
         : launch<float, 64>(q, k, v, mask, out, B, L, H, s);
  } else if (D == 32) {
    bf16 ? launch<__nv_bfloat16, 32>(q, k, v, mask, out, B, L, H, s)
         : launch<float, 32>(q, k, v, mask, out, B, L, H, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
