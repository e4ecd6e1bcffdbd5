// Fused geometric (box-bias) attention (kernel K3) for Hopper (sm_90a).
//
// Replaces: macsa_tpu/ops/box_attention_kernel.py, `_kernel` via
// `_forward_pallas` in the custom VJP `fused_box_attention` (its backward
// is plain math there and a plain PyTorch function here).  Per
// (batch*head) slice b, with N ROIs and head width d:
//   s[i][j] = (q[i] . k[j]) / sqrt(d) + log(max(gates[i][j], 1e-6))   (f32)
//   p[i]    = softmax_j(s[i]),  rounded to the dtype of q
//   out[i]  = sum_j p[i][j] v[j]                     (f32 sum, written as q's dtype)
// q, k, v, out are [BH, N, d] and gates [BH, N, N] (post-ReLU, so many are
// exactly 0 and score log(1e-6)), all contiguous, f32 or bf16.  The scores
// are taken from f32 operands, as the TPU kernel does; the probabilities
// are rounded before P @ V, as in the JAX package's plain path.
//
// What bounds it on the H100: at the serving shape (BH = 8 samples x 6
// aspects x 7 images x 8 heads = 2688, N = 4, d = 96) it reads q, k, v and
// the gates once and writes out once, ~8 MB in bf16, with ~10 MFLOP: a
// few microseconds of device-memory traffic, so launch latency and
// memory bandwidth.  The TPU kernel pads N to 8 rows and d to 128 lanes
// and masks the padded keys with -inf; nothing here is padded.
//
// Design: one warp per slice, 4 warps per block.  N is a template
// parameter (1..8), so the N x N scores live in registers; d is a runtime
// stride that the lanes walk 32 at a time (d = 96 is three steps; it need
// not be a power of two), so loads of q, k, v and stores of out coalesce.
// Each lane sums its share of every q.k product, a butterfly reduction
// gives every lane the full scores, and each lane then forms its columns
// of out.  The gates are read by every lane of the warp (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kGeoClampMin = 1e-6f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
box_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ gates,
                     T* __restrict__ out, int bh, int d, float sqrt_d) {
  const int slice = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (slice >= bh) return;  // the whole warp leaves together
  const long long base = static_cast<long long>(slice) * N * d;

  float s[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = 0.f;
  for (int c = lane; c < d; c += 32) {
    float qc[N], kc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      qc[i] = to_f32(q[base + static_cast<long long>(i) * d + c]);
      kc[i] = to_f32(k[base + static_cast<long long>(i) * d + c]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) s[i][j] = fmaf(qc[i], kc[j], s[i][j]);
  }

  const T* g = gates + static_cast<long long>(slice) * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float row_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s[i][j] = warp_sum(s[i][j]) / sqrt_d + logf(fmaxf(to_f32(g[i * N + j]), kGeoClampMin));
      row_max = fmaxf(row_max, s[i][j]);
    }
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s[i][j] = expf(s[i][j] - row_max);
      total += s[i][j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) s[i][j] = to_f32(from_f32<T>(s[i][j] / total));
  }

  for (int c = lane; c < d; c += 32) {
    float vc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) vc[j] = to_f32(v[base + static_cast<long long>(j) * d + c]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc = fmaf(s[i][j], vc[j], acc);
      out[base + static_cast<long long>(i) * d + c] = from_f32<T>(acc);
    }
  }
}

template <typename T, int N>
void launch(const void* q, const void* k, const void* v, const void* gates, void* out, int bh,
            int d, cudaStream_t stream) {
  const int blocks = (bh + kWarpsPerBlock - 1) / kWarpsPerBlock;
  box_attention_kernel<T, N><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(gates), static_cast<T*>(out), bh, d,
      static_cast<float>(sqrt(static_cast<double>(d))));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* gates, void* out, int bh,
             int n, int d, cudaStream_t s) {
  switch (n) {
    case 1: launch<T, 1>(q, k, v, gates, out, bh, d, s); break;
    case 2: launch<T, 2>(q, k, v, gates, out, bh, d, s); break;
    case 3: launch<T, 3>(q, k, v, gates, out, bh, d, s); break;
    case 4: launch<T, 4>(q, k, v, gates, out, bh, d, s); break;
    case 5: launch<T, 5>(q, k, v, gates, out, bh, d, s); break;
    case 6: launch<T, 6>(q, k, v, gates, out, bh, d, s); break;
    case 7: launch<T, 7>(q, k, v, gates, out, bh, d, s); break;
    case 8: launch<T, 8>(q, k, v, gates, out, bh, d, s); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/out: [bh, n, d] contiguous, f32 (bf16 == 0) or bf16 (bf16 == 1);
// gates: [bh, n, n] in the same dtype; 1 <= n <= 8.  Returns
// cudaGetLastError() after the launch.
extern "C" int macsa_box_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* gates, void* out, int bh, int n, int d,
                                       int bf16, void* stream) {
  if (bh < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, gates, out, bh, n, d, s)
              : dispatch<float>(q, k, v, gates, out, bh, n, d, s);
}
