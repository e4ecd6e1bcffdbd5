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
// Design.  The work is a few microseconds of memory traffic, so what counts
// is how few dependent steps a slice takes, not how many lanes share it.
// `box_attention_vec_kernel`: G = 8, 16 or 32 lanes per slice (the smallest
// that gives every 16-byte chunk of a row its own lane: a row of 96 bf16 is
// twelve chunks, so G = 16 and a warp takes two slices).  A lane loads its
// chunk of all N rows of q, k and v with 16-byte loads, all started before
// anything is used, and forms its share of the N x N scores.  The shares
// are summed in a reduce-scatter of log2(G) shuffle steps that halves the
// values a lane holds at every step, so each lane ends owning a few whole
// scores: it alone adds their gate logarithm and takes their exponential
// (the row maximum and sum cross the few lanes of a row by shuffles).  The
// rounded probabilities are then handed to every lane of the slice, one
// shuffle each, and a lane forms its 16-byte chunk of every output row.
// N is a template parameter (1..8); the score layout pads N to a power of
// two.  Widths that are not whole 16-byte chunks, rows of more than 32
// chunks and unaligned tensors take `box_attention_warp_kernel`: one warp
// per slice walking d 32 elements at a time with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
box_attention_warp_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

// ---- the 16-byte-chunk kernel --------------------------------------------

constexpr int kVecThreads = 128;

template <typename T> struct Chunk;  // 16 bytes of T as floats
template <> struct Chunk<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* x) {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z);
    x[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float* x) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a bf16 is the upper half of its f32
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      w[e] = *reinterpret_cast<unsigned*>(&v);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};


// G lanes per slice; lane g of a slice owns 16-byte chunk g of every row
// (`chunks` <= G of them, the other lanes only help to reduce).
template <typename T, int N, int G>
__global__ void __launch_bounds__(kVecThreads)
box_attention_vec_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ gates,
                         T* __restrict__ out, int bh, int chunks, float sqrt_d) {
  constexpr int E = Chunk<T>::kElems;
  constexpr int P2 = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : 8;  // scores in a P2 x P2 layout
  constexpr int M = P2 * P2 > G ? P2 * P2 : G;    // values in the reduce-scatter
  constexpr int PER = M / G;                      // scores a lane ends owning
  constexpr int SEG = PER < P2 ? PER : P2;        // of one row
  constexpr int ROWS = PER / SEG;                 // whole rows a lane owns
  constexpr int LANES_PER_ROW = P2 / SEG;
  const int lg = threadIdx.x % G;
  const int slice = (blockIdx.x * kVecThreads + threadIdx.x) / G;
  const bool live = slice < bh;
  const bool has_chunk = live && lg < chunks;
  const int d = chunks * E;
  const long long base = static_cast<long long>(slice) * N * d + lg * E;

  // every load of the slice up front
  uint4 qr[N], kr[N], vr[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const long long at = base + static_cast<long long>(i) * d;
    qr[i] = has_chunk ? __ldg(reinterpret_cast<const uint4*>(q + at)) : zero;
    kr[i] = has_chunk ? __ldg(reinterpret_cast<const uint4*>(k + at)) : zero;
    vr[i] = has_chunk ? __ldg(reinterpret_cast<const uint4*>(v + at)) : zero;
  }
  float gate[PER];
  bool valid[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = lg * PER + t, i = e / P2, j = e % P2;
    valid[t] = i < N && j < N;
    gate[t] = live && valid[t]
                  ? to_f32(gates[static_cast<long long>(slice) * N * N + i * N + j])
                  : 1.f;
  }

  // this lane's share of the scores
  float s[M];
#pragma unroll
  for (int e = 0; e < M; ++e) s[e] = 0.f;
  {
    float qf[N][E];
#pragma unroll
    for (int i = 0; i < N; ++i) Chunk<T>::unpack(qr[i], qf[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float kf[E];
      Chunk<T>::unpack(kr[j], kf);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) s[i * P2 + j] = fmaf(qf[i][e], kf[e], s[i * P2 + j]);
    }
  }

  // reduce-scatter over the slice's lanes: a lane keeps the half of its
  // values that its bit `w` names and hands the other half over, so it
  // ends with the sums of values lg * PER .. lg * PER + PER - 1
#pragma unroll
  for (int w = G / 2; w >= 1; w >>= 1) {
    const int cnt = w * PER;
    const bool upper = (lg & w) != 0;
#pragma unroll
    for (int t = 0; t < cnt; ++t) {
      const float send = upper ? s[t] : s[t + cnt];
      const float keep = upper ? s[t + cnt] : s[t];
      s[t] = keep + __shfl_xor_sync(kFull, send, w);
    }
  }

  // gate, softmax over the row (it spans LANES_PER_ROW neighbouring lanes)
  float p[PER];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float row_max = -INFINITY;
#pragma unroll
    for (int t = r * SEG; t < (r + 1) * SEG; ++t) {
      s[t] = valid[t] ? s[t] / sqrt_d + logf(fmaxf(gate[t], kGeoClampMin)) : -INFINITY;
      row_max = fmaxf(row_max, s[t]);
    }
#pragma unroll
    for (int w = 1; w < LANES_PER_ROW; w <<= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(kFull, row_max, w));
    float total = 0.f;
#pragma unroll
    for (int t = r * SEG; t < (r + 1) * SEG; ++t) {
      p[t] = valid[t] ? expf(s[t] - row_max) : 0.f;
      total += p[t];
    }
#pragma unroll
    for (int w = 1; w < LANES_PER_ROW; w <<= 1) total += __shfl_xor_sync(kFull, total, w);
#pragma unroll
    for (int t = r * SEG; t < (r + 1) * SEG; ++t)
      p[t] = valid[t] ? to_f32(from_f32<T>(p[t] / total)) : 0.f;
  }

  // every lane of the slice gets every probability, then forms its chunk
  float acc[N][E];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float vf[E];
    Chunk<T>::unpack(vr[j], vf);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int flat = i * P2 + j;
      const float pij = __shfl_sync(kFull, p[flat % PER], flat / PER, G);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pij, vf[e], acc[i][e]);
    }
  }
  if (has_chunk) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<uint4*>(out + base + static_cast<long long>(i) * d) =
          Chunk<T>::pack(acc[i]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int N>
void launch(const void* q, const void* k, const void* v, const void* gates, void* out, int bh,
            int d, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(gates);
  T* op = static_cast<T*>(out);
  const float sqrt_d = static_cast<float>(sqrt(static_cast<double>(d)));
  constexpr int E = Chunk<T>::kElems;
  const int chunks = d / E;
  if (d % E == 0 && chunks <= 32 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(out)) {
    const int lanes = chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
    const int per_block = kVecThreads / lanes;
    const int blocks = (bh + per_block - 1) / per_block;
    if (lanes == 8)
      box_attention_vec_kernel<T, N, 8><<<blocks, kVecThreads, 0, stream>>>(
          qp, kp, vp, gp, op, bh, chunks, sqrt_d);
    else if (lanes == 16)
      box_attention_vec_kernel<T, N, 16><<<blocks, kVecThreads, 0, stream>>>(
          qp, kp, vp, gp, op, bh, chunks, sqrt_d);
    else
      box_attention_vec_kernel<T, N, 32><<<blocks, kVecThreads, 0, stream>>>(
          qp, kp, vp, gp, op, bh, chunks, sqrt_d);
    return;
  }
  const int blocks = (bh + kWarpsPerBlock - 1) / kWarpsPerBlock;
  box_attention_warp_kernel<T, N><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(qp, kp, vp, gp, op,
                                                                              bh, d, sqrt_d);
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
