// On-device pixel normalization (kernel K2) for Hopper (sm_90a).
//
// Replaces: macsa_tpu/ops/image_prep.py, `_kernel` in `normalize_images_u8`
// (raw uint8), and takes on the packed-frame path that the JAX package runs
// through XLA (`unpack_normalize_pixels`), since the loader ships packed
// frames by default.  For every byte x of an [..., S, S, 3] image:
//   y = (x * (1/255) - mean[c]) * (1/std[c]),   c = byte index mod 3
// in f32, then cast to f32 or bf16 (round to nearest even).  Each product
// and difference is rounded on its own (__fmul_rn / __fsub_rn): no FMA
// contraction, so the result is bit-identical to the same formula run as
// separate PyTorch ops.  Packed frames are [1 validity word | S*S*3/4 pixel
// words]; a frame whose validity word is 0 comes out as exact zeros.
//
// What bounds it on the H100: pure streaming, 1 byte in and 2 or 4 bytes out
// per pixel with ~3 flops each, so device-memory bandwidth.
//
// Design: each thread turns one 32-bit word (4 bytes) into 4 outputs written
// with one 16-byte (f32) or 8-byte (bf16) store; consecutive threads touch
// consecutive words, so loads and stores coalesce.  The output is NHWC, so
// the ResNet reads it as a channels-last NCHW view with no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Norm {
  float inv255;
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float normalize(unsigned byte, int c, const Norm& n) {
  return __fmul_rn(__fsub_rn(__fmul_rn(static_cast<float>(byte), n.inv255), n.mean[c]),
                   n.inv_std[c]);
}

// four outputs for the bytes of `word`, whose first byte has flat index 4w
__device__ __forceinline__ float4 normalize_word(unsigned word, long long w, bool keep,
                                                 const Norm& n) {
  const int c0 = static_cast<int>(w % 3);  // (4w) mod 3 == w mod 3
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = keep ? normalize((word >> (8 * j)) & 0xFFu, (c0 + j) % 3, n) : 0.f;
  return make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store4(float* out, long long i, float4 y) {
  *reinterpret_cast<float4*>(out + i) = y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, float4 y) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = packed;
}

__device__ __forceinline__ void store1(float* out, long long i, float y) { out[i] = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i, float y) {
  out[i] = __float2bfloat16_rn(y);
}

// grid.y strides over frames, grid.x over the pixel words of a frame
template <typename T>
__global__ void unpack_normalize_kernel(const unsigned* __restrict__ words,
                                        T* __restrict__ out, long long frames, int wpf,
                                        Norm n) {
  const int pixel_words = wpf - 1;
  for (long long f = blockIdx.y; f < frames; f += gridDim.y) {
    const unsigned* frame = words + f * wpf;
    const bool keep = frame[0] != 0u;
    T* dst = out + f * 4LL * pixel_words;
    for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < pixel_words;
         w += gridDim.x * blockDim.x)
      store4(dst, 4LL * w, normalize_word(frame[1 + w], w, keep, n));
  }
}

template <typename T>
__global__ void normalize_u8_kernel(const unsigned char* __restrict__ bytes,
                                    T* __restrict__ out, long long n_bytes, Norm n) {
  const long long n_words = (n_bytes + 3) / 4;
  for (long long w = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       w < n_words; w += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = 4 * w;
    if (i + 4 <= n_bytes) {
      const unsigned word = *reinterpret_cast<const unsigned*>(bytes + i);
      store4(out, i, normalize_word(word, w, true, n));
    } else {  // ragged tail of fewer than 4 bytes
      for (long long t = i; t < n_bytes; ++t)
        store1(out, t, normalize(bytes[t], static_cast<int>(t % 3), n));
    }
  }
}

constexpr int kThreads = 256;

Norm make_norm(float inv255, float m0, float m1, float m2, float s0, float s1, float s2) {
  return Norm{inv255, {m0, m1, m2}, {s0, s1, s2}};
}

}  // namespace

// words: [frames, wpf] little-endian packed frames (int32 storage read as
// unsigned); out: [frames, S, S, 3] f32 (bf16 == 0) or bf16 (bf16 == 1).
extern "C" int macsa_unpack_normalize(const void* words, void* out, long long frames,
                                      int wpf, int bf16, float inv255, float m0,
                                      float m1, float m2, float s0, float s1, float s2,
                                      void* stream) {
  if (frames < 1 || wpf < 2) return cudaErrorInvalidValue;
  const Norm n = make_norm(inv255, m0, m1, m2, s0, s1, s2);
  const int pixel_words = wpf - 1;
  const dim3 grid((pixel_words + kThreads - 1) / kThreads,
                  static_cast<unsigned>(frames < 65535 ? frames : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* w = static_cast<const unsigned*>(words);
  if (bf16)
    unpack_normalize_kernel<<<grid, kThreads, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(out), frames, wpf, n);
  else
    unpack_normalize_kernel<<<grid, kThreads, 0, s>>>(
        w, static_cast<float*>(out), frames, wpf, n);
  return static_cast<int>(cudaGetLastError());
}

// bytes: n raw uint8 values of an [..., H, W, 3] tensor; out: same shape.
extern "C" int macsa_normalize_u8(const void* bytes, void* out, long long n_bytes,
                                  int bf16, float inv255, float m0, float m1, float m2,
                                  float s0, float s1, float s2, void* stream) {
  if (n_bytes < 1) return cudaErrorInvalidValue;
  const Norm n = make_norm(inv255, m0, m1, m2, s0, s1, s2);
  const long long n_words = (n_bytes + 3) / 4;
  const long long want = (n_words + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 1048576 ? want : 1048576);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* b = static_cast<const unsigned char*>(bytes);
  if (bf16)
    normalize_u8_kernel<<<blocks, kThreads, 0, s>>>(
        b, static_cast<__nv_bfloat16*>(out), n_bytes, n);
  else
    normalize_u8_kernel<<<blocks, kThreads, 0, s>>>(b, static_cast<float*>(out),
                                                   n_bytes, n);
  return static_cast<int>(cudaGetLastError());
}
