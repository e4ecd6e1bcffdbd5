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
// Design.  A frame is an odd number of words (1 + 37632 at 224^2), so the
// 16-byte alignment of its pixels changes from frame to frame while the
// output's does not.  Shared memory takes the two apart: a block walks
// tiles of `kTileWords` pixel words of one frame; it copies the tile's
// words with 16-byte `cp.async` from the aligned address at or below the
// tile's first word (the copy of the next tile is in flight while this one
// is computed), and every thread then reads its words from shared memory at
// the tile's own offset and writes 16 bytes (two words' outputs in bf16,
// one word's in f32) to an aligned address.  A tile starts at a multiple of
// 3 words and the threads stride by a multiple of 3 words, so a thread's
// channel phase never changes: it rotates the constants once and no modulo
// is left in the loop.  A tile of an invalid frame reads only the validity
// word and writes zeros.  The grid is persistent: as many blocks as fit on
// the SMs, each striding over the tiles.  Packed frames whose bf16 output
// is not 16-byte aligned per frame (an odd count of pixel words) keep the
// one-word-per-thread kernel.  The output is NHWC, so the ResNet reads it
// as a channels-last NCHW view with no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

struct Norm {
  float inv255;
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float normalize(unsigned byte, float mean, float inv_std,
                                           float inv255) {
  return __fmul_rn(__fsub_rn(__fmul_rn(static_cast<float>(byte), inv255), mean), inv_std);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The output is written once and read by another kernel much later, and is
// larger than the L2 cache: a streaming store (evict first) keeps it from
// pushing the tiles still to be read out of the cache.
template <typename V> __device__ __forceinline__ void stream_store(V* p, V v) { __stcs(p, v); }

// the outputs of one word (4 bytes)
__device__ __forceinline__ void store_word(float* out, long long i, const float* y) {
  stream_store(reinterpret_cast<float4*>(out + i), make_float4(y[0], y[1], y[2], y[3]));
}
__device__ __forceinline__ void store_word(__nv_bfloat16* out, long long i, const float* y) {
  stream_store(reinterpret_cast<uint2*>(out + i),
               make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3])));
}
// the outputs of two words: bf16 only (16 bytes)
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, long long i, const float* y) {
  stream_store(reinterpret_cast<uint4*>(out + i),
               make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                          pack_bf16(y[6], y[7])));
}
__device__ __forceinline__ void store_pair(float*, long long, const float*) {}

__device__ __forceinline__ void store1(float* out, long long i, float y) { out[i] = y; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i, float y) {
  out[i] = __float2bfloat16_rn(y);
}

constexpr int kTileThreads = 192;  // a multiple of 3: a thread's channel phase is fixed
constexpr int kTileWords = 2688;   // a multiple of 12 and of 2 * kTileThreads
constexpr int kTileVecs = kTileWords / 4 + 1;  // one more: the copy starts up to 3 words early
static_assert(kTileThreads % 3 == 0 && kTileWords % 12 == 0 &&
              kTileWords % (2 * kTileThreads) == 0, "the channel phase must not move");

// One tile: `len` pixel words from word `t0` of frame `f`.
struct Tile {
  long long f;
  long long t0;
  int len;
  long long src;  // index of the tile's first word in `words`
  int shift;      // words between the aligned copy's start and `src`
};

__device__ __forceinline__ Tile tile_at(long long tile, long long tiles_per_frame,
                                        long long stride, int head, long long pixel_words,
                                        const unsigned* words) {
  Tile t;
  t.f = tile / tiles_per_frame;
  t.t0 = (tile - t.f * tiles_per_frame) * kTileWords;
  const long long left = pixel_words - t.t0;
  t.len = static_cast<int>(left < kTileWords ? left : kTileWords);
  t.src = t.f * stride + head + t.t0;
  t.shift = static_cast<int>((reinterpret_cast<uintptr_t>(words + t.src) >> 2) & 3);
  return t;
}

// Start the copy of a tile's words into `buf`: 16 bytes a thread from
// aligned addresses; a vector that reaches outside the tensor goes word by word.
__device__ __forceinline__ void start_tile_copy(const Tile& t, const unsigned* __restrict__ words,
                                           long long total_words, unsigned* buf) {
  const int vecs = (t.shift + t.len + 3) / 4;
  const long long first = t.src - t.shift;
  for (int v = threadIdx.x; v < vecs; v += kTileThreads) {
    const long long lo = first + 4LL * v;
    if (lo >= 0 && lo + 4 <= total_words) {
      cp_async16(smem_u32(buf + 4 * v), words + lo, true);
    } else {
      for (int e = 0; e < 4; ++e)
        if (lo + e >= 0 && lo + e < total_words) buf[4 * v + e] = words[lo + e];
    }
  }
}

// words: `frames` frames of `head` leading words (1: a validity word, 0:
// none) and `pixel_words` pixel words, `stride` words apart; out:
// [frames, 4 * pixel_words].  `tail_bytes` (< 4) ragged bytes after the last
// whole word of a raw tensor are done by one thread.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_normalize_kernel(const unsigned* __restrict__ words, T* __restrict__ out, long long frames,
                      long long stride, int head, long long pixel_words,
                      long long total_words, int tail_bytes, Norm n) {
  __shared__ __align__(16) unsigned buf[2][kTileVecs * 4];
  constexpr int W = sizeof(T) == 2 ? 2 : 1;  // words behind one 16-byte store
  const long long tiles_per_frame = (pixel_words + kTileWords - 1) / kTileWords;
  const long long n_tiles = frames * tiles_per_frame;
  const int tid = threadIdx.x;
  // byte b of this thread's unit has channel (c0 + b) mod 3 in every tile
  const int c0 = (W * tid) % 3;
  float mean[3], inv_std[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mean[k] = n.mean[(c0 + k) % 3];
    inv_std[k] = n.inv_std[(c0 + k) % 3];
  }

  long long tile = blockIdx.x;
  int stage = 0;
  if (tile < n_tiles) {
    const Tile t = tile_at(tile, tiles_per_frame, stride, head, pixel_words, words);
    if (!head || words[t.f * stride] != 0u) start_tile_copy(t, words, total_words, buf[0]);
  }
  cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < n_tiles) {
      const Tile t = tile_at(next, tiles_per_frame, stride, head, pixel_words, words);
      if (!head || words[t.f * stride] != 0u) start_tile_copy(t, words, total_words, buf[stage ^ 1]);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile's words are in
    __syncthreads();
    const Tile t = tile_at(tile, tiles_per_frame, stride, head, pixel_words, words);
    const bool keep = !head || words[t.f * stride] != 0u;
    T* dst = out + 4 * (t.f * pixel_words + t.t0);
    const unsigned* src = buf[stage] + t.shift;
    for (int u = tid; u * W < t.len; u += kTileThreads) {
      const int w = u * W;
      const bool pair = W == 2 && w + 1 < t.len;
      float y[4 * W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const unsigned word = keep && (e == 0 || pair) ? src[w + e] : 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = 4 * e + j;
          y[b] = keep ? normalize((word >> (8 * j)) & 0xFFu, mean[b % 3], inv_std[b % 3],
                                  n.inv255)
                      : 0.f;
        }
      }
      if (pair)
        store_pair(dst, 4LL * w, y);
      else
        store_word(dst, 4LL * w, y);
    }
    __syncthreads();  // the next copy may overwrite this buffer
    stage ^= 1;
  }
  if (tail_bytes && blockIdx.x == 0 && tid == 0) {
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(words);
    for (long long i = 4 * pixel_words; i < 4 * pixel_words + tail_bytes; ++i)
      store1(out, i, normalize(bytes[i], n.mean[i % 3], n.inv_std[i % 3], n.inv255));
  }
}

// The one-word-per-thread kernel, for packed frames whose outputs are not
// 16-byte aligned frame by frame.  grid.y strides over frames, grid.x over
// the pixel words of a frame.
template <typename T>
__global__ void unpack_normalize_word_kernel(const unsigned* __restrict__ words,
                                             T* __restrict__ out, long long frames, int wpf,
                                             Norm n) {
  const int pixel_words = wpf - 1;
  for (long long f = blockIdx.y; f < frames; f += gridDim.y) {
    const unsigned* frame = words + f * wpf;
    const bool keep = frame[0] != 0u;
    T* dst = out + f * 4LL * pixel_words;
    for (int w = blockIdx.x * blockDim.x + threadIdx.x; w < pixel_words;
         w += gridDim.x * blockDim.x) {
      const unsigned word = frame[1 + w];
      const int c0 = w % 3;  // (4w) mod 3 == w mod 3
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (c0 + j) % 3;
        y[j] = keep ? normalize((word >> (8 * j)) & 0xFFu, n.mean[c], n.inv_std[c], n.inv255)
                    : 0.f;
      }
      store_word(dst, 4LL * w, y);
    }
  }
}

Norm make_norm(float inv255, float m0, float m1, float m2, float s0, float s1, float s2) {
  return Norm{inv255, {m0, m1, m2}, {s0, s1, s2}};
}

// blocks that fit on the card at once
template <typename T>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_normalize_kernel<T>,
                                                  kTileThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <typename T>
void launch_tiles(const void* words, void* out, long long frames, long long stride, int head,
                  long long pixel_words, long long total_words, int tail_bytes, const Norm& n,
                  cudaStream_t s) {
  const long long tiles = frames * ((pixel_words + kTileWords - 1) / kTileWords);
  const long long cap = resident_blocks<T>();
  const unsigned grid = static_cast<unsigned>(tiles < 1 ? 1 : (tiles < cap ? tiles : cap));
  tile_normalize_kernel<T><<<grid, kTileThreads, 0, s>>>(
      static_cast<const unsigned*>(words), static_cast<T*>(out), frames, stride, head,
      pixel_words, total_words, tail_bytes, n);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kWordThreads = 256;

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // every frame's output starts on 16 bytes: always in f32, in bf16 (8
  // bytes a word) when a frame holds an even count of pixel words
  if (aligned16(out) && (!bf16 || pixel_words % 2 == 0 || frames == 1)) {
    if (bf16)
      launch_tiles<__nv_bfloat16>(words, out, frames, wpf, 1, pixel_words, frames * wpf, 0, n, s);
    else
      launch_tiles<float>(words, out, frames, wpf, 1, pixel_words, frames * wpf, 0, n, s);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((pixel_words + kWordThreads - 1) / kWordThreads,
                  static_cast<unsigned>(frames < 65535 ? frames : 65535));
  const unsigned* w = static_cast<const unsigned*>(words);
  if (bf16)
    unpack_normalize_word_kernel<<<grid, kWordThreads, 0, s>>>(
        w, static_cast<__nv_bfloat16*>(out), frames, wpf, n);
  else
    unpack_normalize_word_kernel<<<grid, kWordThreads, 0, s>>>(
        w, static_cast<float*>(out), frames, wpf, n);
  return static_cast<int>(cudaGetLastError());
}

// bytes: n raw uint8 values of an [..., H, W, 3] tensor, 4-byte aligned;
// out: same shape, 16-byte aligned.
extern "C" int macsa_normalize_u8(const void* bytes, void* out, long long n_bytes,
                                  int bf16, float inv255, float m0, float m1, float m2,
                                  float s0, float s1, float s2, void* stream) {
  if (n_bytes < 1 || !aligned16(out)) return cudaErrorInvalidValue;
  const Norm n = make_norm(inv255, m0, m1, m2, s0, s1, s2);
  const long long n_words = n_bytes / 4;
  const int tail = static_cast<int>(n_bytes - 4 * n_words);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one frame with no validity word
  if (bf16)
    launch_tiles<__nv_bfloat16>(bytes, out, 1, n_words, 0, n_words, n_words, tail, n, s);
  else
    launch_tiles<float>(bytes, out, 1, n_words, 0, n_words, n_words, tail, n, s);
  return static_cast<int>(cudaGetLastError());
}
