// The dropout mask of K1, shared by its CUDA-core and tensor-core kernels:
// a keyed 32-bit hash of (seed, b, h, i, j) alone,
//   bits = mix(mix(mix(mix(mix(seed) ^ b) ^ h) ^ i) ^ j),  keep = bits >= threshold,
// so every kernel and every tiling draws the same bits for an element.
// `dropout_bits` in ops/fused_attention.py is the same function.
#pragma once
#include <stdint.h>

namespace attention {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// the hash of (seed, b, h, i); the element's bits are mix32(row_key ^ j)
__device__ __forceinline__ uint32_t row_key(uint32_t seed, int b, int h, int i) {
  return mix32(mix32(mix32(mix32(seed) ^ static_cast<uint32_t>(b)) ^ static_cast<uint32_t>(h)) ^
               static_cast<uint32_t>(i));
}

struct Dropout {
  int on;             // rate > 0
  uint32_t threshold;  // keep iff bits >= threshold
  float inv_keep;     // 1 / (1 - rate), rounded to f32
  uint32_t seed;
  __device__ __forceinline__ bool keep(uint32_t key, int j) const {
    return mix32(key ^ static_cast<uint32_t>(j)) >= threshold;
  }
};

inline Dropout make_dropout(int on, unsigned threshold, float inv_keep, unsigned seed) {
  Dropout d;
  d.on = on;
  d.threshold = threshold;
  d.inv_keep = inv_keep;
  d.seed = seed;
  return d;
}

}  // namespace attention
