// Three TF32 products for one f32 product on Hopper's tensor cores
// (`mma.sync.m16n8k8`), shared by the f32 ("tf32x3") kernels of K1
// (`fused_attention_tf32.cu`) and of K4/K5 (`fused_resnet_tf32.cu`).
//
// Every f32 operand x of a product is split in registers into big = tf32(x)
// and small = tf32(x - big), both rounded to nearest, ties away, and the
// product is taken as small*big + big*small + big*big, each term a TF32
// product accumulated in f32 (small*small, about 2^-22 of the product, is
// left out).  One TF32 product keeps 11 bits of each operand; three keep
// about 22.
//
// Fragments (PTX ISA, m16n8k8 .tf32): lane = 4 g + t.  A (16 x 8, row):
// element e at row g + 8 (e & 1), column t + 4 (e >> 1).  B (8 x 8, col):
// element e at row t + 4 e, column g.  C (16 x 8): element e at row
// g + 8 (e >> 1), column 2 t + (e & 1).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to the nearest TF32 value, ties away from zero: the rounding of
// `cvt.rna.tf32.f32`, the same bits for every finite x, taken with an integer
// add and mask, which the card issues at full rate where the conversion runs
// at a fraction of it (`ablate_attention.py tf32x3`: the backward at
// [48, 170, 768] takes 0.64 ms so, 0.80 with the conversion)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t big, small;  // x = big + small to about 2^-22 of x
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = tf32(x);
  return {big, tf32(x - __uint_as_float(big))};
}

// an A fragment, split
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split s = split(a[e]);
    f.big[e] = s.big;
    f.small[e] = s.small;
  }
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32x3
