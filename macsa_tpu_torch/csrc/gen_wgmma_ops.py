#!/usr/bin/env python3
"""Writes `wgmma_ops.cuh`: the inline-PTX wrappers of Hopper's warpgroup
matrix multiply for bf16 operands and f32 accumulators.

    python3 macsa_tpu_torch/csrc/gen_wgmma_ops.py

A `wgmma.mma_async` names every accumulator register of a thread as an
operand (N/2 of them for an m64nNk16 tile), so the wrappers are long and
regular; this script writes them for N in {64, 128, 192}, with A read from
shared memory through a descriptor (`Op<N>::ss`) or from registers
(`Op<N>::rs`).  The instruction's transpose bits are template arguments
(`ss<TA, TB>`, `rs<TB>`): 0 for an operand stored K-major (k contiguous),
1 for one stored MN-major.  The defaults are a weight matrix's: A [m][k],
B [k][n].  It also writes the TF32 products m64nNk8 for N in {64, 128}
with A from registers (`OpTf32<N>::rs`), whose B is K-major only (TF32
`wgmma` has no transpose bits).  The header is committed; rerun the
script to change it.
"""

from pathlib import Path

WIDTHS = (64, 128, 192)
TF32_WIDTHS = (64, 128)

HEADER = '''\
// Generated by gen_wgmma_ops.py; do not edit by hand.
//
// m64nNk16 bf16 x bf16 -> f32 warpgroup products (sm_90a).  d[N/2] is the
// thread's share of the 64 x N accumulator: d[4j], d[4j+1] are row
// 16*warp + lane/4, columns 8j + 2*(lane%4) and the next; d[4j+2], d[4j+3]
// the same columns of row + 8.  An A fragment in registers is a[0], a[1]:
// rows 16*warp + lane/4 and + 8, k = 2*(lane%4) and the next as one bf16
// pair; a[2], a[3]: the same rows, k + 8: the accumulator's own layout, 16
// columns at a time.  B is always read from shared memory through a
// descriptor.  TA / TB are the transpose bits: 0 for an operand stored
// K-major ([m][k] or [n][k], k contiguous), 1 for MN-major ([k][m] or
// [k][n]); the defaults take A [m][k] and B [k][n].  `accumulate` = 0
// overwrites d, else adds to it.
#pragma once
#include <stdint.h>

namespace wgmma {

template <int N> struct Op;
'''


def operands(n_acc: int, first: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(n_acc))


def acc_constraints(n_acc: int) -> str:
    rows = []
    for i in range(0, n_acc, 8):
        rows.append(", ".join(f'"+f"(d[{i + j}])' for j in range(8)))
    return ",\n          ".join(rows)


def op(n: int) -> str:
    n_acc = n // 2
    d = operands(n_acc, 0)
    return f'''
template <> struct Op<{n}> {{
  // A and B from shared memory
  template <int TA = 0, int TB = 1>
  static __device__ __forceinline__ void ss(float (&d)[{n_acc}], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n_acc + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{d}}}, "
        "%{n_acc}, %{n_acc + 1}, p, 1, 1, %{n_acc + 3}, %{n_acc + 4};\\n}}\\n"
        : {acc_constraints(n_acc)}
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
  }}
  // A from registers (the m16k16 fragment of each warp), B from shared memory
  template <int TB = 1>
  static __device__ __forceinline__ void rs(float (&d)[{n_acc}], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n_acc + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{d}}}, "
        "{{%{n_acc}, %{n_acc + 1}, %{n_acc + 2}, %{n_acc + 3}}}, %{n_acc + 4}, p, 1, 1, %{n_acc + 6};\\n}}\\n"
        : {acc_constraints(n_acc)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
          "n"(TB));
  }}
}};
'''


TF32_HEADER = '''
// m64nNk8 TF32 x TF32 -> f32 warpgroup products, A from registers: a[0..3]
// of warp w's 16 x 8 slice are rows 16w + lane/4, + 8, + 0, + 8 at k =
// lane%4, lane%4, + 4, + 4 (the m16n8k8 .tf32 A fragment); d as above.  B
// is K-major ([n][k], k contiguous) through its descriptor.
template <int N> struct OpTf32;
'''


def op_tf32(n: int) -> str:
    n_acc = n // 2
    d = operands(n_acc, 0)
    return f'''
template <> struct OpTf32<{n}> {{
  static __device__ __forceinline__ void rs(float (&d)[{n_acc}], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n_acc + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{d}}}, "
        "{{%{n_acc}, %{n_acc + 1}, %{n_acc + 2}, %{n_acc + 3}}}, %{n_acc + 4}, p, 1, 1;\\n}}\\n"
        : {acc_constraints(n_acc)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }}
}};
'''


FOOTER = '''
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(PENDING) : "memory");
}

}  // namespace wgmma
'''


def render() -> str:
    """The header's text."""
    return (HEADER + "".join(op(n) for n in WIDTHS) + TF32_HEADER
            + "".join(op_tf32(n) for n in TF32_WIDTHS) + FOOTER)


def main() -> None:
    Path(__file__).with_name("wgmma_ops.cuh").write_text(render())


if __name__ == "__main__":
    main()
