"""Where the f32 tensor-core K4's and K5's time goes: copies of
`fused_resnet_tf32.cu` with one piece taken out (or changed) each, built and
timed beside the whole kernels.

    python macsa_tpu_torch/csrc/ablate_resnet.py

The card's machine has no kernel profiler, so a piece's cost is read as the
time the kernels lose without it: each variant below is the source with a
few lines replaced (the replacement must find its text, so an edit of the
source that moves a piece fails here, not silently), compiled by `nvcc`
into its own library and called through `ctypes`, 10 back-to-back launches
between CUDA events, all in one process: K4 at ResNet-152 stage 3 over 280
images (conv1 [54880, 1024] -> 256 + ReLU, conv3 [54880, 256] -> 1024 +
residual + ReLU) and K5 on one identity bottleneck of each stage over 280
images, with the rows per block of `tf32x3_tile_rows` (K5's time includes
its weight planes' kernel).  The variants compute wrong results; only their
times mean something, except where a variant's name says it computes the
same function; each variant's output is compared with the whole kernels'
bit for bit.  Pieces are taken out behind a condition the compiler cannot
decide (`m_rows < 0`), so what feeds them stays; a copy taken out of K5's
ring is taken out of the bytes its barrier waits for too.  Needs an H100 and
`nvcc`.
"""

import ctypes
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from macsa_tpu_torch.ops import cuda_lib  # noqa: E402
from macsa_tpu_torch.ops import fused_resnet as fr  # noqa: E402

SOURCE = cuda_lib.CSRC / "fused_resnet_tf32.cu"
ENTRIES = ("macsa_matmul_bn_act_tf32x3", "macsa_fused_bottleneck_tf32x3")
# (h = w, C, F) of the identity bottlenecks of ResNet-152's four stages at 224^2
STAGES = {1: (56, 256, 64), 2: (28, 512, 128), 3: (14, 1024, 256), 4: (7, 2048, 512)}
IMAGES = 280

# name -> [(old, new), ...]; every `old` must occur in the source once.  Each
# variant takes the same piece out of K4 (`mma.sync`, `cp.async` ring) and
# K5 (`wgmma`, bulk-copy ring) where both have it.
VARIANTS = {
    "whole": [],
    "one TF32 product (big*big)": [
        ("mma_tf32(part[j], a.small, b0[kk][j].big, b1[kk][j].big);", ";"),
        ("mma_tf32(part[j], a.big, b0[kk][j].small, b1[kk][j].small);", ";"),
        ("    wgmma::OpTf32<NW>::rs(part, a.small[s], big + s * kDescK8, s);  // s = 0 overwrites\n"
         "    wgmma::OpTf32<NW>::rs(part, a.big[s], small + s * kDescK8, 1);\n"
         "    wgmma::OpTf32<NW>::rs(part, a.big[s], big + s * kDescK8, 1);",
         "    wgmma::OpTf32<NW>::rs(part, a.big[s], big + s * kDescK8, s);")],
    "no partial-sum adds (K4: products straight into the accumulators; other rounding)": [
        ("    float part[kNT][4];\n#pragma unroll\n    for (int j = 0; j < kNT; ++j)\n"
         "#pragma unroll\n      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;\n",
         "    float (&part)[kNT][4] = acc[i];\n"),
        ("acc[i][j][e] = __fadd_rn(acc[i][j][e], part[j][e]);", ";"),
        ("acc[i] = __fadd_rn(acc[i], part[i]);", "acc[i] = part[i];")],
    "no splits (raw bits as both halves)": [
        ("using tf32x3::split;\nusing tf32x3::split_a;\n",
         "__device__ __forceinline__ Split split(float x) {\n"
         "  return {__float_as_uint(x), __float_as_uint(x)};\n}\n"
         "__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {\n"
         "  const float a[4] = {a0, a1, a2, a3};\n  FragA f;\n"
         "  for (int e = 0; e < 4; ++e) f.big[e] = f.small[e] = __float_as_uint(a[e]);\n"
         "  return f;\n}\n")],
    "products skipped (copies, waits and epilogues alone)": [
        ("      stage_products<MT, P::kLdB>(acc, smem, off, a_k, b_off, tiles);",
         "      if (tiles < 0) stage_products<MT, P::kLdB>(acc, smem, off, a_k, b_off, tiles);"),
        ("        chunk_products<NW>(part, a,",
         "        if (cv.chunks < 0) chunk_products<NW>(part, a,")],
    "no weight copies": [
        ("    cp_async16(smem_u32(dst + k * P::kLdB + c * 4),",
         "    if (n_cols < 0) cp_async16(smem_u32(dst + k * P::kLdB + c * 4),"),
        ("    mbar_expect_tx(full, bytes);\n    bulk_copy(dst, tile, bytes, full);",
         "    mbar_expect_tx(full, 0);")],
    "no x copies (K4, K5's conv1)": [
        ("    cp_async16(smem_u32(dst + r * kLdA + c * 4),",
         "    if (m_rows < 0) cp_async16(smem_u32(dst + r * kLdA + c * 4),"),
        ("    if (kc < chunks) {\n      cp_async16(",
         "    if (kc < chunks && c < 0) {\n      cp_async16(")],
    "no stores to device memory": [
        ("*reinterpret_cast<float4*>(out + (row0",
         "if (m_rows < 0) *reinterpret_cast<float4*>(out + (row0"),
        ("*reinterpret_cast<float2*>(p.out + off + 8 * j) =",
         "if (m0 < 0) *reinterpret_cast<float2*>(p.out + off + 8 * j) =")],
    "K4 in 128 x 128 tiles, two blocks an SM (same function)": [
        ("launch_matmul_bn_act<Pass<8, 7>>(", "launch_matmul_bn_act<Pass<4, 4>>("),
        ("__global__ void __launch_bounds__(kThreads, 1)\nmatmul_bn_act_tf32x3_kernel",
         "__global__ void __launch_bounds__(kThreads, 2)\nmatmul_bn_act_tf32x3_kernel")],
}


def build_all(tmp: Path) -> dict:
    """Every variant's library, all `nvcc` processes started together."""
    cmds, libs = [], {}
    for name, edits in VARIANTS.items():
        text = SOURCE.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source has {text.count(old)} of\n{old}")
            text = text.replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        src, libs[name] = tmp / f"{stem}.cu", tmp / f"{stem}.so"
        src.write_text(text)
        cmds.append([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                     str(cuda_lib.CSRC), "-shared", "-o", str(libs[name]), str(src)])
    for name, proc in zip(VARIANTS, cuda_lib._run_all(cmds)):
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
        registers = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
        print(f"{name}: registers a thread, by kernel: {' '.join(registers)}", flush=True)
        libs[name] = ctypes.CDLL(str(libs[name]))
        for entry in ENTRIES:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = cuda_lib._SIGNATURES[entry], ctypes.c_int
    return libs


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cases(dev, stream):
    """(name, call(lib), the tensors of x and the weights, the output) of
    every timed case."""
    g = torch.Generator(dev).manual_seed(0)
    ptr = lambda *ts: [None if t is None else t.data_ptr() for t in ts]
    m = IMAGES * 14 * 14
    for k, n, residual in ((1024, 256, False), (256, 1024, True)):
        x = torch.relu(torch.randn(m, k, device=dev, generator=g))
        w = torch.randn(k, n, device=dev, generator=g) / math.sqrt(k)
        mul, add = torch.rand(n, device=dev, generator=g) + 0.5, torch.randn(n, device=dev,
                                                                            generator=g)
        res = torch.randn(m, n, device=dev, generator=g) if residual else None
        out = torch.empty(m, n, device=dev)

        def k4(lib, args=ptr(x, w, mul, add, res, out), m=m, n=n, k=k):
            cuda_lib.check(lib.macsa_matmul_bn_act_tf32x3(*args, m, n, k, 1, stream), "K4")
        yield f"K4 [{m},{k}]->{n}{' +res' if residual else ''} relu", k4, (x, w, res), out
        del x, w, res, out
    for stage, (hw, c, f) in STAGES.items():
        x = torch.relu(torch.randn(IMAGES * hw * hw, c, device=dev, generator=g))
        ws = [torch.randn(*s, device=dev, generator=g) / math.sqrt(s[-2])
              for s in ((c, f), (9, f, f), (f, c))]
        affine = [torch.rand(k, device=dev, generator=g) + 0.5 for k in (f, f, f, f, c, c)]
        out = torch.empty_like(x)
        planes = torch.empty(fr.tf32x3_plane_floats(c, f), device=dev)
        rows = fr.tf32x3_tile_rows(hw, hw, f)

        def k5(lib, args=ptr(x, ws[0], *affine[:2], ws[1], *affine[2:4], ws[2], *affine[4:],
                             out, planes), hw=hw, c=c, f=f, rows=rows):
            cuda_lib.check(lib.macsa_fused_bottleneck_tf32x3(*args, IMAGES, hw, hw, c, f, rows,
                                                             stream), "K5")
        yield f"K5 stage {stage} {rows} rows a block", k5, (x, *ws), out
        del x, ws, affine, out, planes
        torch.cuda.empty_cache()


def main() -> int:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    stream = cuda_lib.stream_handle(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        for case, call, inputs, out in cases(dev, stream):
            whole = None
            for name, lib in libs.items():
                call(lib)
                torch.cuda.synchronize()
                if whole is None:
                    whole = out.clone()
                bits = ("same bits as whole" if torch.equal(out, whole) else
                        f"max |diff| from whole {(out - whole).abs().max().item():.3g}")
                print(f"{case:36s} {name:44s} {event_ms(lambda: call(lib)):.4f} ms; {bits}",
                      flush=True)
            # the whole kernels again with x and the weights all zero: what
            # the operands' values do to the time (the card's power and clocks)
            for t in inputs:
                if t is not None:
                    t.zero_()
            print(f"{case:36s} {'whole, zero x and weights':44s} "
                  f"{event_ms(lambda: call(libs['whole'])):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
