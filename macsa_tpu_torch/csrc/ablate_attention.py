"""Where K1's tensor-core time goes: copies of a kernel source with one
piece taken out (or changed) each, built and timed beside the whole kernel.

    python macsa_tpu_torch/csrc/ablate_attention.py [wgmma|tf32x3]

The card's machine has no kernel profiler, so a piece's cost is read as the
time the kernel loses without it: each variant below is the source with a
few lines replaced (the replacement must find its text, so an edit of the
source that moves a piece fails here, not silently), compiled by `nvcc`
into its own library and called through `ctypes` on the train step's
shape, `[48, 170, 768]` with 12 heads, and on EF-CapTrRoBERTa's
`[48, 256, 768]`, 100 back-to-back launches between CUDA events, all in
one process.  "wgmma" (the default) is the bf16 variant,
`fused_attention_wgmma.cu` (at 170 rows the forward holding its keys and
the one-launch backward; at 256 the ring forward and the two streaming
launches); "tf32x3" the f32 variant, `fused_attention_tf32.cu` (64-key
tiles and two backward launches at both).  A piece that one shape's
kernels do not have leaves that shape's times as they are.  The variants
compute wrong results; only their times mean something, except where a
variant's name says it computes the same function.  Stores are taken out
behind a condition the compiler cannot decide (`L < 0`), so the work that
feeds them stays.  Needs an H100 and `nvcc`.
"""

import ctypes
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from macsa_tpu_torch.ops import cuda_lib  # noqa: E402

# name -> [(old, new), ...]; every `old` must occur in the source once
WGMMA_VARIANTS = {
    "whole": [],
    "fwd: no exponentials": [
        ("p[e] = __expf(s[4 * j + e] - (e < 2 ? mx_lo : mx_hi));",
         "p[e] = s[4 * j + e] - (e < 2 ? mx_lo : mx_hi);")],
    "fwd: no K and V loads": [
        ("  load_rows(k_addr, k + base, hd, 0, NK, L, kWG);\n", ""),
        ("  load_rows(v_addr, v + base, hd, 0, NK, L, kWG);\n", ""),
        ("      load_rows(kv, k + base, hd, t * NK, NK, L, kWG);\n"
         "      load_rows(kv + NK * kRowBytes, v + base, hd, t * NK, NK, L, kWG);\n", "")],
    "fwd: no output stores": [
        ("  store_rows(q_tile, out, hd, q0, kTile, L, kWG);\n}",
         "  if (L < 0) store_rows(q_tile, out, hd, q0, kTile, L, kWG);\n}")],
    "fwd: two blocks an SM": [
        ("__launch_bounds__(kWG, 3)\nattention_fwd_wgmma_kernel",
         "__launch_bounds__(kWG, 2)\nattention_fwd_wgmma_kernel"),
        ("__launch_bounds__(kWG, 5)\nattention_fwd_ring_kernel",
         "__launch_bounds__(kWG, 2)\nattention_fwd_ring_kernel")],
    "fwd ring: three stages": [
        ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")],
    "fwd ring: 128 keys a pass, three blocks an SM": [
        ("constexpr int kRingKeys = 64;", "constexpr int kRingKeys = 128;"),
        ("__launch_bounds__(kWG, 5)\nattention_fwd_ring_kernel",
         "__launch_bounds__(kWG, 3)\nattention_fwd_ring_kernel")],
    "bwd: no exponentials": [
        ("e.p = __expf(fmaf(s, scale, mk) - lse_i);", "e.p = fmaf(s, scale, mk) - lse_i;")],
    "bwd: no loads": [
        ("  load_rows(q_addr, q + base, hd, 0, rows, L, kBwdThreads);\n"
         "  load_rows(k_addr, k + base, hd, 0, rows, L, kBwdThreads);\n"
         "  load_rows(v_addr, v + base, hd, 0, rows, L, kBwdThreads);\n"
         "  load_rows(g_addr, gout + base, hd, 0, rows, L, kBwdThreads);\n", ""),
        ("  load_rows(q_addr, q + base, hd, q0, kTile, L, kWG);  // in step 0's group\n"
         "  load_rows(g_addr, gout + base, hd, q0, kTile, L, kWG);\n", ""),
        ("      load_rows(kv, k + base, hd, key0(t), kTile, L, kWG);\n"
         "      load_rows(kv + kTileBytes, v + base, hd, key0(t), kTile, L, kWG);\n", ""),
        ("  load_rows(k_addr, k + base, hd, j0, kTile, L, kWG);  // in step 0's group\n"
         "  load_rows(v_addr, v + base, hd, j0, kTile, L, kWG);\n", ""),
        ("      load_rows(qg, q + base, hd, t * kTile, kTile, L, kWG);\n"
         "      load_rows(qg + kTileBytes, gout + base, hd, t * kTile, kTile, L, kWG);\n", "")],
    "bwd: no stores": [
        ("  store_rows(q_tile, dq + base, hd, 0, rows, L, kBwdThreads);\n",
         "  if (L < 0) {\n  store_rows(q_tile, dq + base, hd, 0, rows, L, kBwdThreads);\n"),
        ("  store_rows(v_tile, dv + base, hd, 0, rows, L, kBwdThreads);\n}",
         "  store_rows(v_tile, dv + base, hd, 0, rows, L, kBwdThreads);\n  }\n}"),
        ("  store_rows(q_tile, dq + base, hd, q0, kTile, L, kWG);\n",
         "  if (L < 0) store_rows(q_tile, dq + base, hd, q0, kTile, L, kWG);\n"),
        ("  store_rows(k_tile, dk + base, hd, j0, kTile, L, kWG);\n",
         "  if (L < 0) store_rows(k_tile, dk + base, hd, j0, kTile, L, kWG);\n"),
        ("  store_rows(v_tile, dv + base, hd, j0, kTile, L, kWG);\n}",
         "  if (L < 0) store_rows(v_tile, dv + base, hd, j0, kTile, L, kWG);\n}")],
    "bwd: no pass 1 (row term 0)": [
        ("    for (int kt = 0; kt < tiles; ++kt) {\n      float s[32], dp[32];",
         "    for (int kt = 0; kt < (L < 0 ? tiles : 0); ++kt) {\n      float s[32], dp[32];")],
    "bwd: no pass 3 (dq)": [
        ("    for (int kk = 0; kk < rows / 16; ++kk)\n      wgmma::Op<64>::ss<1, 1>(acc_q,",
         "    for (int kk = 0; kk < (L < 0 ? rows / 16 : 1); ++kk)\n"
         "      wgmma::Op<64>::ss<1, 1>(acc_q,")],
    "bwd: no ds^T stores to shared memory": [
        ("key_tile_walk<true>(", "key_tile_walk<false>(")],
    "bwd streamed: launch 1 (dq) alone": [
        ("  attention_bwd_dkdv_kernel<<<", "  if (L < 0) attention_bwd_dkdv_kernel<<<")],
    "bwd streamed: launch 2 (dk, dv) alone": [
        ("  attention_bwd_dq_kernel<<<", "  if (L < 0) attention_bwd_dq_kernel<<<")],
    "bwd streamed: three-stage rings": [
        ("constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 3;")],
    "bwd streamed: three dq blocks an SM": [
        ("__launch_bounds__(kWG, 4)\nattention_bwd_dq_kernel",
         "__launch_bounds__(kWG, 3)\nattention_bwd_dq_kernel")],
    "bwd streamed: four dk/dv blocks an SM": [
        ("__launch_bounds__(kWG, 3)\nattention_bwd_dkdv_kernel",
         "__launch_bounds__(kWG, 4)\nattention_bwd_dkdv_kernel")],
    "bwd streamed: walk (b) without copies": [
        ("    if (t < walked) {\n      const uint32_t kv",
         "    if (t < tiles) {\n      const uint32_t kv")],
    "bwd streamed: launch 2 copies every other tile": [
        ("    if (t < tiles) {\n      const uint32_t qg",
         "    if (t < tiles && t % 2 == 0) {\n      const uint32_t qg")],
    "bwd streamed: two blocks an SM": [
        ("__launch_bounds__(kWG, 4)\nattention_bwd_dq_kernel",
         "__launch_bounds__(kWG, 2)\nattention_bwd_dq_kernel"),
        ("__launch_bounds__(kWG, 3)\nattention_bwd_dkdv_kernel",
         "__launch_bounds__(kWG, 2)\nattention_bwd_dkdv_kernel")],
}


TF32_VARIANTS = {
    "whole": [],
    "products in chains (one slice's three terms in a row; same function)": [
        ("  for (int n = 0; n < kSlices; ++n) {\n    if (kTransposed) {\n"
         "      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n    } else {\n"
         "      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n    }\n  }\n#pragma unroll\n"
         "  for (int n = 0; n < kSlices; ++n) {\n    if (kTransposed) {\n"
         "      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n    } else {\n"
         "      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n    }\n  }\n#pragma unroll\n"
         "  for (int n = 0; n < kSlices; ++n) mma_tf32(c[n], a.big, b0[n].big, b1[n].big);",
         "  for (int n = 0; n < kSlices; ++n) {\n"
         "    mma_tf32(c[n], kTransposed ? a.big : a.small, kTransposed ? b0[n].small : b0[n].big,\n"
         "             kTransposed ? b1[n].small : b1[n].big);\n"
         "    mma_tf32(c[n], kTransposed ? a.small : a.big, kTransposed ? b0[n].big : b0[n].small,\n"
         "             kTransposed ? b1[n].big : b1[n].small);\n"
         "    mma_tf32(c[n], a.big, b0[n].big, b1[n].big);\n  }")],
    "split by cvt.rna.tf32.f32 (same function)": [
        ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')],
    "one TF32 product (big*big)": [
        ("  for (int n = 0; n < kSlices; ++n) {\n    if (kTransposed) {\n"
         "      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n    } else {\n"
         "      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n    }\n  }\n#pragma unroll\n"
         "  for (int n = 0; n < kSlices; ++n) {\n    if (kTransposed) {\n"
         "      mma_tf32(c[n], a.small, b0[n].big, b1[n].big);\n    } else {\n"
         "      mma_tf32(c[n], a.big, b0[n].small, b1[n].small);\n    }\n  }\n#pragma unroll\n", "")],
    "exponentials as exp2f of log2(e)-scaled arguments": [
        ("const float p = expf(s[n][e] - m[r]);",
         "const float p = exp2f((s[n][e] - m[r]) * 1.44269504f);"),
        ("expf(s[n][e] * scale + mv[c] - row_lse[r])",
         "exp2f((s[n][e] * scale + mv[c] - row_lse[r]) * 1.44269504f)"),
        ("expf(s[n][e] * scale + mj[r] - lv[c])",
         "exp2f((s[n][e] * scale + mj[r] - lv[c]) * 1.44269504f)")],
    "no tile copies": [
        ("    hopper::cp_async16(hopper::smem_u32(tile",
         "    if (L < 0) hopper::cp_async16(hopper::smem_u32(tile")],
    "fwd: no exponentials": [
        ("const float p = expf(s[n][e] - m[r]);", "const float p = s[n][e] - m[r];")],
    "fwd: three blocks an SM": [
        ("__launch_bounds__(kThreads)\nattention_fwd_tf32_kernel",
         "__launch_bounds__(kThreads, 3)\nattention_fwd_tf32_kernel")],
    "bwd: no exponentials": [
        ("expf(s[n][e] * scale + mv[c] - row_lse[r])", "(s[n][e] * scale + mv[c] - row_lse[r])"),
        ("expf(s[n][e] * scale + mj[r] - lv[c])", "(s[n][e] * scale + mj[r] - lv[c])")],
    "bwd: launch 1 (dq) alone": [
        ("  attention_bwd_dkdv_tf32_kernel<<<", "  if (L < 0) attention_bwd_dkdv_tf32_kernel<<<")],
    "bwd: launch 2 (dk, dv) alone": [
        ("  attention_bwd_dq_tf32_kernel<<<", "  if (L < 0) attention_bwd_dq_tf32_kernel<<<")],
    "bwd: launch 1 without the row-term walk": [
        ("for (int t = 0; t < 2 * tiles; ++t) {", "for (int t = tiles; t < 2 * tiles; ++t) {")],
}

# variant family -> (source, forward and backward entry points, dtype, variants)
KERNELS = {
    "wgmma": ("fused_attention_wgmma.cu", "macsa_fused_attention_fwd_wgmma",
              "macsa_fused_attention_bwd_wgmma", torch.bfloat16, WGMMA_VARIANTS),
    "tf32x3": ("fused_attention_tf32.cu", "macsa_fused_attention_fwd_tf32x3",
               "macsa_fused_attention_bwd_tf32x3", torch.float32, TF32_VARIANTS),
}


def build_all(tmp: Path, source: Path, entries: tuple, variants: dict) -> dict:
    """Every variant's library, all `nvcc` processes started together."""
    cmds, libs = [], {}
    for name, edits in variants.items():
        text = source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source has {text.count(old)} of\n{old}")
            text = text.replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        src, libs[name] = tmp / f"{stem}.cu", tmp / f"{stem}.so"
        src.write_text(text)
        cmds.append([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
                     "-shared", "-o", str(libs[name]), str(src)])
    for name, proc in zip(variants, cuda_lib._run_all(cmds)):
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
        libs[name] = ctypes.CDLL(str(libs[name]))
        for entry in entries:
            fn = getattr(libs[name], entry)
            fn.argtypes, fn.restype = cuda_lib._SIGNATURES[entry], ctypes.c_int
    return libs


def event_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list) -> int:
    family = argv[0] if argv else "wgmma"
    if family not in KERNELS:
        raise SystemExit(f"usage: ablate_attention.py [{'|'.join(KERNELS)}]")
    source, fwd_entry, bwd_entry, dtype, variants = KERNELS[family]
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"{family}: {source}, {str(dtype)[6:]}")
    g = torch.Generator(dev).manual_seed(0)
    b, h = 48, 12
    stream = cuda_lib.stream_handle(dev)
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp), cuda_lib.CSRC / source, (fwd_entry, bwd_entry), variants)
        for l, (rate_args, rate) in itertools.product(
                (170, 256), (((0, 0, 1.0, 0, None), 0.0),
                             ((1, 429496730, 1.0 / 0.9, 7, None), 0.1))):
            q, k, v, gout = (torch.randn(b, l, h * 64, device=dev, generator=g).to(dtype)
                             for _ in range(4))
            mask = torch.zeros(b, l, device=dev)
            out, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
            lse, row_term = (torch.empty(b, h, l, device=dev) for _ in range(2))
            for name, lib in libs.items():

                def fwd():
                    status = getattr(lib, fwd_entry)(*ptr(q, k, v, mask, out, lse), b, l, h,
                                                     *rate_args, stream)
                    cuda_lib.check(status, fwd_entry)

                def bwd():
                    status = getattr(lib, bwd_entry)(*ptr(q, k, v, mask, gout, lse, row_term,
                                                         dq, dk, dv), b, l, h, *rate_args, stream)
                    cuda_lib.check(status, bwd_entry)

                fwd()  # the backward reads the forward's lse
                torch.cuda.synchronize()
                line = f"[{b},{l},{h * 64}] rate {rate} {name:40s}"
                if not name.startswith("bwd"):
                    line += f" forward {event_ms(fwd):.4f} ms"
                if not name.startswith("fwd"):
                    line += f" backward {event_ms(bwd):.4f} ms"
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
