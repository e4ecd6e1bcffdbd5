"""Where K2's and K3's time goes: copies of their sources with one piece
taken out or one constant changed, built and timed beside the whole kernel.

    python macsa_tpu_torch/csrc/ablate_pixels_and_boxes.py

No kernel profiler works where the card is, so a piece's cost is read as the
time the kernel loses without it: each variant below is `image_prep.cu` or
`box_attention.cu` with a few lines replaced (the replacement must find its
text, so an edit of the source that moves a piece fails here, not
silently), compiled by `nvcc` into its own library and called through
`ctypes` at the shapes of the fine-tune path: packed ROI frames
`[8, 7, 4, 37633]` (a quarter invalid) to bf16 and f32, and box attention
at `[2688, 4, 96]` bf16.  Both kernels are so short that one Python call
costs the host more than the card, so every time here is the device's:
20 launches captured in a CUDA graph, the graph replayed 20 times between
CUDA events.  An empty kernel is timed the same way as the floor.  The
variants compute wrong results; only their times mean something.  Stores
are taken out behind a condition the compiler cannot decide, so the work
that feeds them stays.  Needs an H100 and `nvcc`.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from macsa_tpu_torch.ops import cuda_lib  # noqa: E402

K2, K3, EMPTY = "macsa_unpack_normalize", "macsa_box_attention_fwd", "macsa_empty_launch"

# name -> (source file, [(old, new), ...]); every `old` must occur once
VARIANTS = {
    "k2: whole": ("image_prep.cu", []),
    "k2: the one-word-per-thread kernel (the first design)": ("image_prep.cu", [
        ("  if (aligned16(out) && (!bf16 ||", "  if (frames < 0 && aligned16(out) && (!bf16 ||")]),
    "k2: no loads": ("image_prep.cu", [
        ("      cp_async16(smem_u32(buf + 4 * v), words + lo, true);",
         "      if (total_words < 0) cp_async16(smem_u32(buf + 4 * v), words + lo, true);")]),
    "k2: no stores": ("image_prep.cu", [
        ("      if (pair)\n        store_pair(dst, 4LL * w, y);\n      else\n"
         "        store_word(dst, 4LL * w, y);",
         "      if (total_words < 0) {\n      if (pair)\n        store_pair(dst, 4LL * w, y);\n"
         "      else\n        store_word(dst, 4LL * w, y);\n      }")]),
    "k2: no arithmetic (zeros stored)": ("image_prep.cu", [
        ("    const bool keep = !head || words[t.f * stride] != 0u;",
         "    const bool keep = total_words < 0;")]),
    "k2: tiles of 1344 words": ("image_prep.cu", [
        ("constexpr int kTileWords = 2688;", "constexpr int kTileWords = 1344;"),
        ("kTileWords % (2 * kTileThreads) == 0", "kTileWords % (2 * kTileThreads) != 1")]),
    "k2: tiles of 5376 words": ("image_prep.cu", [
        ("constexpr int kTileWords = 2688;", "constexpr int kTileWords = 5376;")]),
    "k2: half the resident blocks": ("image_prep.cu", [
        ("    blocks = sms * (per_sm > 0 ? per_sm : 1);",
         "    blocks = sms * (per_sm > 1 ? per_sm / 2 : 1);")]),
    "k2: tiles of 5376 words, half the blocks": ("image_prep.cu", [
        ("constexpr int kTileWords = 2688;", "constexpr int kTileWords = 5376;"),
        ("    blocks = sms * (per_sm > 0 ? per_sm : 1);",
         "    blocks = sms * (per_sm > 1 ? per_sm / 2 : 1);")]),
    "k2: one tile a block (no persistent grid)": ("image_prep.cu", [
        ("  const long long cap = resident_blocks<T>();", "  const long long cap = 1LL << 30;")]),
    "k2: plain stores (no __stcs)": ("image_prep.cu", [
        ("{ __stcs(p, v); }", "{ *p = v; }")]),
    "k2: validity word not read again": ("image_prep.cu", [
        ("    const bool keep = !head || words[t.f * stride] != 0u;",
         "    const bool keep = total_words > 0;")]),
    "k3: whole": ("box_attention.cu", []),
    "k3: one warp per slice (the first design)": ("box_attention.cu", [
        ("  if (d % E == 0 && chunks <= 32 &&", "  if (bh < 0 && d % E == 0 && chunks <= 32 &&")]),
    "k3: no logarithm, no exponential": ("box_attention.cu", [
        ("      s[t] = valid[t] ? s[t] / sqrt_d + logf(fmaxf(gate[t], kGeoClampMin)) : -INFINITY;",
         "      s[t] = valid[t] ? s[t] / sqrt_d + gate[t] : -INFINITY;"),
        ("      p[t] = valid[t] ? expf(s[t] - row_max) : 0.f;",
         "      p[t] = valid[t] ? s[t] - row_max : 0.f;")]),
    "k3: no loads": ("box_attention.cu", [
        ("  const bool has_chunk = live && lg < chunks;",
         "  const bool has_chunk = live && lg < chunks && bh < 0;\n"),
        ("  if (has_chunk) {\n#pragma unroll\n    for (int i = 0; i < N; ++i)\n      *reinterpret",
         "  if (live && lg < chunks) {\n#pragma unroll\n    for (int i = 0; i < N; ++i)\n"
         "      *reinterpret")]),
    "k3: no stores": ("box_attention.cu", [
        ("  if (has_chunk) {\n#pragma unroll\n    for (int i = 0; i < N; ++i)\n      *reinterpret",
         "  if (has_chunk && bh < 0) {\n#pragma unroll\n    for (int i = 0; i < N; ++i)\n"
         "      *reinterpret")]),
    "k3: blocks of 256 threads": ("box_attention.cu", [
        ("constexpr int kVecThreads = 128;", "constexpr int kVecThreads = 256;")]),
    "k3: blocks of 64 threads": ("box_attention.cu", [
        ("constexpr int kVecThreads = 128;", "constexpr int kVecThreads = 64;")]),
    "an empty kernel": ("measure/empty_launch.cu", []),
}


def build_all(tmp: Path) -> dict:
    """Every variant's library, all `nvcc` processes started together."""
    cmds, libs = [], {}
    for name, (source, edits) in VARIANTS.items():
        text = (cuda_lib.CSRC / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source has {text.count(old)} of\n{old}")
            text = text.replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in name)
        src, libs[name] = tmp / f"{stem}.cu", tmp / f"{stem}.so"
        src.write_text(text)
        cmds.append([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
                     "-shared", "-o", str(libs[name]), str(src)])
    for name, proc in zip(VARIANTS, cuda_lib._run_all(cmds)):
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}\n{proc.stderr}")
        libs[name] = ctypes.CDLL(str(libs[name]))
        for entry in (K2, K3, EMPTY):
            fn = getattr(libs[name], entry, None)
            if fn is not None:
                fn.argtypes = cuda_lib._SIGNATURES.get(entry, [ctypes.c_void_p])
                fn.restype = ctypes.c_int
    return libs


def graph_ms(launch, per_graph: int = 20, replays: int = 20) -> float:
    """Mean device time of one `launch(stream)`: `per_graph` launches
    captured in a CUDA graph, replayed `replays` times between events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(side.cuda_stream)  # first launch outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(per_graph):
            launch(stream)
    for _ in range(3):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def main() -> int:
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    g = torch.Generator(dev).manual_seed(0)
    pixels = torch.randint(0, 256, (8, 7, 4, 224 * 224 * 3), dtype=torch.uint8, device=dev,
                           generator=g)
    valid = torch.rand(8, 7, 4, device=dev, generator=g) > 0.25
    words = torch.cat([valid.to(torch.int32)[..., None], pixels.view(torch.int32)],
                      -1).contiguous()
    frames, wpf = 8 * 7 * 4, words.shape[-1]
    outs = {1: torch.empty(frames * (wpf - 1) * 4, dtype=torch.bfloat16, device=dev),
            0: torch.empty(frames * (wpf - 1) * 4, dtype=torch.float32, device=dev)}
    consts = (1.0 / 255.0, 0.485, 0.456, 0.406, 1 / 0.229, 1 / 0.224, 1 / 0.225)
    bh, n, d = 2688, 4, 96
    q, k, v = (torch.randn(bh, n, d, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    gates = torch.relu(torch.randn(bh, n, n, device=dev, generator=g)).to(torch.bfloat16)
    box_out = torch.empty_like(q)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(Path(tmp))
        for name, lib in libs.items():
            if name.startswith("k2"):
                line = f"{name:45s}"
                for bf16, label in ((1, "bf16"), (0, "f32")):
                    def launch(stream, bf16=bf16):
                        cuda_lib.check(getattr(lib, K2)(
                            words.data_ptr(), outs[bf16].data_ptr(), frames, wpf, bf16, *consts,
                            stream), K2)
                    line += f" {label} {graph_ms(launch):.4f} ms"
            elif name.startswith("k3"):
                def launch(stream):
                    cuda_lib.check(getattr(lib, K3)(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(),
                        box_out.data_ptr(), bh, n, d, 1, stream), K3)
                line = f"{name:45s} bf16 {graph_ms(launch):.4f} ms"
            else:
                empty = getattr(lib, EMPTY)
                line = f"{name:45s} {graph_ms(lambda s: cuda_lib.check(empty(s), EMPTY)):.4f} ms"
            print(line, flush=True)
    src = torch.empty(94_380_000 // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    print(f"{'copy_ of 47.19 MB (as many bytes moved as K2 bf16)':45s} "
          f"{graph_ms(lambda s: dst.copy_(src)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
