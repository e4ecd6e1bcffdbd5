"""K1's kernels from two source trees, built side by side and timed in turns.

    python macsa_tpu_torch/csrc/compare_attention_builds.py OTHER_CSRC_DIR

Builds every `*.cu` of this checkout's `macsa_tpu_torch/csrc` and of
OTHER_CSRC_DIR (another checkout's `csrc`, for example the parent commit's
unpacked with `git archive` into a git-ignored directory) into a library
each, with the build's own flags, and times K1's forward and backward from
both on the same card, in turns (other, this, this, other), 100 launches
between CUDA events each, at the train step's [48, 170, 768] and at
EF-CapTrRoBERTa's [48, 256, 768], 12 heads, rate 0 and 0.1: bf16 through
the "wgmma" entry points of both, and f32 through the entry point each tree
routes it to (`macsa_fused_attention_{fwd,bwd}_tf32x3` where the library
has them, else the CUDA-core `macsa_fused_attention_{fwd,bwd}` at head width
64).  Before timing, each case's outputs of the two trees are compared
bit for bit (forward: out, lse; backward: dq, dk, dv); it exits 1 if they
differ, as they may where a tree changed K1's arithmetic.  `chip_smoke.py`
checks the numbers against the plain versions.  Needs an H100 and `nvcc`.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from macsa_tpu_torch.ops import cuda_lib  # noqa: E402

ENTRIES = ("macsa_fused_attention_fwd", "macsa_fused_attention_bwd",
           "macsa_fused_attention_fwd_wgmma", "macsa_fused_attention_bwd_wgmma",
           "macsa_fused_attention_fwd_tf32x3", "macsa_fused_attention_bwd_tf32x3")


def build(csrc: Path, out: Path) -> ctypes.CDLL:
    """One library from every `*.cu` of `csrc`, each compiled by its own
    `nvcc`, all started together; the K1 entry points it has, declared."""
    sources = sorted(csrc.glob("*.cu"))
    objects = [out.with_name(f"{out.stem}.{src.stem}.o") for src in sources]
    cmds = [[cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(csrc), "-c", "-o", str(obj),
             str(src)] for src, obj in zip(sources, objects)]
    for cmd, proc in zip(cmds, cuda_lib._run_all(cmds)):
        cuda_lib._check_build(cmd, proc)
    link = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(out),
            *map(str, objects)]
    cuda_lib._check_build(link, subprocess.run(link, capture_output=True, text=True))
    lib = ctypes.CDLL(str(out))
    # a tree from before the entry points took a seed word passes none
    lib.seed_word = "seed_word" in (csrc / "attention_dropout.cuh").read_text()
    for name in ENTRIES:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            sig = cuda_lib._SIGNATURES[name]
            fn.argtypes = sig if lib.seed_word else sig[:-2] + sig[-1:]
            fn.restype = ctypes.c_int
    return lib


def launchers(lib, dtype, b: int, l: int, h: int, tensors: dict, rate_args: tuple, stream):
    """(variant, forward, backward) of `lib` for `dtype` at head width 64."""
    t = tensors
    ptr = lambda *names: [t[n].data_ptr() for n in names]
    rate_args = rate_args if lib.seed_word else rate_args[:-1]
    fwd_in, bwd_in = ptr("q", "k", "v", "mask", "out", "lse"), ptr(
        "q", "k", "v", "mask", "g", "lse", "row_term", "dq", "dk", "dv")
    if dtype == torch.bfloat16:
        variant, fwd, bwd, extra = "wgmma", lib.macsa_fused_attention_fwd_wgmma, \
            lib.macsa_fused_attention_bwd_wgmma, ()
    elif hasattr(lib, "macsa_fused_attention_fwd_tf32x3"):
        variant, fwd, bwd, extra = "tf32x3", lib.macsa_fused_attention_fwd_tf32x3, \
            lib.macsa_fused_attention_bwd_tf32x3, ()
    else:
        variant, fwd, bwd, extra = "simt", lib.macsa_fused_attention_fwd, \
            lib.macsa_fused_attention_bwd, (64, 0)
    return (variant,
            lambda: cuda_lib.check(fwd(*fwd_in, b, l, h, *extra, *rate_args, stream), variant),
            lambda: cuda_lib.check(bwd(*bwd_in, b, l, h, *extra, *rate_args, stream), variant))


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
    if len(argv) != 1 or not Path(argv[0]).is_dir():
        raise SystemExit("usage: compare_attention_builds.py OTHER_CSRC_DIR")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    stream = cuda_lib.stream_handle(dev)
    g = torch.Generator(dev).manual_seed(0)
    b, h = 48, 12
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(Path(argv[0]).resolve(), Path(tmp) / "other.so"),
                "this": build(cuda_lib.CSRC, Path(tmp) / "this.so")}
        for l in (170, 256):
            for dtype in (torch.bfloat16, torch.float32):
                for rate_args, rate in (((0, 0, 1.0, 0, None), 0.0),
                                        ((1, 429496730, 1.0 / 0.9, 7, None), 0.1)):
                    t = {n: torch.randn(b, l, h * 64, device=dev, generator=g).to(dtype)
                         for n in ("q", "k", "v", "g")}
                    t["mask"] = torch.zeros(b, l, device=dev)
                    t.update({n: torch.empty_like(t["q"]) for n in ("out", "dq", "dk", "dv")})
                    t.update({n: torch.empty(b, h, l, device=dev) for n in ("lse", "row_term")})
                    runs = {name: launchers(lib, dtype, b, l, h, t, rate_args, stream)
                            for name, lib in libs.items()}
                    outputs = {}
                    for name, (_, fwd, bwd) in runs.items():
                        fwd()  # the backward reads the forward's lse
                        bwd()
                        outputs[name] = [t[n].clone() for n in ("out", "lse", "dq", "dk", "dv")]
                    same = all(torch.equal(x, y) for x, y in zip(*outputs.values()))
                    differ += not same
                    print(f"[{b},{l},{h * 64}] {str(dtype)[6:]} rate {rate}: out, lse, dq, dk, "
                          f"dv of the two trees {'bitwise equal' if same else 'DIFFER'}",
                          flush=True)
                    for which in (1, 2):
                        times = [(name, event_ms(runs[name][which]))
                                 for name in ("other", "this", "this", "other")]
                        print(f"[{b},{l},{h * 64}] {str(dtype)[6:]} rate {rate} "
                              f"{'forward' if which == 1 else 'backward'}, in turns: "
                              + ", ".join(f"{name} ({runs[name][0]}) {ms:.4f}"
                                          for name, ms in times), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
