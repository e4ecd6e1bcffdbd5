"""Build, load and count the port's hand-written CUDA kernels.

Every `*.cu` file under `macsa_tpu_torch/csrc/` is compiled by its own
`nvcc` process, all started together, and the objects are linked into ONE
shared library with a plain C interface, loaded with `ctypes`.  The
build runs at first use, from the checkout's sources only, into
`macsa_tpu_torch/_build/`; the library's file name carries a hash of the
sources and flags, so an edited source rebuilds.  A missing or failing
`nvcc` raises with its output: there is no fallback.

`launch_counts` is the one piece of module state: each kernel wrapper adds
one to its entry where it launches its kernel, so a run can show that the
main path went through the kernels.  Every launch runs under its tensors'
device (`on_tensor_device`).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
# C entry points: name -> argtypes.  Every pointer and the stream go as
# c_void_p: an undeclared pointer would be cut to 32 bits.
_SIGNATURES = {
    # q, k, v, mask, out, lse (or NULL), B, L, H, D, bf16,
    # dropout, keep_threshold, inv_keep, seed, seed_word (or NULL), stream
    "macsa_fused_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _U, _F, _U, _P, _P],
    # q, k, v, mask, g, lse, row_term, dq, dk, dv, B, L, H, D, bf16,
    # dropout, keep_threshold, inv_keep, seed, seed_word (or NULL), stream
    "macsa_fused_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _U, _F, _U, _P, _P],
    # the bf16 tensor-core variants (csrc/fused_attention_wgmma.cu), head width 64
    # q, k, v, mask, out, lse (or NULL), B, L, H, dropout, keep_threshold, inv_keep, seed,
    # seed_word (or NULL), stream
    "macsa_fused_attention_fwd_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _F, _U,
                                        _P, _P],
    # q, k, v, mask, g, lse, row_term (or NULL up to 192 rows), dq, dk, dv, B, L, H,
    # dropout, keep_threshold, inv_keep, seed, seed_word (or NULL), stream
    "macsa_fused_attention_bwd_wgmma": [_P] * 10 + [_I, _I, _I, _I, _U, _F, _U, _P, _P],
    # the f32 tensor-core variants (csrc/fused_attention_tf32.cu), head width 64: the
    # same arguments as the bf16 ones (the backward's row_term is required)
    "macsa_fused_attention_fwd_tf32x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _F, _U,
                                         _P, _P],
    "macsa_fused_attention_bwd_tf32x3": [_P] * 10 + [_I, _I, _I, _I, _U, _F, _U, _P, _P],
    # words, out, frames, words_per_frame, bf16, inv255, mean[3], inv_std[3], stream
    "macsa_unpack_normalize": [_P, _P, _LL, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    # bytes, out, n, bf16, inv255, mean[3], inv_std[3], stream
    "macsa_normalize_u8": [_P, _P, _LL, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    # q, k, v, gates, out, bh, n, d, bf16, stream
    "macsa_box_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, mul, add, residual (or NULL), out, m, n, k, relu, bf16, stream
    "macsa_matmul_bn_act": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, out, n, h, w, c, f, bf16, stream
    "macsa_fused_bottleneck": [_P] * 11 + [_I] * 6 + [_P],
    # the bf16 tensor-core variants (csrc/fused_resnet_wgmma.cu)
    # x, w, mul, add, residual (or NULL), out, m, n, k, relu, stream
    "macsa_matmul_bn_act_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, out, n, h, w, c, f, tile_rows, stream
    "macsa_fused_bottleneck_wgmma": [_P] * 11 + [_I] * 6 + [_P],
    # the f32 tensor-core variants (csrc/fused_resnet_tf32.cu): K4's arguments as
    # above; K5's with the scratch of its weights' TF32 planes after out
    "macsa_matmul_bn_act_tf32x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "macsa_fused_bottleneck_tf32x3": [_P] * 12 + [_I] * 6 + [_P],
    # w1, w2, w3, planes, c, f, stream
    "macsa_tf32_weight_planes": [_P, _P, _P, _P, _I, _I, _P],
}


def reset_launch_counts() -> None:
    launch_counts.clear()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "port's CUDA kernels cannot be built")


def build_library(build_dir: Path = BUILD_DIR, nvcc: str | None = None) -> Path:
    """Compile csrc/*.cu into one shared library (skipped when a library
    built from the same sources and flags exists) and return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = Path(build_dir) / f"libmacsa_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = nvcc or find_nvcc()
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [Path(build_dir) / f"{tag}.{src.stem}.o" for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objects)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, proc in zip(compiles, _run_all(compiles)):
            _check_build(cmd, proc)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        _check_build(link, subprocess.run(link, capture_output=True, text=True))
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def _run_all(cmds: list) -> list:
    """Start every command at once; wait for all.  -> CompletedProcess list."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    except OSError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"could not run {cmds[0][0]}: {e}") from e
    done = []
    for cmd, p in zip(cmds, procs):
        stdout, stderr = p.communicate()
        done.append(subprocess.CompletedProcess(cmd, p.returncode, stdout, stderr))
    return done


def _check_build(cmd: list, proc: subprocess.CompletedProcess) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point's `cudaGetLastError()` is not cudaSuccess."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_tensor_device(launch):
    """Run a launch function under the CUDA device of its first argument, so
    a kernel reaches the tensors' card whatever device is current (a rank's
    tensors on `cuda:N` while device 0 is current)."""
    @functools.wraps(launch)
    def guarded(x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return launch(x, *args, **kwargs)
    return guarded
