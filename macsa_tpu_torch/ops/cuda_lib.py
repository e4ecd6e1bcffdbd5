"""Build, load and count the port's hand-written CUDA kernels.

Every `*.cu` file under `macsa_tpu_torch/csrc/` is compiled by `nvcc` into
ONE shared library with a plain C interface, loaded with `ctypes`.  The
build runs at first use, from the checkout's sources only, into
`macsa_tpu_torch/_build/`; the library's file name carries a hash of the
sources and flags, so an edited source rebuilds.  A missing or failing
`nvcc` raises with its output: there is no fallback.

`launch_counts` is the one piece of module state: each kernel wrapper adds
one to its entry where it launches its kernel, so a run can show that the
main path went through the kernels.
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
              "-shared", "-Xcompiler", "-fPIC")

launch_counts: collections.Counter = collections.Counter()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
# C entry points: name -> argtypes.  Every pointer and the stream go as
# c_void_p: an undeclared pointer would be cut to 32 bits.
_SIGNATURES = {
    # q, k, v, mask, out, lse (or NULL), B, L, H, D, bf16,
    # dropout, keep_threshold, inv_keep, seed, stream
    "macsa_fused_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _U, _F, _U, _P],
    # q, k, v, mask, g, lse, row_term, dq, dk, dv, B, L, H, D, bf16,
    # dropout, keep_threshold, inv_keep, seed, stream
    "macsa_fused_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _U, _F, _U, _P],
    # words, out, frames, words_per_frame, bf16, inv255, mean[3], inv_std[3], stream
    "macsa_unpack_normalize": [_P, _P, _LL, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P],
    # bytes, out, n, bf16, inv255, mean[3], inv_std[3], stream
    "macsa_normalize_u8": [_P, _P, _LL, _I, _F, _F, _F, _F, _F, _F, _F, _P],
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"could not run {nvcc}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


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
