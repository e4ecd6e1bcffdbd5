"""ctypes bindings for the native host image pipeline (image_pipe.cpp).

A copy of `macsa_tpu/native/__init__.py` for the PyTorch port: libjpeg/libpng
decode + antialiased resize + ImageNet normalization compiled from
`image_pipe.cpp`, called with the GIL released so loader threads scale on
multi-core hosts.

Two differences from the original.  The shared object is built into
`macsa_tpu_torch/_build/` (git-ignored), never beside the source, under a
name that carries a hash of the source.  And decode is a capability of its
own: where the libjpeg/libpng headers are missing, the library is built
with `-DIP_NO_DECODE` and still serves resize and normalize
(`has_decode()` says which build is loaded).  Every public function
degrades to `None` if the toolchain is missing, and
`MACSA_NATIVE_IMAGES=0` disables the native path entirely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "image_pipe.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _enabled() -> bool:
    return os.environ.get("MACSA_NATIVE_IMAGES", "1") != "0"


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"_image_pipe_{digest}.so")


def ensure_built(force: bool = False) -> Optional[str]:
    """Compile the shared object if missing; its path, or None on failure.

    First with the decoders (`-ljpeg -lpng`), then without them
    (`-DIP_NO_DECODE`).  Concurrency-safe across processes: g++ writes to a
    pid-unique temp path that is atomically `os.replace`d into place, so a
    reader can never dlopen a half-written file.
    """
    try:
        so = _so_path()
        if not force and os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.build.{os.getpid()}"
        for defines, libs in (([], ["-ljpeg", "-lpng"]), (["-DIP_NO_DECODE"], [])):
            cmd = _FLAGS + defines + [_SRC, "-o", tmp] + libs
            try:
                proc = subprocess.run(cmd, capture_output=True, timeout=300)
                if proc.returncode == 0:
                    os.replace(tmp, so)
                    return so
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return None
    except Exception:
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    intp = ctypes.POINTER(ctypes.c_int)
    lib.ip_has_decode.restype = ctypes.c_int
    lib.ip_has_decode.argtypes = []
    lib.ip_decode.restype = u8p
    lib.ip_decode.argtypes = [ctypes.c_char_p, intp, intp]
    lib.ip_free.restype = None
    lib.ip_free.argtypes = [u8p]
    lib.ip_resize_u8.restype = None
    lib.ip_resize_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                 ctypes.c_int, ctypes.c_int]
    lib.ip_normalize_f32.restype = None
    lib.ip_normalize_f32.argtypes = [u8p, ctypes.c_longlong, f32p, f32p, f32p]
    lib.ip_resize_normalize_f32.restype = None
    lib.ip_resize_normalize_f32.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound CDLL, building it on first call; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            so = ensure_built() if _enabled() else None
            if so is not None:
                _lib = _bind(ctypes.CDLL(so))
        except OSError:
            _lib = None
        finally:
            _tried = True  # only now: a thread that sees it set must see the result too
    return _lib


def available() -> bool:
    return load() is not None


def has_decode() -> bool:
    """Whether the loaded library was built with libjpeg/libpng."""
    lib = load()
    return lib is not None and bool(lib.ip_has_decode())


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode(path: str) -> Optional[np.ndarray]:
    """Decode JPEG/PNG -> u8 HWC RGB array; None on failure or when the
    native decoders are unavailable (the caller takes its next decoder)."""
    lib = load()
    if lib is None or not lib.ip_has_decode():
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    buf = lib.ip_decode(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if not buf:
        return None
    try:
        n = h.value * w.value * 3
        out = np.ctypeslib.as_array(buf, shape=(n,)).reshape(
            h.value, w.value, 3).copy()
    finally:
        lib.ip_free(buf)
    return out


def resize_u8(img: np.ndarray, size: int) -> Optional[np.ndarray]:
    """Antialiased triangle resize, u8 HWC -> u8 [size, size, 3]."""
    lib = load()
    if lib is None or img.ndim != 3 or img.shape[2] != 3:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((size, size, 3), np.uint8)
    lib.ip_resize_u8(_u8p(img), img.shape[0], img.shape[1], _u8p(out), size,
                     size)
    return out


def resize_normalize(img: np.ndarray, size: int, mean: np.ndarray,
                     std: np.ndarray) -> Optional[np.ndarray]:
    """Fused resize + (x/255 - mean)/std, u8 HWC -> f32 [size, size, 3]."""
    lib = load()
    if lib is None or img.ndim != 3 or img.shape[2] != 3:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    lib.ip_resize_normalize_f32(_u8p(img), img.shape[0], img.shape[1],
                                _f32p(out), size, size, _f32p(mean),
                                _f32p(inv_std))
    return out
