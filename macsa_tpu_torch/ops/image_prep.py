"""On-device pixel normalization in front of the ResNet (kernel K2).

Counterpart of `macsa_tpu/ops/image_prep.py`.  The host ships 1 byte per
pixel, either as frame-structured packed words (`pack_pixels_u8`, the
loader's default) or as raw uint8 `[..., H, W, 3]`; the device computes

    y = (x * (1/255) - mean[c]) * (1/std[c]),   c = byte index mod 3

in float32, then casts to the ResNet's dtype.  Packed frames whose
validity word is 0 come out as exact zeros, the reference's empty-slot
value (vimacsa_dataset.py:130-135 zero-fills after the transform).

PyTorch has few operations on `torch.uint32`, so the port carries packed
words as an int32 view of the same bytes; the kernel reads them unsigned.

On a CUDA tensor the wrappers launch the hand-written kernel
(`macsa_tpu_torch/csrc/image_prep.cu`); on a CPU tensor they run the plain
PyTorch version beside it.  The output is NHWC-contiguous, so
`.permute(0, 3, 1, 2)` is a channels-last NCHW view with no copy.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from macsa_tpu_torch.models.resnet import IMAGENET_MEAN, IMAGENET_STD
from macsa_tpu_torch.ops import cuda_lib

# f32 constants of the host pipe's formula (x * (1/255) - mean) * (1/std),
# shared by the kernel and its plain version so the two agree bit for bit
_INV255 = np.float32(1.0) / np.float32(255.0)
_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_INV_STD = np.float32(1.0) / np.asarray(IMAGENET_STD, np.float32)
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def packed_words_per_frame(image_size: int) -> int:
    """Length of one packed frame: 1 validity word + the pixel words."""
    nbytes = image_size * image_size * 3
    if nbytes % 4:
        raise ValueError(f"image_size {image_size}: {nbytes} bytes is not whole words")
    return 1 + nbytes // 4


def frame_size(words_per_frame: int) -> int:
    """Inverse of `packed_words_per_frame` (raises if no square frame fits)."""
    size = math.isqrt((words_per_frame - 1) * 4 // 3)
    if size < 1 or packed_words_per_frame(size) != words_per_frame:
        raise ValueError(f"{words_per_frame} words is not a packed square RGB frame")
    return size


def pack_pixels_u8(images: np.ndarray, valid: np.ndarray | None = None) -> np.ndarray:
    """Host packing: uint8 [..., S, S, 3] (+ validity [...]) -> int32 words
    [..., 1 + S*S*3/4].  Word 0 of each frame is its validity flag, the rest
    are the frame's bytes as little-endian words: the same bytes as
    `macsa_tpu.ops.image_prep.pack_pixels_u8`, viewed as int32."""
    if images.dtype != np.uint8 or images.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., S, S, 3], got {images.dtype} {images.shape}")
    if sys.byteorder != "little":
        raise RuntimeError("packed transfer assumes a little-endian host")
    lead = images.shape[:-3]
    nbytes = int(np.prod(images.shape[-3:]))
    if nbytes % 4:
        raise ValueError(f"frame of {nbytes} bytes is not whole words")
    words = np.ascontiguousarray(images).reshape(lead + (nbytes,)).view(np.int32)
    if valid is None:
        head = np.ones(lead + (1,), np.int32)
    else:
        if valid.shape != lead:
            raise ValueError(f"valid {valid.shape} != frame axes {lead}")
        head = valid.astype(np.int32).reshape(lead + (1,))
    return np.concatenate([head, words], axis=-1)


def _normalize_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 pixel values [..., 3] -> (x * (1/255) - mean) * (1/std)."""
    dev = x.device
    return ((x * torch.tensor(_INV255, device=dev) - torch.tensor(_MEAN, device=dev))
            * torch.tensor(_INV_STD, device=dev))


def unpack_normalize_pixels_reference(words: torch.Tensor,
                                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K2 on packed frames: int32 [..., W] -> [..., S, S, 3]."""
    size = frame_size(words.shape[-1])
    lead = tuple(words.shape[:-1])
    pixels = words[..., 1:].contiguous().view(torch.uint8)
    x = _normalize_plain(pixels.reshape(lead + (size, size, 3)).float())
    valid = (words[..., 0] != 0).reshape(lead + (1, 1, 1))
    return torch.where(valid, x, torch.zeros((), device=x.device)).to(out_dtype)


def normalize_images_u8_reference(images: torch.Tensor,
                                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K2 on raw uint8 [..., H, W, 3]."""
    return _normalize_plain(images.float()).to(out_dtype)


def _check_cuda_args(x: torch.Tensor, dtype: torch.dtype, out_dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 4:
        raise ValueError("input must be contiguous and 4-byte aligned")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, got {out_dtype}")


def _constants():
    return (float(_INV255), *map(float, _MEAN), *map(float, _INV_STD))


def unpack_normalize_pixels(words: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Packed frames int32 [..., 1 + S*S*3/4] -> normalized [..., S, S, 3]."""
    if words.device.type == "cpu":
        return unpack_normalize_pixels_reference(words, out_dtype)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    _check_cuda_args(words, torch.int32, out_dtype)
    wpf = words.shape[-1]
    size = frame_size(wpf)
    out = torch.empty(tuple(words.shape[:-1]) + (size, size, 3), dtype=out_dtype,
                      device=words.device)
    frames = words.numel() // wpf
    if frames:
        _launch_unpack_normalize(words, out, frames, wpf)
    return out


@cuda_lib.on_tensor_device
def _launch_unpack_normalize(words: torch.Tensor, out: torch.Tensor, frames: int,
                             wpf: int) -> None:
    status = cuda_lib.library().macsa_unpack_normalize(
        words.data_ptr(), out.data_ptr(), frames, wpf, int(out.dtype == torch.bfloat16),
        *_constants(), cuda_lib.stream_handle(words.device))
    cuda_lib.check(status, "macsa_unpack_normalize")
    cuda_lib.launch_counts["device_normalize"] += 1


def normalize_images_u8(images: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Raw uint8 [..., H, W, 3] -> normalized out_dtype of the same shape."""
    if images.shape[-1] != 3:
        raise ValueError(f"expected [..., H, W, 3], got {tuple(images.shape)}")
    if images.device.type == "cpu":
        return normalize_images_u8_reference(images, out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    _check_cuda_args(images, torch.uint8, out_dtype)
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if images.numel():
        _launch_normalize_u8(images, out)
    return out


@cuda_lib.on_tensor_device
def _launch_normalize_u8(images: torch.Tensor, out: torch.Tensor) -> None:
    status = cuda_lib.library().macsa_normalize_u8(
        images.data_ptr(), out.data_ptr(), images.numel(), int(out.dtype == torch.bfloat16),
        *_constants(), cuda_lib.stream_handle(images.device))
    cuda_lib.check(status, "macsa_normalize_u8")
    cuda_lib.launch_counts["device_normalize"] += 1


def device_normalize(images: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Entry point dispatching on the transfer encoding:

    * int32 -- packed frames from `pack_pixels_u8` (the loader's default),
    * uint8 -- raw pixels,
    * float -- already normalized on the host; just cast."""
    if images.dtype == torch.int32:
        return unpack_normalize_pixels(images, out_dtype)
    if images.dtype == torch.uint8:
        return normalize_images_u8(images, out_dtype)
    if not images.is_floating_point():
        raise TypeError(f"unsupported pixel dtype {images.dtype}")
    return images.to(out_dtype)
