"""Host-side image pipeline: decode, resize, normalize, ROI crops.

Equivalent of the reference's torchvision transform stack
(reference: vimacsa_dataset.py:25-30,123-199): Resize((224,224), antialias),
float conversion, ImageNet normalization; ROI crops sliced from the *raw*
decoded image with (x1:x2, y1:y2) indexing the (H, W) axes — the reference's
axis convention (vimacsa_dataset.py:153) — then the same transform; box
coordinates normalized by 512 and clipped to [0,1] (vimacsa_dataset.py:159-164).

A copy of `macsa_tpu/data/images.py` for the PyTorch port.  Everything
returns NHWC (the layout the port's public functions keep; the reference is
NCHW).  Unreadable images become zero tensors, matching the reference's
soft fault tolerance (vimacsa_dataset.py:130-135).

Two differences from the original, both for hosts without libpng headers
and without PIL: `decode_image` ends in the port's own PNG reader
(`data/png.py`), and `resize_u8` ends in a numpy resize with the native
library's arithmetic.  PNG is lossless, so the three decoders return the
same bytes; which one served is logged once.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from macsa_tpu_torch import native
from macsa_tpu_torch.data import png

_log = logging.getLogger("macsa_tpu_torch.images")
_served: set = set()  # decoders that have been named in the log

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
IMAGE_SIZE = 224
COORD_NORM = 512.0


def _note_decoder(name: str) -> None:
    if name not in _served:
        _served.add(name)
        _log.info("image decode: served by %s", name)


def _decode_pil(path: str) -> Optional[np.ndarray]:
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception:
        return None


def _decode_png_reader(path: str) -> Optional[np.ndarray]:
    try:
        return png.read_png(path)
    except (OSError, ValueError, zlib.error):
        return None


DECODERS = (("native libjpeg/libpng", native.decode), ("PIL", _decode_pil),
            ("the numpy PNG reader", _decode_png_reader))


def decode_image(path: str) -> Optional[np.ndarray]:
    """Read an image file -> uint8 HWC RGB array, or None on failure.

    Tries the native libjpeg/libpng decoder first (macsa_tpu_torch/native —
    GIL released, scales across loader threads), then PIL where it imports,
    then the port's own PNG reader.  On a PNG all three return the same
    bytes."""
    for name, decoder in DECODERS:
        out = decoder(path)
        if out is not None:
            _note_decoder(name)
            return out
    return None


def _triangle_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64 weights of the antialiased triangle
    filter, row for row `make_coeffs` of image_pipe.cpp."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    centers = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum(np.floor(centers - filterscale).astype(np.int64), 0)
    hi = np.minimum(np.ceil(centers + filterscale).astype(np.int64), in_size)
    k = np.arange(in_size)
    x = np.abs((k[None, :] + 0.5 - centers[:, None]) / filterscale)
    w = np.where((k[None, :] >= lo[:, None]) & (k[None, :] < hi[:, None]) & (x < 1.0),
                 1.0 - x, 0.0)
    total = w.sum(axis=1, keepdims=True)
    return np.divide(w, total, out=w, where=total > 0.0)


def resize_u8_numpy(img: np.ndarray, size: int) -> np.ndarray:
    """The native library's resize in numpy: separable horizontal-then-
    vertical passes in float64, round half up to uint8.  The sums are taken
    in another order than the C loop's, so a value that lands within
    rounding of .5 may differ by one step (+-1/255)."""
    wx = _triangle_coeffs(img.shape[1], size)
    wy = _triangle_coeffs(img.shape[0], size)
    tmp = np.einsum("xk,ykc->yxc", wx, img.astype(np.float64))
    out = np.einsum("yk,kxc->yxc", wy, tmp)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC -> uint8 [size, size, 3] via antialiased bilinear resize
    (the semantics of torchvision Resize(antialias=True)).  Native C++
    triangle-filter kernel when built; otherwise PIL where it imports (same
    algorithm; outputs agree within +-2/255 — Pillow quantizes filter
    coefficients); otherwise the numpy version of the native arithmetic."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    out = native.resize_u8(img, size)
    if out is not None:
        return out
    try:
        from PIL import Image
    except ImportError:
        return resize_u8_numpy(img, size)
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((size, size), Image.BILINEAR), np.uint8)


def resize_normalize(img: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """uint8 HWC -> normalized float32 [size, size, 3] (fused native kernel
    when available; the fallback mirrors its math — multiply by the f32
    reciprocals, image_pipe.cpp:ip_normalize_f32 — so f32 and packed
    transfers agree to float rounding either way)."""
    out = native.resize_normalize(img, size, IMAGENET_MEAN, IMAGENET_STD)
    if out is not None:
        return out
    inv255 = np.float32(1.0) / np.float32(255.0)
    inv_std = np.float32(1.0) / IMAGENET_STD
    x = resize_u8(img, size).astype(np.float32) * inv255
    return (x - IMAGENET_MEAN) * inv_std


def crop_roi(img: np.ndarray, box: Sequence[float]) -> Optional[np.ndarray]:
    """box = (x1, x2, y1, y2) indexing (H, W) as the reference does
    (vimacsa_dataset.py:151-153).  Returns the raw uint8 crop or None if
    empty."""
    h, w = img.shape[:2]
    x1, x2, y1, y2 = box
    x1, x2 = max(0, int(x1)), min(h, int(x2))
    y1, y2 = max(0, int(y1)), min(w, int(y2))
    crop = img[x1:x2, y1:y2]
    if crop.size == 0:
        return None
    return crop


def normalize_coords(box: Sequence[float]) -> np.ndarray:
    """(x1, x2, y1, y2) / 512 clipped to [0, 1] (vimacsa_dataset.py:159-164)."""
    return np.clip(np.asarray(box, np.float32) / COORD_NORM, 0.0, 1.0)


def build_visual_tensors(
    img_paths: Sequence[str],
    img_folder: str,
    roi_boxes: Dict[str, List[Tuple[float, float, float, float]]],
    num_img: int,
    num_roi: int,
    size: int = IMAGE_SIZE,
    pixel_mode: str = "f32",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (images, roi_images, roi_coors [num_img, num_roi, 4]), zero-padded.

    Mirrors vimacsa_dataset.py:123-199 / iaog_dataset.py:113-153.
    `pixel_mode` selects the host->device transfer encoding:
    * "f32": normalized float32 frames [.., S, S, 3] — the reference's exact
      transfer shape (vimacsa_dataset.py:25-30, 4 bytes/pixel);
    * "packed" (drivers' default): uint32 words [.., 1 + S*S*3/4] from
      ops.image_prep.pack_pixels_u8 — 1 byte/pixel over the host link,
      normalization fused into the on-device int32 unpack, empty slots
      carried as validity words so they unpack to the reference's exact
      zero tensors;
    * "u8": raw uint8 frames (kept for tests/micro-benchmarks; uint8
      elementwise device compute is slow — see ops.image_prep)."""
    assert pixel_mode in ("f32", "packed", "u8"), pixel_mode
    u8 = pixel_mode in ("packed", "u8")
    pix = np.uint8 if u8 else np.float32
    prep = resize_u8 if u8 else resize_normalize
    images = np.zeros((num_img, size, size, 3), pix)
    rois = np.zeros((num_img, num_roi, size, size, 3), pix)
    coors = np.zeros((num_img, num_roi, 4), np.float32)
    img_valid = np.zeros((num_img,), np.bool_)
    roi_valid = np.zeros((num_img, num_roi), np.bool_)

    for i, name in enumerate(list(img_paths)[:num_img]):
        raw = decode_image(os.path.join(img_folder, name))
        if raw is not None:
            images[i] = prep(raw, size)
            img_valid[i] = True
        boxes = roi_boxes.get(name, [])[:num_roi]
        if raw is None or not boxes:
            continue
        for r, box in enumerate(boxes):
            crop = crop_roi(raw, box)
            if crop is not None:
                rois[i, r] = prep(crop, size)
                roi_valid[i, r] = True
            coors[i, r] = normalize_coords(box)
    if pixel_mode == "packed":
        from macsa_tpu_torch.ops.image_prep import pack_pixels_u8
        images = pack_pixels_u8(images, img_valid)
        rois = pack_pixels_u8(rois, roi_valid)
    return images, rois, coors


def roi_boxes_from_csv(path: str, suffix: str = ".png") -> Dict[str, list]:
    """roi_data.csv -> {file_name: [(x1, x2, y1, y2), ...]} preserving row
    order.  The reference appends '.png' to file names
    (run_multimodal_fcmf.py:182)."""
    import csv
    out: Dict[str, list] = {}
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        for row in reader:
            name = row[0] + suffix
            box = tuple(float(v) for v in row[1:5])
            out.setdefault(name, []).append(box)
    return out
