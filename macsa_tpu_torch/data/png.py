"""A PNG reader and writer in numpy and `zlib`.

What makes `decode_image` total on a host without libpng headers and
without PIL, and what lets `data/synth.py` write its images there.  Scope:
non-interlaced PNG at 8 bits a sample, greyscale (colour type 0), RGB (2),
greyscale + alpha (4) and RGBA (6), all five scanline filters.  Anything
else (palette, 16 bits, Adam7) raises `ValueError` with its name; nothing is
guessed.  PNG is lossless, so `read_png` returns the same bytes as libpng
and PIL do after their conversion to RGB: greyscale replicated over the
three channels, alpha dropped.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
FILTERS = ("none", "sub", "up", "average", "paeth")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 arrays a (left), b (above), c (upper left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline [W * bpp] uint8 back from its filtered form."""
    if kind == 0:
        return line
    if kind == 2:
        return line + prior  # uint8 arithmetic wraps, as the format asks
    pixels = line.reshape(-1, bpp)
    if kind == 1:
        return np.cumsum(pixels, axis=0, dtype=np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"PNG scanline filter {kind} does not exist")
    # average and Paeth read the pixel just decoded: one step per pixel
    above = prior.reshape(-1, bpp).astype(np.int16)
    out = np.zeros_like(pixels)
    left = np.zeros(bpp, np.int16)
    upper_left = np.zeros(bpp, np.int16)
    for x in range(pixels.shape[0]):
        if kind == 3:
            predicted = (left + above[x]) >> 1
        else:
            predicted = _paeth(left, above[x], upper_left)
        out[x] = (pixels[x].astype(np.int16) + predicted).astype(np.uint8)
        left, upper_left = out[x].astype(np.int16), above[x]
    return out.reshape(-1)


def decode_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> uint8 [H, W, 3] RGB."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or \
                struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ValueError(f"PNG chunk {tag!r} is cut or fails its CRC")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"PNG bit depth {depth}, colour type {colour}: not supported")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG: not supported")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {height} lines of {stride + 1}")
    lines = raw.reshape(height, stride + 1)
    kinds, filtered = lines[:, 0], lines[:, 1:]
    if not kinds.any():
        pixels = filtered
    else:
        pixels = np.empty((height, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(height):
            prior = pixels[y] = _unfilter(int(kinds[y]), filtered[y], prior, bpp)
    pixels = pixels.reshape(height, width, bpp)
    if bpp <= 2:  # greyscale (+ alpha)
        return np.ascontiguousarray(np.repeat(pixels[:, :, :1], 3, axis=2))
    return np.ascontiguousarray(pixels[:, :, :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One raw scanline [W * bpp] uint8 -> its filtered form."""
    cur = line.astype(np.int16)
    left = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])
    above = prior.astype(np.int16)
    upper_left = np.concatenate([np.zeros(bpp, np.int16), above[:-bpp]])
    predicted = (np.zeros_like(cur), left, above, (left + above) >> 1,
                 _paeth(left, above, upper_left))[kind]
    return (cur - predicted).astype(np.uint8)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def encode_png(image: np.ndarray, filters="none", level: int = 6) -> bytes:
    """uint8 [H, W] (grey), [H, W, 2] (grey + alpha), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA) -> PNG file bytes.  `filters` names one scanline filter
    for every line, or gives one name per line."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 image, got {image.dtype} {image.shape}")
    if image.ndim == 2:
        image = image[:, :, None]
    height, width, bpp = image.shape
    colour = {v: k for k, v in _CHANNELS.items()}.get(bpp)
    if colour is None:
        raise ValueError(f"{bpp} samples a pixel: not a PNG colour type")
    kinds = [FILTERS.index(filters)] * height if isinstance(filters, str) \
        else [FILTERS.index(f) for f in filters]
    if len(kinds) != height:
        raise ValueError(f"{len(kinds)} filters for {height} lines")
    raw = image.reshape(height, width * bpp)
    lines = np.empty((height, width * bpp + 1), np.uint8)
    lines[:, 0] = kinds
    if not any(kinds):
        lines[:, 1:] = raw
    else:
        prior = np.zeros(width * bpp, np.uint8)
        for y in range(height):
            lines[y, 1:] = _filter(kinds[y], raw[y], prior, bpp)
            prior = raw[y]
    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, filters="none", level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image, filters, level))
