"""The tensor-core K4/K5's arithmetic outside the kernels: which variant a
shape gets (bf16 "wgmma", f32 "tf32x3" at the same shapes, else "simt"), how
many image rows a bf16 K5 block takes, and a plain PyTorch emulation of the
bf16 K5 block's index arithmetic (the f32 one's is in
`test_torch_port_fused_resnet_tf32.py`).

The emulation follows `csrc/fused_resnet_wgmma.cu` step by step: row tiles
with a one-row halo, a1 at the padded width WP = w + 1 (one zero column
shared by two image rows), the 3x3 as nine products at the constant row
offsets dy*WP + dx, ragged last tiles, outputs at the padding column
dropped.  It is held against the port's `bottleneck_reference` and the JAX
experiment's `_bottleneck_ref` in f32.  The operand tiles' swizzled byte
offsets are emulated too: each tile must be filled exactly once.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu_torch.ops import fused_resnet as tfr

_spec = importlib.util.spec_from_file_location(
    "fused_resnet_experiment",
    os.path.join(os.path.dirname(__file__), os.pardir, "tools_dev",
                 "fused_resnet_experiment.py"))
jfr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jfr)

BF16, F32 = torch.bfloat16, torch.float32
# (h = w, C, F) of the identity bottlenecks of ResNet-152's four stages at 224^2
STAGES = [(56, 256, 64), (28, 512, 128), (14, 1024, 256), (7, 2048, 512)]


def emulate_block_tiles(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w,
                        tile_rows):
    """K5's tensor-core block, tile by tile, in f32 PyTorch."""
    c, f = w1.shape
    wp = w + 1
    bn_relu = lambda acc, mul, add: torch.clamp_min(acc * mul + add, 0.0)
    out = torch.full_like(x2, float("nan"))
    for img in range(n):
        img_row0 = img * h * w
        for r0 in range(0, h, tile_rows):
            rows = min(tile_rows, h - r0)
            lo, hi = max(r0 - 1, 0), min(r0 + rows + 1, h)
            # a1's row rr holds image row r0 - 1 + rr at padded column 1 + col
            a1 = torch.zeros((tile_rows + 2) * wp + 2, f)
            m1 = (hi - lo) * w
            x_rows = x2[img_row0 + lo * w: img_row0 + hi * w]  # contiguous in x
            y1 = bn_relu(x_rows @ w1, mul1, add1)
            m = torch.arange(m1)
            a1[(lo - r0 + 1) * wp + 1 + (m // w) * wp + m % w] = y1
            # conv2 over the padded positions m = r * wp + col
            m2 = rows * wp
            acc = torch.zeros(m2, f)
            for tap in range(9):
                off = (tap // 3) * wp + tap % 3
                acc += a1[off: off + m2] @ w2[tap]
            a2 = bn_relu(acc, mul2, add2)
            # conv3; the padding column (col == w) is dropped
            y3 = a2 @ w3 * mul3 + add3
            m = torch.arange(m2)
            r, col = m // wp, m % wp
            keep = col < w
            rows_out = img_row0 + (r0 + r[keep]) * w + col[keep]
            out[rows_out] = torch.clamp_min(y3[keep] + x2[rows_out], 0.0)
    return out


def _inputs(rng, n, h, w, c, f):
    x2 = np.maximum(rng.normal(size=(n * h * w, c)), 0.0).astype(np.float32)
    w1 = rng.normal(0, c ** -0.5, size=(c, f)).astype(np.float32)
    w2 = rng.normal(0, (9 * f) ** -0.5, size=(9, f, f)).astype(np.float32)
    w3 = rng.normal(0, f ** -0.5, size=(f, c)).astype(np.float32)
    affine = [(rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32),
               rng.normal(0, 0.1, size=(k,)).astype(np.float32)) for k in (f, f, c)]
    return [x2, w1, *affine[0], w2, *affine[1], w3, *affine[2]]


# tile_rows: one row per block, ragged last tiles (3 of 8, 4 of 6, 5 of 14 and
# of 7), and the whole image in one tile
@pytest.mark.parametrize("tile_rows", [1, 3, 4, 5, 14])
@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (2, 6, 10), (1, 14, 14), (1, 7, 7)])
def test_block_tile_emulation_matches_references(rng, n, h, w, tile_rows):
    tile_rows = min(tile_rows, h)
    args = _inputs(rng, n, h, w, 32, 8)
    got = emulate_block_tiles(*map(torch.from_numpy, args), n, h, w, tile_rows)
    assert not torch.isnan(got).any()  # every output row was written
    want = tfr.bottleneck_reference(*map(torch.from_numpy, args), n, h, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    want_jax = jfr._bottleneck_ref(*map(jnp.asarray, args), n, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w,c,f,rows", [(56, 56, 256, 64, 8), (28, 28, 512, 128, 7),
                                          (14, 14, 1024, 256, 7), (7, 7, 2048, 512, 7),
                                          (6, 10, 256, 64, 6), (8, 8, 256, 64, 8)])
def test_wgmma_tile_rows(h, w, c, f, rows):
    """The rows per block: they fit, one more would not or would not even
    the tiles out, and the emulation at that size is the reference."""
    assert tfr.wgmma_tile_rows(h, w, f) == rows
    assert tfr.wgmma_bottleneck_smem(rows, w, f) <= tfr.SMEM_PER_BLOCK
    tiles = -(-h // rows)
    assert rows == -(-h // tiles)  # evened: no tile is more than a row shorter
    if rows < h:  # the fewest tiles that fit
        assert tfr.wgmma_bottleneck_smem(-(-h // (tiles - 1)), w, f) > tfr.SMEM_PER_BLOCK
    assert tfr.bottleneck_variant(BF16, h, w, c, f) == "wgmma"


def test_wgmma_tile_rows_none_fits():
    assert tfr.wgmma_tile_rows(8, 4000, 64) == 0
    assert tfr.bottleneck_variant(BF16, 8, 4000, 256, 64) == "simt"
    assert tfr.wgmma_tile_rows(14, 14, 256, limit=100_000) == 0


@pytest.mark.parametrize("dtype,h,w,c,f,want", [
    *[(BF16, hw, hw, c, f, "wgmma") for hw, c, f in STAGES],
    *[(F32, hw, hw, c, f, "tf32x3") for hw, c, f in STAGES],
    (BF16, 8, 8, 32, 8, "simt"),      # F below 64
    (BF16, 6, 10, 64, 16, "simt"),    # F a multiple of 16 but not a built width
    (BF16, 6, 10, 256, 64, "wgmma"),  # h != w at a built width
    (BF16, 14, 14, 768, 192, "simt"),  # F a multiple of 64 but not a built width
    (BF16, 14, 14, 192, 64, "simt"),  # C not a multiple of 128
    (F32, 8, 8, 32, 8, "simt"),       # the same shapes in f32
    (F32, 6, 10, 64, 16, "simt"),
    (F32, 6, 10, 256, 64, "tf32x3"),
    (F32, 14, 14, 768, 192, "simt"),
    (F32, 14, 14, 192, 64, "simt"),
    (F32, 8, 4000, 256, 64, "simt"),  # no output row's a1 and a2 fit in shared memory
])
def test_bottleneck_variant(dtype, h, w, c, f, want):
    assert tfr.bottleneck_variant(dtype, h, w, c, f) == want


@pytest.mark.parametrize("dtype,m,k,n,want", [
    (BF16, 54880, 1024, 256, "wgmma"), (BF16, 54880, 256, 1024, "wgmma"),
    (BF16, 1037, 256, 64, "wgmma"), (BF16, 130, 64, 512, "wgmma"), (BF16, 1, 64, 64, "wgmma"),
    (BF16, 777, 100, 130, "simt"), (BF16, 1, 24, 40, "simt"), (BF16, 300, 64, 96, "simt"),
    (BF16, 300, 48, 64, "simt"),
    (F32, 54880, 1024, 256, "tf32x3"), (F32, 300, 64, 256, "tf32x3"),
    (F32, 1037, 256, 64, "tf32x3"), (F32, 1, 64, 64, "tf32x3"),
    (F32, 777, 100, 130, "simt"),   # K not a multiple of 64
    (F32, 300, 64, 96, "simt"),     # N not a multiple of 64
    (F32, 300, 48, 64, "simt"),
])
def test_matmul_variant(dtype, m, k, n, want):
    assert tfr.matmul_variant(dtype, m, n, k) == want


def _a_tile_offset(r, c):
    """Byte offset of 16-byte chunk c (8 k) of row r in an A tile [128 m][64 k]."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _b_tile_offset(k, c):
    """Byte offset of 16-byte chunk c (8 n) of k row k in a B tile [64 k][NW n]."""
    return (c >> 3) * 8192 + (k >> 3) * 1024 + (k & 7) * 128 + (((c & 7) ^ (k & 7)) << 4)


@pytest.mark.parametrize("nw", [64, 128])
def test_operand_tiles_are_filled_exactly_once(nw):
    """The swizzled offsets the copies write are a permutation of the tile's
    16-byte chunks, and a k row of B stays inside its 128-byte line of its
    8 KB column block (what the 128-byte swizzle of the descriptor assumes)."""
    a = sorted(_a_tile_offset(r, c) for r in range(128) for c in range(8))
    assert a == list(range(0, 128 * 64 * 2, 16))
    b = sorted(_b_tile_offset(k, c) for k in range(64) for c in range(nw // 8))
    assert b == list(range(0, 64 * nw * 2, 16))
    for k in range(64):
        for c in range(nw // 8):
            line = (c >> 3) * 8192 + (k >> 3) * 1024 + (k & 7) * 128
            assert line <= _b_tile_offset(k, c) < line + 128


def test_wgmma_wrappers_are_generated():
    """`wgmma_ops.cuh` is what its generator writes."""
    import runpy
    from pathlib import Path
    csrc = Path(tfr.__file__).resolve().parent.parent / "csrc"
    gen = runpy.run_path(str(csrc / "gen_wgmma_ops.py"))
    assert (csrc / "wgmma_ops.cuh").read_text() == gen["render"]()
