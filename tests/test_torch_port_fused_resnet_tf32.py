"""The f32 tensor-core K4/K5 ("tf32x3") outside the kernels: a plain PyTorch
emulation of `csrc/fused_resnet_tf32.cu`, step by step.

Every f32 product is split as the kernels split it (`cvt.rna.tf32.f32`,
taken as an integer add and mask: big = tf32(x), small = tf32(x - big)) and
taken as three TF32 products, small*big + big*small + big*big, 8 columns
of the inner dimension at a time (one `mma.sync.m16n8k8` step); each ring
stage of 16 k is summed from zero and added to the accumulator in f32.
The epilogues round (acc * mul) and + add separately, add the residual in
f32 and keep a1, a2 and the output in f32.  K5 goes tile by tile: TH
output rows with a one-row halo (zero outside the image), a1 with its zero
pixel row, the nine tap-shifted products over K = 9F in w2's own order,
ragged last tiles.  The emulation is held against the port's plain
versions and the JAX experiment's Pallas kernels in interpret mode with
the card's tolerances (K4 1e-5, K5 1e-4 of max|ref|), and one TF32
product is shown to miss them.  The rows per block, the shared memory and
the bank layout of the fragment reads are held against the CUDA source.
"""

import importlib.util
import os
import re
from pathlib import Path

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

SOURCE = (Path(tfr.__file__).resolve().parent.parent / "csrc"
          / "fused_resnet_tf32.cu").read_text()
K4_TOL, K5_TOL = 1e-5, 1e-4  # of max|ref|: phases k4 and k5's f32 tolerances
F32 = torch.float32


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BK = constant("kBK")  # k per ring stage
WARPS = constant("kWarps")

# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def tf32(x):
    """cvt.rna.tf32.f32: to the nearest TF32 value (10 mantissa bits), ties
    away from zero, kept as f32 with the 13 low bits clear."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def product(a, b, terms=3):
    """a [M, K] @ b [K, N] as the kernels take it: K in ring stages of 16,
    each stage summed from zero 8 k at a time (small*big, then big*small,
    then big*big; with `terms` 1 big*big alone) and added to the
    accumulator in f32."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], BK):
        part = torch.zeros_like(acc)
        for k8 in range(k0, min(k0 + BK, a.shape[1]), 8):
            step = slice(k8, k8 + 8)
            if terms == 3:
                part = part + a_small[:, step] @ b_big[step]
                part = part + a_big[:, step] @ b_small[step]
            part = part + a_big[:, step] @ b_big[step]
        acc = acc + part
    return acc


def bn(acc, mul, add):
    return acc * mul + add  # two roundings, as __fmul_rn then __fadd_rn


def emulate_k4(x2, w, mul, add, residual, relu, terms=3):
    """`matmul_bn_act_tf32x3_kernel`: rows are independent, so the block
    tiles change nothing but which block computes a row."""
    y = bn(product(x2, w, terms), mul, add)
    if residual is not None:
        y = y + residual
    return torch.clamp_min(y, 0.0) if relu else y


def tap_rows(m2, w, zero_pixel):
    """[9, m2] a1 pixel read by output pixel m at tap (dy, dx): m + dy*w +
    dx - 1, or the zero pixel where its column leaves the image."""
    m = torch.arange(m2)
    col = m % w
    taps = []
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        inside = (col + dx - 1 >= 0) & (col + dx - 1 < w)
        taps.append(torch.where(inside, m + dy * w + dx - 1, zero_pixel))
    return torch.stack(taps)


def emulate_k5(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w, tile_rows,
               terms=3):
    """`bottleneck_tf32x3_kernel`, block by block."""
    c, f = w1.shape
    relu_bn = lambda acc, mul, add: torch.clamp_min(bn(acc, mul, add), 0.0)
    out = torch.full_like(x2, float("nan"))
    zero_pixel = (tile_rows + 2) * w
    for img in range(n):
        img_row0 = img * h * w
        for r0 in range(0, h, tile_rows):
            rows = min(tile_rows, h - r0)
            lo, hi = max(r0 - 1, 0), min(r0 + rows + 1, h)
            # a1's local row rr holds image row r0 - 1 + rr; the rest stays zero
            a1 = torch.zeros(zero_pixel + 1, f)
            first = (lo - r0 + 1) * w
            a1[first:first + (hi - lo) * w] = relu_bn(
                product(x2[img_row0 + lo * w:img_row0 + hi * w], w1, terms), mul1, add1)
            m2 = rows * w
            a_taps = a1[tap_rows(m2, w, zero_pixel)]                  # [9, m2, F]
            a_conv2 = a_taps.permute(1, 0, 2).reshape(m2, 9 * f)     # k = tap * F + channel
            a2 = relu_bn(product(a_conv2, w2.reshape(9 * f, f), terms), mul2, add2)
            rows_out = slice(img_row0 + r0 * w, img_row0 + r0 * w + m2)
            y = bn(product(a2, w3, terms), mul3, add3) + x2[rows_out]
            out[rows_out] = torch.clamp_min(y, 0.0)
    return out


def _rel(got, want):
    want = torch.as_tensor(np.array(want)).double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _k4_inputs(rng, m, k, n, has_res):
    x2 = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32)
    mul = rng.uniform(0.5, 1.5, size=(n,)).astype(np.float32)
    add = rng.normal(0, 0.1, size=(n,)).astype(np.float32)
    res = rng.normal(size=(m, n)).astype(np.float32) if has_res else None
    return x2, w, mul, add, res


def _k5_inputs(rng, n, h, w, c, f):
    x2 = np.maximum(rng.normal(size=(n * h * w, c)), 0.0).astype(np.float32)
    w1 = rng.normal(0, c ** -0.5, size=(c, f)).astype(np.float32)
    w2 = rng.normal(0, (9 * f) ** -0.5, size=(9, f, f)).astype(np.float32)
    w3 = rng.normal(0, f ** -0.5, size=(f, c)).astype(np.float32)
    affine = [(rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32),
               rng.normal(0, 0.1, size=(k,)).astype(np.float32)) for k in (f, f, c)]
    return [x2, w1, *affine[0], w2, *affine[1], w3, *affine[2]]


# ---------------------------------------------------------------------------
# against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(37, 64, 64), (130, 128, 256)])
@pytest.mark.parametrize("has_res,relu", [(True, True), (False, True), (True, False)])
def test_k4_emulation_matches_references(rng, m, k, n, has_res, relu):
    x2, w, mul, add, res = _k4_inputs(rng, m, k, n, has_res)
    assert tfr.matmul_variant(F32, m, n, k) == "tf32x3"
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = emulate_k4(t(x2), t(w), t(mul), t(add), t(res), relu)
    want = tfr.fused_matmul_bn_act_reference(t(x2), t(w), t(mul), t(add), t(res), relu)
    assert _rel(got, want) <= K4_TOL
    want_jax = jfr.fused_matmul_bn_act(*map(jnp.asarray, (x2, w, mul, add)),
                                       None if res is None else jnp.asarray(res), relu, True)
    assert _rel(got, want_jax) <= K4_TOL


# (n, h, w, C, F, limit): the rows a block takes come from `tf32x3_tile_rows`,
# the whole image at 6 x 10; a shared-memory limit that leaves 4 rows of 7
# (tiles of 4 and 3: a ragged last tile, halo rows inside the image)
@pytest.mark.parametrize("n,h,w,c,f,limit,tile_rows", [(2, 6, 10, 128, 64, None, 6),
                                                       (2, 7, 8, 128, 64, 104_000, 4)])
def test_k5_emulation_matches_references(rng, n, h, w, c, f, limit, tile_rows):
    args = _k5_inputs(rng, n, h, w, c, f)
    kw = {} if limit is None else {"limit": limit}
    assert tfr.tf32x3_tile_rows(h, w, f, **kw) == tile_rows
    assert tfr.bottleneck_variant(F32, h, w, c, f) == "tf32x3"
    got = emulate_k5(*map(torch.from_numpy, args), n, h, w, tile_rows)
    assert not torch.isnan(got).any()  # every output row was written
    want = tfr.bottleneck_reference(*map(torch.from_numpy, args), n, h, w)
    assert _rel(got, want) <= K5_TOL
    want_jax = jfr.fused_bottleneck(*map(jnp.asarray, args), n, h, w, True)
    assert _rel(got, want_jax) <= K5_TOL


def test_one_tf32_product_misses_the_f32_tolerances(rng):
    """Why three products: with one TF32 product for each f32 product K4 and
    K5 fall outside phases k4's and k5's tolerances; with three inside."""
    x2, w, mul, add, res = map(torch.from_numpy, _k4_inputs(rng, 64, 256, 64, True))
    want = tfr.fused_matmul_bn_act_reference(x2, w, mul, add, res)
    err = {terms: _rel(emulate_k4(x2, w, mul, add, res, True, terms), want)
           for terms in (1, 3)}
    assert err[1] > 10 * K4_TOL and err[3] < K4_TOL, err
    args = list(map(torch.from_numpy, _k5_inputs(rng, 1, 6, 10, 128, 64)))
    want = tfr.bottleneck_reference(*args, 1, 6, 10)
    err = {terms: _rel(emulate_k5(*args, 1, 6, 10, 6, terms), want) for terms in (1, 3)}
    assert err[1] > K5_TOL and err[3] < K5_TOL, err


def test_split_rounds_to_nearest_ties_away():
    """cvt.rna: a tie between two TF32 values goes away from zero; big +
    small holds x to about 2^-22 of it."""
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 0.0])
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 0.0]
    y = torch.from_numpy(np.random.default_rng(3).normal(size=10_000).astype(np.float32))
    big, small = split(y)
    assert (tf32(big) == big).all() and (tf32(small) == small).all()
    assert ((big.double() + small.double() - y.double()).abs()
            <= 2.0 ** -21 * y.double().abs()).all()
    assert "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;" in (
        Path(tfr.__file__).resolve().parent.parent / "csrc" / "tf32x3.cuh").read_text()


def test_tap_rows_read_the_zero_pixel_past_the_edges():
    """Tap (dy, dx) of output pixel (r, col) is a1 pixel (r + dy, col + dx -
    1); columns -1 and w read the zero pixel."""
    w, m2, zero = 5, 10, 99
    taps = tap_rows(m2, w, zero)
    for m in range(m2):
        r, col = divmod(m, w)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            want = (r + dy) * w + col + dx - 1 if 0 <= col + dx - 1 < w else zero
            assert taps[tap, m] == want


# ---------------------------------------------------------------------------
# the source's layout
# ---------------------------------------------------------------------------

# (h = w, C, F) of the identity bottlenecks of ResNet-152's four stages at 224^2,
# and the rows a block of the f32 tensor-core K5 takes there
STAGE_ROWS = [((56, 256, 64), 4), ((28, 512, 128), 5), ((14, 1024, 256), 5),
              ((7, 2048, 512), 4)]


def test_shared_memory_formula_is_the_source():
    """The ring (two stages, each the largest A + B chunk: 112 rows of x by
    16 + 4 floats and 16 rows of w by 256 + 8) and the staging tiles (8 warps
    by 32 x (32 + 8)) are the source's constants, and its a1, a2 formula is
    the Python one's."""
    ring_stage = constant("kRingStage")
    assert ring_stage == 112 * (BK + 4) + BK * (256 + 8)
    assert tfr._TF32X3_RING == constant("kRingStages") * ring_stage
    assert tfr._TF32X3_STAGING == WARPS * constant("kStageRows") * (32 + 8)
    assert "constexpr int kLdA = kBK + 4;" in SOURCE
    assert "constexpr int kStageLd = 32 + 8;" in SOURCE
    assert "const long long need = ((tile_rows + 2LL) * w + 1) * (f + 4);" in SOURCE
    assert "const long long a2 = static_cast<long long>(tile_rows) * w * (f + 4);" in SOURCE
    assert "return (kRingFloats + a1_floats(tile_rows, w, f) + a2) * 4;" in SOURCE
    assert '"macsa_fused_bottleneck_tf32x3"' in Path(tfr.cuda_lib.__file__).read_text()


@pytest.mark.parametrize("stage,rows", STAGE_ROWS)
def test_tf32x3_tile_rows(stage, rows):
    """The rows per block at each stage: they fit in the 227 KB a block may
    take, one more would not or would not even the tiles out, and the stage
    runs "tf32x3"."""
    h, c, f = stage
    assert tfr.tf32x3_tile_rows(h, h, f) == rows
    assert tfr.tf32x3_bottleneck_smem(rows, h, f) <= tfr.SMEM_PER_BLOCK == 227 * 1024
    tiles = -(-h // rows)
    assert rows == -(-h // tiles)  # evened: no tile is more than a row shorter
    if rows < h:  # the fewest tiles that fit
        assert tfr.tf32x3_bottleneck_smem(-(-h // (tiles - 1)), h, f) > tfr.SMEM_PER_BLOCK
    assert tfr.bottleneck_variant(F32, h, h, c, f) == "tf32x3"


def test_tf32x3_tile_rows_none_fits():
    assert tfr.tf32x3_tile_rows(8, 4000, 64) == 0
    assert tfr.bottleneck_variant(F32, 8, 4000, 256, 64) == "simt"
    assert tfr.tf32x3_tile_rows(14, 14, 256, limit=100_000) == 0


LANES = torch.arange(32)
G, T = LANES // 4, LANES % 4


@pytest.mark.parametrize("ld,what", [(BK + 4, "ring A chunk"), *[
    (f + 4, f"a1 and a2 at F = {f}") for f in tfr.WGMMA_F]])
def test_ldmatrix_reads_are_free_of_bank_conflicts(ld, what):
    """An A fragment is one `ldmatrix.x4`: each of its four 8 x 4 matrices
    reads 16 bytes from each of 8 consecutive rows of `ld` floats; the 8
    row chunks lie on 8 different 16-byte bank groups.  Lane l gives row
    (l & 7) + 8 ((l >> 3) & 1) at column 4 (l >> 4): the fragment's
    registers come out as the m16n8k8 A fragment (row g + 8 (e & 1),
    column t + 4 (e >> 1))."""
    assert ld % 4 == 0  # 16-byte rows for ldmatrix and cp.async
    for r0 in range(0, 64, 8):
        groups = [((r0 + r) * ld // 4) % 8 for r in range(8)]
        assert len(set(groups)) == 8, (what, r0)
    # the matrices' rows and columns are the fragment's
    rows = (LANES & 7) + 8 * ((LANES >> 3) & 1)
    cols = 4 * (LANES >> 4)
    for e in range(4):  # register e is matrix e: lanes 8e .. 8e + 7 give its rows
        mat = slice(8 * e, 8 * e + 8)
        assert (rows[mat] == torch.arange(8) + 8 * (e & 1)).all()
        assert (cols[mat] == 4 * (e >> 1)).all()
    # within a matrix, lane 4g + t receives the 32-bit element (row g, column t)
    assert torch.equal(G, LANES // 4) and torch.equal(T, LANES % 4)


@pytest.mark.parametrize("pw", [64, 128, 256])
def test_b_fragment_reads_are_free_of_bank_conflicts(pw):
    """B element e of lane 4g + t is row t + 4e, column g of a chunk with
    rows of PW + 8 floats: bank 8t + g, 32 different banks."""
    assert "static constexpr int kLdB = kPW + 8;" in SOURCE
    ldb = pw + 8
    for j in range(pw // 8):
        for e in range(2):
            words = (T + 4 * e) * ldb + 8 * j + G
            assert len(set((words % 32).tolist())) == 32, (pw, j, e)


def test_staging_tile_writes_and_reads_are_free_of_bank_conflicts():
    """The per-warp output staging tile, rows of 32 + 8 floats: a half warp's
    8-byte stores of the accumulators (row g (+ 8), columns 8j + 2t) cover
    32 banks once; a quarter warp's 16-byte reads along a row too."""
    ld = 32 + 8
    for half in (slice(0, 16), slice(16, 32)):
        g, t = G[half], T[half]
        for j in range(4):
            for h in range(2):
                words = (g + 8 * h) * ld + 8 * j + 2 * t
                banks = torch.cat([words % 32, (words + 1) % 32])
                assert len(set(banks.tolist())) == 32, (j, h)
    for r in range(32):
        words = r * ld + 4 * torch.arange(8)[:, None] + torch.arange(4)[None, :]
        assert len(set((words.flatten() % 32).tolist())) == 32
