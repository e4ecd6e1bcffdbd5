"""The f32 tensor-core K4/K5 ("tf32x3") outside the kernels: a plain PyTorch
emulation of `csrc/fused_resnet_tf32.cu`, step by step.

Every f32 product is split as the kernels split it (`cvt.rna.tf32.f32`,
taken as an integer add and mask: big = tf32(x), small = tf32(x - big)) and
taken as three TF32 products, small*big + big*small + big*big, 8 k of the
inner dimension at a time (K4: one `mma.sync.m16n8k8` step, k in order; K5:
one `wgmma` m64nNk8 step, k 4t + 2s and 4t + 2s + 1 of lane t); each 16 k
is summed from zero and added to the accumulator in f32.  The epilogues
round (acc * mul) and + add separately, add the residual in f32 and keep
a1, a2 and the output in f32.  K5 goes block by block: tiles of rows of x
running across image rows and images, a1 on the tile and a halo of w + 1
rows each side (rows outside x clamped, never read), the zero row where a
tap leaves its image, the nine tap-shifted products over K = 9F in w2's own
order, ragged last tiles.  The emulation is held against the port's plain
versions and the JAX experiment's Pallas kernels in interpret mode with
the card's tolerances (K4 1e-5, K5 1e-4 of max|ref|), and one TF32 product
is shown to miss them.  K5's weight planes (split once a call, K-major,
64-byte swizzle, k permuted in a tile), the rows per block, the shared
memory and the bank layout of the operand reads are held against the CUDA
source.
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


# the k of a 16-k chunk each k8 step takes: K4's `mma.sync` in order; K5's
# `wgmma` k 4t + 2s and 4t + 2s + 1 of lane t (the planes' order)
K4_STEPS = [list(range(0, 8)), list(range(8, 16))]
K5_STEPS = [[4 * t + 2 * s + e for t in range(4) for e in range(2)] for s in range(2)]


def product(a, b, terms=3, steps=K4_STEPS):
    """a [M, K] @ b [K, N] as the kernels take it: K in chunks of 16, each
    summed from zero one k8 step at a time (small*big, then big*small, then
    big*big; with `terms` 1 big*big alone) and added to the accumulator in
    f32."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], BK):
        part = torch.zeros_like(acc)
        for ks in steps:
            step = [k0 + k for k in ks]
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


def tap_rows(m0, tile_rows, rows, h, w, zero_row):
    """[9, tile_rows] a1 row read by output row i (row m0 + i of x) at tap
    (dy, dx): i + dy*w + dx (a1 row j holds x row m0 - w - 1 + j), or the
    zero row where the pixel's row r + dy - 1 or column col + dx - 1 leaves
    its image, or the row is past the tile or past x."""
    i = torch.arange(tile_rows)
    q = m0 + i
    inside = q < rows
    r, col = (q // w) % h, q % w
    taps = []
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        ok = inside & (r + dy >= 1) & (r + dy <= h) & (col + dx >= 1) & (col + dx <= w)
        taps.append(torch.where(ok, i + dy * w + dx, zero_row))
    return torch.stack(taps)


def emulate_k5(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w, tile_rows,
               terms=3):
    """`bottleneck_tf32x3_kernel`, block by block."""
    rows, f = x2.shape[0], w1.shape[1]
    relu_bn = lambda acc, mul, add: torch.clamp_min(bn(acc, mul, add), 0.0)
    prod = lambda a, b: product(a, b, terms, K5_STEPS)
    out = torch.full_like(x2, float("nan"))
    r1 = tile_rows + 2 * w + 2  # a1's rows; row r1 is zero
    for m0 in range(0, rows, tile_rows):
        q = (m0 - w - 1 + torch.arange(r1)).clamp(0, rows - 1)  # rows outside x: never read
        a1 = torch.cat([relu_bn(prod(x2[q], w1), mul1, add1), torch.zeros(1, f)])
        a_taps = a1[tap_rows(m0, tile_rows, rows, h, w, r1)]        # [9, tile_rows, F]
        a_conv2 = a_taps.permute(1, 0, 2).reshape(tile_rows, 9 * f)  # k = tap * F + channel
        a2 = relu_bn(prod(a_conv2, w2.reshape(9 * f, f)), mul2, add2)
        kept = torch.arange(m0, min(m0 + tile_rows, rows))
        y = bn(prod(a2, w3), mul3, add3)[:len(kept)] + x2[kept]
        out[kept] = torch.clamp_min(y, 0.0)
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


# (n, h, w, C, F, limit, tile_rows): the rows a block takes come from
# `tf32x3_tile_rows`; limits that leave 16 and 8 rows a block: tiles that
# start and end inside image rows and across two images, a ragged last tile
@pytest.mark.parametrize("n,h,w,c,f,limit,tile_rows", [(2, 6, 10, 128, 64, None, 256),
                                                       (2, 7, 8, 128, 64, 136_000, 16),
                                                       (3, 4, 6, 128, 64, 132_000, 8)])
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
    err = {terms: _rel(emulate_k5(*args, 1, 6, 10, 16, terms), want) for terms in (1, 3)}
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
    """Tap (dy, dx) of output row i, pixel (r, col) of its image, reads the
    a1 row of pixel (r + dy - 1, col + dx - 1) of the same image, a1 row j
    holding x row m0 - w - 1 + j; taps that leave the image, and rows past
    x, read the zero row."""
    n, h, w, tile_rows, zero = 3, 4, 5, 16, 99
    rows = n * h * w
    for m0 in range(0, rows, tile_rows):
        taps = tap_rows(m0, tile_rows, rows, h, w, zero)
        for i in range(tile_rows):
            q = m0 + i
            img, r, col = q // (h * w), (q // w) % h, q % w
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                rr, cc = r + dy - 1, col + dx - 1
                if q < rows and 0 <= rr < h and 0 <= cc < w:
                    assert taps[tap, i] - (w + 1) + m0 == (img * h + rr) * w + cc
                else:
                    assert taps[tap, i] == zero


# ---------------------------------------------------------------------------
# the source's layout
# ---------------------------------------------------------------------------

# (h = w, C, F) of the identity bottlenecks of ResNet-152's four stages at 224^2,
# and the rows of x a block of the f32 tensor-core K5 takes there
STAGE_ROWS = [((56, 256, 64), 192), ((28, 512, 128), 128), ((14, 1024, 256), 64),
              ((7, 2048, 512), 16)]


def k5_smem_from_source(tile_rows, w, f):
    """`k5_smem` of the CUDA source, from its own constants."""
    plane_row = BK * 4
    b_tile = constant("kMaxNB") * plane_row * 2
    x_ring = constant("kXSlots") * 16 * plane_row
    a2 = tile_rows if f > constant("kMaxNB") else 0
    return (1024 + constant("kStages") * b_tile + WARPS * x_ring
            + (tile_rows + 2 * w + 2 + 1 + a2) * (4 * f + 64) + 2 * constant("kStages") * 8)


def test_shared_memory_formula_is_the_source():
    """The weight ring (three stages of a 256-column tile of 16 k, big and
    small planes), each warp's ring of x rows (three slots of 16 rows by
    16 k), a1 with its halo and zero row (and a2's own rows at F = 512) in
    rows of F + 16 floats, the barriers: the Python formula is the
    source's."""
    assert "constexpr int kBTile = kMaxNB * kPlaneRow * 2;" in SOURCE
    assert "constexpr int kXRing = kXSlots * 16 * kPlaneRow;" in SOURCE
    assert "return tile_rows + 2 * w + 2; }" in SOURCE
    assert "return f > kMaxNB ? tile_rows : 0; }" in SOURCE
    assert ("return kAlign + static_cast<long long>(kStages) * kBTile + kWarps * kXRing +\n"
            "         (a1_rows(tile_rows, w) + 1LL + a2_rows(tile_rows, f)) * (4 * f + 64) + "
            "2 * kStages * 8;") in SOURCE
    assert "constexpr int LD = F + 16;" in SOURCE
    for f in tfr.WGMMA_F:
        for w in (1, 7, 14, 28, 56, 100):
            for rows in (8, 16, 64, 128, 192, 256):
                assert tfr.tf32x3_bottleneck_smem(rows, w, f) == k5_smem_from_source(rows, w, f)
    assert '"macsa_fused_bottleneck_tf32x3": [_P] * 12 + [_I] * 6 + [_P]' in Path(
        tfr.cuda_lib.__file__).read_text()


@pytest.mark.parametrize("stage,rows", STAGE_ROWS)
def test_tf32x3_tile_rows(stage, rows):
    """The rows per block at each stage: they fit in the 227 KB a block may
    take, the next multiple of 64 (below 64: of 8) would not, and the stage
    runs "tf32x3"."""
    h, c, f = stage
    assert tfr.tf32x3_tile_rows(h, h, f) == rows
    assert tfr.tf32x3_bottleneck_smem(rows, h, f) <= tfr.SMEM_PER_BLOCK == 227 * 1024
    step = 64 if rows >= 64 else 8
    assert tfr.tf32x3_bottleneck_smem(rows + step, h, f) > tfr.SMEM_PER_BLOCK
    assert tfr.bottleneck_variant(F32, h, h, c, f) == "tf32x3"


def test_tf32x3_tile_rows_none_fits():
    assert tfr.tf32x3_tile_rows(8, 4000, 64) == 0
    assert tfr.bottleneck_variant(F32, 8, 4000, 256, 64) == "simt"
    assert tfr.tf32x3_tile_rows(14, 14, 256, limit=100_000) == 0


# ---------------------------------------------------------------------------
# the weight planes
# ---------------------------------------------------------------------------

def plane_offsets(k, n):
    """[k, n] float offsets of w's elements in its big plane (the small one
    is nb * 16 floats on): tile (column tile, 16-k tile), row j of the tile
    its column, place 4c + e of the row holding k = c + 4e of the tile, the
    16-byte chunk c stored at chunk c ^ ((j >> 1) & 3)."""
    nb = min(n, 256)
    kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
    tile = (nn // nb) * (k // 16) + kk // 16
    j, c, e = nn % nb, (kk % 16) % 4, (kk % 16) // 4
    return tile * nb * 32 + j * 16 + 4 * (c ^ ((j >> 1) & 3)) + e


@pytest.mark.parametrize("stage", [s for s, _ in STAGE_ROWS])
def test_weight_planes_plain_version_is_the_split_of_wt(stage):
    """`tf32x3_weight_planes_reference` (the card test holds the kernel to
    it bit for bit) puts tf32(w) and tf32(w - tf32(w)), rounded to nearest
    ties away, of w1, w2 and w3 where `plane_offsets` says."""
    _, c, f = stage
    g = torch.Generator().manual_seed(7)
    w1, w2, w3 = (torch.randn(*s, generator=g) for s in ((c, f), (9, f, f), (f, c)))
    w1[0, :4] = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 0.0])  # ties
    planes = tfr.tf32x3_weight_planes_reference(w1, w2, w3).view(torch.int32)
    assert planes.numel() == tfr.tf32x3_plane_floats(c, f)
    start = 0
    for w in (w1, w2.reshape(9 * f, f), w3):
        k, n = w.shape
        big = tf32(w)
        at = start + plane_offsets(k, n)
        assert torch.equal(planes[at], big.view(torch.int32))
        assert torch.equal(planes[at + min(n, 256) * 16], tf32(w - big).view(torch.int32))
        start += 2 * k * n
    assert tf32(w1[0, :4]).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 0.0]


@pytest.mark.parametrize("n", [64, 128, 256, 512])
def test_plane_addresses_cover_each_element_once(n):
    """Over a weight [48, n], the big and small planes' offsets take each
    float of the 2 * 48 * n exactly once; within a tile row the swizzle
    keeps each 16-byte chunk inside its 64-byte row."""
    off = plane_offsets(48, n)
    both = torch.cat([off.flatten(), (off + min(n, 256) * 16).flatten()])
    assert torch.equal(torch.sort(both).values, torch.arange(2 * 48 * n))
    assert ((off % (min(n, 256) * 32)) // 16 == torch.arange(n)[None, :] % min(n, 256)).all()


def test_k8_steps_take_the_lane_rows_k():
    """wgmma step s reads places 8s .. 8s + 7 of each plane row; A's lane t
    gives place t (registers 0, 1) and t + 4 (2, 3).  With the planes' k
    order that is k 4t + 2s and 4t + 2s + 1: the two floats a lane loads
    for the step from its 16-byte row chunk 4t .. 4t + 3, and each k once."""
    k_at = lambda place: place // 4 + 4 * (place % 4)  # place 4c + e holds k = c + 4e
    for s in range(2):
        for t in range(4):
            assert k_at(8 * s + t) == 4 * t + 2 * s
            assert k_at(8 * s + t + 4) == 4 * t + 2 * s + 1
        assert sorted(k_at(8 * s + i) for i in range(8)) == sorted(K5_STEPS[s])
    assert sorted(K5_STEPS[0] + K5_STEPS[1]) == list(range(16))
    assert "const Split s = split(src[4LL * e * j.n]);" in SOURCE  # chunk c: k = c + 4e


LANES = torch.arange(32)
G, T = LANES // 4, LANES % 4


def test_ldmatrix_reads_are_free_of_bank_conflicts():
    """K4's A fragment is one `ldmatrix.x4` from a ring A chunk of rows of
    16 + 4 floats: each of its four 8 x 4 matrices reads 16 bytes from each
    of 8 consecutive rows; the 8 row chunks lie on 8 different 16-byte bank
    groups.  Lane l gives row (l & 7) + 8 ((l >> 3) & 1) at column
    4 (l >> 4): the fragment's registers come out as the m16n8k8 A fragment
    (row g + 8 (e & 1), column t + 4 (e >> 1))."""
    ld = BK + 4
    assert "constexpr int kLdA = kBK + 4;" in SOURCE
    for r0 in range(0, 64, 8):
        groups = [((r0 + r) * ld // 4) % 8 for r in range(8)]
        assert len(set(groups)) == 8, r0
    rows = (LANES & 7) + 8 * ((LANES >> 3) & 1)
    cols = 4 * (LANES >> 4)
    for e in range(4):  # register e is matrix e: lanes 8e .. 8e + 7 give its rows
        mat = slice(8 * e, 8 * e + 8)
        assert (rows[mat] == torch.arange(8) + 8 * (e & 1)).all()
        assert (cols[mat] == 4 * (e >> 1)).all()
    assert torch.equal(G, LANES // 4) and torch.equal(T, LANES % 4)


@pytest.mark.parametrize("ld,what", [(BK, "a warp's ring of x rows"), *[
    (f + 16, f"a1 and a2 at F = {f}") for f in tfr.WGMMA_F]])
def test_a_row_reads_are_free_of_bank_conflicts(ld, what):
    """K5's lane 4g + t reads 16 bytes of its rows g and g + 8 at float
    4t: a quarter warp's 16-byte loads (lanes 8q .. 8q + 7: rows 2q and
    2q + 1, consecutive rows of a1, a2 or the x ring) cover 32 banks once."""
    for r0 in range(0, 64, 2):
        for q in range(4):
            lanes = torch.arange(8 * q, 8 * q + 8)
            g, t = lanes // 4, lanes % 4
            words = (r0 + g - 2 * q) * ld + 4 * t
            chunk = words[:, None] + torch.arange(4)[None, :]
            assert len(set((chunk.flatten() % 32).tolist())) == 32, (what, r0, q)


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
