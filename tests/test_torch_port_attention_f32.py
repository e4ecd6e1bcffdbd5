"""The f32 tensor-core K1 ("tf32x3") outside the kernels: a plain PyTorch
emulation of `csrc/fused_attention_tf32.cu`, step by step.

Every f32 product is split as the kernels split it (`cvt.rna.tf32.f32`:
big = tf32(x), small = tf32(x - big)) and taken as three TF32 products,
small*big + big*small + big*big, 8 columns of the inner dimension at a time
(one `mma.sync.m16n8k8` step), summed in f32.  Forward: 64-query tiles,
64-key tiles with the key >= L cut, a running max and sum, the dropout hash
at each element's (i, j), the row logsumexp.  Backward, two launches: the
dq launch walks the key tiles twice (the row term rowsum(dp * p), then
ds = p (dp - row term) and dq += ds K); the dk/dv launch walks the query
tiles with the transposed tiles S^T = K Q^T and dP^T = V g^T.  The
emulation is held against the port's plain versions and the JAX package's
Pallas kernel in interpret mode with the card's tolerances (forward 1e-5
absolute, backward 1e-4 of max|ref|), and one TF32 product is shown to
miss them.  The fragment maps of m16n8k8 are emulated too: the relabelled
key axis that feeds a product's accumulators to the next product gives the
same sum, and every fragment read of a padded tile row is free of bank
conflicts.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.ops import fused_attention as jfa
from macsa_tpu_torch.ops import fused_attention as tfa

SOURCE = (Path(tfa.__file__).resolve().parent.parent / "csrc"
          / "fused_attention_tf32.cu").read_text()
D, TILE = tfa.WGMMA_HEAD_DIM, tfa.TF32X3_TILE
MASKS = {"neg10000": -10000.0, "finfo_min": float(np.finfo(np.float32).min)}
FWD_ATOL, BWD_REL = 1e-5, 1e-4  # phase k1's and phase k1_bwd's f32 tolerances
INF = float("inf")


def constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


# floats a tile row takes in shared memory: the head width and its padding
STRIDE = D + int(re.search(r"constexpr int kStride = kD \+ (\d+);", SOURCE).group(1))


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


def product(a, b, acc=None, terms=3, transposed=False):
    """acc + a [M, K] @ b [K, N] as the kernels take it: K in steps of 8,
    each step three TF32 products (small*big, big*small, big*big; the two
    small terms the other way round for a `transposed` product, S^T = K Q^T
    or dP^T = V g^T, so that it sums the terms of S or dP in their order)
    or, with `terms` 1, one (big*big), summed in f32."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc
    for k0 in range(0, a.shape[1], 8):
        step = slice(k0, k0 + 8)
        if terms == 3:
            small_terms = [a_small[:, step] @ b_big[step], a_big[:, step] @ b_small[step]]
            for term in small_terms[::-1] if transposed else small_terms:
                acc = acc + term
        acc = acc + a_big[:, step] @ b_big[step]
    return acc


def padded_rows(x, r0):
    """Rows [r0, r0 + TILE) of x [L, D]; rows past L are zero (`load_tile`)."""
    out = torch.zeros(TILE, x.shape[1])
    take = max(min(x.shape[0] - r0, TILE), 0)
    out[:take] = x[r0:r0 + take]
    return out


def padded(row, r0, fill=0.0):
    """Values [r0, r0 + TILE) of a per-row vector, `fill` past L."""
    out = torch.full((TILE,), fill)
    take = max(min(row.shape[0] - r0, TILE), 0)
    out[:take] = row[r0:r0 + take]
    return out


def keep_tile(seed, b, h, i0, j0, rate):
    """Keep mask of the 64 x 64 tile of queries from i0 and keys from j0."""
    ar = torch.arange(TILE)
    return tfa.dropout_keep(seed, b, h, i0 + ar[:, None], j0 + ar[None, :], rate)


def emulate_forward(q, k, v, mask, heads, rate, seed, terms=3):
    """`attention_fwd_tf32_kernel`, block by block and tile by tile ->
    (out [B, L, H*D], lse [B, H, L])."""
    n_b, l, _ = q.shape
    scale = 1.0 / math.sqrt(D)
    inv = tfa._inv_keep(rate) if rate > 0.0 else 1.0
    out = torch.full_like(q, float("nan"))
    lse = torch.full((n_b, heads, l), float("nan"))
    valid = lambda j0: j0 + torch.arange(TILE) < l
    for b in range(n_b):
        for h in range(heads):
            qh, kh, vh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v))
            for q0 in range(0, l, TILE):
                q_tile = padded_rows(qh, q0)
                m, total, o = torch.full((TILE,), -INF), torch.zeros(TILE), torch.zeros(TILE, D)
                for k0 in range(0, l, TILE):
                    s = product(q_tile, padded_rows(kh, k0).T, terms=terms) * scale \
                        + padded(mask[b], k0)
                    s = torch.where(valid(k0), s, -INF)
                    mx = torch.maximum(m, s.max(-1).values)  # finite: key 0 is < L
                    corr = torch.exp(m - mx)  # 0 on the first tile
                    p = torch.exp(s - mx[:, None])
                    total = total * corr + p.sum(-1)  # every exponential, kept or not
                    if rate > 0.0:
                        p = torch.where(keep_tile(seed, b, h, q0, k0, rate), p * inv, 0.0)
                    o = product(p, padded_rows(vh, k0), acc=o * corr[:, None], terms=terms)
                    m = mx
                rows = min(TILE, l - q0)  # rows >= L are not stored
                out[b, q0:q0 + rows, h * D:(h + 1) * D] = (o / total[:, None])[:rows]
                lse[b, h, q0:q0 + rows] = (m + torch.log(total))[:rows]
    return out, lse


def emulate_backward(q, k, v, mask, g, lse, heads, rate, seed):
    """`attention_bwd_dq_tf32_kernel` then `attention_bwd_dkdv_tf32_kernel`,
    block by block -> (dq, dk, dv), each [B, L, H*D]."""
    n_b, l, _ = q.shape
    scale = 1.0 / math.sqrt(D)
    inv = tfa._inv_keep(rate) if rate > 0.0 else 1.0
    grads = [torch.full_like(q, float("nan")) for _ in range(3)]
    row_term = torch.full((n_b, heads, l), float("nan"))
    valid = lambda r0: r0 + torch.arange(TILE) < l

    def dropped(p, dp, keep):
        if rate == 0.0:
            return p, dp
        return torch.where(keep, p * inv, 0.0), torch.where(keep, dp * inv, 0.0)

    for b in range(n_b):
        for h in range(heads):
            qh, kh, vh, gh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v, g))
            # launch 1: a block per query tile, two walks over the key tiles
            for q0 in range(0, l, TILE):
                q_tile, g_tile = padded_rows(qh, q0), padded_rows(gh, q0)
                row_lse = padded(lse[b, h], q0)
                term, acc = torch.zeros(TILE), torch.zeros(TILE, D)
                for walk in (1, 2):
                    for k0 in range(0, l, TILE):
                        k_tile, v_tile = padded_rows(kh, k0), padded_rows(vh, k0)
                        s = product(q_tile, k_tile.T) * scale + padded(mask[b], k0)
                        p = torch.where(valid(k0), torch.exp(s - row_lse[:, None]), 0.0)
                        _, dp = dropped(p, product(g_tile, v_tile.T),
                                        keep_tile(seed, b, h, q0, k0, rate))
                        if walk == 1:
                            term = term + (dp * p).sum(-1)
                        else:
                            acc = product(p * (dp - term[:, None]), k_tile, acc=acc)
                rows = min(TILE, l - q0)
                grads[0][b, q0:q0 + rows, h * D:(h + 1) * D] = (acc * scale)[:rows]
                row_term[b, h, q0:q0 + rows] = term[:rows]
            # launch 2: a block per key tile walks the query tiles; rows are keys
            for k0 in range(0, l, TILE):
                k_tile, v_tile = padded_rows(kh, k0), padded_rows(vh, k0)
                m_keys = padded(mask[b], k0)
                acc_k, acc_v = torch.zeros(TILE, D), torch.zeros(TILE, D)
                for i0 in range(0, l, TILE):
                    q_tile, g_tile = padded_rows(qh, i0), padded_rows(gh, i0)
                    s_t = product(k_tile, q_tile.T, transposed=True) * scale + m_keys[:, None] \
                        - padded(lse[b, h], i0)[None, :]
                    p = torch.where(valid(k0)[:, None] & valid(i0)[None, :], torch.exp(s_t), 0.0)
                    pd, dp = dropped(p, product(v_tile, g_tile.T, transposed=True),
                                     keep_tile(seed, b, h, i0, k0, rate).T)
                    ds = p * (dp - padded(row_term[b, h], i0)[None, :])
                    acc_v = product(pd, g_tile, acc=acc_v)
                    acc_k = product(ds, q_tile, acc=acc_k)
                rows = min(TILE, l - k0)
                grads[1][b, k0:k0 + rows, h * D:(h + 1) * D] = (acc_k * scale)[:rows]
                grads[2][b, k0:k0 + rows, h * D:(h + 1) * D] = acc_v[:rows]
    return grads


def _inputs(rng, l, neg, b=2, heads=2):
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, l, heads * D)).astype(np.float32))
                  for _ in range(4))
    mask = np.zeros((b, l), np.float32)
    mask[1, max(l // 3, 1):] = neg  # padded keys
    return q, k, v, torch.from_numpy(mask), g


def _jax_args(*xs):
    return tuple(jnp.asarray(x.numpy()) for x in xs)


# ---------------------------------------------------------------------------
# against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("l", [1, 40, 130, 170])
def test_forward_emulation_matches_references(rng, l, mask_kind):
    heads = 2
    q, k, v, mask, _ = _inputs(rng, l, MASKS[mask_kind])
    want_jax = np.asarray(jfa.fused_self_attention(
        *_jax_args(q, k, v, mask), jnp.zeros((1,), jnp.int32), heads, 0.0, True))
    for rate, seed in ((0.0, 0), (0.1, 77)):
        got, lse = emulate_forward(q, k, v, mask, heads, rate, seed)
        assert not torch.isnan(got).any() and not torch.isnan(lse).any()  # all written
        want = tfa.attention_reference(q, k, v, mask, heads, rate, seed)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FWD_ATOL)
        scores = torch.einsum("bnqd,bnkd->bnqk", tfa.split_heads(q, heads),
                              tfa.split_heads(k, heads)) / math.sqrt(D) + mask[:, None, None, :]
        np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(),
                                   rtol=0, atol=1e-4)
        if rate == 0.0:
            np.testing.assert_allclose(got.numpy(), want_jax, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("l", [40, 170])
def test_backward_emulation_matches_references(rng, l, mask_kind):
    heads = 2
    q, k, v, mask, g = _inputs(rng, l, MASKS[mask_kind])
    _, vjp = jax.vjp(lambda *x: jfa.fused_self_attention(
        *x, jnp.asarray(mask.numpy()), jnp.zeros((1,), jnp.int32), heads, 0.0, True),
        *_jax_args(q, k, v))
    want_jax = [np.asarray(x) for x in vjp(jnp.asarray(g.numpy()))]
    for rate, seed in ((0.0, 0), (0.1, 77)):
        lse = emulate_forward(q, k, v, mask, heads, rate, seed)[1]
        got = emulate_backward(q, k, v, mask, g, lse, heads, rate, seed)
        want = tfa.attention_backward_reference(q, k, v, mask, g, heads, rate, seed)
        for name, x, w, wj in zip("qkv", got, want, want_jax):
            assert not torch.isnan(x).any(), name
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0,
                                       atol=BWD_REL * w.abs().max().item(), err_msg=name)
            if rate == 0.0:
                np.testing.assert_allclose(x.numpy(), wj, rtol=0,
                                           atol=BWD_REL * np.abs(wj).max(), err_msg=name)


def test_transposed_products_sum_the_same_terms_in_the_same_order():
    """S^T = K Q^T takes the small terms the other way round, so that each
    element adds the same three TF32 products in the order S = Q K^T adds
    them: the same bits.  A one-row attention then has dq = dk = 0
    exactly (p = 1, ds = p (dp - rowsum(dp p)) = 0), as its reference."""
    gen = np.random.default_rng(5)
    q, k = (torch.from_numpy(gen.normal(size=(TILE, D)).astype(np.float32)) for _ in range(2))
    assert torch.equal(product(k, q.T, transposed=True), product(q, k.T).T)
    q, k, v, g = (torch.from_numpy(gen.normal(size=(2, 1, 2 * D)).astype(np.float32))
                  for _ in range(4))
    mask = torch.zeros(2, 1)
    lse = emulate_forward(q, k, v, mask, 2, 0.0, 0)[1]
    dq, dk, dv = emulate_backward(q, k, v, mask, g, lse, 2, 0.0, 0)
    assert not dq.any() and not dk.any() and dv.abs().max() > 0


def test_one_tf32_product_misses_the_f32_tolerance(rng):
    """Why three products: with one TF32 product for each f32 product the
    forward is far outside phase k1's 1e-5; with three it is inside."""
    heads = 2
    q, k, v, mask, _ = _inputs(rng, 170, -10000.0)
    want = tfa.attention_reference(q, k, v, mask, heads)
    err = {terms: (emulate_forward(q, k, v, mask, heads, 0.0, 0, terms)[0]
                   - want).abs().max().item() for terms in (1, 3)}
    assert err[1] > 10 * FWD_ATOL, err
    assert err[3] < FWD_ATOL, err


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


# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------

LANES = torch.arange(32)
G, T = LANES // 4, LANES % 4


def a_coords(e):
    """(row, column) of element e of m16n8k8's tf32 A fragment, per lane."""
    return G + 8 * (e & 1), T + 4 * (e >> 1)


def b_coords(e):
    """(k row, n column) of element e of the B fragment, per lane."""
    return T + 4 * e, G


def c_coords(e):
    """(row, column) of element e of the accumulator fragment, per lane."""
    return G + 8 * (e >> 1), 2 * T + (e & 1)


def mma(a_frag, b_frag):
    """One m16n8k8 step from per-lane fragments [32, 4] and [32, 2] -> C [16, 8]."""
    a, b = torch.zeros(16, 8), torch.zeros(8, 8)
    for e in range(4):
        a[a_coords(e)] = a_frag[:, e]
    for e in range(2):
        b[b_coords(e)] = b_frag[:, e]
    return a @ b


@pytest.mark.parametrize("which", ["product_rows", "product_acc"])
def test_fragment_reads_give_the_tile_product(which):
    """The kernels' fragment reads, one m16n8k8 step at a time, sum to the
    tile product.  `product_rows`: A from rows of a tile (columns 8kk + t,
    + 4), B from rows of another (A B^T).  `product_acc`: A from the
    previous product's accumulators with each slice's columns relabelled
    (A's column t is column 2t, t + 4 is 2t + 1), B's rows read in that
    order.  Small integers, so the sums are exact."""
    gen = torch.Generator().manual_seed(0)
    a_tile = torch.randint(-4, 5, (16, 64), generator=gen).float()
    b_tile = torch.randint(-4, 5, (64, 64), generator=gen).float()
    for n in range(8):
        got = torch.zeros(16, 8)
        for kk in range(8):
            if which == "product_rows":
                a_frag = torch.stack([a_tile[G, 8 * kk + T], a_tile[G + 8, 8 * kk + T],
                                      a_tile[G, 8 * kk + T + 4], a_tile[G + 8, 8 * kk + T + 4]], 1)
                b_frag = torch.stack([b_tile[8 * n + G, 8 * kk + T],
                                      b_tile[8 * n + G, 8 * kk + T + 4]], 1)
            else:
                # the accumulator fragment of slice kk, fed as (c0, c2, c1, c3)
                acc = [a_tile[:, 8 * kk:8 * kk + 8][c_coords(e)] for e in range(4)]
                a_frag = torch.stack([acc[0], acc[2], acc[1], acc[3]], 1)
                b_frag = torch.stack([b_tile[8 * kk + 2 * T, 8 * n + G],
                                      b_tile[8 * kk + 2 * T + 1, 8 * n + G]], 1)
            got += mma(a_frag, b_frag)
        want = (a_tile @ (b_tile.T if which == "product_rows" else b_tile))[:, 8 * n:8 * n + 8]
        assert torch.equal(got, want), (which, n)


def test_accumulator_elements_are_one_a_fragment():
    """Relabelling loses and repeats nothing: the four accumulator elements
    of the 32 lanes fill the 16 x 8 A fragment once each."""
    seen = torch.zeros(16, 8, dtype=torch.int64)
    for e, src in enumerate((0, 2, 1, 3)):
        row, col = c_coords(src)
        a_row, a_col = a_coords(e)
        assert torch.equal(row, a_row)  # the same query (or key) row
        # A's column t holds column 2t, t + 4 holds 2t + 1
        assert torch.equal(col, 2 * (a_col % 4) + a_col // 4)
        seen[a_row, a_col] += 1
    assert (seen == 1).all()


def test_fragment_reads_are_free_of_bank_conflicts():
    """Every fragment read of a padded tile puts the 32 lanes on 32
    different banks (4-byte words): rows as m or n with the columns as k
    (`load_a`, `product_rows`' B), and rows as k (`product_acc`' B)."""
    stride = STRIDE
    assert stride == D + 4 and stride * 4 % 16 == 0  # 16-byte copies stay aligned
    reads = {  # word offset of each read, per lane, at step kk of output slice n
        "load_a": lambda kk, n: [r * stride + 8 * kk + c for r in (G, G + 8) for c in (T, T + 4)],
        "product_rows B": lambda kk, n: [(8 * n + G) * stride + 8 * kk + c for c in (T, T + 4)],
        "product_acc B": lambda kk, n: [(8 * kk + 2 * T + r) * stride + 8 * n + G for r in (0, 1)],
    }
    for name, addresses in reads.items():
        for kk in range(8):
            for n in range(8):
                for addr in addresses(kk, n):
                    assert len(set((addr % 32).tolist())) == 32, (name, kk, n)


def test_python_constants_are_the_source():
    """The tile, the head width and the shared memory of the three kernels
    (a stage of the ring: two tiles and its rows' values; the dq and dk/dv
    launches hold two tiles besides): each fits the 227 KB a block may take,
    three forward blocks or two backward blocks to an SM."""
    assert constant("kD") == D and constant("kTile") == TILE == 64
    tile = TILE * STRIDE * 4
    need = {"forward": 2 * (2 * tile + TILE * 4),  # K, V, the mask row's values
            "dq": 2 * tile + 2 * (2 * tile + TILE * 4),  # Q, g held
            "dkdv": 2 * tile + 2 * (2 * tile + 3 * TILE * 4)}  # K, V held; lse, term, hash
    assert need["forward"] == 70_144
    assert "constexpr int kFwdStage = 2 * kTileFloats + kTile;" in SOURCE
    assert "constexpr int kDkdvStage = 2 * kTileFloats + 3 * kTile;" in SOURCE
    smem = 227 * 1024
    for name, blocks in (("forward", 3), ("dq", 2), ("dkdv", 2)):
        assert blocks * (need[name] + 1024) <= smem, name  # + 1 KB CUDA reserves a block
    assert '"macsa_fused_attention_fwd_tf32x3"' in Path(
        tfa.cuda_lib.__file__).read_text()


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.float32, 64, "tf32x3"), (torch.bfloat16, 64, "wgmma"),
    (torch.float32, 32, "simt"), (torch.bfloat16, 32, "simt"),
])
@pytest.mark.parametrize("length", [1, 170, 256])
def test_f32_at_head_width_64_is_tf32x3_both_ways(dtype, head_dim, want, length):
    for backward in (False, True):
        assert tfa.attention_variant(dtype, head_dim, length, backward) == want
