"""The tensor-core K1's arithmetic outside the kernels: which variant a
shape gets, and a plain PyTorch emulation of the blocks' steps.

The emulation follows `csrc/fused_attention_wgmma.cu` step by step, in f32.
Forward: one block per 64-query tile, rows past L zero, keys walked NK at a
time with the key >= L cut, a running max and sum (one pass when the row
fits), the dropout hash drawn by each thread at its own accumulator
elements' (i, j), the row logsumexp stored.  Backward, one launch: pass 1
(the row term from dp * p, key tile by key tile), pass 2 (the transposed
tiles S^T = K Q^T and dP^T = V g^T, dV and dK summed query tile by query
tile, ds^T kept), pass 3 (dQ = ds K from the ds^T tiles in one chain).  It
is held against the port's plain versions and against the JAX package's
Pallas kernel in interpret mode.  The swizzled tile offsets the blocks
write are emulated too: each tile must be filled exactly once.
"""

import math
import re
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.ops import fused_attention as jfa
from macsa_tpu_torch.ops import fused_attention as tfa

BF16, F32 = torch.bfloat16, torch.float32
D, TILE, WG = tfa.WGMMA_HEAD_DIM, 64, 128  # head width; rows and threads of a warpgroup
MASKS = {"neg10000": -10000.0, "finfo_min": float(np.finfo(np.float32).min)}
CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "fused_attention_wgmma.cu").read_text()
# keys the held-row forward is instantiated for, as its C entry point picks
# them, and the keys a pass of the ring forward takes past the widest
KEY_PASSES = tuple(int(n) for n in re.findall(r"return launch_fwd<(\d+)>", SOURCE))
RING_KEYS = int(re.search(r"constexpr int kRingKeys = (\d+);", SOURCE).group(1))
INF = float("inf")


def key_pass(length):
    """The narrowest instantiated width that takes the whole row, else the
    ring's pass (the kernel then walks the keys with a running max and sum)."""
    return next((n for n in KEY_PASSES if length <= n), RING_KEYS)


def accumulator_coords(n):
    """(row, column), each [128 threads, n/2 registers], of a thread's share
    of the 64 x n accumulator of m64nNk16 (the map `wgmma_ops.cuh` gives)."""
    t, r = torch.arange(WG)[:, None], torch.arange(n // 2)[None, :]
    warp, lane, j, e = t // 32, t % 32, r // 4, r % 4
    return 16 * warp + lane // 4 + 8 * (e // 2), 8 * j + 2 * (lane % 4) + e % 2 + 0 * t


def keep_tile(seed, b, h, i0, j0, n, rate, transposed=False):
    """The keep mask of a 64 x n accumulator tile, every thread hashing its
    own elements: rows are queries from i0 and columns keys from j0, or,
    transposed, rows keys from j0 and columns queries from i0."""
    row, col = accumulator_coords(n)
    i, j = (i0 + col, j0 + row) if transposed else (i0 + row, j0 + col)
    tile = torch.zeros(TILE, n, dtype=torch.bool)
    tile[row, col] = tfa.dropout_keep(seed, b, h, i, j, rate)
    return tile


def padded_rows(x, r0, rows):
    """Rows [r0, r0 + rows) of x [L, D]; rows past L are zero (`load_rows`)."""
    out = torch.zeros(rows, x.shape[1])
    take = max(min(x.shape[0] - r0, rows), 0)
    out[:take] = x[r0:r0 + take]
    return out


def mask_row(mask_b, r0, rows):
    """The block's copy of the mask row: -inf at keys past L."""
    out = torch.full((rows,), -INF)
    take = max(min(mask_b.shape[0] - r0, rows), 0)
    out[:take] = mask_b[r0:r0 + take]
    return out


def emulate_forward(q, k, v, mask, heads, rate, seed, nk):
    """The forward block, tile by tile -> (out [B, L, H*D], lse [B, H, L])."""
    b_, l, _ = q.shape
    scale = 1.0 / math.sqrt(D)
    inv = tfa._inv_keep(rate) if rate > 0.0 else 1.0
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b_, heads, l), float("nan"))
    for b in range(b_):
        for h in range(heads):
            qh, kh, vh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v))
            for q0 in range(0, l, TILE):
                q_tile = padded_rows(qh, q0, TILE)
                m = torch.full((TILE,), -INF)
                total, o = torch.zeros(TILE), torch.zeros(TILE, D)
                for k0 in range(0, l, nk):
                    s = q_tile @ padded_rows(kh, k0, nk).T * scale + mask_row(mask[b], k0, nk)
                    mx = torch.maximum(m, s.max(-1).values)  # finite: key k0 is < L
                    corr = torch.exp(m - mx)  # 0 in the first pass
                    p = torch.exp(s - mx[:, None])
                    total = total * corr + p.sum(-1)  # the sum takes the undropped p
                    if rate > 0.0:
                        p = torch.where(keep_tile(seed, b, h, q0, k0, nk, rate), p * inv, 0.0)
                    o = o * corr[:, None] + p @ padded_rows(vh, k0, nk)
                    m = mx
                rows = min(TILE, l - q0)  # rows >= L are not stored
                out[b, q0:q0 + rows, h * D:(h + 1) * D] = (o / total[:, None])[:rows]
                lse[b, h, q0:q0 + rows] = (m + torch.log(total))[:rows]
    return out, lse


def emulate_backward(q, k, v, mask, g, lse, heads, rate, seed):
    """The one-launch backward block -> (dq, dk, dv), each [B, L, H*D]."""
    b_, l, _ = q.shape
    assert l <= tfa.WGMMA_BWD_ONE_LAUNCH_LEN  # a head's q, k, v, g stay in the block
    scale = 1.0 / math.sqrt(D)
    inv = tfa._inv_keep(rate) if rate > 0.0 else 1.0
    tiles = -(-l // TILE)
    rows = tiles * TILE
    grads = [torch.full_like(q, float("nan")) for _ in range(3)]
    for b in range(b_):
        for h in range(heads):
            qs, ks, vs, gs = (padded_rows(x[b, :, h * D:(h + 1) * D], 0, rows)
                              for x in (q, k, v, g))
            lse_s = torch.full((rows,), INF)  # p = exp(. - inf) = 0 for a query >= L
            lse_s[:l] = lse[b, h]
            mrow = mask_row(mask[b], 0, rows)
            tile = lambda x, t: x[t * TILE:(t + 1) * TILE]

            def elements(s, dpd, keep):
                p = torch.exp(s)
                if rate > 0.0:
                    return p, torch.where(keep, p * inv, 0.0), torch.where(keep, dpd * inv, 0.0)
                return p, p, dpd

            # pass 1: warpgroup w owns queries; the row term, key tile by key tile
            term = torch.zeros(rows)
            for w in range(tiles):
                for kt in range(tiles):
                    s = tile(qs, w) @ tile(ks, kt).T * scale + tile(mrow, kt) \
                        - tile(lse_s, w)[:, None]
                    keep = keep_tile(seed, b, h, w * TILE, kt * TILE, TILE, rate)
                    p, _, dp = elements(s, tile(gs, w) @ tile(vs, kt).T, keep)
                    term[w * TILE:(w + 1) * TILE] += (dp * p).sum(-1)
            # pass 2: warpgroup w owns keys; rows of the tiles are keys, columns queries
            dk, dv = torch.zeros(rows, D), torch.zeros(rows, D)
            ds_t = torch.zeros(tiles, rows, TILE)  # per query tile [keys][queries]
            for w in range(tiles):
                for qt in range(tiles):
                    s_t = tile(ks, w) @ tile(qs, qt).T * scale + tile(mrow, w)[:, None] \
                        - tile(lse_s, qt)
                    keep_t = keep_tile(seed, b, h, qt * TILE, w * TILE, TILE, rate,
                                       transposed=True)
                    p, pd, dp = elements(s_t, tile(vs, w) @ tile(gs, qt).T, keep_t)
                    ds = p * (dp - tile(term, qt))
                    dv[w * TILE:(w + 1) * TILE] += pd @ tile(gs, qt)
                    dk[w * TILE:(w + 1) * TILE] += ds @ tile(qs, qt)
                    ds_t[qt, w * TILE:(w + 1) * TILE] = ds
            # pass 3: warpgroup w owns queries again; A is ds^T read MN-major
            dq = torch.cat([ds_t[w].T @ ks for w in range(tiles)])
            for grad, x in zip(grads, (dq * scale, dk * scale, dv)):
                grad[b, :, h * D:(h + 1) * D] = x[:l]
    return grads


def _inputs(rng, l, neg, b=2, heads=2):
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, l, heads * D)).astype(np.float32))
                  for _ in range(4))
    mask = np.zeros((b, l), np.float32)
    mask[1, max(l // 3, 1):] = neg  # padded keys
    return q, k, v, torch.from_numpy(mask), g


def _jax_forward(q, k, v, mask, heads):
    return np.asarray(jfa.fused_self_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, mask)), jnp.zeros((1,), jnp.int32),
        heads, 0.0, True))


# nk 64: the running max and sum over several key tiles even at small L
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("nk", [64, None])
@pytest.mark.parametrize("l", [40, 170, 193])
def test_forward_emulation_matches_references(rng, l, nk, mask_kind):
    heads = 2
    nk = nk or key_pass(l)
    q, k, v, mask, _ = _inputs(rng, l, MASKS[mask_kind])
    want_jax = _jax_forward(q, k, v, mask, heads)
    for rate, seed in ((0.0, 0), (0.1, 77)):
        got, lse = emulate_forward(q, k, v, mask, heads, rate, seed, nk)
        assert not torch.isnan(got).any() and not torch.isnan(lse).any()  # all written
        want = tfa.attention_reference(q, k, v, mask, heads, rate, seed)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
        scores = torch.einsum("bnqd,bnkd->bnqk", tfa.split_heads(q, heads),
                              tfa.split_heads(k, heads)) / math.sqrt(D) + mask[:, None, None, :]
        np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(),
                                   rtol=0, atol=1e-4)
        if rate == 0.0:
            np.testing.assert_allclose(got.numpy(), want_jax, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("l", [40, 170, 192])
def test_backward_emulation_matches_references(rng, l, mask_kind):
    heads = 2
    q, k, v, mask, g = _inputs(rng, l, MASKS[mask_kind])
    _, vjp = jax.vjp(lambda *x: jfa.fused_self_attention(
        *x, jnp.asarray(mask.numpy()), jnp.zeros((1,), jnp.int32), heads, 0.0, True),
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want_jax = [np.asarray(x) for x in vjp(jnp.asarray(g.numpy()))]
    for rate, seed in ((0.0, 0), (0.1, 77)):
        lse = emulate_forward(q, k, v, mask, heads, rate, seed, key_pass(l))[1]
        got = emulate_backward(q, k, v, mask, g, lse, heads, rate, seed)
        want = tfa.attention_backward_reference(q, k, v, mask, g, heads, rate, seed)
        for name, x, w, wj in zip("qkv", got, want, want_jax):
            assert not torch.isnan(x).any(), name
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)
            if rate == 0.0:
                np.testing.assert_allclose(x.numpy(), wj, rtol=0, atol=1e-5, err_msg=name)


def test_backward_of_a_longer_row_is_the_cuda_core_variants():
    """193 rows: no longer the CUDA-core variant's either way.  The forward
    walks two ring passes on the tensor cores; the backward's one block no
    longer holds the head, so the one-launch emulation refuses the row and
    the two streaming launches take it on the tensor cores
    (`test_torch_port_attention_long_rows.py` emulates them)."""
    assert tfa.attention_variant(BF16, D, 193) == "wgmma"
    assert tfa.attention_variant(BF16, D, 193, backward=True) == "wgmma"
    assert key_pass(193) == RING_KEYS
    x = torch.zeros(1, 193, D)
    with pytest.raises(AssertionError):
        emulate_backward(x, x, x, torch.zeros(1, 193), x, torch.zeros(1, 1, 193), 1, 0.0, 0)


@pytest.mark.parametrize("dtype,head_dim,length,backward,want", [
    (BF16, 64, 1, False, "wgmma"), (BF16, 64, 170, False, "wgmma"),
    (BF16, 64, 514, False, "wgmma"), (BF16, 64, 4096, False, "wgmma"),
    (BF16, 64, 1, True, "wgmma"), (BF16, 64, 170, True, "wgmma"),
    (BF16, 64, 192, True, "wgmma"), (BF16, 64, 193, True, "wgmma"),
    (BF16, 64, 514, True, "wgmma"),
    (BF16, 32, 170, False, "simt"), (BF16, 32, 170, True, "simt"),
    (F32, 64, 170, False, "tf32x3"), (F32, 64, 170, True, "tf32x3"),
    (F32, 32, 40, False, "simt"), (F32, 32, 170, True, "simt"),
    (BF16, 32, 256, False, "simt"), (F32, 32, 256, True, "simt"),
])
def test_attention_variant(dtype, head_dim, length, backward, want):
    assert tfa.attention_variant(dtype, head_dim, length, backward) == want


@pytest.mark.parametrize("length,want", [(1, 64), (64, 64), (65, 128), (128, 128), (129, 192),
                                         (170, 192), (192, 192), (193, RING_KEYS),
                                         (514, RING_KEYS)])
def test_key_pass_of_the_source(length, want):
    """The C entry point's dispatch: `L <= n` for every held width, the
    ring's passes past the widest."""
    assert KEY_PASSES == (64, 128, 192) and RING_KEYS == 64
    limits = [int(n) for n in re.findall(r"if \(L <= (\d+)\) return launch_fwd<", SOURCE)]
    assert limits == list(KEY_PASSES)
    assert "  return launch_fwd_ring<kRingKeys>(" in SOURCE
    assert key_pass(length) == want


def test_python_constants_are_the_sources():
    """The variant rule's limits are written twice, in `ops/fused_attention.py`
    and in the CUDA source: they must agree.  And the shared memory the
    source asks for fits the blocks an SM each kernel's launch bounds
    claim: three for the held-row forward, five for the ring forward, four
    and three for the streaming backward's two launches, one for the
    one-launch backward."""
    constant = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))
    assert constant("kD") == tfa.WGMMA_HEAD_DIM
    assert constant("kTile") == TILE
    assert constant("kBwdRows") == tfa.WGMMA_BWD_ONE_LAUNCH_LEN
    align, smem, tile = 1024, 227 * 1024, TILE * D * 2
    fwd_stages, bwd_stages = constant("kFwdStages"), constant("kBwdStages")
    ring_keys = constant("kRingKeys")
    need = {
        "attention_fwd_wgmma_kernel": align + tile + 2 * 192 * D * 2 + 192 * 4,
        "attention_fwd_ring_kernel": align + tile + fwd_stages * (2 * ring_keys * D * 2
                                                                  + ring_keys * 4),
        "attention_bwd_wgmma_kernel": align + 4 * 192 * D * 2 + 3 * 192 * D * 2 + 4 * 192 * 4,
        # two held tiles, two tiles a stage, a stage's lse, row term and hash
        "attention_bwd_dq_kernel": align + 2 * tile + bwd_stages * (2 * tile + 3 * TILE * 4),
    }
    need["attention_bwd_dkdv_kernel"] = need["attention_bwd_dq_kernel"]
    bounds = {name: int(n) for n, name in re.findall(
        r"__launch_bounds__\((?:kWG|kBwdThreads), (\d+)\)\n(attention_\w+)\(", SOURCE)}
    assert bounds == {"attention_fwd_wgmma_kernel": 3, "attention_fwd_ring_kernel": 5,
                      "attention_bwd_wgmma_kernel": 1, "attention_bwd_dq_kernel": 4,
                      "attention_bwd_dkdv_kernel": 3}
    for name, blocks in bounds.items():  # + 1 KB that CUDA reserves per block
        assert blocks * (need[name] + 1024) <= smem, name


@pytest.mark.parametrize("n", [64, 128, 192])
def test_accumulator_map(n):
    """Every element of the 64 x n tile belongs to one (thread, register);
    four lanes share a row (the quad reductions); and registers 8kk..8kk+7
    are the A fragment of k step kk of the next product: a[0], a[1] rows lo
    and lo + 8 at k = 2 * (lane % 4), a[2], a[3] the same rows at k + 8."""
    row, col = accumulator_coords(n)
    cells = sorted((row * n + col).flatten().tolist())
    assert cells == list(range(64 * n))
    lane = torch.arange(WG) % 32
    lo = row[:, 0]
    assert torch.equal(lo, 16 * (torch.arange(WG) // 32) + lane // 4)
    for t in range(0, WG, 4):  # a quad holds one pair of rows
        assert len(set(lo[t:t + 4].tolist())) == 1
    for kk in range(n // 16):
        for a in range(4):  # packed pair a of the fragment: registers 8kk + 2a, + 1
            r0 = 8 * kk + 2 * a
            assert torch.equal(row[:, r0], lo + 8 * (a % 2))
            assert torch.equal(col[:, r0] - 16 * kk, 2 * (lane % 4) + 8 * (a // 2))
            assert torch.equal(col[:, r0 + 1], col[:, r0] + 1)


def _swizzled(r, c):
    """Byte offset of 16-byte chunk c of row r in a swizzled tile (`hopper_tiles.cuh`)."""
    return r * 128 + ((c ^ (r & 7)) << 4)


@pytest.mark.parametrize("rows,threads", [(64, 128), (192, 128), (192, 384), (128, 384)])
def test_loaded_tiles_are_filled_exactly_once(rows, threads):
    """`load_rows`: the block's copies cover every 16-byte chunk of the tile
    once, a row stays inside its own 128 bytes (what the 128-byte swizzle
    of both descriptor forms assumes), and 8-row groups are 1024 bytes apart."""
    written = []
    for t in range(threads):
        for idx in range(t, rows * 8, threads):
            r, c = idx >> 3, idx & 7
            assert r * 128 <= _swizzled(r, c) < (r + 1) * 128
            written.append(_swizzled(r, c))
    assert sorted(written) == list(range(0, rows * 128, 16))
    assert _swizzled(8, 0) - _swizzled(0, 0) == 1024  # the descriptors' stride offset
    assert _swizzled(16, 0) - _swizzled(0, 0) == 2048  # 16 k further, MN-major


@pytest.mark.parametrize("wg", [0, 1, 2])
def test_staged_and_transposed_tiles_are_written_exactly_once(wg):
    """`stage_tile` and pass 2's ds^T stores: a warpgroup's threads write
    every 4-byte pair of its 64 rows x 64 columns once, at the swizzled
    place of (row, column): K-major readers (rows M, columns k) and
    MN-major readers (rows k, columns M: dQ's A operand) see one layout."""
    row, col = accumulator_coords(64)
    written = {}
    for t in range(WG):
        lane, warp = t % 32, t // 32
        row_lo, col2 = 64 * wg + warp * 16 + lane // 4, (lane % 4) * 2
        for j in range(8):
            for half, r in enumerate((row_lo, row_lo + 8)):
                off = _swizzled(r, j) + col2 * 2
                assert off not in written
                written[off] = (r, 8 * j + col2)
                reg = 4 * j + 2 * half  # the accumulator pair stored there
                assert (int(row[t, reg]) + 64 * wg, int(col[t, reg])) == written[off]
    assert sorted(written) == list(range(64 * wg * 128, 64 * (wg + 1) * 128, 4))
    for off, (r, c) in written.items():  # element (r, c) of a tile, whoever reads it
        assert off == r * 128 + (((c // 8) ^ (r & 7)) << 4) + (c % 8) * 2


@pytest.mark.parametrize("heads", [1, 2, 12])
def test_head_rows_are_whole_aligned_tile_rows(heads):
    """One head's row is 128 bytes at h * 128 of a row of H * 128 bytes:
    eight 16-byte copies, each 16-byte aligned, no head transpose."""
    x = torch.arange(3 * 5 * heads * D, dtype=torch.float32).reshape(3, 5, heads * D).to(BF16)
    for h in range(heads):
        for c in range(8):
            elem = (1 * 5 + 2) * heads * D + h * D + c * 8  # (b=1, i=2, h, chunk c)
            assert (elem * x.element_size()) % 16 == 0
            assert torch.equal(x.flatten()[elem:elem + 8],
                               tfa.split_heads(x, heads)[1, h, 2, c * 8:c * 8 + 8])


def test_wgmma_wrappers_are_generated_with_both_operand_forms():
    """`wgmma_ops.cuh` is what its generator writes, at the widths K1 needs,
    with the transpose bits as template arguments (K-major B for Q K^T)."""
    gen = runpy.run_path(str(CSRC / "gen_wgmma_ops.py"))
    assert set(KEY_PASSES) <= set(gen["WIDTHS"])
    text = gen["render"]()
    assert (CSRC / "wgmma_ops.cuh").read_text() == text
    assert text.count("template <int TA = 0, int TB = 1>") == len(gen["WIDTHS"])
    assert text.count("template <int TB = 1>") == len(gen["WIDTHS"])
    assert "m64n192k16" in text
