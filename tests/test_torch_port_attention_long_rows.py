"""K1's tensor-core kernels past the one-launch backward's 192 rows,
emulated step by step in plain PyTorch on the CPU, in f32.

Forward (`attention_fwd_ring_kernel` of `csrc/fused_attention_wgmma.cu`):
a block of 64 queries walks the keys `kRingKeys` at a time with a running
max and sum; each pass's K, V and mask row sit in one stage of a ring of
`kFwdStages` stages, and the copies of pass t + stages - 1 go into the stage
of pass t - 1 once every thread is done with it, before pass t is computed.
The backward's rings (`kBwdStages`) run the same way.

Backward, two launches:
- launch 1 (`attention_bwd_dq_kernel`): a block holds a 64-query tile of Q
  and g and walks the 64-key tiles of K, V and the mask row through the
  ring twice: walk (a) sums the row term rowsum(dp * p) and stores it to
  [B, H, L]; walk (b) forms ds = p (dp - row term) and dQ += ds K;
- launch 2 (`attention_bwd_dkdv_kernel`): a block holds a 64-key tile of K
  and V and streams the query tiles of Q and g, with their lse (+inf past
  L), row term (launch 1's, 0 past L) and row hash, on the transposed
  tiles S^T = K Q^T and dP^T = V g^T.

The ring itself is emulated: a stage may only be refilled once its tile is
done with, and each step must find its own tile in its stage.  Everything
is held against the port's plain versions and against the JAX package's
Pallas kernel in interpret mode.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.ops import fused_attention as jfa
from macsa_tpu_torch.ops import fused_attention as tfa
from test_torch_port_attention_tiles import (D, INF, MASKS, SOURCE, TILE, _inputs, _jax_forward,
                                             keep_tile, mask_row, padded_rows)

BF16 = torch.bfloat16
RING_KEYS = int(re.search(r"constexpr int kRingKeys = (\d+);", SOURCE).group(1))
FWD_STAGES, BWD_STAGES = (int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))
                          for name in ("kFwdStages", "kBwdStages"))
LENGTHS = [193, 256, 300]  # one row over the one-launch limit, EF-CapTr's, a ragged tail
RATES = [(0.0, 0), (0.1, 77)]


class Ring:
    """A streaming kernel's ring of `stages` stages in shared memory: tile
    t goes into stage t % stages.  `done(t)` marks the barrier after which
    every thread is done with tile t; a stage may be refilled only after
    the tile it holds is done with, and `use(t)` must find tile t."""

    def __init__(self, stages):
        self.slots = [None] * stages
        self.finished = -1

    def load(self, t, payload):
        held = self.slots[t % len(self.slots)]
        assert held is None or held[0] <= self.finished, f"tile {t} over tile {held[0]} in use"
        self.slots[t % len(self.slots)] = (t, payload)

    def use(self, t):
        tile, payload = self.slots[t % len(self.slots)]
        assert tile == t, f"step {t} finds tile {tile}"
        return payload

    def done(self, t):
        self.finished = t


def walk(ring, steps, load, ahead=None):
    """The kernels' loop: the copies of the first `ahead` tiles before it
    (stages - 1, the kernels' distance), then at the top of step t a
    barrier (every thread is done with step t - 1), the copies of step
    t + ahead, and step t's tile -> yields (t, that tile's payload)."""
    ahead = len(ring.slots) - 1 if ahead is None else ahead
    for t in range(min(ahead, steps)):
        ring.load(t, load(t))
    for t in range(steps):
        ring.done(t - 1)
        if t + ahead < steps:
            ring.load(t + ahead, load(t + ahead))
        yield t, ring.use(t)


def _scale_inv(rate):
    return 1.0 / math.sqrt(D), (tfa._inv_keep(rate) if rate > 0.0 else 1.0)


def _keep(seed, b, h, i0, j0, rate, transposed=False):
    return keep_tile(seed, b, h, i0, j0, TILE, rate, transposed) if rate > 0.0 else None


def elements(s, dpd, keep, rate):
    """p, the dropped p and the dropped dp of a tile from its scores (with
    the mask row and -lse already added) and g v^T."""
    p = torch.exp(s)
    if rate > 0.0:
        inv = _scale_inv(rate)[1]
        return p, torch.where(keep, p * inv, 0.0), torch.where(keep, dpd * inv, 0.0)
    return p, p, dpd


def padded_vector(x, r0, rows, fill):
    """Entries [r0, r0 + rows) of a per-query vector, `fill` past L."""
    out = torch.full((rows,), fill)
    take = max(min(x.shape[0] - r0, rows), 0)
    out[:take] = x[r0:r0 + take]
    return out


def emulate_forward_ring(q, k, v, mask, heads, rate, seed, nk=RING_KEYS):
    """The ring forward's blocks -> (out [B, L, H*D], lse [B, H, L])."""
    b_, l, _ = q.shape
    scale, inv = _scale_inv(rate)
    passes = -(-l // nk)
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b_, heads, l), float("nan"))
    for b in range(b_):
        for h in range(heads):
            qh, kh, vh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v))
            for q0 in range(0, l, TILE):
                q_tile = padded_rows(qh, q0, TILE)
                m = torch.full((TILE,), -INF)
                total, o = torch.zeros(TILE), torch.zeros(TILE, D)
                load = lambda t: (padded_rows(kh, t * nk, nk), padded_rows(vh, t * nk, nk),
                                  mask_row(mask[b], t * nk, nk))
                for t, (k_t, v_t, m_row) in walk(Ring(FWD_STAGES), passes, load):
                    s = q_tile @ k_t.T * scale + m_row
                    mx = torch.maximum(m, s.max(-1).values)  # finite: key 0 is < L
                    corr = torch.exp(m - mx)  # 0 in the first pass
                    p = torch.exp(s - mx[:, None])
                    total = total * corr + p.sum(-1)  # the sum takes the undropped p
                    if rate > 0.0:
                        p = torch.where(keep_tile(seed, b, h, q0, t * nk, nk, rate), p * inv, 0.0)
                    o = o * corr[:, None] + p @ v_t
                    m = mx
                rows = min(TILE, l - q0)  # rows >= L are not stored
                out[b, q0:q0 + rows, h * D:(h + 1) * D] = (o / total[:, None])[:rows]
                lse[b, h, q0:q0 + rows] = (m + torch.log(total))[:rows]
    return out, lse


def emulate_dq_launch(q, k, v, mask, g, lse, heads, rate, seed):
    """Launch 1's blocks -> (dq [B, L, H*D], row term [B, H, L]); the row
    term is NaN wherever no block wrote it."""
    b_, l, _ = q.shape
    scale = _scale_inv(rate)[0]
    tiles = -(-l // TILE)
    dq = torch.full_like(q, float("nan"))
    row_term = torch.full((b_, heads, l), float("nan"))
    for b in range(b_):
        for h in range(heads):
            qh, kh, vh, gh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v, g))
            for q0 in range(0, l, TILE):
                q_t, g_t = padded_rows(qh, q0, TILE), padded_rows(gh, q0, TILE)
                lse_t = padded_vector(lse[b, h], q0, TILE, INF)  # p = 0 for a query >= L
                key_tile = lambda t: (t if t < tiles else t - tiles) * TILE  # walks (a), (b)
                load = lambda t: (padded_rows(kh, key_tile(t), TILE),
                                  padded_rows(vh, key_tile(t), TILE),
                                  mask_row(mask[b], key_tile(t), TILE))
                term, acc = torch.zeros(TILE), torch.zeros(TILE, D)
                rows = min(TILE, l - q0)
                for t, (k_t, v_t, m_row) in walk(Ring(BWD_STAGES), 2 * tiles, load):
                    s = q_t @ k_t.T * scale + m_row - lse_t[:, None]
                    keep = _keep(seed, b, h, q0, key_tile(t), rate)
                    p, _, dp = elements(s, g_t @ v_t.T, keep, rate)
                    if t < tiles:  # walk (a)
                        term = term + (dp * p).sum(-1)
                        if t + 1 == tiles:
                            row_term[b, h, q0:q0 + rows] = term[:rows]
                    else:  # walk (b)
                        acc = acc + (p * (dp - term[:, None])) @ k_t
                dq[b, q0:q0 + rows, h * D:(h + 1) * D] = (acc * scale)[:rows]
    return dq, row_term


def emulate_dkdv_launch(q, k, v, mask, g, lse, row_term, heads, rate, seed):
    """Launch 2's blocks, reading launch 1's row term -> (dk, dv)."""
    b_, l, _ = q.shape
    scale = _scale_inv(rate)[0]
    tiles = -(-l // TILE)
    dk, dv = torch.full_like(q, float("nan")), torch.full_like(q, float("nan"))
    for b in range(b_):
        for h in range(heads):
            qh, kh, vh, gh = (x[b, :, h * D:(h + 1) * D] for x in (q, k, v, g))
            terms = row_term[b, h]
            assert not torch.isnan(terms).any()  # launch 1 wrote every query < L
            for j0 in range(0, l, TILE):
                k_t, v_t = padded_rows(kh, j0, TILE), padded_rows(vh, j0, TILE)
                mk = mask_row(mask[b], j0, TILE)  # the block's keys, -inf past L
                load = lambda t: (padded_rows(qh, t * TILE, TILE), padded_rows(gh, t * TILE, TILE),
                                  padded_vector(lse[b, h], t * TILE, TILE, INF),
                                  padded_vector(terms, t * TILE, TILE, 0.0))
                acc_k, acc_v = torch.zeros(TILE, D), torch.zeros(TILE, D)
                for t, (q_t, g_t, lse_v, term_v) in walk(Ring(BWD_STAGES), tiles, load):
                    # rows are keys, columns queries
                    s_t = k_t @ q_t.T * scale + mk[:, None] - lse_v[None, :]
                    keep_t = _keep(seed, b, h, t * TILE, j0, rate, transposed=True)
                    p, pd, dp = elements(s_t, v_t @ g_t.T, keep_t, rate)
                    acc_v = acc_v + pd @ g_t
                    acc_k = acc_k + (p * (dp - term_v[None, :])) @ q_t
                rows = min(TILE, l - j0)
                dk[b, j0:j0 + rows, h * D:(h + 1) * D] = (acc_k * scale)[:rows]
                dv[b, j0:j0 + rows, h * D:(h + 1) * D] = acc_v[:rows]
    return dk, dv


def _reference_row_term(q, k, v, mask, g, heads, rate, seed):
    """rowsum(dp * p) of the plain backward's arithmetic, [B, H, L]."""
    b, l, _ = q.shape
    qh, kh, vh, gh = (tfa.split_heads(t, heads) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bnqd,bnkd->bnqk", qh, kh) / math.sqrt(D)
                      + mask[:, None, None, :], dim=-1)
    dp = torch.einsum("bnqd,bnkd->bnqk", gh, vh)
    if rate > 0.0:
        dp = torch.where(tfa._keep_mask(seed, b, heads, l, rate, q.device),
                         dp * tfa._inv_keep(rate), 0.0)
    return (dp * p).sum(-1)


@pytest.mark.parametrize("rate,seed", RATES)
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("l", LENGTHS)
def test_ring_forward_emulation_matches_references(rng, l, mask_kind, rate, seed):
    heads = 2
    q, k, v, mask, _ = _inputs(rng, l, MASKS[mask_kind], heads=heads)
    got, lse = emulate_forward_ring(q, k, v, mask, heads, rate, seed)
    assert not torch.isnan(got).any() and not torch.isnan(lse).any()  # all written
    want = tfa.attention_reference(q, k, v, mask, heads, rate, seed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    scores = torch.einsum("bnqd,bnkd->bnqk", tfa.split_heads(q, heads),
                          tfa.split_heads(k, heads)) / math.sqrt(D) + mask[:, None, None, :]
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(scores, -1).numpy(),
                               rtol=0, atol=1e-4)
    if rate == 0.0:
        np.testing.assert_allclose(got.numpy(), _jax_forward(q, k, v, mask, heads),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate,seed", RATES)
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("l", LENGTHS)
def test_streamed_backward_emulation_matches_references(rng, l, mask_kind, rate, seed):
    heads = 2
    q, k, v, mask, g = _inputs(rng, l, MASKS[mask_kind], heads=heads)
    lse = emulate_forward_ring(q, k, v, mask, heads, rate, seed)[1]
    dq, row_term = emulate_dq_launch(q, k, v, mask, g, lse, heads, rate, seed)
    np.testing.assert_allclose(
        row_term.numpy(), _reference_row_term(q, k, v, mask, g, heads, rate, seed).numpy(),
        rtol=0, atol=1e-5)
    got = (dq, *emulate_dkdv_launch(q, k, v, mask, g, lse, row_term, heads, rate, seed))
    want = tfa.attention_backward_reference(q, k, v, mask, g, heads, rate, seed)
    want_jax = None
    if rate == 0.0:
        _, vjp = jax.vjp(lambda *x: jfa.fused_self_attention(
            *x, jnp.asarray(mask.numpy()), jnp.zeros((1,), jnp.int32), heads, 0.0, True),
            *(jnp.asarray(x.numpy()) for x in (q, k, v)))
        want_jax = [np.asarray(x) for x in vjp(jnp.asarray(g.numpy()))]
    for n, (name, x, w) in enumerate(zip("qkv", got, want)):
        assert not torch.isnan(x).any(), name
        np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=name)
        if want_jax is not None:
            np.testing.assert_allclose(x.numpy(), want_jax[n], rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("length", LENGTHS + [514])
def test_long_rows_run_on_the_tensor_cores_both_ways(length):
    """Past the one-launch limit bf16 at head width 64 stays "wgmma" both
    ways, f32 at head width 64 "tf32x3"; head width 32 stays "simt"."""
    assert length > tfa.WGMMA_BWD_ONE_LAUNCH_LEN
    for backward in (False, True):
        assert tfa.attention_variant(BF16, D, length, backward) == "wgmma"
        assert tfa.attention_variant(torch.float32, D, length, backward) == "tf32x3"
        assert tfa.attention_variant(BF16, 32, length, backward) == "simt"


@pytest.mark.parametrize("length,passes", [(193, 4), (255, 4), (256, 4), (257, 5), (300, 5),
                                           (514, 9)])
def test_ring_forward_walks_unpadded_passes(length, passes):
    """The ring's passes of `kRingKeys` keys: 256 rows are walked as 4 x 64
    keys (the held 192-key kernel would walk 384), never a whole pass of
    padding, and the source's entry point sends every L past 192 there."""
    assert RING_KEYS == 64
    assert -(-length // RING_KEYS) == passes
    assert passes * RING_KEYS - length < RING_KEYS
    assert re.search(r"if \(L <= 192\) return launch_fwd<192>.*\n"
                     r"\s*return launch_fwd_ring<kRingKeys>", SOURCE)


@pytest.mark.parametrize("stages,ahead,ok", [
    (FWD_STAGES, None, True), (BWD_STAGES, None, True), (2, 1, True), (3, 2, True),
    (1, 1, False), (2, 2, False), (3, 3, False)])
def test_ring_refills_a_stage_only_when_its_tile_is_done(stages, ahead, ok):
    """The kernels' loop with the copies of tile t + ahead issued before
    tile t is computed: `ahead` must stay under the stage count, or a copy
    lands on the tile in use (the kernels use stages - 1)."""
    assert FWD_STAGES >= 2 and BWD_STAGES >= 2  # cp.async.wait_group<stages - 2>
    steps = walk(Ring(stages), 6, lambda t: t, ahead)
    if ok:
        assert [payload for _, payload in steps] == list(range(6))
    else:
        with pytest.raises(AssertionError, match="in use"):
            list(steps)


@pytest.mark.parametrize("l", [193, 256])
def test_dq_launch_walks_each_key_tile_twice(l):
    """Launch 1's ring order: key tiles 0..n-1 for walk (a), then 0..n-1
    again for walk (b), and its row term reaches launch 2 whole."""
    tiles = -(-l // TILE)
    order = []
    list(walk(Ring(BWD_STAGES), 2 * tiles,
              lambda t: order.append(t if t < tiles else t - tiles)))
    assert order == list(range(tiles)) * 2
    q, k, v, g = (torch.zeros(1, l, D) for _ in range(4))
    mask = torch.zeros(1, l)
    _, row_term = emulate_dq_launch(q, k, v, mask, g, torch.zeros(1, 1, l), 1, 0.0, 0)
    assert not torch.isnan(row_term).any()
