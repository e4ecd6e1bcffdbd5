"""The plain reference of the benchmark: the FCMF classifier, the Phase-1
seq2seq and ResNet-152, in plain PyTorch and float32.

It follows the port's model code (`macsa_tpu_torch/models/`) operation
for operation, so that one state dict, made by the benchmark from the
seed, loads into both, and it draws the same dropout masks from the same
seed: the same `numpy.random.SeedSequence` derivation of one device and one
host generator per step, the same draws in the same order, and the same
keyed 32-bit hash for the masks of the text encoder's attention.  Where
the port launches a hand-written kernel (attention forward and backward,
box attention, pixel unpacking), this file computes the same function with
plain `torch` operations and lets autograd differentiate it.

Departures from the port, each deliberate:
* every product and every activation is float32 (the configuration's
  bf16 compute is the program's; the reference is the f32 ideal),
* no tensor parallelism, no MDE (`use_mde` is off in both
  configurations), no decode loop (the benchmark trains the seq2seq with
  teacher forcing only),
* `lowp`, when given, rounds to a lower precision where the program's
  compute dtype rounds: the operands of every matrix product, every dense
  layer's output and every LayerNorm's output (the control of
  `port_bench/reference/control.py`).

It imports nothing of the port, of JAX or of the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Lowp = Optional[Callable[[torch.Tensor], torch.Tensor]]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _lp(lowp: Lowp, *ts):
    return ts if lowp is None else tuple(lowp(t) for t in ts)


# ---------------------------------------------------------------------------
# dropout: the step's generators and the attention mask's hash
# ---------------------------------------------------------------------------

class StepRng:
    """One training step's dropout randomness, derived from (seed, step):
    a generator on the activations' device for the elementwise masks and a
    host generator for the seed of each text-encoder attention call."""

    def __init__(self, seed: int, step: int, device):
        dev_seed, host_seed = np.random.SeedSequence([seed, step]).generate_state(2)
        self.device = torch.Generator(torch.device(device)).manual_seed(int(dev_seed))
        self.host = torch.Generator().manual_seed(int(host_seed))

    def keep_mask(self, shape, rate: float, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.device, device=device) >= rate

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hashed_keep(seed: int, b: int, n: int, l: int, rate: float, device) -> torch.Tensor:
    """[b, n, l, l] keep mask of one attention call:
    mix(mix(mix(mix(mix(seed) ^ b) ^ h) ^ i) ^ j) >= round(rate * 2^32)."""
    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32

    ar = lambda m: torch.arange(m, device=device, dtype=torch.int64)
    row = _mix32(u32(seed))
    for coord in (ar(b)[:, None, None, None], ar(n)[None, :, None, None], ar(l)[:, None]):
        row = _mix32(row ^ coord)
    bits = _mix32(row ^ ar(l))
    return bits >= min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def dropout(x: torch.Tensor, rate: float, rng: Optional[StepRng]) -> torch.Tensor:
    if rng is None or rate == 0.0:
        return x
    return torch.where(rng.keep_mask(x.shape, rate, x.device), x / (1.0 - rate), 0.0)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, lowp: Lowp = None):
        super().__init__()
        self.lowp = lowp
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out))

    def forward(self, x):
        x, w = _lp(self.lowp, x, self.weight)
        return _lp(self.lowp, F.linear(x, w, self.bias))[0]


class LayerNorm(nn.Module):
    """Epsilon inside the square root, f32 statistics."""

    def __init__(self, dim: int, eps: float, lowp: Lowp = None):
        super().__init__()
        self.eps, self.lowp = eps, lowp
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return _lp(self.lowp, y)[0]


def split_heads(x, n):
    b, l, h = x.shape
    return x.reshape(b, l, n, h // n).transpose(1, 2)


def merge_heads(x):
    b, n, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, n * d)


def attention_core(q, k, v, additive_mask, keep, rate, lowp: Lowp):
    q, k = _lp(lowp, q, k)
    scores = torch.einsum("bnqd,bnkd->bnqk", q, k) / math.sqrt(q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs * float(np.float32(1.0 / (1.0 - rate))), 0.0)
    probs, v = _lp(lowp, probs, v)
    return torch.einsum("bnqk,bnkd->bnqd", probs, v)


class SelfAttention(nn.Module):
    """Projections + core.  Self-attention of at least 32 rows under a
    [B, 1, 1, L] padding mask (the text encoder) takes its dropout mask
    from the hash, keyed by a host draw; every other call site draws its
    mask from the device generator."""

    def __init__(self, h: int, heads: int, rate: float, lowp: Lowp):
        super().__init__()
        self.heads, self.rate, self.lowp = heads, rate, lowp
        self.query, self.key, self.value = (Dense(h, h, lowp) for _ in range(3))

    def forward(self, q_states, kv_states, additive_mask, rng):
        rng = rng if self.training else None
        rate = 0.0 if rng is None else self.rate
        qr, kr, vr = self.query(q_states), self.key(kv_states), self.value(kv_states)
        n = self.heads
        keep = None
        hashed = (additive_mask is not None and additive_mask.dim() == 4
                  and additive_mask.shape[1] == 1 and additive_mask.shape[2] == 1
                  and qr.shape[1] == kr.shape[1] and qr.shape[1] >= 32)
        if hashed:
            if rate > 0.0:
                keep = hashed_keep(rng.kernel_seed(), qr.shape[0], n, qr.shape[1], rate,
                                   qr.device)
            mask = additive_mask[:, 0, 0, :].float()[:, None, None, :]
        else:
            if rate > 0.0:
                keep = rng.keep_mask((qr.shape[0], n, qr.shape[1], kr.shape[1]), rate,
                                     qr.device)
            mask = additive_mask
        ctx = attention_core(split_heads(qr, n), split_heads(kr, n), split_heads(vr, n),
                             mask, keep, rate, self.lowp)
        return merge_heads(ctx)


class SelfOutput(nn.Module):
    def __init__(self, h, eps, rate, lowp):
        super().__init__()
        self.rate = rate
        self.dense = Dense(h, h, lowp)
        self.LayerNorm = LayerNorm(h, eps, lowp)

    def forward(self, hidden, residual, rng):
        h = dropout(self.dense(hidden), self.rate, rng if self.training else None)
        return self.LayerNorm(h + residual)


class Attention(nn.Module):
    def __init__(self, c, lowp):
        super().__init__()
        self.self = SelfAttention(c["hidden_size"], c["num_attention_heads"],
                                  c["attention_probs_dropout_prob"], lowp)
        self.output = SelfOutput(c["hidden_size"], c["layer_norm_eps"],
                                 c["hidden_dropout_prob"], lowp)

    def forward(self, s1, s2, mask, rng):
        return self.output(self.self(s1, s2, mask, rng), s1, rng)


class Layer(nn.Module):
    """Attention (self, or cross when `s2` differs) + FFN, HF names."""

    def __init__(self, c, lowp):
        super().__init__()
        h, i = c["hidden_size"], c["intermediate_size"]
        self.rate = c["hidden_dropout_prob"]
        self.attention = Attention(c, lowp)
        self.intermediate = nn.ModuleDict({"dense": Dense(h, i, lowp)})
        self.output = nn.ModuleDict({"dense": Dense(i, h, lowp),
                                     "LayerNorm": LayerNorm(h, c["layer_norm_eps"], lowp)})

    def forward(self, s1, s2, mask, rng):
        x = self.attention(s1, s2, mask, rng)
        h = self.output["dense"](F.gelu(self.intermediate["dense"](x)))
        h = dropout(h, self.rate, rng if self.training else None)
        return self.output["LayerNorm"](h + x)


class Stack1(nn.Module):
    """One layer held as `layer.0` (the checkpoints' names)."""

    def __init__(self, c, lowp):
        super().__init__()
        self.layer = nn.ModuleList([Layer(c, lowp)])

    def forward(self, s1, s2, mask, rng):
        return self.layer[0](s1, s2, mask, rng)


class Pooler(nn.Module):
    def __init__(self, h, lowp):
        super().__init__()
        self.dense = Dense(h, h, lowp)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


def extend_mask(mask):
    return (1.0 - mask[:, None, None, :].float()) * -10000.0


# ---------------------------------------------------------------------------
# text encoder and FCMF
# ---------------------------------------------------------------------------

class TextEncoder(nn.Module):
    def __init__(self, t, lowp, table: Optional[nn.Parameter] = None):
        super().__init__()
        self.t = t
        h = t["hidden_size"]
        c = dict(t)
        self.embeddings = nn.Module()
        e = self.embeddings
        e.word_embeddings = nn.Module()
        e.word_embeddings.weight = (nn.Parameter(torch.empty(t["vocab_size"], h))
                                    if table is None else table)
        e.position_embeddings = nn.Module()
        e.position_embeddings.weight = nn.Parameter(torch.empty(t["max_position_embeddings"], h))
        e.token_type_embeddings = nn.Module()
        e.token_type_embeddings.weight = nn.Parameter(torch.empty(t["type_vocab_size"], h))
        e.LayerNorm = LayerNorm(h, t["layer_norm_eps"], lowp)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            Layer(c, lowp) for _ in range(t["num_hidden_layers"]))})
        self.pooler = Pooler(h, lowp)

    def forward(self, ids, types, attention_mask, rng):
        e, t = self.embeddings, self.t
        m = (ids != t["pad_token_id"]).long()
        pos = torch.cumsum(m, 1) * m + t["pad_token_id"]
        h = (F.embedding(ids, e.word_embeddings.weight) + F.embedding(pos, e.position_embeddings.weight)
             + F.embedding(types, e.token_type_embeddings.weight))
        h = dropout(e.LayerNorm(h), t["hidden_dropout_prob"], rng if self.training else None)
        ext = (1.0 - attention_mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
        for layer in self.encoder["layer"]:
            h = layer(h, h, ext, rng)
        return h, self.pooler(h)


GEO_DIM = 64


def box_embedding(boxes):
    x_min, x_max, y_min, y_max = boxes.float().split(1, dim=-1)
    cx, cy = (x_min + x_max) * 0.5, (y_min + y_max) * 0.5
    w, h = (x_max - x_min) + 1.0, (y_max - y_min) + 1.0
    dx = torch.log(torch.clamp(torch.abs((cx - cx.transpose(1, 2)) / w), min=1e-3))
    dy = torch.log(torch.clamp(torch.abs((cy - cy.transpose(1, 2)) / h), min=1e-3))
    dw, dh = torch.log(w / w.transpose(1, 2)), torch.log(h / h.transpose(1, 2))
    pos = torch.stack([dx, dy, dw, dh], dim=-1)
    n_freq = GEO_DIM // 8
    dim_mat = 1.0 / torch.pow(1000.0, torch.arange(n_freq, dtype=torch.float32,
                                                   device=boxes.device) / n_freq)
    mul = ((100.0 * pos)[..., None] * dim_mat).reshape(*pos.shape[:3], 4 * n_freq)
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)


class BoxAttention(nn.Module):
    def __init__(self, heads, d, rate, lowp):
        super().__init__()
        self.heads, self.d, self.rate, self.lowp = heads, d, rate, lowp
        self.linears = nn.ModuleList(Dense(d, d, lowp) for _ in range(4))
        self.WGs = nn.ModuleList(Dense(GEO_DIM, 1, lowp) for _ in range(heads))

    def forward(self, x, boxes, rng):
        h, dk = self.heads, self.d // self.heads
        geo = box_embedding(boxes)

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, dk).transpose(1, 2)

        q, k, v = (heads(self.linears[i](x)) for i in range(3))
        wg_w = torch.cat([g.weight for g in self.WGs])
        wg_b = torch.cat([g.bias for g in self.WGs])
        geo_l, wg_l = _lp(self.lowp, geo, wg_w)
        w_g = F.relu(F.linear(geo_l, wg_l, wg_b)).permute(0, 3, 1, 2)
        ql, kl = _lp(self.lowp, q, k)
        scores = torch.einsum("bhqd,bhkd->bhqk", ql, kl) / math.sqrt(dk)
        scores = scores + torch.log(torch.clamp(w_g, min=1e-6))
        probs = dropout(torch.softmax(scores, -1), self.rate, rng if self.training else None)
        pl, vl = _lp(self.lowp, probs, v)
        out = torch.einsum("bhqk,bhkd->bhqd", pl, vl)
        b, _, n, _ = out.shape
        return self.linears[3](out.transpose(1, 2).reshape(b, n, self.d))


class FCMFEncoder(nn.Module):
    def __init__(self, cfg, lowp, table=None):
        super().__init__()
        m, t = cfg["model"], cfg["text"]
        self.cfg = cfg
        h = m["hidden_size"]
        self.bert = nn.Module()
        self.bert.cell = TextEncoder(t, lowp, table)
        self.vismap2text = Dense(cfg["visual_feat_dim"], h, lowp)
        self.roimap2text = Dense(cfg["visual_feat_dim"], h, lowp)
        self.box_head = BoxAttention(cfg["box_heads"], h, m["attention_probs_dropout_prob"], lowp)
        self.text2img_attention = Stack1(m, lowp)
        self.text2img_pooler = Pooler(h, lowp)
        self.text2roi_pooler = Pooler(h, lowp)
        self.mm_attention = Stack1(m, lowp)

    def forward(self, ids, grid, roi, coors, types, attention_mask, added_mask, rng):
        cfg = self.cfg
        b, ni = grid.shape[:2]
        seq, _ = self.bert.cell(ids, types, attention_mask, rng)
        seq_len = seq.shape[1]
        text_rep = seq.repeat_interleave(ni, dim=0)
        img = self.vismap2text(grid.reshape((-1,) + tuple(grid.shape[2:])))
        img_mask = added_mask[:, :cfg["num_patches"]].repeat_interleave(ni, 0)
        t2i = self.text2img_attention(text_rep[:, :1], img, extend_mask(img_mask), rng)
        all_h = self.text2img_pooler(t2i).reshape(b, ni, -1)
        t2r_mask = extend_mask(added_mask[:, :seq_len + cfg["num_roi"]].repeat_interleave(ni, 0))
        conv_roi = self.roimap2text(roi.reshape((-1,) + tuple(roi.shape[2:])))
        rel = self.box_head(conv_roi, coors.reshape((-1,) + tuple(coors.shape[2:])), rng)
        text_roi = torch.cat([text_rep, rel], dim=1)
        roi_enc = self.mm_attention(text_roi[:, :1], text_roi, t2r_mask, rng)
        all_r = self.text2roi_pooler(roi_enc).reshape(b, ni, -1)
        fusion = torch.cat([seq[:, :1], all_h, all_r], dim=1)
        comb = extend_mask(added_mask[:, :1 + 2 * ni])
        return self.mm_attention(fusion, fusion, comb, rng)


class FCMF(nn.Module):
    """Phase-2 classifier: encoder -> first-token pool -> dropout -> Dense."""

    def __init__(self, cfg, lowp: Lowp = None):
        super().__init__()
        self.cfg = cfg
        h = cfg["model"]["hidden_size"]
        self.encoder = FCMFEncoder(cfg, lowp)
        self.text_pooler = Pooler(h, lowp)
        self.classifier = Dense(h, cfg["num_labels"], lowp)

    def forward(self, ids, grid, roi, coors, types, attention_mask, added_mask, rng=None):
        fused = self.encoder(ids, grid, roi, coors, types, attention_mask, added_mask, rng)
        cls = dropout(self.text_pooler(fused), self.cfg["model"]["hidden_dropout_prob"],
                      rng if self.training else None)
        return self.classifier(cls)


def fcmf_all_aspects(model: FCMF, batch: dict, grid, roi, rng=None):
    """[B, A, ...] views folded into B*A rows, the visual rows repeated to
    match (b*A + a) -> logits [B, A, labels]."""
    b, a = batch["input_ids"].shape[:2]
    fold = {k: batch[k].reshape((b * a,) + tuple(batch[k].shape[2:])).long()
            for k in ("input_ids", "token_type_ids", "attention_mask", "added_mask")}
    rep = lambda x: x.repeat_interleave(a, dim=0)
    logits = model(fold["input_ids"], rep(grid), rep(roi), rep(batch["roi_coors"].float()),
                   fold["token_type_ids"], fold["attention_mask"], fold["added_mask"], rng)
    return logits.reshape(b, a, -1)


def aspect_loss(logits, labels):
    """Per-aspect mean CE over the batch, summed over the aspects."""
    ce = F.cross_entropy(logits.flatten(0, 1), labels.long().flatten(),
                         reduction="none").reshape(labels.shape)
    return ce.mean(0).sum()


# ---------------------------------------------------------------------------
# Phase-1 decoder and seq2seq
# ---------------------------------------------------------------------------

class PerHeadAttention(nn.Module):
    """Per-head projections w_kx, w_qx [n, E, d]; the value stream is the
    key projection; masked scores are filled with -1e4."""

    def __init__(self, e, d, n, lowp):
        super().__init__()
        self.d, self.n, self.lowp = d, n, lowp
        self.w_kx = nn.Parameter(torch.empty(n, e, d))
        self.w_qx = nn.Parameter(torch.empty(n, e, d))
        self.proj = Dense(n * d, e, lowp)

    def forward(self, k, q):
        kl, wk, ql, wq = _lp(self.lowp, k, self.w_kx, q, self.w_qx)
        kx = torch.einsum("ble,hed->bhld", kl, wk)
        qx = torch.einsum("ble,hed->bhld", ql, wq)
        qxl, kxl = _lp(self.lowp, qx, kx)
        score = torch.einsum("bhqd,bhkd->bhqk", qxl, kxl) / math.sqrt(self.d)
        lq, lk = score.shape[2], score.shape[3]
        tri = torch.ones(lq, lk, dtype=torch.bool, device=score.device).tril()
        probs = torch.softmax(torch.where(tri, score, -1e4), dim=-1)
        pl, vl = _lp(self.lowp, probs, kx)
        out = torch.einsum("bhqk,bhkd->bhqd", pl, vl)
        return self.proj(out.transpose(1, 2).reshape(out.shape[0], lq, self.n * self.d))


class AddNorm(nn.Module):
    def __init__(self, h, rate, lowp):
        super().__init__()
        self.rate = rate
        self.ln = LayerNorm(h, 1e-12, lowp)

    def forward(self, x, y, rng):
        return self.ln(dropout(y, self.rate, rng if self.training else None) + x)


class DecoderBlock(nn.Module):
    """Causal self-attention, cross-attention under the reference's causal
    tril over the encoder positions, FFN."""

    def __init__(self, dc, lowp):
        super().__init__()
        h, n = dc["hidden_size"], dc["num_heads"]
        self.attention1 = PerHeadAttention(h, h // n, n, lowp)
        self.addnorm1 = AddNorm(h, dc["dropout"], lowp)
        self.attention2 = PerHeadAttention(h, h // n, n, lowp)
        self.addnorm2 = AddNorm(h, dc["dropout"], lowp)
        self.ffn = nn.Module()
        self.ffn.dense1 = Dense(h, dc["ffn_hidden"], lowp)
        self.ffn.dense2 = Dense(dc["ffn_hidden"], h, lowp)
        self.add_norm3 = AddNorm(h, dc["dropout"], lowp)

    def forward(self, x, enc, rng):
        y = self.addnorm1(x, self.attention1(x, x), rng)
        z = self.addnorm2(y, self.attention2(enc, y), rng)
        return self.add_norm3(z, self.ffn.dense2(F.gelu(self.ffn.dense1(z))), rng)


def sinusoidal_positions(max_len, dim, device=None):
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    inv = torch.pow(10000.0, torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    p = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    p[:, 0::2], p[:, 1::2] = torch.sin(pos / inv), torch.cos(pos / inv)
    return p


class Seq2Seq(nn.Module):
    """FCMF encoder + decoder, one token table tied three ways."""

    def __init__(self, cfg, dc, lowp: Lowp = None):
        super().__init__()
        self.cfg, self.dc, self.lowp = cfg, dc, lowp
        h = cfg["model"]["hidden_size"]
        table = nn.Parameter(torch.empty(dc["vocab_size"], h))
        self.encoder = FCMFEncoder(cfg, lowp, table)
        self.decoder = nn.Module()
        d = self.decoder
        d.embedding = nn.Module()
        d.embedding.weight = table
        d.blks = nn.ModuleDict({f"block{i}": DecoderBlock(dc, lowp)
                                for i in range(dc["num_blocks"])})
        d.dense = nn.Module()
        d.dense.weight = table
        d.dense.bias = nn.Parameter(torch.empty(dc["vocab_size"]))

    def forward(self, batch, grid, roi, rng=None):
        ids = batch["enc_input_ids"].long()
        enc = self.encoder(ids, grid, roi, batch["roi_coors"].float(),
                           batch["token_type_ids"].long(), batch["attention_mask"].long(),
                           batch["added_mask"].long(), rng)
        d, dc = self.decoder, self.dc
        tok = batch["dec_input_ids"].long()
        x = F.embedding(tok, d.embedding.weight) * math.sqrt(dc["hidden_size"])
        x = x + sinusoidal_positions(dc["max_position_embeddings"], dc["hidden_size"],
                                     x.device)[:tok.shape[1]][None]
        x = dropout(x, dc["dropout"], rng if self.training else None)
        for blk in d.blks.values():
            x = blk(x, enc, rng)
        xl, wl = _lp(self.lowp, x, d.dense.weight)
        return xl @ wl.T + d.dense.bias


def seq2seq_loss(logits, labels):
    """CE over the valid tokens (label -100 ignored), their mean."""
    valid = labels != -100
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# ResNet-152 with frozen BatchNorm, and the pixels in front of it
# ---------------------------------------------------------------------------

class FrozenBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5)
        mul, add = self.weight * inv, self.bias - self.running_mean * self.weight * inv
        return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, lowp: Lowp = None):
        super().__init__()
        self.stride, self.pad, self.lowp = stride, k // 2, lowp
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        x, w = _lp(self.lowp, x, self.weight)
        return F.conv2d(x, w, stride=self.stride, padding=self.pad)


class Bottleneck(nn.Module):
    def __init__(self, cin, f, stride, down, lowp):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, f, 1, lowp=lowp), FrozenBN(f)
        self.conv2, self.bn2 = Conv(f, f, 3, stride, lowp), FrozenBN(f)
        self.conv3, self.bn3 = Conv(f, 4 * f, 1, lowp=lowp), FrozenBN(4 * f)
        self.downsample = (nn.Sequential(Conv(cin, 4 * f, 1, stride, lowp), FrozenBN(4 * f))
                           if down else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    """torchvision names up to layer4; grid (7x7) and pooled features."""

    def __init__(self, stages=(3, 8, 36, 3), nf=64, lowp: Lowp = None):
        super().__init__()
        self.conv1, self.bn1 = Conv(3, nf, 7, 2, lowp), FrozenBN(nf)
        cin = nf
        self.n = len(stages)
        for s, blocks in enumerate(stages):
            f = nf * 2 ** s
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(cin, f, 2 if (s > 0 and i == 0) else 1, i == 0, lowp))
                cin = 4 * f
            self.add_module(f"layer{s + 1}", nn.Sequential(*mods))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
        for s in range(self.n):
            x = getattr(self, f"layer{s + 1}")(x)
        return x

    def features(self, frames: torch.Tensor, pooled: bool) -> torch.Tensor:
        """frames [..., H, W, 3] normalized f32 -> [..., 49, C] or [..., C]."""
        lead = tuple(frames.shape[:-3])
        feat = self(frames.reshape((-1,) + tuple(frames.shape[-3:])).permute(0, 3, 1, 2))
        feat = feat.permute(0, 2, 3, 1)
        if pooled:
            return feat.mean(dim=(1, 2)).reshape(lead + (feat.shape[-1],))
        n, h, w, c = feat.shape
        if (h, w) != (7, 7):
            feat = feat.reshape(n, 7, h // 7, 7, w // 7, c).mean(dim=(2, 4))
        return feat.reshape(lead + (49, c))


def unpack_frames(words: torch.Tensor, size: int) -> torch.Tensor:
    """Packed int32 frames [..., 1 + S*S*3/4] -> normalized f32 [..., S, S, 3]:
    (x / 255 - mean[c]) / std[c] for a frame whose first word is nonzero,
    exact zeros for one whose first word is 0."""
    valid = words[..., 0] != 0
    pix = words[..., 1:].contiguous().view(torch.uint8).reshape(
        tuple(words.shape[:-1]) + (size, size, 3)).float()
    mean = torch.tensor(IMAGENET_MEAN, device=words.device)
    std = torch.tensor(IMAGENET_STD, device=words.device)
    y = (pix / 255.0 - mean) / std
    return torch.where(valid[..., None, None, None], y, 0.0)
