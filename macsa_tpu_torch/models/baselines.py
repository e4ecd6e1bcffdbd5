"""The paper's baseline architectures in PyTorch: mRoBERTa, TomBERT and
EF-CapTrRoBERTa.

Counterpart of `macsa_tpu/models/baselines.py` (reference:
mROBERTa/train_mroberta_vimacsa_full.py:191-288,
tomROBERTa/train_tomroberta_vimacsa_full.py:187-257,
EF-CapTrRoBERTa/train_ef_captr_roberta.py:121-134):
* mRoBERTa: text encoder -> visual projections -> one cross-attention (text
  queries all I x 49 patches + I x R ROIs, no mask over empty image slots)
  with residual + LN -> 3 post-LN transformer encoder layers under the text
  mask -> CLS classifier,
* TomBERT: one text encoder called twice (target, then sentence), Target-Image
  Matching block(s), one multimodal encoder layer over [target-CLS |
  sentence], a classifier over the first two tokens (2H -> 4),
* EF-CapTrRoBERTa: a text-only classifier over caption-augmented input.

`roberta` is the port's `TextEncoder` (HF RoBERTa names), so its
self-attention runs through kernel K1 where `fused_attention` is on and the
rows are 32 or more (TomBERT's 16-token target stays plain, as in JAX).
Everything else carries the JAX tree's names (`cross_attention.q_proj.weight`,
`mm_layer_0.norm1.weight`, ...).  `MHA` is torch `nn.MultiheadAttention`'s
math through the plain `attention_core`, with its key-padding mask adding
`finfo(float32).min`; its LayerNorms are `LayerNormTF` at eps 1e-5, as in
JAX, so the no-decay rule of `train/optim.py` exempts their weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from macsa_tpu_torch.config import TextEncoderConfig
from macsa_tpu_torch.models.layers import (Dense, DropoutRng, LayerNormTF, dropout,
                                           gelu_erf)
from macsa_tpu_torch.models.text_encoder import TextEncoder
from macsa_tpu_torch.ops.fused_attention import attention_core, merge_heads, split_heads

BASELINE_NAMES = ("mroberta", "tomroberta", "efcap")


class MHA(nn.Module):
    """torch `nn.MultiheadAttention` with separate q/k/v/out projections.
    `key_padding_mask` [B, Lk] is 1 where a key is kept."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(hidden_size, hidden_size, compute_dtype, device=device))

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        n = self.num_heads
        q = split_heads(self.q_proj(query), n)
        k = split_heads(self.k_proj(key), n)
        v = split_heads(self.v_proj(value), n)
        mask = None
        if key_padding_mask is not None:
            mask = ((1.0 - key_padding_mask[:, None, None, :].float())
                    * torch.finfo(torch.float32).min)
        rng = rng if self.training else None
        rate = 0.0 if rng is None else self.dropout_rate
        keep = (rng.keep_mask((q.shape[0], n, q.shape[2], k.shape[2]), rate, q.device)
                if rate > 0.0 else None)
        return self.out_proj(merge_heads(attention_core(q, k, v, mask, keep, rate)))


class TorchEncoderLayer(nn.Module):
    """torch `nn.TransformerEncoderLayer`: post-LN, GELU, LN eps 1e-5."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int,
                 dropout_rate: float = 0.1, compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        dt = compute_dtype
        self.dropout_rate = dropout_rate
        self.self_attn = MHA(hidden_size, num_heads, dropout_rate, dt, device=device)
        self.norm1 = LayerNormTF(hidden_size, 1e-5, dt, device=device)
        self.linear1 = Dense(hidden_size, ffn_size, dt, device=device)
        self.linear2 = Dense(ffn_size, hidden_size, dt, device=device)
        self.norm2 = LayerNormTF(hidden_size, 1e-5, dt, device=device)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rng = rng if self.training else None
        rate = self.dropout_rate
        attn = dropout(self.self_attn(x, x, x, key_padding_mask, rng), rate, rng)
        x = self.norm1(x + attn)
        h = dropout(gelu_erf(self.linear1(x)), rate, rng)
        h = dropout(self.linear2(h), rate, rng)
        return self.norm2(x + h)


def _visual_tokens(model, visual_embeds_att: torch.Tensor,
                   roi_embeds_att: torch.Tensor) -> torch.Tensor:
    """[B, I, P, F] patches and [B, I, R, F] ROIs -> [B, I*P + I*R, H]."""
    b, dt = visual_embeds_att.shape[0], model.config.torch_dtype
    vis = visual_embeds_att.reshape(b, -1, model.visual_feat_dim).to(dt)
    roi = roi_embeds_att.reshape(b, -1, model.visual_feat_dim).to(dt)
    return torch.cat([model.vis_projection(vis), model.roi_projection(roi)], dim=1)


class _VisualBaseline(nn.Module):
    """The text encoder and the two visual projections mRoBERTa and TomBERT share."""

    def __init__(self, config: TextEncoderConfig, num_labels: int, visual_feat_dim: int,
                 device=None):
        super().__init__()
        self.config, self.num_labels, self.visual_feat_dim = config, num_labels, visual_feat_dim
        h, dt = config.hidden_size, config.torch_dtype
        self.roberta = TextEncoder(config, device=device)
        self.vis_projection = Dense(visual_feat_dim, h, dt, device=device)
        self.roi_projection = Dense(visual_feat_dim, h, dt, device=device)

    def _mm_layers(self, count: int, device) -> None:
        cfg = self.config
        for i in range(count):
            self.add_module(f"mm_layer_{i}", TorchEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
                cfg.hidden_dropout_prob, cfg.torch_dtype, device=device))


class MRoBERTa(_VisualBaseline):
    """mRoBERTa (Yu & Jiang 2019 adaptation)."""

    def __init__(self, config: TextEncoderConfig, num_labels: int = 4,
                 num_mm_layers: int = 3, visual_feat_dim: int = 2048, device=None):
        super().__init__(config, num_labels, visual_feat_dim, device=device)
        h, dt = config.hidden_size, config.torch_dtype
        self.num_mm_layers = num_mm_layers
        self.cross_attention = MHA(h, config.num_attention_heads,
                                   config.attention_probs_dropout_prob, dt, device=device)
        self.norm_cross = LayerNormTF(h, 1e-5, dt, device=device)
        self._mm_layers(num_mm_layers, device)
        self.classifier = Dense(h, num_labels, torch.float32, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                visual_embeds_att: torch.Tensor, roi_embeds_att: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rng = rng if self.training else None
        text, _ = self.roberta(input_ids, None, attention_mask, rng)
        visual = _visual_tokens(self, visual_embeds_att, roi_embeds_att)
        fused = self.norm_cross(text + self.cross_attention(text, visual, visual, None, rng))
        for i in range(self.num_mm_layers):
            fused = getattr(self, f"mm_layer_{i}")(fused, attention_mask, rng)
        cls = dropout(fused[:, 0], self.config.hidden_dropout_prob, rng)
        return self.classifier(cls.float())


class TargetImageMatching(nn.Module):
    """MHA + add&norm + 4x FFN + add&norm
    (tomROBERTa/train_tomroberta_vimacsa_full.py:187-199)."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        dt = compute_dtype
        self.dropout_rate = dropout_rate
        self.mha = MHA(hidden_size, num_heads, dropout_rate, dt, device=device)
        self.norm1 = LayerNormTF(hidden_size, 1e-5, dt, device=device)
        self.ff1 = Dense(hidden_size, hidden_size * 4, dt, device=device)
        self.ff2 = Dense(hidden_size * 4, hidden_size, dt, device=device)
        self.norm2 = LayerNormTF(hidden_size, 1e-5, dt, device=device)

    def forward(self, target: torch.Tensor, image: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rng = rng if self.training else None
        attn = dropout(self.mha(target, image, image, None, rng), self.dropout_rate, rng)
        h = self.norm1(target + attn)
        f = dropout(self.ff2(gelu_erf(self.ff1(h))), self.dropout_rate, rng)
        return self.norm2(h + f)


class TomBERT(_VisualBaseline):
    """TomBERT over a shared two-stream backbone: one `roberta`, called on
    the target and then on the sentence (both calls add to its gradient;
    each draws its own dropout masks from the step's generators)."""

    def __init__(self, config: TextEncoderConfig, num_labels: int = 4,
                 num_tim_layers: int = 1, num_mm_layers: int = 1,
                 visual_feat_dim: int = 2048, device=None):
        super().__init__(config, num_labels, visual_feat_dim, device=device)
        h, dt = config.hidden_size, config.torch_dtype
        self.num_tim_layers, self.num_mm_layers = num_tim_layers, num_mm_layers
        for i in range(num_tim_layers):
            self.add_module(f"ti_matching_{i}", TargetImageMatching(
                h, config.num_attention_heads, config.attention_probs_dropout_prob, dt,
                device=device))
        self._mm_layers(num_mm_layers, device)
        self.classifier = Dense(2 * h, num_labels, torch.float32, device=device)

    def forward(self, target_ids: torch.Tensor, target_mask: torch.Tensor,
                sentence_ids: torch.Tensor, sentence_mask: torch.Tensor,
                visual_embeds_att: torch.Tensor, roi_embeds_att: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rng = rng if self.training else None
        h_t, _ = self.roberta(target_ids, None, target_mask, rng)
        h_s, _ = self.roberta(sentence_ids, None, sentence_mask, rng)
        g_visual = _visual_tokens(self, visual_embeds_att, roi_embeds_att)
        h_v = h_t
        for i in range(self.num_tim_layers):
            h_v = getattr(self, f"ti_matching_{i}")(h_v, g_visual, rng)
        h_mm = torch.cat([h_v[:, :1], h_s], dim=1)
        mm_mask = torch.cat([torch.ones_like(sentence_mask[:, :1]), sentence_mask], dim=1)
        for i in range(self.num_mm_layers):
            h_mm = getattr(self, f"mm_layer_{i}")(h_mm, mm_mask, rng)
        pooled = dropout(torch.cat([h_mm[:, 0], h_mm[:, 1]], dim=-1),
                         self.config.hidden_dropout_prob, rng)
        return self.classifier(pooled.float())


class EFCapTrRoBERTa(nn.Module):
    """Text-only classifier over caption-augmented input."""

    def __init__(self, config: TextEncoderConfig, num_labels: int = 4, device=None):
        super().__init__()
        self.config, self.num_labels = config, num_labels
        self.roberta = TextEncoder(config, device=device)
        self.classifier = Dense(config.hidden_size, num_labels, torch.float32, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        rng = rng if self.training else None
        seq, _ = self.roberta(input_ids, None, attention_mask, rng)
        cls = dropout(seq[:, 0], self.config.hidden_dropout_prob, rng)
        return self.classifier(cls.float())


def build_baseline(name: str, config: TextEncoderConfig, visual_feat_dim: int = 2048,
                   device=None) -> nn.Module:
    """The driver's `--model` choice -> its module."""
    if name == "mroberta":
        return MRoBERTa(config, visual_feat_dim=visual_feat_dim, device=device)
    if name == "tomroberta":
        return TomBERT(config, visual_feat_dim=visual_feat_dim, device=device)
    if name == "efcap":
        return EFCapTrRoBERTa(config, device=device)
    raise ValueError(f"unknown baseline {name!r}: one of {BASELINE_NAMES}")
