"""XLM-R / ViSoBERT-compatible RoBERTa text encoder in PyTorch.

Counterpart of `macsa_tpu/models/text_encoder.py`.  Module names follow HF
RoBERTa (`embeddings.*`, `encoder.layer.N.*`, `pooler.dense`), so the
reference's `encoder.bert.cell.*` keys line up one to one.  The layers run
unrolled; each one's self-attention goes through kernel K1 when
`config.fused_attention` is on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from macsa_tpu_torch.config import ModelConfig, TextEncoderConfig
from macsa_tpu_torch.models import layers


def block_config(cfg: TextEncoderConfig) -> ModelConfig:
    """Transformer-block hyperparams for the backbone (HF RoBERTa LN eps=1e-5)."""
    return ModelConfig(
        hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        hidden_act="gelu",
        hidden_dropout_prob=cfg.hidden_dropout_prob,
        attention_probs_dropout_prob=cfg.attention_probs_dropout_prob,
        layer_norm_eps=cfg.layer_norm_eps,
        initializer_range=cfg.initializer_range,
        dtype=cfg.dtype,
        fused_attention=cfg.fused_attention,
    )


def create_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """RoBERTa position ids: pad tokens keep padding_idx; others count from
    padding_idx+1 (HF `create_position_ids_from_input_ids` semantics)."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class RobertaEmbeddings(nn.Module):
    def __init__(self, config: TextEncoderConfig, device=None):
        super().__init__()
        self.config = config
        h, dt = config.hidden_size, config.torch_dtype
        self.word_embeddings = layers.Embed(config.vocab_size, h, dt, device=device)
        self.position_embeddings = layers.Embed(config.max_position_embeddings, h, dt,
                                                device=device)
        self.token_type_embeddings = layers.Embed(config.type_vocab_size, h, dt,
                                                  device=device)
        self.LayerNorm = layers.LayerNormTF(h, config.layer_norm_eps, dt, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                rng: Optional[layers.DropoutRng] = None) -> torch.Tensor:
        pos_ids = create_position_ids(input_ids, self.config.pad_token_id)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        h = (self.word_embeddings(input_ids) + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return layers.dropout(self.LayerNorm(h), self.config.hidden_dropout_prob,
                              rng if self.training else None)


class TextEncoder(nn.Module):
    """RoBERTa encoder returning (sequence_output, pooled_output), the
    contract the reference consumes from its FeatureExtractor
    (mm_modeling.py:440-446)."""

    def __init__(self, config: TextEncoderConfig, device=None):
        super().__init__()
        self.config = config
        block = block_config(config)
        self.embeddings = RobertaEmbeddings(config, device=device)
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            layers.BertLayer(block, device=device)
            for _ in range(config.num_hidden_layers))})
        self.pooler = layers.TokenPooler(block, device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[layers.DropoutRng] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.embeddings(input_ids, token_type_ids, rng)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        # HF extended-mask convention: (1 - m) * finfo(float32).min
        ext = attention_mask[:, None, None, :].float()
        ext = (1.0 - ext) * torch.finfo(torch.float32).min
        for layer in self.encoder["layer"]:
            h = layer(h, ext, rng=rng)
        return h, self.pooler(h)
