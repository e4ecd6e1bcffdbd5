"""Kimi Linear as FCMF's text backbone, in PyTorch.

The decoder of moonshotai/Kimi-Linear-48B-A3B (the Kimi Linear report,
arXiv:2510.26692): pre-norm residual layers in the config's pattern, three
KDA layers to one latent-attention layer, then a final RMSNorm.

* KDA (`KimiDeltaAttention`, as flash-linear-attention writes it): q, k, v
  projections, each through a short causal depthwise convolution and SiLU;
  the decay gate's low-rank projections f_b(f_a(x)) with `dt_bias` and
  `A_log`; beta = sigmoid(b_proj(x)); the gated delta rule over the heads
  (`ops/kda.py`); RMSNorm of each head's output times its weight and
  sigmoid(g_b(g_a(x)) + bias); o_proj.  Span `kda` around the block, with
  device events; the core's span `kda_core` is `ops/kda.py`'s.
* the other layers' latent attention is `deepseek_v2.MLAttention` without
  rotary positions (`mla_use_nope`: the 64-wide parts enter the scores as
  they are, scale (128 + 64)^-1/2), under the causal and padding mask,
* layer 1 a SwiGLU `deepseek_v2.MLP`, the rest `deepseek_v2.MoE`: the
  sigmoid router with its correction bias, renormalized over the 8 chosen
  and scaled by 2.446, this rank's held experts, one shared expert.

The views are right-padded and every mixer is causal, so a real token
never sees a pad.  `KimiLinearEncoder` is what FCMF's `FeatureExtractor`
holds as `cell`: `deepseek_v2.DeepseekV2Encoder`'s pooling and
`text_proj` (row 0 the last real token's projected state).  Parameters are
f32, cast at call time; the names are HF's, but each layer's MLP or MoE is
`mlp` and the held experts are stacked as in `deepseek_v2.py`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from macsa_tpu_torch.config import KimiLinearConfig
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.models.deepseek_v2 import (MLP, DeepseekV2Encoder, Linear, MLAttention, MoE,
                                                RMSNorm, causal_padding_mask)
from macsa_tpu_torch.ops.kda import KDAMixer
from macsa_tpu_torch.utils.logging import span


class ShortConvolution(nn.Module):
    """The weight [channels, 1, kernel] of a depthwise causal convolution,
    no bias (`ops/kda.short_conv` applies it, with SiLU, in the mixer)."""

    def __init__(self, channels: int, kernel: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[-1])  # nn.Conv1d's fan-in bound
        self.weight.uniform_(-bound, bound, generator=generator)


class KimiDeltaAttention(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, device=None):
        super().__init__()
        h, n, d, dt = cfg.hidden_size, cfg.kda_num_heads, cfg.kda_head_dim, cfg.torch_dtype
        width, kernel = n * d, cfg.short_conv_kernel_size
        self.heads, self.eps = n, cfg.rms_norm_eps
        self.q_proj = Linear(h, width, dt, device)
        self.k_proj = Linear(h, width, dt, device)
        self.v_proj = Linear(h, width, dt, device)
        self.q_conv1d = ShortConvolution(width, kernel, device)
        self.k_conv1d = ShortConvolution(width, kernel, device)
        self.v_conv1d = ShortConvolution(width, kernel, device)
        self.A_log = nn.Parameter(torch.empty(n, device=device))
        self.f_a_proj = Linear(h, d, dt, device)
        self.f_b_proj = Linear(d, width, dt, device)
        self.dt_bias = nn.Parameter(torch.empty(width, device=device))
        self.b_proj = Linear(h, n, dt, device)
        self.g_a_proj = Linear(h, d, dt, device)
        self.g_b_proj = layers.Dense(d, width, dt, device)
        self.o_norm = RMSNorm(d, cfg.rms_norm_eps, dt, device)
        self.o_proj = Linear(width, h, dt, device)

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        """flash-linear-attention's: A_log = log U(1, 16), dt_bias 0."""
        self.A_log.uniform_(1.0, 16.0, generator=generator).log_()
        self.dt_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("kda", device=True):
            y = KDAMixer.apply(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                               self.q_conv1d.weight, self.k_conv1d.weight, self.v_conv1d.weight,
                               self.f_b_proj(self.f_a_proj(x)), self.A_log, self.dt_bias,
                               self.b_proj(x), self.g_b_proj(self.g_a_proj(x)),
                               self.o_norm.weight, self.heads, self.eps)
            return self.o_proj(y)


class KimiDecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, index: int, device=None):
        super().__init__()
        ds, dt, h, eps = cfg.deepseek(), cfg.torch_dtype, cfg.hidden_size, cfg.rms_norm_eps
        self.kda = cfg.is_kda(index)
        self.self_attn = KimiDeltaAttention(cfg, device) if self.kda else MLAttention(ds, device)
        self.mlp = (MoE(ds, device) if index >= cfg.first_k_dense_replace
                    else MLP(h, cfg.intermediate_size, dt, device))
        self.input_layernorm = RMSNorm(h, eps, dt, device)
        self.post_attention_layernorm = RMSNorm(h, eps, dt, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        a = self.input_layernorm(x)
        x = x + (self.self_attn(a) if self.kda else self.self_attn(a, mask, None, None))
        return x + self.mlp(self.post_attention_layernorm(x))


class KimiLinearEncoder(DeepseekV2Encoder):
    """The decoder stack, then `text_proj` into the fusion's width `out_dim`
    (`DeepseekV2Encoder.forward`)."""

    def __init__(self, cfg: KimiLinearConfig, out_dim: int, device=None):
        nn.Module.__init__(self)
        self.config = cfg
        dt, h = cfg.torch_dtype, cfg.hidden_size
        self.embed_tokens = layers.Embed(cfg.vocab_size, h, dt, device=device)
        self.layers = nn.ModuleList(KimiDecoderLayer(cfg, i, device)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(h, cfg.rms_norm_eps, dt, device)
        self.text_proj = layers.Dense(h, out_dim, dt, device=device)

    def hidden_states(self, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder's final normed states [B, L, hidden_size]."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = causal_padding_mask(attention_mask)
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, mask)
        return self.norm(h)
