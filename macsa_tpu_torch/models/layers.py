"""BERT-style fusion building blocks in PyTorch.

Counterpart of `macsa_tpu/models/layers.py` (reference:
fcmf_framework/mm_modeling.py:10-431).  Module and parameter names follow
the reference's PyTorch checkpoints (HF BERT/RoBERTa names), so a
reference state dict loads with `load_state_dict(strict=True)`.

Conventions shared by every module of the port:
* parameters are float32; each module computes in its configured dtype
  (bf16 or f32) and casts its weights at call time, as flax's
  `nn.Dense(dtype=..., param_dtype=float32)` does,
* LayerNorm statistics are f32 whatever the activation dtype,
* masks are additive float masks (0 keep, -10000 drop),
* constructors allocate parameters without filling them: values come from
  `init_weights` (seeded through an explicit `torch.Generator`) or from
  `load_state_dict`,
* dropout sits where the JAX modules have it and is on only for a module
  in training mode that is handed a `DropoutRng`: every forward takes an
  optional `rng`, and without one (serving) the module is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.config import ModelConfig
from macsa_tpu_torch.ops.fused_attention import (
    attention_core, fused_self_attention, merge_heads, split_heads)


@dataclasses.dataclass
class DropoutRng:
    """The randomness of one training step's dropout, from explicit
    generators only: `device` draws the elementwise masks on the
    activations' device, `host` draws the seed of each attention-kernel
    call on the host, so no call waits on the device for it."""

    device: torch.Generator
    host: torch.Generator

    @classmethod
    def for_step(cls, seed: int, step: int, device) -> "DropoutRng":
        """Generators derived from (seed, step), as the JAX step folds the
        step into its key (`jax.random.fold_in(rng, state.step)`)."""
        dev_seed, host_seed = np.random.SeedSequence([seed, step]).generate_state(2)
        return cls(torch.Generator(torch.device(device)).manual_seed(int(dev_seed)),
                   torch.Generator().manual_seed(int(host_seed)))

    def keep_mask(self, shape, rate: float, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.device, device=device) >= rate

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.host))


def dropout(x: torch.Tensor, rate: float, rng: Optional[DropoutRng]) -> torch.Tensor:
    """Inverted dropout (flax `nn.Dropout`): kept elements scaled by
    1/(1-rate) in x's dtype, the others zero.  Identity without an rng."""
    if rng is None or rate == 0.0:
        return x
    return torch.where(rng.keep_mask(x.shape, rate, x.device), x / (1.0 - rate), 0.0)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) GELU, the reference's `gelu` (mm_modeling.py:10-15)."""
    return F.gelu(x)


ACT2FN: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_erf, "relu": F.relu, "swish": F.silu}


class Dense(nn.Module):
    """y = x W^T + b with f32 parameters, computed in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.normal_(0.0, std, generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Module):
    """Lookup table with f32 parameters; rows come out in `compute_dtype`.
    `weight` hands in a table shared with other modules (the Phase-1 token
    table, tied three ways) instead of allocating one."""

    def __init__(self, num_embeddings: int, dim: int,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 weight: Optional[nn.Parameter] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        if weight is not None and weight.shape[1] != dim:
            raise ValueError(f"shared table {tuple(weight.shape)} is not {dim} wide")
        self.weight = (nn.Parameter(torch.empty(num_embeddings, dim, device=device))
                       if weight is None else weight)

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNormTF(nn.Module):
    """LayerNorm with epsilon inside the square root, stats in f32
    (the reference's FCMFLayerNorm, mm_modeling.py:158-171)."""

    def __init__(self, dim: int, eps: float = 1e-12,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.compute_dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill every parameter and frozen statistic of `module` from `generator`
    (the counterpart of flax's `init` with a seeded key)."""
    for m in module.modules():
        if hasattr(m, "init_weights_"):
            m.init_weights_(generator, std)
    return module


class BertSelfAttention(nn.Module):
    """Multi-head self/cross attention projections + core
    (BertSelfAttention / BertCoAttention, mm_modeling.py:174-266).

    With `config.fused_attention` the attention runs through kernel K1
    (`ops/fused_attention.py`) whenever the call matches its contract,
    exactly as the JAX package dispatches (`layers.py:154-160`):
    self-attention (Lq == Lk >= 32) under a [B, 1, 1, Lk] padding mask, i.e.
    the text-encoder blocks, with the probs dropout inside the kernel.
    Other call sites (CLS-query branches, the 15-token fusion,
    cross-attention) run the plain math."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.config = config
        h, dt = config.hidden_size, config.torch_dtype
        self.query = Dense(h, h, dt, device=device)
        self.key = Dense(h, h, dt, device=device)
        self.value = Dense(h, h, dt, device=device)

    def forward(self, q_states: torch.Tensor, kv_states: torch.Tensor,
                additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        cfg = self.config
        n = cfg.num_attention_heads
        rng = rng if self.training else None
        rate = 0.0 if rng is None else cfg.attention_probs_dropout_prob
        qr, kr, vr = self.query(q_states), self.key(kv_states), self.value(kv_states)
        if (cfg.fused_attention and additive_mask is not None
                and additive_mask.dim() == 4 and additive_mask.shape[1] == 1
                and additive_mask.shape[2] == 1
                and qr.shape[1] == kr.shape[1] and qr.shape[1] >= 32):
            mask_row = additive_mask[:, 0, 0, :].float().contiguous()
            seed = rng.kernel_seed() if rate > 0.0 else 0
            return fused_self_attention(qr, kr, vr, mask_row, n, rate, seed)
        keep = None
        if rate > 0.0:
            keep = rng.keep_mask((qr.shape[0], n, qr.shape[1], kr.shape[1]), rate, qr.device)
        ctx = attention_core(split_heads(qr, n), split_heads(kr, n),
                             split_heads(vr, n), additive_mask, keep, rate)
        return merge_heads(ctx)


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (mm_modeling.py:269-280)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        h, dt = config.hidden_size, config.torch_dtype
        self.dropout_rate = config.hidden_dropout_prob
        self.dense = Dense(h, h, dt, device=device)
        self.LayerNorm = LayerNormTF(h, config.layer_norm_eps, dt, device=device)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        h = dropout(self.dense(hidden), self.dropout_rate, rng if self.training else None)
        return self.LayerNorm(h + residual)


class BertAttention(nn.Module):
    """Self-attention + output block (mm_modeling.py:283-292).

    `num_query_tokens` restricts the query rows to the first N tokens (K/V
    stay full).  Query rows never interact inside one attention+FFN layer,
    so the first N output rows equal the same rows of the full output."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.self = BertSelfAttention(config, device=device)
        self.output = BertSelfOutput(config, device=device)

    def forward(self, hidden: torch.Tensor, additive_mask: Optional[torch.Tensor],
                num_query_tokens: Optional[int] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        q_states = hidden if num_query_tokens is None else hidden[:, :num_query_tokens]
        return self.output(self.self(q_states, hidden, additive_mask, rng), q_states, rng)


class BertCrossAttention(nn.Module):
    """Cross-attention (Q from s1, K/V from s2) + output (mm_modeling.py:294-303)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.self = BertSelfAttention(config, device=device)
        self.output = BertSelfOutput(config, device=device)

    def forward(self, s1: torch.Tensor, s2: torch.Tensor,
                s2_additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.output(self.self(s1, s2, s2_additive_mask, rng), s1, rng)


class BertMLP(nn.Module):
    """Intermediate + output FFN (mm_modeling.py:305-328).

    Its sub-modules carry the HF names `intermediate.dense`, `output.dense`
    and `output.LayerNorm`; the transformer layers below extend this class
    so those keys sit directly under `layer.N`, as in the checkpoints."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        h, i, dt = config.hidden_size, config.intermediate_size, config.torch_dtype
        self.act = ACT2FN[config.hidden_act]
        self.dropout_rate = config.hidden_dropout_prob
        self.intermediate = nn.ModuleDict({"dense": Dense(h, i, dt, device=device)})
        self.output = nn.ModuleDict({
            "dense": Dense(i, h, dt, device=device),
            "LayerNorm": LayerNormTF(h, config.layer_norm_eps, dt, device=device)})

    def mlp(self, hidden: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        h = self.output["dense"](self.act(self.intermediate["dense"](hidden)))
        h = dropout(h, self.dropout_rate, rng if self.training else None)
        return self.output["LayerNorm"](h + hidden)

    def forward(self, hidden: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.mlp(hidden, rng)


class BertLayer(BertMLP):
    """Full transformer layer (mm_modeling.py:331-342)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config, device=device)
        self.attention = BertAttention(config, device=device)

    def forward(self, hidden: torch.Tensor, additive_mask: Optional[torch.Tensor],
                num_query_tokens: Optional[int] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.mlp(self.attention(hidden, additive_mask, num_query_tokens, rng), rng)


class BertCrossAttentionLayer(BertMLP):
    """Cross-attention transformer layer (mm_modeling.py:344-355)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__(config, device=device)
        self.attention = BertCrossAttention(config, device=device)

    def forward(self, s1: torch.Tensor, s2: torch.Tensor,
                s2_additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.mlp(self.attention(s1, s2, s2_additive_mask, rng), rng)


class MultimodalEncoder(nn.Module):
    """One BertLayer, as the reference stacks (mm_modeling.py:373-387);
    held in a list for the checkpoint's `layer.0.*` keys."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(config, device=device)])

    def forward(self, hidden: torch.Tensor, additive_mask: Optional[torch.Tensor],
                num_query_tokens: Optional[int] = None,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.layer[0](hidden, additive_mask, num_query_tokens, rng)


class BertCrossEncoder(nn.Module):
    """One cross-attention layer, as the reference stacks
    (mm_modeling.py:389-403); held in a list for the `layer.0.*` keys."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList([BertCrossAttentionLayer(config, device=device)])

    def forward(self, s1: torch.Tensor, s2: torch.Tensor,
                s2_additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        return self.layer[0](s1, s2, s2_additive_mask, rng)


class TokenPooler(nn.Module):
    """dense + tanh over the first token (BertPooler, mm_modeling.py:419-431)."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.hidden_size, config.torch_dtype,
                           device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


def extend_attention_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] 0/1 mask -> [B, 1, 1, L] additive mask, -10000 at masked
    slots (fcmf_pretraining.py:54-56)."""
    ext = mask[:, None, None, :].to(dtype)
    return (1.0 - ext) * -10000.0
