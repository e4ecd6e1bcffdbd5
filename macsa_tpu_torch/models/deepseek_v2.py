"""DeepSeek-V2 as FCMF's text backbone, in PyTorch.

The decoder of deepseek-ai/DeepSeek-V2(-Lite), equation for equation as
its own `modeling_deepseek.py` defines them (arXiv:2405.04434):

* RMSNorm: x * rsqrt(mean(x^2) + eps) in f32, times the weight,
* multi-head latent attention without q-LoRA: q = q_proj(x), split into
  `qk_nope_head_dim` + `qk_rope_head_dim` a head; c = kv_a_proj_with_mqa(x),
  split into the `kv_lora_rank` latent and one rope key shared by every
  head; kv_b_proj(kv_a_layernorm(latent)) gives each head's no-rope key
  and value; rope (YaRN) on the rope parts after the de-interleave
  `view(..., d/2, 2).transpose(-1, -2)`; softmax scale
  qk_head_dim^-1/2 * mscale(factor, mscale_all_dim)^2; softmax in f32 under
  the causal mask and the key padding; o_proj,
* SwiGLU MLPs down(silu(gate(x)) * up(x)): the leading dense layers'
  (`intermediate_size`), the shared experts' (`n_shared_experts` x
  `moe_intermediate_size`) and each routed expert's,
* the router: f32 logits of f32 inputs, softmax, the greedy top-k, its
  weights kept as they are (`norm_topk_prob` false, scaling 1),
* pre-norm residual layers and a final norm.

The MoE layer is the share of one rank of an expert-parallel deployment
(`DeepseekV2Config.ep_size`, `ep_rank`): it routes every token over all
`n_routed_experts` and computes the part of the result that its
`experts_held` experts give, every (token, slot) routed to one of them
and no other; on one process it runs without the exchange.  The held
experts' products are one grouped product (`torch._grouped_mm`) over the
routes sorted by expert, the groups' ends on the device: nothing in the
layer waits for the host.  `HeldExperts` keeps only its inputs for the
backward and computes the products again there.

`DeepseekV2Encoder` is what FCMF's `FeatureExtractor` holds as `cell`:
the decoder over the right-padded views (positions 0..L-1), then
`text_proj` into the fusion's width, with row 0 of the result the
projected state of each view's last real token (the pool of HF's
`*ForSequenceClassification`: under the causal mask row 0 sees only
itself).

Parameters are f32 and cast at call time to the compute dtype, as in
`layers.py`; the names are HF's but for the held experts, which are
stacked: `mlp.experts.gate_up_proj[i]` is expert `first_expert + i`'s
gate_proj and up_proj weights one above the other ([2F, D]) and
`mlp.experts.down_proj[i]` its down_proj weight ([D, F]).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.config import DeepseekV2Config
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.utils.logging import span


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.eps, self.compute_dtype = eps, compute_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight).to(self.compute_dtype)


class Linear(nn.Module):
    """y = x W^T, no bias; f32 weight, computed in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt))


# ---------------------------------------------------------------------------
# YaRN rotary positions
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> Tuple[int, int]:
    """The rotary dimensions between which YaRN ramps from interpolated
    (below `low`) to extrapolated frequencies."""
    dim, base, orig = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_original_max_position

    def at(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    return (max(math.floor(at(cfg.rope_beta_fast)), 0),
            min(math.ceil(at(cfg.rope_beta_slow)), dim - 1))


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """inv_freq = freq_inter * (1 - mask) + freq_extra * mask, mask = 1 - ramp."""
    dim = cfg.qk_rope_head_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / cfg.rope_theta ** exps
    freq_inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** exps)
    low, high = yarn_correction_range(cfg)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low if high > low else 0.001), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """cos and sin are scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    return (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
            / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    return cfg.qk_head_dim ** -0.5 * m * m


def rope_tables(inv_freq: torch.Tensor, length: int, mscale: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos and sin [length, d] of positions 0..length-1."""
    freqs = torch.outer(torch.arange(length, dtype=torch.float32, device=inv_freq.device),
                        inv_freq)
    emb = torch.cat((freqs, freqs), -1)
    return emb.cos() * mscale, emb.sin() * mscale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., L, d]: de-interleaved (pairs (2i, 2i+1) -> i, d/2 + i), then
    x * cos + rotate_half(x) * sin, in f32, back in x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = xf.chunk(2, -1)
    return (xf * cos + torch.cat((-x2, x1), -1) * sin).to(x.dtype)


def causal_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] key validity -> bool [B, 1, L, L]: query i sees valid keys j <= i."""
    length = attention_mask.shape[1]
    causal = torch.ones(length, length, dtype=torch.bool, device=attention_mask.device).tril()
    return causal[None, None] & attention_mask.bool()[:, None, None, :]


class MLAttention(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None):
        super().__init__()
        self.cfg = cfg
        h, n, dt = cfg.hidden_size, cfg.num_attention_heads, cfg.torch_dtype
        self.q_proj = Linear(h, n * cfg.qk_head_dim, dt, device)
        self.kv_a_proj_with_mqa = Linear(h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dt, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps, dt, device)
        self.kv_b_proj = Linear(cfg.kv_lora_rank, n * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                                dt, device)
        self.o_proj = Linear(n * cfg.v_head_dim, h, dt, device)
        self.scale = softmax_scale(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, cos: Optional[torch.Tensor],
                sin: Optional[torch.Tensor]) -> torch.Tensor:
        """`cos`, `sin`: the rope tables; None under `mla_use_nope`, where
        the 64-wide parts enter the scores unrotated."""
        c = self.cfg
        b, l, _ = x.shape
        n, nope, rope, vd = (c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim,
                             c.v_head_dim)
        q = self.q_proj(x).view(b, l, n, nope + rope).transpose(1, 2)
        latent, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], -1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, l, n, nope + vd).transpose(1, 2)
        k_nope, v = kv.split([nope, vd], -1)
        k_pe = k_pe.view(b, l, 1, rope).transpose(1, 2)
        if not c.mla_use_nope:
            q_nope, q_pe = q.split([nope, rope], -1)
            q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], -1)
            k_pe = apply_rope(k_pe, cos, sin)
        k = torch.cat([k_nope, k_pe.expand(b, n, l, rope)], -1)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(b, l, n * vd))


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, hidden: int, intermediate: int, compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.gate_proj = Linear(hidden, intermediate, compute_dtype, device)
        self.up_proj = Linear(hidden, intermediate, compute_dtype, device)
        self.down_proj = Linear(intermediate, hidden, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


# ---------------------------------------------------------------------------
# the MoE layer: router, dispatch, the held experts, combine
# ---------------------------------------------------------------------------

class Router(nn.Module):
    """Scores over all experts of f32 logits, greedy top-k -> (experts
    [T, k], weights [T, k] f32).  `scoring_func` "softmax": the k largest
    softmax scores are the weights.  "sigmoid" (Kimi Linear, DeepSeek-V3):
    s = sigmoid(logits); the k largest s + `e_score_correction_bias` (a
    fixed buffer, never trained) pick the experts; their s are the weights.
    Then, with `norm_topk_prob`, the weights over their sum + 1e-20, and
    times `routed_scaling_factor` where it is not 1."""

    def __init__(self, cfg: DeepseekV2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size,
                                               device=device))
        if cfg.scoring_func == "sigmoid":
            self.register_buffer("e_score_correction_bias",
                                 torch.zeros(cfg.n_routed_experts, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.normal_(0.0, std, generator=generator)
        if self.cfg.scoring_func == "sigmoid":
            self.e_score_correction_bias.normal_(0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        logits = F.linear(x.float(), self.weight.float())
        if c.scoring_func == "sigmoid":
            scores = logits.sigmoid()
            _, experts = torch.topk(scores + self.e_score_correction_bias, c.num_experts_per_tok,
                                    dim=-1)
            weight = scores.gather(-1, experts)
        else:
            weight, experts = torch.topk(logits.softmax(-1), c.num_experts_per_tok, dim=-1)
        if c.norm_topk_prob:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        if c.routed_scaling_factor != 1:
            weight = weight * c.routed_scaling_factor
        return experts, weight


def dispatch(experts: torch.Tensor, first: int, held: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Routes [T, k] -> (order [T*k], rows [T*k], ends [held] int32): the
    (token, slot) routes sorted by held expert, the routes to other experts
    after them; the row of each route in that order; and each held
    expert's end in it.  Row r of the grouped products is route order[r]
    (token order[r] // k); rows from ends[-1] on are not computed.  On the
    device, with no wait for the host."""
    local = experts.flatten() - first
    key = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(key, stable=True)
    rows = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0],
                                                                   device=order.device))
    counts = torch.zeros(held + 1, dtype=torch.int64, device=key.device).index_add_(
        0, key, torch.ones_like(key))
    return order, rows, torch.cumsum(counts[:held], 0).to(torch.int32)


def _per_token(rows: torch.Tensor, route_rows: torch.Tensor, ends: torch.Tensor,
               tokens: int) -> torch.Tensor:
    """[R, D] values by row -> [T, D]: each token's sum over its routes to
    the held experts, in f32, in the rows' dtype.  A gather by route, not a
    scatter: no atomics, the same sum every run."""
    held = (route_rows < ends[-1])[:, None]
    by_route = torch.where(held, rows[route_rows], 0.0)
    return by_route.view(tokens, -1, rows.shape[1]).sum(1, dtype=torch.float32).to(rows.dtype)


class _HeldExpertsFn(torch.autograd.Function):
    """out[t] = sum over the routes r of token t to a held expert e of
    down_e(weight[r] * silu(gate_e(x[t])) * up_e(x[t])) (the route's weight
    taken into the down product's input, which is linear), summed in f32.

    The products are `torch._grouped_mm` over the rows grouped by `ends`:
    rows [R, K] times each group's [K, N], or with two 2-D operands [K, R]
    and [R, N] (the weights' gradients) each group's [K, N].  Rows past
    ends[-1] are neither read nor, in a [R, N] result, written.

    Saves only its inputs: the backward gathers the rows and computes the
    gate and up products again (the forward's [routes, width] buffers,
    sized for every route, would hold ~0.8 GB a layer).  Rows past
    ends[-1] hold whatever the grouped product left there: no result of
    theirs reaches a token or a weight."""

    @staticmethod
    def _act(xs, w13, ends):
        g, u = torch._grouped_mm(xs, w13.transpose(1, 2), offs=ends).chunk(2, -1)
        return F.silu(g) * u

    @staticmethod
    def forward(ctx, x, gate_up, down, token, route_rows, weight, ends, dt):
        w13, w2 = gate_up.to(dt), down.to(dt)
        a = _HeldExpertsFn._act(x[token], w13, ends) * weight.to(dt)[:, None]
        ctx.save_for_backward(x, gate_up, down, token, route_rows, weight, ends)
        ctx.dt = dt
        y = torch._grouped_mm(a, w2.transpose(1, 2), offs=ends)
        return _per_token(y, route_rows, ends, x.shape[0])

    @staticmethod
    def backward(ctx, d_out):
        x, gate_up, down, token, route_rows, weight, ends = ctx.saved_tensors
        dt = ctx.dt
        w13, w2 = gate_up.to(dt), down.to(dt)
        xs = x[token]
        with torch.enable_grad():
            h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=ends).requires_grad_()
            g, u = h.chunk(2, -1)
            a = F.silu(g) * u
        w = weight.to(dt)[:, None]
        dy = d_out.to(dt)[token]
        d_aw = torch._grouped_mm(dy, w2, offs=ends)
        held = torch.arange(token.shape[0], device=x.device) < ends[-1]
        d_weight = torch.where(held, (d_aw * a.detach()).sum(-1, dtype=torch.float32), 0.0)
        d_down = torch._grouped_mm(dy.t(), a.detach() * w, offs=ends)
        (dh,) = torch.autograd.grad(a, h, d_aw * w)
        d_gate_up = torch._grouped_mm(dh.t(), xs, offs=ends)
        dx = _per_token(torch._grouped_mm(dh, w13, offs=ends), route_rows, ends, x.shape[0])
        return (dx.to(x.dtype), d_gate_up.to(gate_up.dtype), d_down.to(down.dtype), None, None,
                d_weight, None, None)


class HeldExperts(nn.Module):
    """The `experts_held` routed experts of this rank, stacked."""

    def __init__(self, cfg: DeepseekV2Config, device=None):
        super().__init__()
        h, f, d = cfg.experts_held, cfg.moe_intermediate_size, cfg.hidden_size
        self.compute_dtype = cfg.torch_dtype
        self.gate_up_proj = nn.Parameter(torch.empty(h, 2 * f, d, device=device))
        self.down_proj = nn.Parameter(torch.empty(h, d, f, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.gate_up_proj.normal_(0.0, std, generator=generator)
        self.down_proj.normal_(0.0, std, generator=generator)

    def forward(self, x, token, route_rows, weight, ends) -> torch.Tensor:
        return _HeldExpertsFn.apply(x, self.gate_up_proj, self.down_proj, token, route_rows,
                                    weight, ends, self.compute_dtype)


class MoE(nn.Module):
    """Routed experts (this rank's share) plus the shared experts.  Spans:
    `moe` around the whole layer, with the count `rows` (the routes sent to
    the held experts, a device tensor), and `experts` around the held
    experts' grouped products."""

    def __init__(self, cfg: DeepseekV2Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg, device)
        self.experts = HeldExperts(cfg, device)
        self.shared_experts = MLP(cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts,
                                  cfg.torch_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        with span("moe") as traced:
            flat = x.reshape(-1, x.shape[-1])
            experts, weight = self.gate(flat)
            order, route_rows, ends = dispatch(experts, c.first_expert, c.experts_held)
            held = torch.arange(order.shape[0], device=x.device) < ends[-1]
            row_weight = torch.where(held, weight.flatten()[order], 0.0)
            with span("experts"):
                routed = self.experts(flat, order // experts.shape[1], route_rows, row_weight,
                                      ends)
            if traced is not None:
                traced.counts["rows"] = ends[-1]
            return (routed + self.shared_experts(flat)).view(x.shape)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int, device=None):
        super().__init__()
        dt, h, eps = cfg.torch_dtype, cfg.hidden_size, cfg.rms_norm_eps
        self.self_attn = MLAttention(cfg, device)
        self.mlp = (MoE(cfg, device) if index >= cfg.first_k_dense_replace
                    else MLP(h, cfg.intermediate_size, dt, device))
        self.input_layernorm = RMSNorm(h, eps, dt, device)
        self.post_attention_layernorm = RMSNorm(h, eps, dt, device)

    def forward(self, x, mask, cos, sin) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2Encoder(nn.Module):
    """The decoder stack, then `text_proj` into the fusion's width `out_dim`;
    row 0 of the output is the projected state of each sequence's last real
    token.  -> (sequence [B, L, out_dim], None): the contract of
    `text_encoder.TextEncoder` without a pooler."""

    def __init__(self, cfg: DeepseekV2Config, out_dim: int, device=None):
        super().__init__()
        self.config = cfg
        dt, h = cfg.torch_dtype, cfg.hidden_size
        self.embed_tokens = layers.Embed(cfg.vocab_size, h, dt, device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, device)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(h, cfg.rms_norm_eps, dt, device)
        self.text_proj = layers.Dense(h, out_dim, dt, device=device)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg, device), persistent=False)
        self.mscale = rope_mscale(cfg)

    def hidden_states(self, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder's final normed states [B, L, hidden_size]."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask = causal_padding_mask(attention_mask)
        cos, sin = rope_tables(self.inv_freq, input_ids.shape[1], self.mscale)
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, mask, cos, sin)
        return self.norm(h)

    def forward(self, input_ids: torch.Tensor, token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[layers.DropoutRng] = None) -> Tuple[torch.Tensor, None]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        h = self.hidden_states(input_ids, attention_mask)
        last = attention_mask.sum(1) - 1
        pooled = h[torch.arange(h.shape[0], device=h.device), last]
        return self.text_proj(torch.cat([pooled[:, None], h[:, 1:]], 1)), None
