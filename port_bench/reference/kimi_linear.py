"""The plain reference of the FCMF classifier with Kimi Linear as its text
backbone (configuration `fcmf_kimi_linear_48b_a3b`), in plain PyTorch and
float32.

The backbone follows the Kimi Linear report (arXiv:2510.26692) and
flash-linear-attention's `KimiDeltaAttention`: pre-norm residual layers,
layer i (1-based) a KDA layer where `linear_attn_config.kda_layers` holds
i, else latent attention; then a final RMSNorm.

* KDA: x's q, k, v projections, each through a causal depthwise
  convolution of `short_conv_kernel_size` taps (zero left padding, no
  bias) and SiLU; q and k l2-normalized per head (eps 1e-6 under the
  root), q times head_dim^-1/2; g = -exp(A_log) * softplus(f_b(f_a(x)) +
  dt_bias), beta = sigmoid(b_proj(x)); per head, position by position,
  S = Diag(exp g_t) S;  S += beta_t k_t (v_t - S^T k_t)^T;  o_t = S^T q_t,
  from S = 0; then RMSNorm(o) over the head (eps rms_norm_eps) times
  `o_norm.weight` times sigmoid(g_b(g_a(x)) + its bias); o_proj,
* latent attention without q-LoRA and without rotary positions
  (`mla_use_nope`): the 64-wide parts of q and of the shared key enter the
  scores as they are, scale (qk_nope + qk_rope)^-1/2, softmax in f32 under
  the causal mask and the key padding,
* layer 1 a SwiGLU of `intermediate_size`; the rest MoE layers: s =
  sigmoid of the f32 logits over all `num_experts * ep_size` experts, the
  `num_experts_per_token` largest s + `e_score_correction_bias` chosen,
  their s over their sum (+1e-20) times `routed_scaling_factor`; the held
  experts each over the tokens routed to it (`deepseek_v2.Experts`: a
  loop with a boolean mask) plus the shared expert.

Then `deepseek_v2.Backbone`'s projection into the fusion's width, row 0
the last real token's state, inside `reference/model.py`'s `FCMF`.

Departures, as in `reference/deepseek_v2.py`: every product and
activation is f32; `lowp` rounds where the program's compute dtype
rounds (every linear layer's operands and output, the convolutions'
operands and outputs and their SiLU, the KDA core's output and the gated
norm's; the router's logits and KDA's g and beta are f32 in the program
too).  The MoE balance loss is left out, as in the program.  Each decoder
layer runs under `torch.utils.checkpoint`, and within a KDA layer the
recurrence runs in stretches of `SEGMENT` positions, each under a nested
`checkpoint` (exact in f32: no dropout, deterministic operations): one
position's state is [B, H, 128, 128] f32, 100 MB at 48 views, so a
layer's backward keeps the stretches' first states and one stretch's.

`NO_DECAY_LEAVES`: `A_log` and `dt_bias` take no weight decay (as
flash-linear-attention marks them); `reference/train.no_decay` decides by
leaf name `bias` and normalization modules alone, so the benchmark's entry
adds these.

It imports nothing of the port, of JAX or of the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from port_bench.reference import deepseek_v2 as ds, model
from port_bench.reference.deepseek_v2 import MLP, Linear, RMSNorm
from port_bench.reference.model import Lowp, _lp

SEGMENT = 10
L2_EPS = 1e-6
NO_DECAY_LEAVES = ("A_log", "dt_bias")


def as_deepseek(c: dict) -> dict:
    """Kimi's MoE keys under the names `reference/deepseek_v2.py` reads."""
    return dict(c, n_routed_experts=c["num_experts"], n_shared_experts=c["num_shared_experts"],
                num_experts_per_tok=c["num_experts_per_token"])


# ---------------------------------------------------------------------------
# KDA
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel))


def causal_conv_silu(x, weight, lowp: Lowp):
    """x [B, L, C], weight [C, 1, K]: y_t = sum_i weight[:, 0, i] x_{t-K+1+i},
    x_s = 0 for s < 0; then SiLU."""
    x, w = _lp(lowp, x, weight)
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(w[:, 0, i] * xp[:, i:i + x.shape[1]] for i in range(k))
    return _lp(lowp, F.silu(_lp(lowp, y)[0]))[0]


def _stretch(s, q, k, v, g, beta):
    """The recurrence over one stretch of positions from state s."""
    outs = []
    for t in range(q.shape[1]):
        s = s * g[:, t].exp().unsqueeze(-1)
        kt = k[:, t]
        u = beta[:, t].unsqueeze(-1) * (v[:, t] - torch.einsum("bhkv,bhk->bhv", s, kt))
        s = s + kt.unsqueeze(-1) * u.unsqueeze(-2)
        outs.append(torch.einsum("bhkv,bhk->bhv", s, q[:, t]))
    return s, torch.stack(outs, 1)


def kda_recurrence(q, k, v, g, beta, segment: int = SEGMENT):
    """q, k, v, g [B, L, H, D], beta [B, L, H] -> o [B, L, H, D]: position
    by position, the stretches of `segment` positions checkpointed."""
    b, l, h, d = q.shape
    s = q.new_zeros(b, h, d, v.shape[-1])
    outs = []
    for t0 in range(0, l, segment):
        part = slice(t0, t0 + segment)
        s, o = checkpoint(_stretch, s, q[:, part], k[:, part], v[:, part], g[:, part],
                          beta[:, part], use_reentrant=False)
        outs.append(o)
    return torch.cat(outs, 1)


class KDA(nn.Module):
    def __init__(self, c: dict, lowp: Lowp):
        super().__init__()
        self.c, self.lowp = c, lowp
        lin = c["linear_attn_config"]
        h, n, d = c["hidden_size"], lin["num_heads"], lin["head_dim"]
        width, kernel = n * d, lin["short_conv_kernel_size"]
        self.heads = n
        self.q_proj, self.k_proj, self.v_proj = (Linear(h, width, lowp) for _ in range(3))
        self.q_conv1d, self.k_conv1d, self.v_conv1d = (Conv(width, kernel) for _ in range(3))
        self.A_log = nn.Parameter(torch.empty(n))
        self.f_a_proj = Linear(h, d, lowp)
        self.f_b_proj = Linear(d, width, lowp)
        self.dt_bias = nn.Parameter(torch.empty(width))
        self.b_proj = Linear(h, n, lowp)
        self.g_a_proj = Linear(h, d, lowp)
        self.g_b_proj = model.Dense(d, width, lowp)
        self.o_norm = RMSNorm(d, c["rms_norm_eps"], lowp)
        self.o_proj = Linear(width, h, lowp)

    def forward(self, x):
        b, l, _ = x.shape
        n, lp = self.heads, self.lowp

        def heads(t):
            return t.view(b, l, n, -1)

        q, k, v = (heads(causal_conv_silu(p(x), conv.weight, lp)) for p, conv in
                   ((self.q_proj, self.q_conv1d), (self.k_proj, self.k_conv1d),
                    (self.v_proj, self.v_conv1d)))
        d = q.shape[-1]
        q = q * torch.rsqrt(q.square().sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
        k = k * torch.rsqrt(k.square().sum(-1, keepdim=True) + L2_EPS)
        g = -self.A_log.exp()[:, None] * F.softplus(heads(self.f_b_proj(self.f_a_proj(x)))
                                                    + self.dt_bias.view(n, d))
        beta = torch.sigmoid(self.b_proj(x))
        o = _lp(lp, kda_recurrence(q, k, v, g, beta))[0]
        o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + self.o_norm.eps)
        y = o * self.o_norm.weight * torch.sigmoid(heads(self.g_b_proj(self.g_a_proj(x))))
        return self.o_proj(_lp(lp, y.reshape(b, l, n * d))[0])


# ---------------------------------------------------------------------------
# latent attention without rotary positions; the sigmoid-routed MoE
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, c: dict, lowp: Lowp):
        super().__init__()
        self.c, self.lowp = c, lowp
        h, n = c["hidden_size"], c["num_attention_heads"]
        nope, rope, vd, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                             c["kv_lora_rank"])
        self.q_proj = Linear(h, n * (nope + rope), lowp)
        self.kv_a_proj_with_mqa = Linear(h, r + rope, lowp)
        self.kv_a_layernorm = RMSNorm(r, c["rms_norm_eps"], lowp)
        self.kv_b_proj = Linear(r, n * (nope + vd), lowp)
        self.o_proj = Linear(n * vd, h, lowp)

    def forward(self, x, additive_mask):
        c = self.c
        b, l, _ = x.shape
        n, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"], c["v_head_dim"])
        query = self.q_proj(x).view(b, l, n, nope + rope).transpose(1, 2)
        latent, k_pe = torch.split(self.kv_a_proj_with_mqa(x), [c["kv_lora_rank"], rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, l, n, nope + vd).transpose(1, 2)
        k_nope, v = torch.split(kv, [nope, vd], dim=-1)
        key = torch.cat([k_nope, k_pe.view(b, 1, l, rope).expand(b, n, l, rope)], -1)
        query, key = _lp(self.lowp, query, key)
        scores = query @ key.transpose(2, 3) * (nope + rope) ** -0.5 + additive_mask
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32)
        probs, v = _lp(self.lowp, probs, v)
        return self.o_proj((probs @ v).transpose(1, 2).reshape(b, l, n * vd))


class Router(nn.Module):
    """The sigmoid gate without the balance loss -> (experts [T, k], weights [T, k])."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        experts = c["num_experts"] * c["ep_size"]
        self.weight = nn.Parameter(torch.empty(experts, c["hidden_size"]))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))

    def forward(self, x):
        c = self.c
        scores = torch.sigmoid(F.linear(x, self.weight))
        experts = torch.topk(scores + self.e_score_correction_bias, c["num_experts_per_token"],
                             dim=-1).indices
        weight = scores.gather(1, experts)
        if c["moe_renormalize"]:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return experts, weight * c["routed_scaling_factor"]


class MoE(ds.MoE):
    def __init__(self, c: dict, lowp: Lowp):
        super().__init__(as_deepseek(c), lowp)
        self.gate = Router(c)


class Layer(nn.Module):
    def __init__(self, c: dict, index: int, lowp: Lowp):
        super().__init__()
        h = c["hidden_size"]
        self.kda = index + 1 in c["linear_attn_config"]["kda_layers"]
        self.self_attn = KDA(c, lowp) if self.kda else Attention(c, lowp)
        moe = index >= c["first_k_dense_replace"] and index % c["moe_layer_freq"] == 0
        self.mlp = MoE(c, lowp) if moe else MLP(h, c["intermediate_size"], lowp)
        self.input_layernorm = RMSNorm(h, c["rms_norm_eps"], lowp)
        self.post_attention_layernorm = RMSNorm(h, c["rms_norm_eps"], lowp)

    def forward(self, x, additive_mask):
        a = self.input_layernorm(x)
        x = x + (self.self_attn(a) if self.kda else self.self_attn(a, additive_mask))
        return x + self.mlp(self.post_attention_layernorm(x))


class Backbone(ds.Backbone):
    """`deepseek_v2.Backbone` with Kimi Linear's layers and no rope."""

    def __init__(self, c: dict, out_dim: int, lowp: Lowp = None):
        nn.Module.__init__(self)
        self.c, self.lowp = c, lowp
        h = c["hidden_size"]
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(torch.empty(c["vocab_size"], h))
        self.layers = nn.ModuleList(Layer(c, i, lowp) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(h, c["rms_norm_eps"], lowp)
        self.text_proj = model.Dense(h, out_dim, lowp)

    def hidden_states(self, ids, attention_mask):
        l = ids.shape[1]
        h = _lp(self.lowp, F.embedding(ids, self.embed_tokens.weight))[0]
        allowed = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()[None, None] & (
            attention_mask[:, None, None, :] != 0)
        additive = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
        for layer in self.layers:
            h = checkpoint(layer, h, additive, use_reentrant=False)
        return self.norm(h)


def FCMF(cfg: dict, lowp: Lowp = None) -> model.FCMF:
    """`model.FCMF` of the configuration's fusion, with `Backbone` as its
    `encoder.bert.cell`.  Turns TF32 off for the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = model.FCMF(dict(cfg, text=ds._UNUSED_TEXT), lowp)
    m.encoder.bert.cell = Backbone(cfg, cfg["model"]["hidden_size"], lowp)
    return m
