"""The plain reference of the FCMF classifier with DeepSeek-V2 as its text
backbone (configuration `fcmf_deepseek_v2_lite`), in plain PyTorch and
float32.

The backbone follows DeepSeek-V2's own `modeling_deepseek.py`
(deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434): RMSNorm; multi-head
latent attention without q-LoRA, YaRN rope on the rope parts after HF's
de-interleave, the softmax scale qk_head_dim^-1/2 * mscale^2, softmax in
f32 under the causal mask and the key padding; SwiGLU MLPs; the softmax
router over all experts with the greedy top-k and its weights as they
are; the routed experts this rank holds, each over the tokens routed to
it (a loop over the experts, rows picked by a boolean mask), plus the
shared experts; pre-norm residual layers and a final norm.  Then the
projection into the fusion's width, with row 0 the last real token's
state.  The rest of the classifier is `reference/model.py`'s `FCMF`: this
file builds it and puts the backbone and projection in its `bert.cell`.

Departures, as in `reference/model.py`: every product and activation is
f32; `lowp` rounds where the program's compute dtype rounds (the operands
of every matrix product, every linear layer's and norm's output; the
router's f32 logits are not rounded, as the program computes them in
f32).  The MoE balance loss is left out, as in the program (a
classification fine-tune).  Each decoder layer runs under
`torch.utils.checkpoint` (exact in f32: no dropout, deterministic
operations), so that the full-width f32 model, three AdamW steps and its
activations fit on one card.

The configuration is the benchmark's dict: DeepSeek's keys at its top
level, `n_routed_experts` the experts held here, `ep_size` and `ep_rank`
the deployment (the router has `n_routed_experts * ep_size` outputs; this
rank holds experts `[ep_rank * n_routed_experts, (ep_rank + 1) *
n_routed_experts)`).

It imports nothing of the port, of JAX or of the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from port_bench.reference import model
from port_bench.reference.model import Lowp, _lp

# the ViSoBERT encoder `model.FCMF` builds before its `bert.cell` is replaced
_UNUSED_TEXT = {"vocab_size": 1, "hidden_size": 1, "max_position_embeddings": 1,
                "type_vocab_size": 1, "layer_norm_eps": 1e-5, "num_hidden_layers": 0,
                "num_attention_heads": 1, "intermediate_size": 1, "pad_token_id": 0,
                "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


class RMSNorm(model.LayerNorm):
    """x * rsqrt(mean(x^2) + eps) * weight.  A `model.LayerNorm` only so that
    `train.no_decay`, which decides by module type, gives its scale no decay."""

    def __init__(self, dim: int, eps: float, lowp: Lowp = None):
        nn.Module.__init__(self)
        self.eps, self.lowp = eps, lowp
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight
        return _lp(self.lowp, y)[0]


class Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, lowp: Lowp = None):
        super().__init__()
        self.lowp = lowp
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))

    def forward(self, x):
        x, w = _lp(self.lowp, x, self.weight)
        return _lp(self.lowp, x @ w.T)[0]


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_inv_freq(c: dict) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inv_freq."""
    rs, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]
    orig = rs["original_max_position_embeddings"]
    low = max(math.floor(yarn_find_correction_dim(rs["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(yarn_find_correction_dim(rs["beta_slow"], dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def cos_sin(c: dict, length: int, device):
    rs = c["rope_scaling"]
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, yarn_inv_freq(c).to(device))
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_get_mscale(rs["factor"], rs["mscale"])
         / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]))
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x, cos, sin):
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


def softmax_scale(c: dict) -> float:
    rs = c["rope_scaling"]
    m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 * m * m


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

    def forward(self, x, additive_mask, cos, sin):
        c = self.c
        b, l, _ = x.shape
        n, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"], c["v_head_dim"])
        q = self.q_proj(x).view(b, l, n, nope + rope).transpose(1, 2)
        q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
        latent, k_pe = torch.split(self.kv_a_proj_with_mqa(x), [c["kv_lora_rank"], rope], dim=-1)
        k_pe = k_pe.view(b, l, 1, rope).transpose(1, 2)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(b, l, n, nope + vd).transpose(1, 2)
        k_nope, v = torch.split(kv, [nope, vd], dim=-1)
        q_pe, k_pe = apply_rotary(q_pe, cos, sin), apply_rotary(k_pe, cos, sin)
        query = torch.cat([q_nope, q_pe], -1)
        key = torch.cat([k_nope, k_pe.expand(b, n, l, rope)], -1)
        query, key = _lp(self.lowp, query, key)
        scores = query @ key.transpose(2, 3) * softmax_scale(c) + additive_mask
        probs = torch.softmax(scores, dim=-1, dtype=torch.float32)
        probs, v = _lp(self.lowp, probs, v)
        out = (probs @ v).transpose(1, 2).reshape(b, l, n * vd)
        return self.o_proj(out)


class MLP(nn.Module):
    def __init__(self, h: int, inter: int, lowp: Lowp):
        super().__init__()
        self.gate_proj = Linear(h, inter, lowp)
        self.up_proj = Linear(h, inter, lowp)
        self.down_proj = Linear(inter, h, lowp)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """MoEGate without the balance loss -> (experts [T, k], weights [T, k])."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.weight = nn.Parameter(torch.empty(c["n_routed_experts"] * c["ep_size"],
                                               c["hidden_size"]))

    def forward(self, x):
        c = self.c
        scores = F.linear(x, self.weight).softmax(dim=-1)
        weight, experts = torch.topk(scores, k=c["num_experts_per_tok"], dim=-1)
        if c["norm_topk_prob"]:
            weight = weight / weight.sum(dim=-1, keepdim=True)
        else:
            weight = weight * c["routed_scaling_factor"]
        return experts, weight


class Experts(nn.Module):
    """The held experts: `gate_up_proj[i]` is expert first + i's gate and up
    weights one above the other, `down_proj[i]` its down weight."""

    def __init__(self, c: dict, lowp: Lowp):
        super().__init__()
        self.c, self.lowp = c, lowp
        held, f, h = c["n_routed_experts"], c["moe_intermediate_size"], c["hidden_size"]
        self.gate_up_proj = nn.Parameter(torch.empty(held, 2 * f, h))
        self.down_proj = nn.Parameter(torch.empty(held, h, f))

    def forward(self, x, experts, weight):
        c = self.c
        first = c["ep_rank"] * c["n_routed_experts"]
        out = torch.zeros_like(x)
        for i in range(c["n_routed_experts"]):
            hit = experts == first + i                       # [T, k]: at most one slot a token
            rows = hit.any(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            xs, w13 = _lp(self.lowp, x[rows], self.gate_up_proj[i])
            g, u = _lp(self.lowp, xs @ w13.T)[0].chunk(2, -1)
            a, w2 = _lp(self.lowp, F.silu(g) * u, self.down_proj[i])
            y = _lp(self.lowp, a @ w2.T)[0]
            out = out.index_add(0, rows, y * (weight * hit).sum(-1)[rows, None])
        return out


class MoE(nn.Module):
    def __init__(self, c: dict, lowp: Lowp):
        super().__init__()
        self.lowp = lowp
        self.gate = Router(c)
        self.experts = Experts(c, lowp)
        self.shared_experts = MLP(c["hidden_size"],
                                  c["moe_intermediate_size"] * c["n_shared_experts"], lowp)

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1])
        experts, weight = self.gate(flat)
        routed = _lp(self.lowp, self.experts(flat, experts, weight))[0]
        return (routed + self.shared_experts(flat)).view(x.shape)


class Layer(nn.Module):
    def __init__(self, c: dict, index: int, lowp: Lowp):
        super().__init__()
        h = c["hidden_size"]
        self.self_attn = Attention(c, lowp)
        moe = index >= c["first_k_dense_replace"] and index % c["moe_layer_freq"] == 0
        self.mlp = MoE(c, lowp) if moe else MLP(h, c["intermediate_size"], lowp)
        self.input_layernorm = RMSNorm(h, c["rms_norm_eps"], lowp)
        self.post_attention_layernorm = RMSNorm(h, c["rms_norm_eps"], lowp)

    def forward(self, x, additive_mask, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), additive_mask, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class Backbone(nn.Module):
    """The decoder, then `text_proj` into the fusion's width; row 0 of the
    result is the last real token's state.  -> (sequence, None), the
    contract `model.FCMFEncoder` reads from `bert.cell`."""

    def __init__(self, c: dict, out_dim: int, lowp: Lowp = None):
        super().__init__()
        self.c, self.lowp = c, lowp
        h = c["hidden_size"]
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(torch.empty(c["vocab_size"], h))
        self.layers = nn.ModuleList(Layer(c, i, lowp) for i in range(c["num_hidden_layers"]))
        self.norm = RMSNorm(h, c["rms_norm_eps"], lowp)
        self.text_proj = model.Dense(h, out_dim, lowp)

    def hidden_states(self, ids, attention_mask):
        b, l = ids.shape
        h = _lp(self.lowp, F.embedding(ids, self.embed_tokens.weight))[0]
        allowed = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()[None, None] & (
            attention_mask[:, None, None, :] != 0)
        additive = torch.where(allowed, 0.0, torch.finfo(torch.float32).min)
        cos, sin = cos_sin(self.c, l, ids.device)
        for layer in self.layers:
            h = checkpoint(layer, h, additive, cos, sin, use_reentrant=False)
        return self.norm(h)

    def forward(self, ids, types, attention_mask, rng):
        h = self.hidden_states(ids, attention_mask)
        last = attention_mask.long().sum(1) - 1
        pooled = h[torch.arange(h.shape[0], device=h.device), last]
        return self.text_proj(torch.cat([pooled[:, None], h[:, 1:]], 1)), None


def FCMF(cfg: dict, lowp: Lowp = None) -> model.FCMF:
    """`model.FCMF` of the configuration's fusion, with `Backbone` as its
    `encoder.bert.cell`.  Turns TF32 off for the process: on the card a
    float32 product may otherwise run in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = model.FCMF(dict(cfg, text=_UNUSED_TEXT), lowp)
    m.encoder.bert.cell = Backbone(cfg, cfg["model"]["hidden_size"], lowp)
    return m
