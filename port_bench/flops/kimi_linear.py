"""Operations and bytes of the FCMF step with Kimi Linear as its text
backbone (configuration `fcmf_kimi_linear_48b_a3b`), counted from shapes,
with `counts.py`'s conventions (a product [m, k] x [k, n] is 2*m*k*n; a
trained module's forward counts three times in a step; norms, gates,
convolutions, softmax, routing and lookups are not counted; a kernel call
reads each input once and writes each output once).

The KDA core's work is that of the chunked form at `KDA_CHUNK` = 64
positions a chunk, whatever chunk the program uses, so that any
implementation of the core is held to the same work.  Per head and chunk
of C positions, head width D (keys and values alike): the pairwise
products k k^T and q k^T (2 C^2 D each), the unit-triangular solve with the
2D columns of [beta K~ | beta V] (C^2 * 2D), the state's three products W
S, (exp(G) q) S and (exp(G_last - G) k)^T U (2 C D^2 each) and A_qk U
(2 C^2 D): 8 C^2 D + 6 C D^2, over every chunk of the padded length.  Its
bytes: q, k, v read and o written in the compute dtype, g (f32, one a key
channel) and beta (f32, one a head) read.

The MoE layers are `deepseek_v2.py`'s count under Kimi's key names: the
held experts' products at the routes each layer's `moe` span counted, and
for `mfu.train` the routes an expert gets in expectation.
"""

from __future__ import annotations

import math

from port_bench.flops import deepseek_v2 as ds
from port_bench.flops.counts import bound_s, classifier_fwd, fcmf_fusion_fwd, mm

KDA_CHUNK = 64


def as_deepseek(cfg: dict) -> dict:
    """Kimi's MoE keys under the names `flops/deepseek_v2.py` reads."""
    return dict(cfg, n_routed_experts=cfg["num_experts"],
                n_shared_experts=cfg["num_shared_experts"],
                num_experts_per_tok=cfg["num_experts_per_token"])


def router_width(cfg: dict) -> int:
    """The router's outputs: every expert of the deployment."""
    return ds.router_width(as_deepseek(cfg))


def kda_layer_count(cfg: dict) -> int:
    return sum(1 for i in cfg["linear_attn_config"]["kda_layers"]
               if i <= cfg["num_hidden_layers"])


def kda_core(seqs: int, length: int, cfg: dict, elt: int) -> dict:
    """One KDA layer's core over `seqs` sequences of `length` positions."""
    lin = cfg["linear_attn_config"]
    h, d, c = lin["num_heads"], lin["head_dim"], KDA_CHUNK
    chunks = math.ceil(length / c)
    tokens = seqs * length * h
    return {"flop": seqs * h * chunks * (8 * c * c * d + 6 * c * d * d),
            "bytes": tokens * d * (4 * elt + 4) + tokens * 4}


def kda_core_bound_s(seqs: int, length: int, cfg: dict, elt: int, peak_flops: float) -> float:
    return bound_s(kda_core(seqs, length, cfg, elt), peak_flops)


def kda_fwd(seqs: int, length: int, cfg: dict) -> float:
    """One KDA layer: q, k, v, o; the decay and output gates' low-rank
    pairs; beta's projection; the core."""
    lin = cfg["linear_attn_config"]
    t, h, n, d = seqs * length, cfg["hidden_size"], lin["num_heads"], lin["head_dim"]
    proj = 4 * mm(t, h, n * d) + 2 * (mm(t, h, d) + mm(t, d, n * d)) + mm(t, h, n)
    return proj + kda_core(seqs, length, cfg, 2)["flop"]


def expected_held_rows(tokens: int, cfg: dict) -> float:
    return ds.expected_held_rows(tokens, as_deepseek(cfg))


def backbone_fwd(seqs: int, length: int, cfg: dict, held_rows: float) -> float:
    """The decoder and `text_proj`, with `held_rows` routes a MoE layer."""
    t, h, n = seqs * length, cfg["hidden_size"], cfg["num_hidden_layers"]
    kda = kda_layer_count(cfg)
    moe = ds.moe_layers(cfg)
    flop = kda * kda_fwd(seqs, length, cfg) + (n - kda) * ds.mla_fwd(seqs, length, cfg)
    flop += (n - moe) * ds.swiglu_fwd(t, h, cfg["intermediate_size"])
    f = cfg["moe_intermediate_size"]
    flop += moe * (mm(t, h, router_width(cfg))
                   + ds.swiglu_fwd(t, h, f * cfg["num_shared_experts"])
                   + ds.swiglu_fwd(held_rows, h, f))
    return flop + mm(t, h, cfg["model"]["hidden_size"])


def finetune_step(cfg: dict, batch: int, aspects: int, length: int) -> float:
    """One fine-tune step over B*A views: the whole FCMF trained (x3), the
    held experts at the routes they get in expectation."""
    seqs = batch * aspects
    model = (backbone_fwd(seqs, length, cfg, expected_held_rows(seqs * length, cfg))
             + fcmf_fusion_fwd(seqs, length, cfg) + classifier_fwd(seqs, cfg))
    return 3 * model


def experts_bound_s(rows: int, cfg: dict, elt: int, peak_flops: float) -> float:
    """The least time of one MoE layer's grouped products in a step."""
    return ds.experts_bound_s(rows, as_deepseek(cfg), elt, peak_flops)
