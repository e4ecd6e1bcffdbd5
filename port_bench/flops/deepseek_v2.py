"""Operations and bytes of the FCMF step with DeepSeek-V2 as its text
backbone (configuration `fcmf_deepseek_v2_lite`), counted from shapes, with
`counts.py`'s conventions: a product [m, k] x [k, n] is 2*m*k*n; a trained
module's forward counts three times in a step; norms, rope, softmax,
routing and lookups are not counted; a kernel call reads each input once
and writes each output once.

The MoE layers' held experts work on the routes sent to them, a count
that depends on the data (`rows`): the grouped products' bounds take the
count each MoE layer's span recorded, and the step's FLOP for `mfu.train`
the routes an expert gets in expectation, tokens * k / experts (the
router's softmax over random weights is symmetric in the experts).
"""

from __future__ import annotations

from typing import List

from port_bench.flops.counts import bound_s, classifier_fwd, fcmf_fusion_fwd, mm


def router_width(cfg: dict) -> int:
    """The router's outputs: every expert of the deployment."""
    return cfg["n_routed_experts"] * cfg["ep_size"]


def expected_held_rows(tokens: int, cfg: dict) -> float:
    return tokens * cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / router_width(cfg)


def moe_layers(cfg: dict) -> int:
    n, dense, freq = cfg["num_hidden_layers"], cfg["first_k_dense_replace"], cfg["moe_layer_freq"]
    return sum(1 for i in range(n) if i >= dense and i % freq == 0)


def mla_fwd(seqs: int, length: int, cfg: dict) -> float:
    """One latent-attention layer over `seqs` sequences of `length`."""
    t, h, n = seqs * length, cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    proj = (mm(t, h, n * (nope + rope)) + mm(t, h, r + rope) + mm(t, r, n * (nope + vd))
            + mm(t, n * vd, h))
    attn = seqs * n * (mm(length, nope + rope, length) + mm(length, length, vd))
    return proj + attn


def swiglu_fwd(rows: float, h: int, inter: int) -> float:
    return 3 * mm(rows, h, inter)


def backbone_fwd(seqs: int, length: int, cfg: dict, held_rows: float) -> float:
    """The decoder and `text_proj`, with `held_rows` routes a MoE layer."""
    t, h = seqs * length, cfg["hidden_size"]
    moe = moe_layers(cfg)
    flop = cfg["num_hidden_layers"] * mla_fwd(seqs, length, cfg)
    flop += (cfg["num_hidden_layers"] - moe) * swiglu_fwd(t, h, cfg["intermediate_size"])
    f = cfg["moe_intermediate_size"]
    flop += moe * (mm(t, h, router_width(cfg)) + swiglu_fwd(t, h, f * cfg["n_shared_experts"])
                   + swiglu_fwd(held_rows, h, f))
    return flop + mm(t, h, cfg["model"]["hidden_size"])


def finetune_step(cfg: dict, batch: int, aspects: int, length: int) -> float:
    """One fine-tune step over B*A views: the whole FCMF trained (x3), the
    held experts at the routes they get in expectation."""
    seqs = batch * aspects
    model = (backbone_fwd(seqs, length, cfg, expected_held_rows(seqs * length, cfg))
             + fcmf_fusion_fwd(seqs, length, cfg) + classifier_fwd(seqs, cfg))
    return 3 * model


def expert_calls(rows: int, cfg: dict, elt: int) -> List[dict]:
    """The grouped products of one MoE layer in a train step, as the port's
    `HeldExperts` runs them over `rows` routes and the G held experts:
    gate_up [rows, D] x G [D, 2F] and down [rows, F] x G [F, D]; gate_up
    again in the backward; then d_a = dy x G [D, F], d_down = dy^T a (a
    [D, rows] x [rows, F] product whose output is G matrices), d_gate_up =
    dh^T x the same way, and d_x = dh x G [2F, D]."""
    d, f, g = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]

    def rows_times_weights(k, n):
        return {"flop": mm(rows, k, n), "bytes": elt * (rows * k + g * k * n + rows * n)}

    def weight_gradient(k, n):
        return {"flop": mm(k, rows, n), "bytes": elt * (rows * k + rows * n + g * k * n)}

    gate_up = rows_times_weights(d, 2 * f)
    return [gate_up, rows_times_weights(f, d), gate_up, rows_times_weights(d, f),
            weight_gradient(d, f), weight_gradient(2 * f, d), rows_times_weights(2 * f, d)]


def experts_bound_s(rows: int, cfg: dict, elt: int, peak_flops: float) -> float:
    """The least time of one MoE layer's grouped products in a step."""
    return sum(bound_s(c, peak_flops) for c in expert_calls(rows, cfg, elt))
