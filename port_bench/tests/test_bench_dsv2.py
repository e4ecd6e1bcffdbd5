"""The cell `finetune.dsv2lite.cached` (configuration `fcmf_deepseek_v2_lite`,
entry `finetune_moe_step`): its manifest entries and files, its FLOP and
byte counts against hand counts, whole runs on the CPU at a tiny width
(sound runs correct, each planted fault not, a traced run reads its
metrics), and on the card: no host synchronisation inside the `moe` spans,
and the full-width backbone's forward against the reference's, layer by
layer.

    python -m pytest port_bench/tests/test_bench_dsv2.py -q -p no:cacheprovider
    python -m pytest port_bench/tests/test_bench_dsv2.py -q -m gpu -p no:cacheprovider -s
"""

import json
import os

import pytest
import torch

from conftest import BENCH, CHECKOUT
from port_bench.flops import counts, deepseek_v2 as flops
from port_bench.lib import bench

CELL, CONFIG = "finetune.dsv2lite.cached", "fcmf_deepseek_v2_lite"
SEED = 3 * 2 ** 30 + 11
NEW_METRICS = ("moe_host_ms.train", "experts_device_ms.train", "experts_roofline.train")
SHARED_METRICS = ("mfu.train", "idle_share.train", "launches_per_step.train",
                  "text_encoder_host_ms.train", "fusion_host_ms.train",
                  "backward_host_ms.train", "optimizer_host_ms.train")
# DeepSeek-V2-Lite's config.json (the model catalog's row)
PUBLISHED = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
             "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
             "max_position_embeddings": 163840, "model_type": "deepseek_v2",
             "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
             "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": False,
             "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
             "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
             "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                              "mscale_all_dim": 0.707,
                              "original_max_position_embeddings": 4096, "type": "yarn"},
             "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
             "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
             "topk_method": "greedy", "v_head_dim": 128, "vocab_size": 102400}
TINY = {"vocab_size": 120, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 3, "num_attention_heads": 2,
        "n_routed_experts": 2, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 8, "v_head_dim": 8}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_manifest_names_the_cell_and_its_metrics(manifest):
    cfg = next(c for c in manifest["configs"] if c["name"] == CONFIG)
    assert cfg["reduced"] == ["n_routed_experts"]
    assert "deepseek-ai/DeepSeek-V2-Lite" in cfg["source"]
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["chips"]) == (CONFIG, 1) and len(cell["why"]) <= 200
    metrics = {m["name"]: m for m in manifest["end_to_end"] + manifest["per_layer"]}
    assert CELL in metrics["train_samples_per_s"]["workloads"]
    for name in SHARED_METRICS:
        assert CELL in metrics[name]["workloads"], name
    for name in NEW_METRICS:
        assert metrics[name]["workloads"] == [CELL], name
        assert metrics[name]["moves"] == "train_samples_per_s"
    assert metrics["experts_roofline.train"]["unit"] == "%"


def test_the_configuration_is_the_published_one_but_the_experts_held():
    with open(os.path.join(BENCH, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    assert {k: cfg[k] for k in PUBLISHED if cfg[k] != PUBLISHED[k]} == {"n_routed_experts": 8}
    assert cfg["reduced"] == ["n_routed_experts"]
    assert (cfg["ep_size"], cfg["ep_rank"]) == (8, 0)
    assert flops.router_width(cfg) == 64


def test_counts_against_hand_counts():
    cfg = dict(PUBLISHED, n_routed_experts=8, ep_size=8, ep_rank=0, model={"hidden_size": 768})
    # one MLA layer over 2 sequences of 3 tokens: q 2048->16*192, kv_a 2048->576,
    # kv_b 512->16*256, o 16*128->2048; scores 192 and values 128 deep, 16 heads
    t = 6
    proj = 2 * t * (2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048)
    attn = 2 * 16 * 2 * (3 * 192 * 3 + 3 * 3 * 128)
    assert flops.mla_fwd(2, 3, cfg) == proj + attn
    assert flops.expected_held_rows(8160, cfg) == 6120
    assert flops.moe_layers(cfg) == 26
    # the seven grouped products of one MoE layer over 765 routes, bf16
    calls = flops.expert_calls(765, cfg, 2)
    gate_up, down = 2 * 765 * 2048 * 2816, 2 * 765 * 1408 * 2048
    # forward gate_up, down; gate_up again; d_a, d_down, d_gate_up, d_x
    assert [c["flop"] for c in calls] == [gate_up, down, gate_up, down, down, gate_up, gate_up]
    assert calls[0]["bytes"] == 2 * (765 * 2048 + 8 * 2048 * 2816 + 765 * 2816)
    assert calls[1]["bytes"] == 2 * (765 * 1408 + 8 * 1408 * 2048 + 765 * 2048)
    assert calls[4]["bytes"] == 2 * (765 * 2048 + 765 * 1408 + 8 * 2048 * 1408)
    assert flops.experts_bound_s(765, cfg, 2, counts.PEAK_BF16) == pytest.approx(
        sum(max(c["flop"] / 989e12, c["bytes"] / 3.35e12) for c in calls))
    # the backbone over one token a layer: 27 MLA layers, one dense SwiGLU,
    # 26 x (router 64, shared 2 x 1408, 0.75 held routes), text_proj
    want = 27 * flops.mla_fwd(1, 1, cfg) + 3 * 2 * 2048 * 10944 + 26 * (
        2 * 2048 * 64 + 3 * 2 * 2048 * 2816 + 3 * 2 * 0.75 * 2048 * 1408) + 2 * 2048 * 768
    assert flops.backbone_fwd(1, 1, cfg, 0.75) == pytest.approx(want)


def narrow_dsv2(files) -> None:
    """The configuration at a tiny width (`conftest.narrow` sizes the fusion)."""
    path = os.path.join(files.root, "configs", f"{CONFIG}.json")
    with open(path) as f:
        c = json.load(f)
    c.update(TINY)
    c["text"].update(bos_token_id=110, eos_token_id=111, pad_token_id=111)
    with open(path, "w") as f:
        json.dump(c, f)


def run(tiny_bench, trace=False):
    files, manifest = tiny_bench
    narrow_dsv2(files)
    return bench.run_cell(files, manifest, CELL, SEED, 0.3, trace, torch.device("cpu"))


def test_a_sound_traced_run_is_correct_and_reads_its_metrics(tiny_bench):
    """The traced stretch on the host's trace alone: the span readers find
    their spans; the device readers find no kernels and are left out."""
    out = run(tiny_bench, trace=True)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert m["moe_host_ms.train"]["value"] > 0 and m["text_encoder_host_ms.train"]["value"] > 0
    assert 0 < m["mfu.train"]["value"] < 100
    assert "experts_device_ms.train" not in m and "experts_roofline.train" not in m
    notes = out["notes"]
    assert notes["route_disagreement"] == 0.0  # f32 on both sides
    # 2 of 16 experts: an eighth of the 2 * 6 * 40 tokens' 6 routes, about
    assert 0.5 * 360 < notes["held_rows_per_layer"] < 1.5 * 360


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_a_planted_fault_is_not_correct(tiny_bench, monkeypatch, fault):
    from test_bench_cells import FAULTS

    FAULTS[fault](monkeypatch)
    out = run(tiny_bench)
    assert not out["correct"], out["check"]


def test_the_parent_program_fails_at_once(tiny_bench, monkeypatch):
    """A program without the DeepSeek-V2 backbone stops before any work."""
    import macsa_tpu_torch.config as port_config

    monkeypatch.delattr(port_config, "DeepseekV2Config")
    with pytest.raises(ImportError):
        run(tiny_bench)


def test_the_new_readers_find_nothing_without_spans_or_kernels(tiny_bench, monkeypatch):
    from macsa_tpu_torch.utils import logging as port_logging

    files, _ = tiny_bench

    class NoKernels:
        steps = 4

        def matching(self, *parts):
            return 0, 0.0

    for name in NEW_METRICS:
        assert files.module("metrics", name).read({"trace": NoKernels()}) is None, name
    monkeypatch.delattr(port_logging, "span_median")
    monkeypatch.delattr(port_logging, "SPANS")
    assert files.module("metrics", "moe_host_ms.train").read({}) is None
    assert files.module("metrics", "experts_roofline.train").read({"trace": NoKernels()}) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _full_width(card, layers: int):
    from port_bench.entries import finetune_moe_step

    with open(os.path.join(BENCH, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = layers
    return cfg, finetune_moe_step.port_configs(cfg, "bfloat16").text


@pytest.mark.gpu
def test_the_moe_spans_hold_no_host_synchronisation(card):
    """One MoE layer at full width over 48 x 170 tokens, forward and
    backward: no synchronising call (the sync debug mode raises on one), and
    in the host's trace no synchronise or blocking copy inside a `moe` span."""
    from macsa_tpu_torch.models import deepseek_v2 as port

    _, c = _full_width(card, 2)
    layer = port.MoE(c, device=card)
    from macsa_tpu_torch.models.layers import init_weights
    init_weights(layer, torch.Generator(card).manual_seed(1))
    x = torch.randn(48, 170, 2048, device=card, dtype=torch.bfloat16, requires_grad=True)
    (layer(x).float().square().mean()).backward()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (layer(x).float().square().mean()).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        y = layer(x)
    torch.cuda.synchronize()
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.name == "moe"]
    assert spans
    blocking = [e.name for e in events
                if any(s <= e.time_range.start <= t for s, t in spans)
                and ("Synchronize" in e.name or e.name in ("cudaMemcpy", "aten::item",
                                                           "aten::_local_scalar_dense"))]
    assert not blocking, blocking
    del y


@pytest.mark.gpu
def test_the_backbone_forward_at_full_width_layer_by_layer(card):
    """Each of the 27 layers, in bf16, against the f32 reference's layer on
    the reference's own input (one batch of 48 views, L 170): the relative
    Frobenius gap of each layer's output and the share of routes that
    differ; and the whole stack's final states."""
    from macsa_tpu_torch.models import deepseek_v2 as port
    from port_bench.entries import finetune_moe_step
    from port_bench.lib import traffic
    from port_bench.reference import deepseek_v2 as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, c = _full_width(card, 27)
    with torch.device(card):
        want = ref.Backbone(cfg, cfg["model"]["hidden_size"])
    state = finetune_moe_step.model_state(cfg, SEED, card)
    want.load_state_dict({k[len("encoder.bert.cell."):]: v for k, v in state.items()
                          if k.startswith("encoder.bert.cell.")})
    got = port.DeepseekV2Encoder(c, cfg["model"]["hidden_size"], device=card)
    got.load_state_dict(want.state_dict())
    del state
    ctx = bench.Ctx(CELL, {"traffic": {"rows": 48, "batch": 8, "text_len": [24, 170],
                                       "label_probs": [0.7, 0.1, 0.05, 0.15],
                                       "max_steps": 1}},
                    cfg, SEED, 0.0, False, card, 0.0)
    pool, _ = finetune_moe_step.inputs(ctx)
    ids = torch.as_tensor(pool["input_ids"][:8].reshape(48, -1), device=card).long()
    mask = torch.as_tensor(pool["attention_mask"][:8].reshape(48, -1), device=card)
    gaps = []
    with torch.no_grad():
        additive = torch.where(port.causal_padding_mask(mask), 0.0, torch.finfo(torch.float32).min)
        cos, sin = ref.cos_sin(cfg, 170, card)
        pmask = port.causal_padding_mask(mask)
        pcos, psin = port.rope_tables(got.inv_freq, 170, got.mscale)
        h = torch.nn.functional.embedding(ids, want.embed_tokens.weight)
        for i, (p, r) in enumerate(zip(got.layers, want.layers)):
            routes = {}
            if hasattr(p.mlp, "gate"):
                for name, m in (("port", p.mlp.gate), ("ref", r.mlp.gate)):
                    def keep(mod, args, out, name=name):
                        routes.setdefault(name, out[0])
                    m._forward_hooks.clear()
                    m.register_forward_hook(keep)
            out_r = r(h, additive, cos, sin)
            out_p = p(h.to(torch.bfloat16), pmask, pcos, psin).float()
            gap = float((out_p - out_r).norm() / out_r.norm())
            differ = 0.0
            if routes:
                a, b = routes["port"], routes["ref"]
                differ = 1 - float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())
            gaps.append((i, gap, differ))
            h = out_r
        final_gap = float((got.hidden_states(ids, mask).float() - want.hidden_states(ids, mask)
                           ).norm() / want.hidden_states(ids, mask).norm())
    print(json.dumps({"layers": gaps, "final_states_gap": final_gap}))
    assert all(g < 2e-2 for _, g, _ in gaps), gaps
    assert final_gap < 5e-2
    assert all(d < 0.05 for *_, d in gaps), gaps
