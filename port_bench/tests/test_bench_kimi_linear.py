"""The cell `finetune.kimilinear.cached` (configuration
`fcmf_kimi_linear_48b_a3b`, entry `finetune_kimi_step`): its manifest
entries and files, its FLOP and byte counts against hand counts, whole
runs on the CPU at a tiny width (sound runs correct, each planted fault
not, a traced run reads its metrics, the parent program stops at once),
and on the card: the full-width backbone's first layers against the
reference's, layer by layer, and the KDA block's memory and time.

    python -m pytest port_bench/tests/test_bench_kimi_linear.py -q -p no:cacheprovider
    python -m pytest port_bench/tests/test_bench_kimi_linear.py -q -m gpu -p no:cacheprovider -s
"""

import json
import os

import pytest
import torch

from conftest import BENCH, CHECKOUT
from port_bench.flops import counts, kimi_linear as flops
from port_bench.lib import bench

CELL, CONFIG = "finetune.kimilinear.cached", "fcmf_kimi_linear_48b_a3b"
SEED = 3 * 2 ** 30 + 23
NEW_METRICS = ("kda_host_ms.train", "kda_device_ms.train", "kda_fwd_roofline.train")
SHARED_METRICS = ("mfu.train", "idle_share.train", "launches_per_step.train",
                  "graph_replays.train", "text_encoder_host_ms.train", "fusion_host_ms.train",
                  "backward_host_ms.train", "optimizer_host_ms.train", "moe_host_ms.train",
                  "experts_device_ms.train", "experts_roofline.train")
KDA = [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26]
# Kimi-Linear-48B-A3B-Instruct's config.json (the model catalog's row)
PUBLISHED = {"first_k_dense_replace": 1, "head_dim": 72, "hidden_act": "silu",
             "hidden_size": 2304, "intermediate_size": 9216, "kv_lora_rank": 512,
             "linear_attn_config": {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27],
                                    "head_dim": 128, "kda_layers": KDA, "num_heads": 32,
                                    "short_conv_kernel_size": 4},
             "mla_use_nope": True, "model_max_length": 1048576, "model_type": "kimi_linear",
             "moe_intermediate_size": 1024, "moe_layer_freq": 1, "moe_renormalize": True,
             "moe_router_activation_func": "sigmoid", "num_attention_heads": 32,
             "num_expert_group": 1, "num_experts": 256, "num_experts_per_token": 8,
             "num_hidden_layers": 27, "num_key_value_heads": 32, "num_nextn_predict_layers": 0,
             "num_shared_experts": 1, "q_lora_rank": None, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_scaling": None,
             "rope_theta": 10000, "routed_scaling_factor": 2.446, "tie_word_embeddings": False,
             "topk_group": 1, "use_grouped_topk": True, "v_head_dim": 128,
             "vocab_size": 163840}
TINY = {"vocab_size": 120, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 5, "num_attention_heads": 2,
        "num_key_value_heads": 2, "num_experts": 2, "ep_size": 8, "num_experts_per_token": 4,
        "kv_lora_rank": 16, "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8,
        "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5],
                               "head_dim": 8, "num_heads": 2, "short_conv_kernel_size": 4}}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_manifest_names_the_cell_and_its_metrics(manifest):
    cfg = next(c for c in manifest["configs"] if c["name"] == CONFIG)
    assert "moonshotai/Kimi-Linear-48B-A3B-Instruct" in cfg["source"]
    assert "num_experts" in cfg["reduced"]
    cell = next(w for w in manifest["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["chips"]) == (CONFIG, 1) and len(cell["why"]) <= 200
    metrics = {m["name"]: m for m in manifest["end_to_end"] + manifest["per_layer"]}
    assert CELL in metrics["train_samples_per_s"]["workloads"]
    for name in SHARED_METRICS:
        assert CELL in metrics[name]["workloads"], name
    for name in NEW_METRICS:
        assert metrics[name]["workloads"] == [CELL], name
        assert metrics[name]["moves"] == "train_samples_per_s"
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{name}.py"))
    assert metrics["kda_fwd_roofline.train"]["unit"] == "%"
    assert metrics["kda_host_ms.train"]["source"] == "program_span"


def test_the_configuration_is_the_published_one_but_what_it_lists():
    with open(os.path.join(BENCH, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    changed = {k for k in PUBLISHED if cfg[k] != PUBLISHED[k]}
    assert changed == set(cfg["reduced"])
    assert cfg["num_experts"] == 8 and (cfg["ep_size"], cfg["ep_rank"]) == (32, 0)
    assert flops.router_width(cfg) == 256
    lin = cfg["linear_attn_config"]
    # a cut drops whole periods of 3 KDA + 1 MLA layers and renumbers the rest
    assert sorted(lin["kda_layers"] + lin["full_attn_layers"]) == list(
        range(1, cfg["num_hidden_layers"] + 1))
    assert (27 - cfg["num_hidden_layers"]) % 4 == 0
    assert {k: v for k, v in lin.items() if "layers" not in k} == {
        "head_dim": 128, "num_heads": 32, "short_conv_kernel_size": 4}
    for key in ("deployment", "assumed", "text", "model", "compute_dtype", "resnet"):
        assert key in cfg, key
    assert all(0 <= v < cfg["vocab_size"] for v in cfg["text"].values())


def test_counts_against_hand_counts():
    cfg = dict(PUBLISHED, num_experts=8, ep_size=32, ep_rank=0, model={"hidden_size": 768})
    # the KDA core over 2 sequences of 170 (3 chunks of 64), 32 heads of 128
    c, d = 64, 128
    core = flops.kda_core(2, 170, cfg, 2)
    assert core["flop"] == 2 * 32 * 3 * (8 * c * c * d + 6 * c * d * d)
    assert core["bytes"] == 2 * 170 * 32 * (128 * (4 * 2 + 4) + 4)
    assert flops.kda_core_bound_s(48, 170, cfg, 2, counts.PEAK_BF16) == pytest.approx(
        max(48 * 32 * 3 * (8 * c * c * d + 6 * c * d * d) / 989e12,
            48 * 170 * 32 * (128 * 12 + 4) / 3.35e12))
    # one KDA layer over one token: q, k, v, o 2304 x 4096; f_a, g_a 2304 x 128;
    # f_b, g_b 128 x 4096; b 2304 x 32; the core (one chunk of 64 for 1 token)
    proj = 2 * (4 * 2304 * 4096 + 2 * (2304 * 128 + 128 * 4096) + 2304 * 32)
    assert flops.kda_fwd(1, 1, cfg) == proj + 32 * (8 * c * c * d + 6 * c * d * d)
    assert flops.kda_layer_count(cfg) == 20
    assert flops.expected_held_rows(8160, cfg) == 8160 * 8 * 8 / 256
    # the backbone: 20 KDA, 7 NoPE MLA (the DeepSeek count), one dense SwiGLU,
    # 26 x (router 256, one shared 1024, held routes), text_proj
    from port_bench.flops import deepseek_v2 as ds
    held = 0.25
    want = (20 * flops.kda_fwd(1, 1, cfg) + 7 * ds.mla_fwd(1, 1, cfg) + 3 * 2 * 2304 * 9216
            + 26 * (2 * 2304 * 256 + 3 * 2 * 2304 * 1024 + 3 * 2 * held * 2304 * 1024)
            + 2 * 2304 * 768)
    assert flops.backbone_fwd(1, 1, cfg, held) == pytest.approx(want)
    # the held experts' seven grouped products: DeepSeek's count at Kimi's widths
    calls = ds.expert_calls(255, flops.as_deepseek(cfg), 2)
    assert calls[0]["flop"] == 2 * 255 * 2304 * 2048
    assert calls[0]["bytes"] == 2 * (255 * 2304 + 8 * 2304 * 2048 + 255 * 2048)
    assert flops.experts_bound_s(255, cfg, 2, counts.PEAK_BF16) == pytest.approx(
        sum(max(x["flop"] / 989e12, x["bytes"] / 3.35e12) for x in calls))


def narrow_kimi(files) -> None:
    """The configuration at a tiny width (`conftest.narrow` sizes the fusion)."""
    path = os.path.join(files.root, "configs", f"{CONFIG}.json")
    with open(path) as f:
        c = json.load(f)
    c.update(TINY)
    c["text"].update(bos_token_id=110, eos_token_id=111, pad_token_id=119)
    with open(path, "w") as f:
        json.dump(c, f)


def run(tiny_bench, trace=False):
    files, manifest = tiny_bench
    narrow_kimi(files)
    return bench.run_cell(files, manifest, CELL, SEED, 0.3, trace, torch.device("cpu"))


def test_a_sound_traced_run_is_correct_and_reads_its_metrics(tiny_bench):
    """The traced stretch on the host's trace alone: the span readers find
    their spans; the device readers find no kernels or events and are left
    out."""
    out = run(tiny_bench, trace=True)
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert m["kda_host_ms.train"]["value"] > 0 and m["moe_host_ms.train"]["value"] > 0
    assert m["text_encoder_host_ms.train"]["value"] > m["kda_host_ms.train"]["value"]
    assert 0 < m["mfu.train"]["value"] < 100
    for name in ("kda_device_ms.train", "kda_fwd_roofline.train", "experts_roofline.train"):
        assert name not in m, name
    notes = out["notes"]
    assert notes["route_disagreement"] == 0.0  # f32 on both sides
    # 2 of 16 experts: an eighth of the 2 * 6 * 40 tokens' 4 routes, about
    assert 0.5 * 240 < notes["held_rows_per_layer"] < 1.5 * 240


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer"])
def test_a_planted_fault_is_not_correct(tiny_bench, monkeypatch, fault):
    from test_bench_cells import FAULTS

    FAULTS[fault](monkeypatch)
    out = run(tiny_bench)
    assert not out["correct"], out["check"]


def test_the_parent_program_fails_at_once(tiny_bench, monkeypatch):
    """A program without the Kimi Linear backbone stops before any work."""
    import macsa_tpu_torch.config as port_config

    monkeypatch.delattr(port_config, "KimiLinearConfig")
    with pytest.raises(ImportError):
        run(tiny_bench)


def test_the_new_readers_find_nothing_without_spans(tiny_bench, monkeypatch):
    from macsa_tpu_torch.utils import logging as port_logging

    files, _ = tiny_bench

    class NoKernels:
        steps = 4

        def matching(self, *parts):
            return 0, 0.0

    port_logging.SPANS.end_episode()
    for name in NEW_METRICS:
        assert files.module("metrics", name).read(
            {"trace": NoKernels(), "kda_core_bound_s": lambda s, l: 1.0}) is None, name
    monkeypatch.delattr(port_logging, "span_median")
    monkeypatch.delattr(port_logging, "SPANS")
    for name in NEW_METRICS:
        assert files.module("metrics", name).read({"trace": NoKernels()}) is None, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _full_width(layers: int):
    from port_bench.entries import finetune_kimi_step

    with open(os.path.join(BENCH, "configs", f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = layers
    lin = cfg["linear_attn_config"]
    lin["kda_layers"] = [i for i in lin["kda_layers"] if i <= layers]
    lin["full_attn_layers"] = [i for i in lin["full_attn_layers"] if i <= layers]
    return cfg, finetune_kimi_step.port_configs(cfg, "bfloat16").text


@pytest.mark.gpu
def test_the_backbone_forward_at_full_width_layer_by_layer(card):
    """Layers 1-5 (KDA with the dense MLP, KDA and MLA with MoE), in bf16,
    against the f32 reference's layer on the reference's own input (one
    batch of 48 views, L 170): the relative Frobenius gap of each layer's
    output, the share of routes that differ, and the KDA core alone, bf16
    q, k, v against the f32 recurrence on the same inputs."""
    from macsa_tpu_torch.models import deepseek_v2 as ds_port
    from macsa_tpu_torch.models import kimi_linear as port
    from macsa_tpu_torch.ops import kda
    from port_bench.entries import finetune_kimi_step
    from port_bench.reference import kimi_linear as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, c = _full_width(5)
    with torch.device(card):
        want = ref.Backbone(cfg, cfg["model"]["hidden_size"])
    state = finetune_kimi_step.model_state(cfg, SEED, card)
    want.load_state_dict({k[len("encoder.bert.cell."):]: v for k, v in state.items()
                          if k.startswith("encoder.bert.cell.")})
    got = port.KimiLinearEncoder(c, cfg["model"]["hidden_size"], device=card)
    got.load_state_dict(want.state_dict())
    del state
    ctx = bench.Ctx(CELL, {"traffic": {"rows": 48, "batch": 8, "text_len": [24, 170],
                                       "label_probs": [0.7, 0.1, 0.05, 0.15],
                                       "max_steps": 1}},
                    cfg, SEED, 0.0, False, card, 0.0)
    from port_bench.entries import finetune_moe_step
    pool, _ = finetune_moe_step.inputs(ctx)
    ids = torch.as_tensor(pool["input_ids"][:8].reshape(48, -1), device=card).long()
    mask = torch.as_tensor(pool["attention_mask"][:8].reshape(48, -1), device=card)
    gaps = []
    with torch.no_grad():
        additive = torch.where(ds_port.causal_padding_mask(mask), 0.0,
                               torch.finfo(torch.float32).min)
        pmask = ds_port.causal_padding_mask(mask)
        h = torch.nn.functional.embedding(ids, want.embed_tokens.weight)
        for i, (p, r) in enumerate(zip(got.layers, want.layers)):
            routes = {}
            if hasattr(p.mlp, "gate"):
                for name, m in (("port", p.mlp.gate), ("ref", r.mlp.gate)):
                    def keep(mod, args, out, name=name):
                        routes.setdefault(name, out[0])
                    m._forward_hooks.clear()
                    m.register_forward_hook(keep)
            out_r = r(h, additive)
            out_p = p(h.to(torch.bfloat16), pmask).float()
            gap = float((out_p - out_r).norm() / out_r.norm())
            differ = 0.0
            if routes:
                a, b = routes["port"], routes["ref"]
                differ = 1 - float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())
            gaps.append((i, gap, differ))
            h = out_r
        gen = torch.Generator(card).manual_seed(1)
        q, k, v = (torch.randn(48, 170, 32, 128, device=card, generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        g = -11 * torch.rand(48, 170, 32, 128, device=card, generator=gen)
        beta = torch.rand(48, 170, 32, device=card, generator=gen)
        o = kda.chunk_kda(q, k, v, g, beta, torch.float32)
        qf, kf = kda.l2norm(q.float()) * 128 ** -0.5, kda.l2norm(k.float())
        core_gap = float((o - ref.kda_recurrence(qf, kf, v.float(), g, beta)).norm()
                         / o.norm())
    print(json.dumps({"layers": gaps, "core_gap": core_gap}))
    assert core_gap < 1e-4
    assert all(g < 3e-2 for _, g, _ in gaps), gaps
    assert all(d < 0.05 for *_, d in gaps), gaps


@pytest.mark.gpu
def test_a_kda_block_step_at_full_width(card):
    """One KDA block over 48 x 170 tokens in bf16, forward and backward:
    the memory it holds between them (its inputs, not the chunked form's
    intermediates), the backward's transient peak and the device time of
    each, printed; no synchronising call inside."""
    from macsa_tpu_torch.models import kimi_linear as port
    from macsa_tpu_torch.models.layers import init_weights

    _, c = _full_width(1)
    block = port.KimiDeltaAttention(c, device=card)
    init_weights(block, torch.Generator(card).manual_seed(1))
    x = torch.randn(48, 170, 2304, device=card, dtype=torch.bfloat16, requires_grad=True)
    block(x).float().square().mean().backward()  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev[0].record()
        y = block(x)
        ev[1].record()
        held = torch.cuda.memory_allocated() - base
        y.float().square().mean().backward()
        ev[2].record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(json.dumps({"held_mb": held / 2 ** 20, "peak_mb": peak / 2 ** 20,
                      "fwd_ms": ev[0].elapsed_time(ev[1]), "bwd_ms": ev[1].elapsed_time(ev[2])}))
    assert held < 1.0 * 2 ** 30
