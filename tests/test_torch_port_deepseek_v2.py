"""DeepSeek-V2 as FCMF's text backbone (`models/deepseek_v2.py`) against the
benchmark's plain f32 reference (`port_bench/reference/deepseek_v2.py`) at a
tiny width on the CPU, on seeded random weights.

* the backbone's hidden states and FCMF's logits agree to f32 rounding,
* the harness's three AdamW steps (loss, first gradients, changes) too,
* YaRN's inv_freq, cos/sin and softmax scale against their formulas,
* the router's top-k and weights against a direct computation,
* the share: over ep_rank 0..ep_size-1, the ranks' routed parts, with the
  shared experts counted once, add up to the uncut reference layer,
* the held experts' gradients against autograd through the reference,
* `no_decay_names` covers RMSNorm, and a local `config.json` of
  `model_type: deepseek_v2` builds `DeepseekV2Config`.
"""

import json
import math

import numpy as np
import pytest
import torch

from macsa_tpu_torch.config import DeepseekV2Config
from macsa_tpu_torch.models import deepseek_v2 as port
from macsa_tpu_torch.train import common, optim
from port_bench.entries import finetune_moe_step
from port_bench.lib import traffic, weights
from port_bench.reference import deepseek_v2 as ref
from port_bench.reference.train import state_for

SEED = 2 ** 31 + 19

# DeepSeek-V2-Lite's keys at a tiny width: 1 dense + 2 MoE layers, the router
# over 16 experts, this rank holding 2 of them (ep_size 8), top-6
TINY = {"vocab_size": 96, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 3, "first_k_dense_replace": 1,
        "moe_layer_freq": 1, "num_attention_heads": 2, "n_routed_experts": 2,
        "n_shared_experts": 2, "num_experts_per_tok": 6, "routed_scaling_factor": 1,
        "norm_topk_prob": False, "scoring_func": "softmax", "topk_method": "greedy",
        "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 8,
        "qk_rope_head_dim": 8, "v_head_dim": 8, "rope_theta": 10000,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "max_position_embeddings": 163840, "rms_norm_eps": 1e-6, "ep_size": 8, "ep_rank": 0,
        "model_type": "deepseek_v2", "attention_bias": False, "hidden_act": "silu",
        "text": {"bos_token_id": 90, "eos_token_id": 91, "pad_token_id": 91},
        "model": {"hidden_size": 24, "num_hidden_layers": 1, "num_attention_heads": 2,
                  "intermediate_size": 32, "hidden_dropout_prob": 0.1,
                  "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12},
        "num_imgs": 2, "num_roi": 2, "num_labels": 4, "num_patches": 49,
        "visual_feat_dim": 16, "max_text_len": 12, "box_heads": 2, "aspects": 6,
        "compute_dtype": {"train": "float32"}}


def tiny(**kw):
    return dict(TINY, **kw)


def port_config(cfg) -> DeepseekV2Config:
    return finetune_moe_step.port_configs(cfg, "float32").text


def seeded(module, seed=SEED):
    shapes, norms = weights.shapes_of(module)
    return weights.seeded_state(shapes, norms, seed, "cpu", std=0.2)


def ids_and_mask(b=3, length=12, vocab=96):
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, vocab, (b, length), generator=g)
    mask = torch.ones(b, length, dtype=torch.int64)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, mask


def test_backbone_hidden_states_and_output_match_the_reference():
    cfg = tiny()
    want = ref.Backbone(cfg, 24)
    state = seeded(want)
    want.load_state_dict(state)
    got = port.DeepseekV2Encoder(port_config(cfg), 24)
    got.load_state_dict(state)
    ids, mask = ids_and_mask()
    with torch.no_grad():
        torch.testing.assert_close(got.hidden_states(ids, mask), want.hidden_states(ids, mask),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got(ids, None, mask)[0], want(ids, None, mask, None)[0],
                                   rtol=1e-5, atol=1e-5)


def test_fcmf_logits_match_the_reference():
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.layers import DropoutRng
    from macsa_tpu_torch.train.steps import fcmf_forward_all_aspects
    from port_bench.reference import model as ref_model

    cfg = tiny()
    want = ref.FCMF(cfg)
    state = seeded(want)
    want.load_state_dict(state_for(want, state))
    got = FCMF(finetune_moe_step.port_configs(cfg, "float32"))
    got.load_state_dict(state)
    ids, mask = ids_and_mask(12)
    g = torch.Generator().manual_seed(7)
    batch = {"input_ids": ids.view(2, 6, -1), "attention_mask": mask.view(2, 6, -1),
             "token_type_ids": torch.zeros_like(ids).view(2, 6, -1),
             "added_mask": torch.ones(2, 6, 12 + 49, dtype=torch.int64),
             "roi_coors": torch.as_tensor(traffic.boxes(traffic.host_rng(SEED, 1), (2, 2, 2))),
             "grid": torch.rand(2, 2, 49, 16, generator=g),
             "roi": torch.rand(2, 2, 2, 16, generator=g)}
    got.train(), want.train()
    logits = fcmf_forward_all_aspects(got, torch.nn.Module(), batch,
                                      DropoutRng.for_step(SEED, 2, "cpu"))
    torch.testing.assert_close(
        logits, ref_model.fcmf_all_aspects(want, batch, batch["grid"], batch["roi"],
                                           ref_model.StepRng(SEED, 2, "cpu")),
        rtol=1e-5, atol=1e-5)


def test_three_adamw_steps_match_the_reference(tmp_path):
    """Loss, first gradients and changes over three steps through the
    benchmark's own comparison, the program in f32."""
    import os
    import shutil
    import time

    from port_bench.lib import bench

    root = tmp_path / "pb"
    bench_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "port_bench")
    shutil.copytree(bench_dir, root, ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                                   "_cache"))
    with open(root / "configs" / "fcmf_deepseek_v2_lite.json", "w") as f:
        json.dump(tiny(resnet={"stage_sizes": [1, 1, 1, 1], "num_filters": 2,
                               "image_size": 224}), f)
    with open(root / "workloads" / "finetune.dsv2lite.cached.json") as f:
        w = json.load(f)
    w["traffic"].update(rows=16, batch=2, text_len=[4, 12], max_steps=20, warm_steps=1,
                        trace_steps=1)
    with open(root / "workloads" / "finetune.dsv2lite.cached.json", "w") as f:
        json.dump(w, f)
    files = bench.Files(str(root))
    manifest = {"end_to_end": [], "per_layer": []}
    out = bench.run_cell(files, manifest, "finetune.dsv2lite.cached", SEED, 0.05, False,
                         torch.device("cpu"), time.perf_counter())
    numbers = {k: v["value"] for k, v in out["check"].items()}
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers
    assert out["notes"]["route_disagreement"] == 0.0
    assert out["notes"]["held_rows_per_layer"] > 0


def test_yarn_tables_and_softmax_scale_follow_the_formulas():
    c = DeepseekV2Config(qk_rope_head_dim=64)
    dim, base, factor, orig = 64, 10000.0, 40.0, 4096

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert port.yarn_correction_range(c) == (low, high) == (10, 23)
    i = np.arange(dim // 2)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    extra = base ** (-2.0 * i / dim)
    want = extra / factor * ramp + extra * (1 - ramp)
    np.testing.assert_allclose(port.yarn_inv_freq(c).numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert port.rope_mscale(c) == pytest.approx(1.0)
    assert port.softmax_scale(c) == pytest.approx(192 ** -0.5 * m * m)
    cos, sin = port.rope_tables(port.yarn_inv_freq(c), 5, port.rope_mscale(c))
    angles = np.arange(5)[:, None] * np.concatenate([want, want])[None]
    np.testing.assert_allclose(cos.numpy(), np.cos(angles), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(angles), rtol=1e-5, atol=1e-6)
    # the de-interleave: pairs (2i, 2i+1) become (i, d/2 + i)
    x = torch.arange(8.0).view(1, 1, 1, 8)
    got = port.apply_rope(x, torch.ones(1, 8), torch.zeros(1, 8))
    assert got.flatten().tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_router_top6_and_weights_are_the_softmax_of_the_logits():
    c = port_config(tiny())
    r = port.Router(c)
    r.weight.data = torch.randn(16, 32, generator=torch.Generator().manual_seed(1))
    x = torch.randn(40, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        experts, weight = r(x)
    probs = torch.softmax(x.double() @ r.weight.detach().double().T, -1)
    for t in range(40):
        want = sorted(range(16), key=lambda e: -probs[t, e].item())[:6]
        assert sorted(experts[t].tolist()) == sorted(want)
        np.testing.assert_allclose(weight[t].double().numpy(), probs[t, experts[t]].numpy(),
                                   rtol=1e-5)
    assert weight.dtype == torch.float32


def _moe_pair(rank: int, ep_size: int, held: int, state: dict):
    """A port MoE layer holding rank `rank`'s share of `state`'s experts."""
    c = port_config(tiny(n_routed_experts=held, ep_size=ep_size, ep_rank=rank))
    m = port.MoE(c)
    first = rank * held
    part = dict(state)
    part["experts.gate_up_proj"] = state["experts.gate_up_proj"][first:first + held]
    part["experts.down_proj"] = state["experts.down_proj"][first:first + held]
    m.load_state_dict(part)
    return m


def test_expert_shares_add_up_to_the_uncut_layer():
    """Over ep_rank 0..7 (2 experts each of 16), the routed parts plus the
    shared experts once equal the reference layer that holds all 16."""
    uncut = ref.MoE(tiny(n_routed_experts=16, ep_size=1, ep_rank=0), None)
    state = seeded(uncut)
    uncut.load_state_dict(state)
    x = torch.randn(3, 12, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        shared = uncut.shared_experts(x.reshape(-1, 32)).view(x.shape)
        parts = [_moe_pair(r, 8, 2, state)(x) - shared for r in range(8)]
        torch.testing.assert_close(sum(parts) + shared, uncut(x), rtol=1e-5, atol=1e-5)
        # each share is its own: a rank's part misses what the other ranks add
        assert (parts[0] + shared - uncut(x)).abs().max() > 1e-3


def test_held_experts_gradients_match_autograd_through_the_reference():
    cfg = tiny(ep_rank=3)
    want = ref.MoE(cfg, None)
    state = seeded(want)
    want.load_state_dict(state)
    got = port.MoE(port_config(cfg))
    got.load_state_dict(state)
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(4))
    dy = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(6))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    for m, xi in zip((got, want), xs):
        (m(xi) * dy).sum().backward()
    torch.testing.assert_close(xs[0].grad, xs[1].grad, rtol=1e-5, atol=1e-5)
    for (n, p), (_, q) in zip(got.named_parameters(), want.named_parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-5, msg=n)
    assert got.experts.gate_up_proj.grad.abs().max() > 0
    assert got.gate.weight.grad.abs().max() > 0


def test_dispatch_orders_routes_by_held_expert():
    experts = torch.tensor([[4, 1, 5], [5, 2, 4], [0, 4, 7]])
    order, rows, ends = port.dispatch(experts, first=4, held=2)
    assert ends.tolist() == [3, 5] and ends.dtype == torch.int32
    flat = experts.flatten()
    assert flat[order[:3]].tolist() == [4, 4, 4] and flat[order[3:5]].tolist() == [5, 5]
    assert torch.equal(order[rows], torch.arange(9))


def test_no_decay_names_cover_rmsnorm():
    from macsa_tpu_torch.models.fcmf import FCMF

    model = FCMF(finetune_moe_step.port_configs(tiny(), "float32"))
    names = optim.no_decay_names(model)
    norms = [n for n, mod in model.named_modules() if isinstance(mod, port.RMSNorm)]
    assert len(norms) == 3 * 3 + 1  # input, post-attention, kv_a per layer; the final norm
    assert {f"{n}.weight" for n in norms} <= names
    assert "encoder.bert.cell.layers.1.mlp.experts.gate_up_proj" not in names
    assert "encoder.bert.cell.text_proj.bias" in names


def test_build_text_config_reads_a_deepseek_v2_config_json(tmp_path):
    hf = {k: v for k, v in TINY.items() if k not in ("text", "model", "ep_size", "ep_rank")}
    hf["n_routed_experts"] = 64
    (tmp_path / "config.json").write_text(json.dumps(hf))
    c = common.build_text_config(str(tmp_path), "bfloat16")
    assert isinstance(c, DeepseekV2Config)
    assert (c.n_routed_experts, c.ep_size, c.experts_held, c.first_expert) == (64, 8, 8, 0)
    assert (c.rope_factor, c.rope_mscale_all_dim, c.dtype) == (40, 0.707, "bfloat16")
    assert c.hidden_size == 32 and c.kv_lora_rank == 16
