"""Kimi Linear as FCMF's text backbone (`models/kimi_linear.py`, `ops/kda.py`)
against the benchmark's plain f32 reference (`port_bench/reference/kimi_linear.py`)
at a tiny width on the CPU, on seeded random weights.

* the chunked KDA core against the position-by-position recurrence, forward
  and gradients, at lengths that are not a whole number of chunks, with
  right padding and with decays down to -12 a step,
* the mixer's autograd function (inputs kept, the backward recomputed)
  against plain autograd through the same mixer,
* the sigmoid router's choice (its correction bias) and weights
  (renormalized over all 8 chosen, scaled),
* the share: over every rank, the routed parts plus the shared expert once
  add up to the uncut reference layer,
* latent attention without rotary positions,
* the backbone's states, FCMF's logits and three AdamW steps,
* `from_hf`, `no_decay_names`, `build_text_config` and `train/finetune.py`
  on a local `config.json` of `model_type: kimi_linear`.
"""

import dataclasses
import json
import os
import shutil

import pytest
import torch

from macsa_tpu_torch.config import KimiLinearConfig
from macsa_tpu_torch.models import deepseek_v2 as ds_port
from macsa_tpu_torch.models import kimi_linear as port
from macsa_tpu_torch.ops import cuda_lib, kda
from macsa_tpu_torch.train import common, optim
from port_bench.entries import finetune_kimi_step
from port_bench.lib import traffic
from port_bench.reference import kimi_linear as ref
from port_bench.reference.train import state_for

SEED = 2 ** 31 + 23

# Kimi Linear's keys at a tiny width: layers 1-3 KDA, 4 latent attention,
# 5 KDA (the published pattern's period and the tail's start); layer 1 dense,
# 2-5 MoE; the router over 16 experts, this rank holding 2 (ep_size 8), top-4
TINY = {"vocab_size": 96, "hidden_size": 32, "intermediate_size": 48,
        "moe_intermediate_size": 16, "num_hidden_layers": 5, "first_k_dense_replace": 1,
        "moe_layer_freq": 1, "num_attention_heads": 2, "num_key_value_heads": 2,
        "num_experts": 2, "num_shared_experts": 1, "num_experts_per_token": 4,
        "routed_scaling_factor": 2.446, "moe_renormalize": True,
        "moe_router_activation_func": "sigmoid", "num_expert_group": 1, "topk_group": 1,
        "use_grouped_topk": True, "kv_lora_rank": 16, "q_lora_rank": None,
        "qk_nope_head_dim": 8, "qk_rope_head_dim": 8, "v_head_dim": 8, "mla_use_nope": True,
        "rope_scaling": None, "rope_theta": 10000, "rms_norm_eps": 1e-5, "head_dim": 72,
        "hidden_act": "silu", "model_type": "kimi_linear", "num_nextn_predict_layers": 0,
        "linear_attn_config": {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5],
                               "head_dim": 8, "num_heads": 2, "short_conv_kernel_size": 4},
        "ep_size": 8, "ep_rank": 0,
        "text": {"bos_token_id": 90, "eos_token_id": 91, "pad_token_id": 95},
        "model": {"hidden_size": 24, "num_hidden_layers": 1, "num_attention_heads": 2,
                  "intermediate_size": 32, "hidden_dropout_prob": 0.1,
                  "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12},
        "num_imgs": 2, "num_roi": 2, "num_labels": 4, "num_patches": 49,
        "visual_feat_dim": 16, "max_text_len": 12, "box_heads": 2, "aspects": 6,
        "compute_dtype": {"train": "float32"}}


def tiny(**kw):
    return dict(TINY, **kw)


def port_config(cfg) -> KimiLinearConfig:
    return finetune_kimi_step.port_configs(cfg, "float32").text


def seeded(module, seed=SEED):
    """The benchmark's draw (`finetune_kimi_step.seeded_state`: A_log =
    log U(1, 16)) at std 0.2."""
    return finetune_kimi_step.seeded_state(module, seed, "cpu", std=0.2)


def ids_and_mask(b=3, length=12, vocab=96):
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, vocab, (b, length), generator=g)
    mask = torch.ones(b, length, dtype=torch.int64)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids, mask


def core_inputs(b, length, h=2, d=8, floor=-12.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, length, h, d, generator=g) for _ in range(3))
    decay = floor * torch.rand(b, length, h, d, generator=g)
    return q, k, v, decay, torch.rand(b, length, h, generator=g)


@pytest.mark.parametrize("length", [5, 16, 37])
def test_chunked_core_matches_the_recurrence_forward_and_gradients(length):
    """f32 chunks against the f64 recurrence at decays down to -12 a step:
    exp(-G) over one chunk of 16 would overflow f32 (checked), so a core
    that factored the pairwise decays so would give inf or nan.  The
    tolerance is f32's: ~1e-7 relative a product, over a few hundred of
    them."""
    q, k, v, g, beta = core_inputs(2, length)
    assert torch.isinf(torch.exp(-g[:, :16].cumsum(1))).any() or length < 16
    leaves = [t.clone().requires_grad_() for t in (q, k, v, g, beta)]
    got = kda.chunk_kda(*leaves, torch.float32)
    wide = [t.double().clone().requires_grad_() for t in (q, k, v, g, beta)]
    qn = kda.l2norm(wide[0]) * 8 ** -0.5
    want = ref.kda_recurrence(qn, kda.l2norm(wide[1]), *wide[2:])
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(got.shape, generator=torch.Generator().manual_seed(9))
    got.backward(dy)
    want.backward(dy.double())
    for a, b, name in zip(leaves, wide, "q k v g beta".split()):
        assert torch.isfinite(a.grad).all(), name
        torch.testing.assert_close(a.grad.double(), b.grad, rtol=1e-4, atol=1e-5, msg=name)


def steep_inputs(b, length, h=2, d=8, seed=0):
    """`core_inputs` with decays of -30 to -200 a step on positions 3-7 and
    40-43 (3 and more in a row, across a sub-chunk's start)."""
    q, k, v, g, beta = core_inputs(b, length, h, d, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for at in (slice(3, 8), slice(40, 44)):
        part = g[:, at]
        part.copy_(-30 - 170 * torch.rand(part.shape, generator=gen))
    return q, k, v, g, beta


@pytest.mark.parametrize("decays", ["seeded", "steep"])
@pytest.mark.parametrize("length", [1, 15, 16, 17, 63, 64, 65, 170])
def test_the_hand_derived_backward_matches_autograd(length, decays):
    """`chunk_kda_backward` (the kernels' sweep and sub-chunk factoring,
    plain) against autograd through the f64 recurrence, both in f64 (the
    same function: 1e-10), and, where the decays are within
    `chunk_kda`'s envelope, against autograd through `chunk_kda` in f32
    (two f32 orders of the same sums: the f32 tolerance of
    `test_chunked_core_matches_the_recurrence_forward_and_gradients`).  The
    plain sub-chunk forward `subchunk_kda` against the recurrence too: it
    is exact for the steep decays, where exp(-G) over 3 positions
    overflows f32."""
    made = core_inputs(2, length) if decays == "seeded" else steep_inputs(2, length)
    wide = [t.double().clone().requires_grad_() for t in made]
    want = ref.kda_recurrence(kda.l2norm(wide[0]) * 8 ** -0.5, kda.l2norm(wide[1]), *wide[2:])
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    want.backward(dy)
    got = kda.subchunk_kda(*[t.double() for t in made], torch.float64)
    torch.testing.assert_close(got, want.detach(), rtol=1e-10, atol=1e-12)
    grads = kda.chunk_kda_backward(*[t.double() for t in made], dy)
    names = "q k v g beta".split()
    for a, w, name in zip(grads, wide, names):
        torch.testing.assert_close(a, w.grad, rtol=1e-10, atol=1e-12, msg=name)
    if decays == "steep":
        if length > 5:
            assert torch.isinf(torch.exp(-made[3][:, 3:6].sum(1))).any()
        return
    leaves = [t.clone().requires_grad_() for t in made]
    kda.chunk_kda(*leaves, torch.float32).backward(dy.float())
    for a, w, name in zip(kda.chunk_kda_backward(*made, dy.float()), leaves, names):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, w.grad, rtol=1e-4, atol=1e-5, msg=name)


def test_the_core_function_runs_the_plain_versions_on_the_cpu():
    """`KDACore` on CPU tensors: `subchunk_kda` forward, `chunk_kda_backward`
    (its gradient) backward; no kernel launch."""
    made = core_inputs(2, 37)
    leaves = [t.clone().requires_grad_() for t in made]
    dy = torch.randn(2, 37, 2, 8, generator=torch.Generator().manual_seed(3))
    cuda_lib.reset_launch_counts()
    out = kda.KDACore.apply(*leaves, torch.float32)
    out.backward(dy)
    assert not cuda_lib.launch_counts
    torch.testing.assert_close(out, kda.subchunk_kda(*made, torch.float32), rtol=0, atol=0)
    for a, w in zip(kda.chunk_kda_backward(*made, dy), leaves):
        torch.testing.assert_close(w.grad, a, rtol=0, atol=0)


def test_right_padding_leaves_the_real_positions_as_they_are():
    """A view's real tokens come first: what follows (pads, or a longer
    sequence) changes nothing before it, in any chunk."""
    q, k, v, g, beta = core_inputs(2, 40, seed=1)
    whole = kda.chunk_kda(q, k, v, g, beta, torch.float32)
    for real in (7, 16, 23):
        part = kda.chunk_kda(q[:, :real], k[:, :real], v[:, :real], g[:, :real],
                             beta[:, :real], torch.float32)
        torch.testing.assert_close(whole[:, :real], part, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("slice_tokens", [4096, 21, 42])
def test_the_mixer_function_matches_autograd_through_the_mixer(monkeypatch, slice_tokens):
    """`KDAMixer` (inputs kept, the backward recomputed a slice of the
    sequences at a time: 1 slice, 3 of 1 sequence, 2 of 2 and 1) against
    autograd through `kda_mixer` itself: the same operations, so the same
    values up to the order of the sums over the slices (a weight's gradient
    is a sum of some thousand f32 terms that cancel: 1e-4 relative)."""
    monkeypatch.setattr(kda, "BACKWARD_TOKENS", slice_tokens)
    cfg = port_config(tiny())
    block = port.KimiDeltaAttention(cfg)
    block.load_state_dict({k[len("self_attn."):]: v for k, v in
                           seeded(ref.Layer(tiny(), 0, None)).items()
                           if k.startswith("self_attn.")})
    x = torch.randn(3, 21, 32, generator=torch.Generator().manual_seed(3))
    dy = torch.randn(3, 21, 32, generator=torch.Generator().manual_seed(4))
    b = block
    proj = lambda xi: (b.q_proj(xi), b.k_proj(xi), b.v_proj(xi), b.q_conv1d.weight,  # noqa: E731
                       b.k_conv1d.weight, b.v_conv1d.weight, b.f_b_proj(b.f_a_proj(xi)),
                       b.A_log, b.dt_bias, b.b_proj(xi), b.g_b_proj(b.g_a_proj(xi)),
                       b.o_norm.weight)
    grads = []
    for plain in (False, True):
        block.zero_grad()
        xi = x.clone().requires_grad_()
        args = proj(xi)
        y = (kda.kda_mixer(*args, b.heads, b.eps) if plain
             else kda.KDAMixer.apply(*args, b.heads, b.eps))
        (b.o_proj(y) * dy).sum().backward()
        grads.append([xi.grad] + [p.grad.clone() for p in block.parameters()])
    for a, w in zip(*grads):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    assert block.A_log.grad.abs().max() > 0 and block.dt_bias.grad.abs().max() > 0


def test_sigmoid_router_choice_and_weights():
    """The experts with the 4 largest sigmoid + bias (a bias that moves the
    choice), weighted by their sigmoid over the sum of all 4 chosen (held
    or not), times 2.446."""
    c = port_config(tiny()).deepseek()
    r = ds_port.Router(c)
    r.weight.data = torch.randn(16, 32, generator=torch.Generator().manual_seed(1))
    r.e_score_correction_bias.copy_(torch.linspace(-0.6, 0.6, 16))
    x = torch.randn(40, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        experts, weight = r(x)
    s = torch.sigmoid(x.double() @ r.weight.detach().double().T)
    moved = 0
    for t in range(40):
        want = sorted(range(16), key=lambda e: -(s[t, e] + r.e_score_correction_bias[e]).item())[:4]
        moved += sorted(want) != sorted(torch.topk(s[t], 4).indices.tolist())
        assert sorted(experts[t].tolist()) == sorted(want)
        chosen = s[t, experts[t]]
        torch.testing.assert_close(weight[t].double(), chosen / chosen.sum() * 2.446,
                                   rtol=1e-6, atol=1e-7)
    assert moved > 5 and weight.dtype == torch.float32


def _moe_share(rank: int, state: dict):
    c = port_config(tiny(ep_rank=rank)).deepseek()
    m = ds_port.MoE(c)
    part = dict(state)
    for leaf in ("experts.gate_up_proj", "experts.down_proj"):
        part[leaf] = state[leaf][2 * rank:2 * rank + 2]
    m.load_state_dict(part)
    return m


def test_expert_shares_add_up_to_the_uncut_layer():
    """Over ep_rank 0..7 (2 of 16 experts each), the routed parts plus the
    shared expert once equal the reference layer that holds all 16."""
    uncut = ref.MoE(tiny(num_experts=16, ep_size=1), None)
    state = seeded(uncut)
    uncut.load_state_dict(state)
    x = torch.randn(3, 12, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        shared = uncut.shared_experts(x.reshape(-1, 32)).view(x.shape)
        parts = [_moe_share(r, state)(x) - shared for r in range(8)]
        torch.testing.assert_close(sum(parts) + shared, uncut(x), rtol=1e-5, atol=1e-5)
        assert (parts[0] + shared - uncut(x)).abs().max() > 1e-3


def test_latent_attention_without_rope_matches_the_reference():
    """`MLAttention` under `mla_use_nope` (no rotation, scale 16^-1/2 here,
    192^-1/2 at the published widths) against the reference's layer."""
    want = ref.Attention(tiny(), None)
    state = seeded(want)
    want.load_state_dict(state)
    got = ds_port.MLAttention(port_config(tiny()).deepseek())
    got.load_state_dict(state)
    assert got.scale == pytest.approx(16 ** -0.5)
    assert port_config(dict(TINY, qk_nope_head_dim=128, qk_rope_head_dim=64)
                       ).deepseek().qk_head_dim ** -0.5 == pytest.approx(192 ** -0.5)
    x = torch.randn(3, 12, 32, generator=torch.Generator().manual_seed(8))
    _, mask = ids_and_mask()
    additive = torch.where(ds_port.causal_padding_mask(mask), 0.0, torch.finfo(torch.float32).min)
    with torch.no_grad():
        torch.testing.assert_close(got(x, ds_port.causal_padding_mask(mask), None, None),
                                   want(x, additive), rtol=1e-5, atol=1e-5)


def test_the_layer_schedule_is_the_configs():
    c = KimiLinearConfig()
    assert [i + 1 for i in range(27) if not c.is_kda(i)] == [4, 8, 12, 16, 20, 24, 27]
    m = port.KimiLinearEncoder(dataclasses.replace(port_config(tiny())), 24)
    kinds = [type(layer.self_attn).__name__ for layer in m.layers]
    assert kinds == ["KimiDeltaAttention"] * 3 + ["MLAttention", "KimiDeltaAttention"]
    assert type(m.layers[0].mlp).__name__ == "MLP"
    assert all(type(layer.mlp).__name__ == "MoE" for layer in m.layers[1:])
    # so the train step stays eager (`train/step_graph.py`), as with DeepSeek-V2
    from macsa_tpu_torch.train.step_graph import holds_moe
    assert holds_moe(m)


def test_backbone_hidden_states_and_output_match_the_reference():
    cfg = tiny()
    want = ref.Backbone(cfg, 24)
    state = seeded(want)
    want.load_state_dict(state)
    got = port.KimiLinearEncoder(port_config(cfg), 24)
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
    got = FCMF(finetune_kimi_step.port_configs(cfg, "float32"))
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
    benchmark's own comparison, the program in f32 (its chunked core
    against the reference's recurrence: f32 rounding apart)."""
    import time

    from port_bench.lib import bench

    root = tmp_path / "pb"
    bench_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "port_bench")
    shutil.copytree(bench_dir, root, ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                                   "_cache"))
    with open(root / "configs" / "fcmf_kimi_linear_48b_a3b.json", "w") as f:
        json.dump(tiny(resnet={"stage_sizes": [1, 1, 1, 1], "num_filters": 2,
                               "image_size": 224}), f)
    with open(root / "workloads" / "finetune.kimilinear.cached.json") as f:
        w = json.load(f)
    w["traffic"].update(rows=16, batch=2, text_len=[4, 12], max_steps=20, warm_steps=1,
                        trace_steps=1)
    with open(root / "workloads" / "finetune.kimilinear.cached.json", "w") as f:
        json.dump(w, f)
    out = bench.run_cell(bench.Files(str(root)), {"end_to_end": [], "per_layer": []},
                         "finetune.kimilinear.cached", SEED, 0.05, False, torch.device("cpu"),
                         time.perf_counter())
    numbers = {k: v["value"] for k, v in out["check"].items()}
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers
    assert out["notes"]["route_disagreement"] == 0.0
    assert out["notes"]["held_rows_per_layer"] > 0


def test_published_config_builds_and_from_hf_refuses_what_is_not_built():
    hf = {k: v for k, v in TINY.items() if k not in ("text", "model", "ep_rank")}
    c = KimiLinearConfig.from_hf(dict(hf, num_experts=16))
    assert (c.kda_layers, c.kda_num_heads, c.kda_head_dim) == ((1, 2, 3, 5), 2, 8)
    assert (c.num_experts, c.ep_size, c.deepseek().experts_held) == (16, 8, 2)
    for bad, key in (({"num_expert_group": 2, "topk_group": 2}, "num_expert_group"),
                     ({"q_lora_rank": 64}, "q_lora_rank"),
                     ({"mla_use_nope": False}, "mla_use_nope"),
                     ({"moe_router_activation_func": "softmax"}, "moe_router_activation_func")):
        with pytest.raises(ValueError, match=key):
            KimiLinearConfig.from_hf(dict(hf, num_experts=16, **bad))
    with pytest.raises(ValueError, match="linear_attn_config"):
        KimiLinearConfig.from_hf(dict(hf, num_experts=16, linear_attn_config=dict(
            TINY["linear_attn_config"], kda_layers=[1, 2, 3])))


def test_no_decay_names_cover_the_norms_and_the_decay_parameters():
    from macsa_tpu_torch.models.fcmf import FCMF

    model = FCMF(finetune_kimi_step.port_configs(tiny(), "float32"))
    names = optim.no_decay_names(model)
    cell = "encoder.bert.cell.layers"
    for i in (0, 1, 2, 4):
        assert {f"{cell}.{i}.self_attn.{leaf}" for leaf in
                ("A_log", "dt_bias", "o_norm.weight", "g_b_proj.bias")} <= names
    assert f"{cell}.3.self_attn.kv_a_layernorm.weight" in names
    assert f"{cell}.0.self_attn.q_conv1d.weight" not in names
    assert f"{cell}.0.self_attn.f_b_proj.weight" not in names
    assert f"{cell}.1.mlp.experts.gate_up_proj" not in names


def test_build_text_config_reads_a_kimi_linear_config_json(tmp_path):
    hf = {k: v for k, v in TINY.items() if k not in ("text", "model", "ep_size", "ep_rank")}
    hf["num_experts"] = 256
    (tmp_path / "config.json").write_text(json.dumps(hf))
    c = common.build_text_config(str(tmp_path), "bfloat16")
    assert isinstance(c, KimiLinearConfig)
    ds = c.deepseek()
    assert (ds.n_routed_experts, ds.ep_size, ds.experts_held, ds.first_expert) == (256, 32, 8, 0)
    assert (ds.scoring_func, ds.norm_topk_prob, ds.routed_scaling_factor) == (
        "sigmoid", True, 2.446)
    assert c.dtype == "bfloat16" and c.hidden_size == 32


def test_train_finetune_trains_with_this_backbone(tmp_path):
    """`train/finetune.py` on the synthetic dataset, its tokenizer directory's
    `config.json` replaced by a tiny Kimi Linear one: the normal path, eager
    (a model with a MoE layer is not graphed)."""
    from macsa_tpu_torch.data import synth
    from macsa_tpu_torch.train import finetune

    data = tmp_path / "data"
    synth.write_dataset(str(data))
    tok = data / "tok"
    hf = {k: v for k, v in TINY.items() if k not in ("text", "model", "ep_size", "ep_rank")}
    with open(tok / "config.json") as f:
        vocab = max(json.load(f).get("vocab_size", 0), 512)
    (tok / "config.json").write_text(json.dumps(dict(hf, num_experts=256, vocab_size=vocab)))

    def hook(cfg, rcfg):
        assert isinstance(cfg.text, KimiLinearConfig)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, hidden_size=32, num_attention_heads=4, intermediate_size=64),
            visual_feat_dim=4 * 32, box_heads=8)
        return cfg, dataclasses.replace(rcfg, num_filters=4)

    out = tmp_path / "out"
    result = finetune.main(
        ["--data_dir", str(data / "data"), "--image_dir", str(data / "images"),
         "--output_dir", str(out), "--pretrained_hf_model", str(tok), "--device", "cpu",
         "--resnet_stages", "1,1,1,1", "--num_imgs", "2", "--num_rois", "2", "--no-bf16",
         "--max_seq_length", "24", "--train_batch_size", "4", "--eval_batch_size", "4",
         "--num_train_epochs", "1", "--log_every", "1", "--seed", "5", "--do_train"],
        config_hook=hook)
    losses = [loss for e in result["epochs"] for loss in e["losses"]]
    assert losses and all(torch.isfinite(torch.tensor(losses)))
    assert os.path.exists(out / "last.pt")
