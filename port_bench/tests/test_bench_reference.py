"""The plain reference against the port at a tiny width on the CPU, in f32:
the same weights and dropout draws give the same logits, features and
pixels, and three train steps the same readings."""

import json
import os

import numpy as np
import pytest
import torch

from port_bench.entries import finetune_step, pretrain_step
from port_bench.lib import traffic, weights
from port_bench.reference import model as ref_model
from port_bench.reference.train import state_for

SEED = 2 ** 31 + 77


def tiny_cfg(tiny_bench, name):
    files, _ = tiny_bench
    return files.json("configs", name)


def aspect_batch(cfg, b=2):
    rng = traffic.host_rng(SEED, 5)
    batch = traffic.aspect_views(rng, b, cfg["aspects"], cfg["max_text_len"], cfg["num_patches"],
                                 cfg["text"]["vocab_size"], (8, cfg["max_text_len"]))
    batch["labels"] = traffic.labels(rng, b, cfg["aspects"], (0.7, 0.1, 0.05, 0.15))
    batch["roi_coors"] = traffic.boxes(rng, (b, cfg["num_imgs"], cfg["num_roi"]))
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    g = torch.Generator().manual_seed(3)
    out["grid"] = torch.rand(b, cfg["num_imgs"], cfg["num_patches"], cfg["visual_feat_dim"],
                             generator=g)
    out["roi"] = torch.rand(b, cfg["num_imgs"], cfg["num_roi"], cfg["visual_feat_dim"],
                            generator=g)
    return out


def test_fcmf_logits_with_dropout(tiny_bench):
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.layers import DropoutRng
    from macsa_tpu_torch.train.steps import fcmf_forward_all_aspects

    cfg = tiny_cfg(tiny_bench, "fcmf_visobert")
    fc, _ = finetune_step.port_configs(cfg, "float32")
    state = finetune_step.model_state(cfg, SEED, "cpu")
    port = FCMF(fc)
    port.load_state_dict(state)
    ref = ref_model.FCMF(cfg)
    ref.load_state_dict(state_for(ref, state))
    batch = aspect_batch(cfg)
    port.train(), ref.train()
    got = fcmf_forward_all_aspects(port, torch.nn.Module(), batch,
                                   DropoutRng.for_step(SEED, 4, "cpu"))
    want = ref_model.fcmf_all_aspects(ref, batch, batch["grid"], batch["roi"],
                                      ref_model.StepRng(SEED, 4, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    other = ref_model.fcmf_all_aspects(ref, batch, batch["grid"], batch["roi"],
                                       ref_model.StepRng(SEED, 5, "cpu"))
    assert (other - got).abs().max() > 1e-3  # the draws matter


def test_seq2seq_logits_with_dropout(tiny_bench):
    from macsa_tpu_torch.models.layers import DropoutRng
    from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq

    cfg = tiny_cfg(tiny_bench, "iaog_fcmf_visobert")
    fc, _ = finetune_step.port_configs(cfg, "float32")
    state = pretrain_step.model_state(cfg, SEED, "cpu")
    port = FCMFSeq2Seq(fc, pretrain_step.decoder_config(cfg, "float32"))
    port.load_state_dict(state)
    ref = ref_model.Seq2Seq(cfg, cfg["decoder"])
    ref.load_state_dict(state_for(ref, state))
    pool = pretrain_step.host_pool(cfg, {"rows": 3, "text_len": [8, 40], "decoder_len": [3, 8]},
                                   SEED)
    bt = {k: torch.as_tensor(v) for k, v in pool.items()}
    a = aspect_batch(cfg, 3)
    bt["grid"], bt["roi"] = a["grid"], a["roi"]
    port.train(), ref.train()
    got = port(bt["enc_input_ids"], bt["dec_input_ids"], bt["grid"], bt["roi"], bt["roi_coors"],
               bt["token_type_ids"], bt["attention_mask"], bt["added_mask"],
               rng=DropoutRng.for_step(SEED, 1, "cpu"))
    want = ref(bt, bt["grid"], bt["roi"], ref_model.StepRng(SEED, 1, "cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_resnet_features_and_pixels(tiny_bench):
    from macsa_tpu_torch.models.resnet import VisualFeatures
    from macsa_tpu_torch.ops.image_prep import device_normalize

    cfg = tiny_cfg(tiny_bench, "fcmf_visobert")
    _, rc = finetune_step.port_configs(cfg, "float32")
    state = finetune_step.resnet_state(cfg, SEED, "cpu")
    port = VisualFeatures(rc)
    port.load_state_dict(state)
    r = cfg["resnet"]
    ref = ref_model.ResNet(tuple(r["stage_sizes"]), r["num_filters"])
    ref.load_state_dict(state)
    g = traffic.device_generator(SEED, 4, "cpu")
    words = torch.as_tensor(traffic.frames(g, (2, 3), 0.6, "packed", "cpu"))
    pixels = ref_model.unpack_frames(words, 224)
    torch.testing.assert_close(pixels, device_normalize(words, torch.float32), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        torch.testing.assert_close(ref.features(pixels, False),
                                   port.grid_features(pixels), rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(ref.features(pixels, True),
                                   port.pooled_features(pixels), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cell", ["finetune.cached", "pretrain.cached", "finetune.pixels"])
def test_three_f32_steps_match_the_reference(tiny_bench, cell):
    """The program in f32 (the configuration's bf16 set to f32) and the
    reference agree to f32 rounding through three AdamW steps."""
    from port_bench.lib import bench

    files, manifest = tiny_bench
    path = os.path.join(files.root, "configs", files.json("workloads", cell)["config"] + ".json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["compute_dtype"]["train"] = "float32"
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = bench.run_cell(files, manifest, cell, SEED, 0.2, False, torch.device("cpu"))
    numbers = {k: v["value"] for k, v in out["check"].items()}
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-4, numbers
    assert numbers["change_gap"] < 1e-3, numbers


def test_weights_follow_the_leaf_rules():
    shapes = {"a.weight": (3, 4), "a.bias": (3,), "ln.weight": (4,), "c.weight": (2, 3, 3, 3),
              "bn.running_var": (2,)}
    s = weights.seeded_state(shapes, {"ln"}, 7, "cpu")
    assert torch.all(s["a.bias"] == 0) and torch.all(s["ln.weight"] == 1)
    assert torch.all(s["bn.running_var"] == 1)
    again = weights.seeded_state(shapes, {"ln"}, 7, "cpu")
    assert all(torch.equal(s[k], again[k]) for k in shapes)
    assert not np.allclose(s["a.weight"], weights.seeded_state(shapes, {"ln"}, 8, "cpu")["a.weight"])
