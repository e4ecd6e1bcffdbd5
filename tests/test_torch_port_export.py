"""The port's serving bundle (`macsa_tpu_torch/inference/export.py`) against
the JAX package's.

* One set of weights, JAX-initialized at the width of `tests/test_export.py`
  (32 wide, one layer, a (1,1,1,1) ResNet of 4 filters at 64^2): the JAX
  bundle is exported from a JAX checkpoint, the port's from a port
  checkpoint of the same weights (`jax_import`).  The two bundles' logits
  agree on one numpy batch, and the port bundle's equal its live eval
  step's.
* `predict` pads a partial batch and refuses a larger one; the bf16 bundle
  tracks the f32 one at the JAX test's tolerances; `bundle.json` has the
  JAX keys with `device` for `platforms`.
* At L >= 32 the exported graph holds the registered K1 op (and K3's with
  `use_pallas_box_attention`), whose CPU implementations are the plain
  versions: the bundle equals the plain path's live step.
* The inference CLI with `--bundle` predicts what it predicts with
  `--checkpoint` on synthetic records.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.inference import export as jexport
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.train import checkpoints as jckpt
from macsa_tpu.train import common as jcommon
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.inference import cli, export
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.train import checkpoints, common, jax_import, optim
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_eval_step
from test_torch_port_models import jinit, randomize

VOCAB, B, IMG = 128, 2, 64  # exported batch size; 64/32 -> 2x2 grid
SMALL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32)
TEXT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=64)
RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="float32")
FCMF_ARGS = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=12,
                 box_heads=4)


def port_config(**kw) -> tcfg.FCMFConfig:
    return tcfg.FCMFConfig(model=tcfg.ModelConfig(**SMALL), text=tcfg.TextEncoderConfig(**TEXT),
                           **{**FCMF_ARGS, **kw})


def _batch(rng, n, cfg):
    a, l = len(jcfg.ASPECTS), cfg.max_text_len
    return {
        "images": rng.normal(size=(n, cfg.num_imgs, IMG, IMG, 3)).astype(np.float32),
        "roi_images": rng.normal(
            size=(n, cfg.num_imgs, cfg.num_roi, IMG, IMG, 3)).astype(np.float32),
        "roi_coors": rng.uniform(0, 1, size=(n, cfg.num_imgs, cfg.num_roi, 4)).astype(np.float32),
        "input_ids": rng.integers(2, VOCAB, size=(n, a, l)).astype(np.int32),
        "token_type_ids": np.zeros((n, a, l), np.int32),
        "attention_mask": (np.arange(l) < rng.integers(3, l + 1, size=(n, a, 1))).astype(np.int32),
        "added_mask": np.ones((n, a, l + cfg.num_patches), np.int32),
    }


def _live(model, visual, batch):
    _, logits = make_finetune_eval_step(model, visual)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return logits.numpy()


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The JAX bundle and the port's f32 and bf16 bundles of one set of
    JAX-initialized weights, with the port's live modules."""
    tmp = tmp_path_factory.mktemp("export")
    jfcmf = jcfg.FCMFConfig(model=jcfg.ModelConfig(**SMALL),
                            text=jcfg.TextEncoderConfig(**TEXT), **FCMF_ARGS)
    jresnet = jcfg.ResNetConfig(**RESNET)
    model, visual = JFCMF(jfcmf), JVisual(jresnet)
    batch = _batch(np.random.default_rng(0), 1, jfcmf)
    # the ResNet the JAX export builds for a checkpoint without one
    visual_params = jcommon.jit_init(visual, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 1, IMG, IMG, 3)))
    params = jinit(model, batch["input_ids"][:, 0], np.zeros((1, 2, 4, 128), np.float32),
                   np.zeros((1, 2, 2, 128), np.float32), batch["roi_coors"], None,
                   batch["attention_mask"][:, 0], batch["added_mask"][:, 0])["params"]
    params = randomize(params, np.random.default_rng(1))
    jckpt.CheckpointManager(str(tmp / "jckpt")).save_params("raw", params)
    jax_out = jexport.export_bundle(
        checkpoint=str(tmp / "jckpt" / "raw"), output_dir=str(tmp / "jax_bundle"),
        batch_size=B, platforms=("cpu",), fcmf_config=jfcmf, resnet_config=jresnet,
        image_size=IMG)

    cfg, rcfg = port_config(), tcfg.ResNetConfig(**RESNET)
    port, port_visual = FCMF(cfg), VisualFeatures(rcfg)
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 1), strict=True)
    port_visual.load_state_dict(jax_import.visual_state_dict_from_jax(visual_params["params"]))
    ckpt = str(tmp / "ckpt")
    checkpoints.CheckpointManager(ckpt).save(
        "best", TrainState.create(port, port_visual, optim.AdamW(port, 1e-3)), 1)
    out = {dtype: export.export_bundle(ckpt, str(tmp / f"bundle_{dtype}"), batch_size=B,
                                       device="cpu", fcmf_config=cfg, resnet_config=rcfg,
                                       image_size=IMG, dtype=dtype)
           for dtype in ("float32", "bfloat16")}
    served = {dtype: export.load_bundle(path) for dtype, path in out.items()}
    return {"jax": jax_out, "port": out, "served": served, "model": port,
            "visual": port_visual, "cfg": cfg}


def test_bundle_files_and_meta(bundles):
    out = bundles["port"]["float32"]
    assert sorted(os.listdir(out)) == ["bundle.json", "model.pt2"]
    meta, jmeta = (json.load(open(os.path.join(d, "bundle.json")))
                   for d in (out, bundles["jax"]))
    assert set(meta) == set(jmeta) - {"platforms"} | {"device"}
    assert meta["device"] == "cpu" and meta["batch_size"] == B and meta["image_size"] == IMG
    assert meta["aspects"] == jmeta["aspects"] and meta["polarities"] == jmeta["polarities"]
    assert meta["batch_spec"] == jmeta["batch_spec"]
    # K1 stays in the program (JAX forces it off)
    assert meta["config"]["text"]["fused_attention"] is True
    assert jmeta["config"]["text"]["fused_attention"] is False
    assert meta["config"]["model"]["dtype"] == "float32"
    assert json.load(open(os.path.join(bundles["port"]["bfloat16"], "bundle.json"))
                     )["config"]["model"]["dtype"] == "bfloat16"


def test_bundle_matches_the_jax_bundle_and_the_live_step(bundles):
    served = bundles["served"]["float32"]
    batch = _batch(np.random.default_rng(2), B, bundles["cfg"])
    got = served.predict(batch)
    assert got.shape == (B, len(jcfg.ASPECTS), 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, jexport.load_bundle(bundles["jax"]).predict(batch),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, _live(bundles["model"], bundles["visual"], batch),
                               atol=1e-6, rtol=0)


def test_partial_batch_padding(bundles):
    served = bundles["served"]["float32"]
    full = _batch(np.random.default_rng(3), B, bundles["cfg"])
    one = {k: v[:1] for k, v in full.items()}
    got_one, got_full = served.predict(one), served.predict(full)
    assert got_one.shape[0] == 1
    np.testing.assert_allclose(got_one[0], got_full[0], atol=1e-6, rtol=0)
    labels = served.predict_labels(one)
    assert len(labels) == 1 and set(labels[0]) == set(jcfg.ASPECTS)
    with pytest.raises(ValueError, match="exported batch size"):
        served.predict({k: np.repeat(v, 2, axis=0) for k, v in full.items()})
    with pytest.raises(ValueError, match="bundle expects"):
        served.predict({**full, "input_ids": full["input_ids"][:, :, :5]})
    with pytest.raises(ValueError, match="exported for cpu"):
        export.load_bundle(bundles["port"]["float32"], device="cuda")


def test_bfloat16_bundle_close_to_f32(bundles):
    batch = _batch(np.random.default_rng(4), B, bundles["cfg"])
    got16 = bundles["served"]["bfloat16"].predict(batch)
    got32 = bundles["served"]["float32"].predict(batch)
    np.testing.assert_allclose(got16, got32, atol=0.15, rtol=0.2)  # tests/test_export.py


def test_exported_graph_holds_the_kernel_ops(tmp_path):
    """At L = 40 the text encoder reaches K1 (Lq >= 32); with the box
    kernel on, K3 is in the program too.  Their CPU implementations are
    the plain versions: the bundle gives the plain path's logits."""
    cfg = port_config(max_text_len=40, use_pallas_box_attention=True)
    rcfg = tcfg.ResNetConfig(**RESNET)
    model, visual = FCMF(cfg), VisualFeatures(rcfg)
    init_weights(model, torch.Generator().manual_seed(0), 0.2)
    init_weights(visual, torch.Generator().manual_seed(1))
    checkpoints.CheckpointManager(str(tmp_path)).save(
        "best", TrainState.create(model, visual, optim.AdamW(model, 1e-3)), 1)
    out = export.export_bundle(str(tmp_path), str(tmp_path / "b"), batch_size=B, device="cpu",
                               fcmf_config=cfg, resnet_config=rcfg, image_size=IMG)
    served = export.load_bundle(out)
    targets = [str(n.target) for n in served._call.graph.nodes if n.op == "call_function"]
    assert targets.count("macsa_tpu_torch.fused_self_attention.default") == 1  # one layer
    assert targets.count("macsa_tpu_torch.box_attention.default") == 1

    plain = FCMF(dataclasses.replace(
        cfg, use_pallas_box_attention=False,
        model=dataclasses.replace(cfg.model, fused_attention=False),
        text=dataclasses.replace(cfg.text, fused_attention=False)))
    plain.load_state_dict(model.state_dict())
    batch = _batch(np.random.default_rng(5), B, cfg)
    np.testing.assert_allclose(served.predict(batch), _live(plain, visual, batch), atol=1e-6,
                               rtol=0)


def test_cli_with_bundle_equals_cli_with_checkpoint(tmp_path, monkeypatch):
    """`python -m macsa_tpu_torch.inference.export` writes the bundle; the
    CLI's batch mode over synthetic records with `--bundle` (shapes from
    bundle.json, --batch_size clamped to the bundle's) predicts what
    `--checkpoint` predicts on the same weights.  (Both build the fusion
    stack at 768; the test narrows it to 32 through the tokenizer's
    `config.json`, a config hook and a monkeypatch of the export's
    `ModelConfig`.)"""
    data = str(tmp_path / "synth")
    synth.write_dataset(data, n_train=5)
    tok = os.path.join(data, "tok")
    with open(os.path.join(tok, "config.json")) as f:
        hf = json.load(f)
    hf.update(hidden_size=32, num_attention_heads=4, intermediate_size=64)
    with open(os.path.join(tok, "config.json"), "w") as f:
        json.dump(hf, f)
    small = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)

    def hook(cfg, rcfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **small)), rcfg

    cfg, rcfg = hook(tcfg.FCMFConfig(model=tcfg.ModelConfig(),
                                     text=common.build_text_config(tok, "float32"),
                                     num_imgs=2, num_roi=2, max_text_len=48),
                     tcfg.ResNetConfig(dtype="float32", stage_sizes=(1, 1, 1, 1)))
    model = FCMF(cfg)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():  # unit-gain weights, and a head steep enough that reviews differ
        for name, p in model.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=g)
            elif name.endswith("LayerNorm.weight"):
                p.uniform_(0.5, 1.5, generator=g)
            else:
                p.normal_(0.0, 0.1, generator=g)
        model.classifier.weight.mul_(20.0)
    visual = VisualFeatures(rcfg)
    init_weights(visual, torch.Generator().manual_seed(1))
    ckpt = str(tmp_path / "ckpt")
    manager = checkpoints.CheckpointManager(ckpt)
    state = TrainState.create(model, visual, optim.AdamW(model, 1e-3))
    manager.save("best", state, 1)

    with open(os.path.join(data, "data", "train.json")) as f:
        records = [{"text": r["comment"],
                    "image_list": [os.path.join(data, "images", n) for n in r["list_img"]]}
                   for r in json.load(f)]
    args = ["--pretrained_hf_model", tok, "--roi_csv", os.path.join(data, "data", "roi_data.csv"),
            "--input_json", str(tmp_path / "records.json"), "--batch_size", "4",
            "--device", "cpu"]
    ckpt_args = ["--checkpoint", ckpt, "--num_imgs", "2", "--num_rois", "2",
                 "--max_seq_length", "48", "--resnet_stages", "1,1,1,1"]
    # center each class's logit over these records, so that the predictions
    # turn on what differs between the reviews
    server = cli.Server(cli.build_argparser().parse_args(args + ckpt_args), hook)
    _, logits = server.eval_step(server.batch(
        [server.prep_record(r["text"], r["image_list"]) for r in records]))
    with torch.no_grad():
        model.classifier.bias.sub_(logits.mean(dim=(0, 1)))
    manager.save("best", state, 1)

    monkeypatch.setattr(export, "ModelConfig", functools.partial(export.ModelConfig, **small))
    bundle = str(tmp_path / "bundle")
    export.main(["--checkpoint", ckpt, "--output_dir", bundle, "--pretrained_hf_model", tok,
                 "--resnet_stages", "1,1,1,1", "--num_imgs", "2", "--num_rois", "2",
                 "--max_seq_length", "48", "--batch_size", "2", "--device", "cpu"])
    assert sorted(os.listdir(bundle)) == ["bundle.json", "model.pt2"]

    with open(tmp_path / "records.json", "w") as f:
        json.dump(records, f, ensure_ascii=False)
    want = cli.main(args + ckpt_args + ["--output_file", str(tmp_path / "ckpt.jsonl")],
                    config_hook=hook)
    got = cli.main(args + ["--bundle", bundle, "--output_file", str(tmp_path / "bundle.jsonl")])
    rows = [(tmp_path / name).read_text().splitlines() for name in ("bundle.jsonl", "ckpt.jsonl")]
    assert "NaN" not in rows[0][0]
    assert rows[0] == rows[1] and len(rows[0]) == 5
    assert len({json.dumps(json.loads(r)["prediction"]) for r in rows[0]}) > 1  # reviews differ
    assert got["batch_size"] == 2 and want["batch_size"] == 4  # clamped to the bundle's
    with pytest.raises(SystemExit):  # one of the two, not neither
        cli.main(args)
