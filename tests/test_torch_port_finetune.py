"""The port's fine-tune driver (`macsa_tpu_torch.train.finetune`) from files.

`main` runs on the port's synthetic dataset with `--device cpu`: the
artifacts of the reference driver appear, epochs are whole, an epoch on
cached features takes the steps an uncached run takes, a stopped run resumes
bitwise, and every flag whose path is not ported raises with its reason
(`--fine_tune_cnn` and `--use_mde` run: test_torch_port_finetune_cnn.py,
test_torch_port_mde.py). Against the JAX package: with dropout 0 and the
parameters carried across by `jax_import`, the driver's first losses are
those of `macsa_tpu`'s train step fed the same batches (the JAX driver's own
end-to-end tests are marked slow; its step is what the tier-1 suite can
afford).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.train import optim as joptim
from macsa_tpu.train import steps as jsteps
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.data.loader import DataLoader
from macsa_tpu_torch.train import checkpoints, finetune, jax_import
from test_torch_port_models import jinit, randomize

SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)
ARTIFACTS = ("best.pt", "last.pt", "train.log", "metrics.jsonl", "test_results_fcmf.txt",
             "test_predictions_formatted.txt")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_synth")
    synth.write_dataset(str(root))  # 16 train / 4 dev / 4 test reviews, 2 text layers
    return str(root)


def _argv(data, out, *extra, epochs=2):
    return ["--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", str(out), "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--resnet_stages", "1,1,1,1",
            "--num_imgs", "2", "--num_rois", "2", "--no-bf16", "--max_seq_length", "48",
            "--train_batch_size", "4", "--eval_batch_size", "4", "--num_train_epochs",
            str(epochs), "--log_every", "1", "--seed", "5", *extra]


def small_hook(dropout=None):
    """Narrow the model the flags built (the text width comes from the
    tokenizer directory's config.json, 768) so that a run takes seconds."""
    def hook(cfg, rcfg):
        extra = {} if dropout is None else dict(hidden_dropout_prob=dropout,
                                                attention_probs_dropout_prob=dropout)
        rcfg = dataclasses.replace(rcfg, num_filters=4)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **SMALL, **extra),
            text=dataclasses.replace(cfg.text, **SMALL, **extra),
            visual_feat_dim=4 * 32, box_heads=8)
        return cfg, rcfg
    return hook


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_driver_trains_evaluates_tests_and_writes_the_artifacts(data, tmp_path):
    """At the width the tokenizer directory names (768, 2 text layers)."""
    out = tmp_path / "cached"
    result = finetune.main(_argv(data, out, "--do_train", "--do_eval", "--do_test"))
    for name in ARTIFACTS:
        assert (out / name).is_file(), name
    cold, warm = result["epochs"]
    assert [e["steps"] for e in (cold, warm)] == [4, 4] and warm["first_step"] == 4
    assert len(cold["losses"]) == len(warm["losses"]) == 4
    assert np.isfinite(cold["losses"] + warm["losses"]).all()
    assert 0.0 < result["best_dev_f1"] <= 1.0
    assert set(result["test"]) == {"Location", "Food", "Room", "Facilities", "Service",
                                   "Public_area", "average"}
    records = _metrics(out)
    assert [r["epoch_steps"] for r in records if "epoch_steps" in r] == [4, 4]
    assert [r["step"] for r in records if "loss" in r] == list(range(1, 9))
    assert sum("dev_f1" in r for r in records) == 2
    report = (out / "test_results_fcmf.txt").read_text().splitlines()
    assert len(report) == 7 and report[0].startswith("Location: P=") and \
        report[-1].startswith("Average: P=")
    dump = (out / "test_predictions_formatted.txt").read_text()
    assert dump.count("Sentence: ") == 4 and dump.count("predict=") == 24
    log = (out / "train.log").read_text()
    assert "visual feature cache[train]" in log and "--prng rbg: ignored" in log

    # the warm epoch ran on cached features; an uncached run takes the same steps
    uncached = finetune.main(_argv(data, tmp_path / "uncached", "--do_train",
                                   "--cache_visual_features", "off"))
    assert [e["losses"] for e in uncached["epochs"]] == [cold["losses"], warm["losses"]]
    assert "best_dev_f1" in uncached and "test" not in uncached
    assert not (tmp_path / "uncached" / "best.pt").exists()  # no eval: only `last`
    assert (tmp_path / "uncached" / "last.pt").is_file()


@pytest.mark.parametrize("flags,reason", [
    (["--mp", "2"], "--mp 2 does not divide the 1 processes of the run")])
def test_driver_refuses_what_is_not_ported_with_its_reason(data, tmp_path, flags, reason):
    # tensor parallelism is ported (tests/test_torch_port_tp.py); what is
    # refused is an mp that does not divide the processes
    with pytest.raises(ValueError, match=reason):
        finetune.main(_argv(data, tmp_path, "--do_train", *flags))
    assert not os.listdir(tmp_path)  # refused before anything is written


def test_driver_runs_on_the_card_unless_told_otherwise(data, tmp_path):
    argv = _argv(data, tmp_path, "--do_train")
    if not torch.cuda.is_available():
        without_device = [a for a in argv if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.main(without_device)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        finetune.main(argv + ["--fused_attention", "on"])
    assert finetune.build_argparser().parse_args(argv).device == "cpu"
    assert finetune.build_argparser().get_default("device") == "cuda"


def test_flag_surface_covers_the_jax_drivers():
    from macsa_tpu.train import finetune as jfinetune
    theirs = {a.dest: a for a in jfinetune.build_argparser()._actions}
    ours = {a.dest: a for a in finetune.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) <= set(ours)
    for dest, action in theirs.items():
        assert ours[dest].default == action.default, dest
        assert ours[dest].choices == action.choices, dest


def test_use_mde_with_alpha_one_runs_and_profile_dir_gets_a_trace_an_epoch(data, tmp_path):
    result = finetune.main(_argv(data, tmp_path / "out", "--do_train", "--use_mde", "--alpha",
                                 "1.0", "--profile_dir", str(tmp_path / "traces"), epochs=1),
                           config_hook=small_hook())
    assert [e["steps"] for e in result["epochs"]] == [4]
    traces = sorted(os.listdir(tmp_path / "traces"))
    assert [t.split("_")[0] for t in traces] == ["epoch0"]
    # no card: no device time, and it is not made up from the host's
    assert all(e["device_kernel_ms_per_step"] is None for e in result["epochs"])


def test_first_losses_match_the_jax_train_step(data, tmp_path):
    """Dropout 0, parameters made in JAX and carried over, the batches the
    driver's loader yields: the driver's first two losses against
    `macsa_tpu`'s step.  rtol 1e-4: f32 on both sides, sums in other orders
    through the ResNet and five transformer layers, one AdamW update between."""
    argv = _argv(data, tmp_path, "--do_train")
    args = finetune.build_argparser().parse_args(argv)
    made = {}

    def config_hook(cfg, rcfg):
        made["cfg"], made["rcfg"] = small_hook(dropout=0.0)(cfg, rcfg)
        return made["cfg"], made["rcfg"]

    def model_hook(model, visual):
        cfg, rcfg = made["cfg"], made["rcfg"]
        common = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **SMALL)
        jconfig = jcfg.FCMFConfig(
            model=jcfg.ModelConfig(**common),
            text=jcfg.TextEncoderConfig(
                vocab_size=cfg.text.vocab_size, num_hidden_layers=cfg.text.num_hidden_layers,
                max_position_embeddings=cfg.text.max_position_embeddings,
                type_vocab_size=cfg.text.type_vocab_size, **common),
            num_imgs=2, num_roi=2, visual_feat_dim=cfg.visual_feat_dim, max_text_len=48)
        jmodel = JFCMF(jconfig)
        jvisual = JVisual(jcfg.ResNetConfig(stage_sizes=rcfg.stage_sizes, num_filters=4,
                                            dtype="float32"))
        rng = np.random.default_rng(0)
        ids = np.full((1, 48), 5, np.int32)
        params = randomize(jinit(
            jmodel, ids, np.zeros((1, 2, 49, 128), np.float32),
            np.zeros((1, 2, 2, 128), np.float32), np.zeros((1, 2, 2, 4), np.float32), None,
            np.ones_like(ids), np.ones((1, 48 + 49), np.int32))["params"], rng)
        visual_params = randomize(jinit(jvisual, np.zeros((1, 224, 224, 3), np.float32)), rng)
        model.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
        visual.load_state_dict(jax_import.visual_state_dict_from_jax(visual_params["params"]),
                               strict=True)
        made.update(jmodel=jmodel, jvisual=jvisual, params=params, visual_params=visual_params)

    result = finetune.main(argv, config_hook=config_hook, model_hook=model_hook)
    got = result["epochs"][0]["losses"][:2]

    # the JAX step on the batches the driver's loader yields in epoch 0
    from macsa_tpu_torch.data.tokenizer import load_tokenizer
    from macsa_tpu_torch.data.vimacsa import MACSADataset
    from macsa_tpu_torch.train import common
    boxes, dict_img, dict_roi = common.load_metadata(args.data_dir)
    dataset = MACSADataset(common.load_records(os.path.join(args.data_dir, "train.json")),
                           load_tokenizer(args.pretrained_hf_model), args.image_dir, boxes,
                           dict_img, dict_roi, num_img=2, num_roi=2, max_text_len=48,
                           pixel_mode="packed")
    loader = DataLoader(dataset, 4, shuffle=True, seed=args.seed, drop_last=True, num_workers=2)
    schedule = lambda lr: joptim.linear_warmup_schedule(lr, 0, 8)  # 4 steps x 2 epochs
    tx = joptim.make_adamw(schedule(args.encoder_learning_rate), weight_decay=args.weight_decay,
                           max_grad_norm=args.max_grad_norm,
                           head_learning_rate=schedule(args.classifier_head_learning_rate))
    state = JTrainState.create(made["params"], made["visual_params"], tx)
    step = jsteps.make_finetune_train_step(made["jmodel"], made["jvisual"], donate=False)
    want = []
    for batch, _ in zip(loader, range(2)):
        jbatch = {k: jnp.asarray(v.view(np.uint32) if k in ("images", "roi_images") else v)
                  for k, v in batch.items() if k not in ("_idx", "text")}
        state, metrics = step(state, jbatch, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[1]


class _Stop(Exception):
    pass


def _last_tensors(out):
    got = torch.load(os.path.join(out, "last.pt"), map_location="cpu", weights_only=True)
    flat = {f"model.{k}": v for k, v in got["model"].items()}
    for index, entry in got["optimizer"]["optimizer"]["state"].items():
        flat.update({f"opt.{index}.{k}": torch.as_tensor(v) for k, v in entry.items()})
    return flat, {k: got[k] for k in ("step", "epoch", "best_score")}


@pytest.mark.parametrize("extra", [(), ("--gradient_accumulation_steps", "3")],
                         ids=["plain", "accumulating"])
def test_driver_resumes_bitwise(data, tmp_path, monkeypatch, extra):
    """Three epochs straight, against the same run stopped right after
    its second epoch's checkpoint and resumed from `last`: dropout is on, the
    schedule is the same, and the final checkpoints hold the same bits.
    With 3 accumulated micro-steps and 4 steps an epoch, an update is in
    progress across each stop."""
    hook = small_hook()
    straight = finetune.main(_argv(data, tmp_path / "straight", "--do_train", *extra, epochs=3),
                             config_hook=hook)

    save = checkpoints.CheckpointManager.save

    def save_then_stop(self, tag, state, epoch, best_score=0.0):
        save(self, tag, state, epoch, best_score)
        if epoch == 2:
            raise _Stop

    stopped_argv = _argv(data, tmp_path / "stopped", "--do_train", *extra, epochs=3)
    with monkeypatch.context() as patch:
        patch.setattr(checkpoints.CheckpointManager, "save", save_then_stop)
        with pytest.raises(_Stop):
            finetune.main(stopped_argv, config_hook=hook)
    resumed = finetune.main(stopped_argv + ["--resume_from_checkpoint", "last"],
                            config_hook=hook)
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    assert resumed["epochs"][0]["first_step"] == 8
    assert resumed["epochs"][0]["losses"] == straight["epochs"][2]["losses"]
    want, want_meta = _last_tensors(tmp_path / "straight")
    got, got_meta = _last_tensors(tmp_path / "stopped")
    assert got_meta == want_meta == {"step": 12, "epoch": 3, "best_score": 0.0}
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_freeze_encoder_leaves_the_encoder_as_it_was(data, tmp_path):
    before = {}
    result = finetune.main(
        _argv(data, tmp_path, "--do_train", "--freeze_encoder", epochs=1),
        config_hook=small_hook(),
        model_hook=lambda model, visual: before.update(
            {k: v.clone() for k, v in model.state_dict().items()}))
    after = torch.load(tmp_path / "last.pt", map_location="cpu", weights_only=True)["model"]
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(not k.startswith("encoder.") for k in moved)
    assert {k.split(".")[0] for k in moved} == {"text_pooler", "classifier"}
    assert np.isfinite(result["epochs"][0]["losses"]).all()


def test_disk_feature_cache_spares_the_next_run_its_decoding(data, tmp_path):
    argv = _argv(data, tmp_path / "out", "--do_train", "--feature_cache_dir",
                 str(tmp_path / "features"), epochs=1)
    first = finetune.main(argv, config_hook=small_hook())
    assert len([n for n in os.listdir(tmp_path / "features") if n.endswith(".grid.npy")]) == 16
    second = finetune.main(argv, config_hook=small_hook())
    log = (tmp_path / "out" / "train.log").read_text()
    assert "prefilled 16/16 rows from disk" in log
    # the same weights (seeded init) on bf16-stored features: close, not equal, in f32
    np.testing.assert_allclose(second["epochs"][0]["losses"], first["epochs"][0]["losses"],
                               rtol=2e-2)


def test_driver_runs_without_transformers_pil_and_the_native_library(data, tmp_path):
    """As on a machine that has torch and numpy only: the tokenizer.json
    reader, the numpy PNG reader and the numpy resize serve the run."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import dataclasses, json, os, sys
for name in ("transformers", "tokenizers", "PIL", "jax", "flax", "optax", "orbax"):
    sys.modules[name] = None  # importing it raises ImportError
os.environ["MACSA_NATIVE_IMAGES"] = "0"
from macsa_tpu_torch.train import finetune
small = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)
def hook(cfg, rcfg):
    return (dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **small),
                                text=dataclasses.replace(cfg.text, **small),
                                visual_feat_dim=128),
            dataclasses.replace(rcfg, num_filters=4))
result = finetune.main({_argv(data, tmp_path, "--do_train", "--do_eval", "--do_test", epochs=1)!r},
                       config_hook=hook)
print("LOSSES", json.dumps(result["epochs"][0]["losses"]))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    losses = json.loads(proc.stdout.split("LOSSES ")[1].splitlines()[0])
    assert len(losses) == 4 and np.isfinite(losses).all()
    log = (tmp_path / "train.log").read_text()
    assert "served by the numpy PNG reader" in log and "served by native" not in log
    for name in ARTIFACTS:
        assert (tmp_path / name).is_file(), name
    # the same run in this process (HF tokenizer, native decode and resize):
    # the same tokens and pixels but for the resize's last bit (+-1/255)
    here = finetune.main(_argv(data, tmp_path / "here", "--do_train", epochs=1),
                         config_hook=small_hook())
    np.testing.assert_allclose(losses, here["epochs"][0]["losses"], rtol=1e-2)
