"""The port's baseline driver (`macsa_tpu_torch.train.train_baselines`) from files.

`main` runs each of the three models on the port's synthetic dataset with
`--device cpu` at a narrow width: one epoch with train, dev and test writes
the reference driver's artifacts; a stopped run resumes for exactly the
epochs left; `efcap` reads a caption file; the flags cover the JAX
driver's.  Against the JAX package: with dropout 0 and the parameters
carried across by `jax_import`, the driver's first losses are those of
`macsa_tpu`'s baseline train step fed the same batches.
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
from macsa_tpu.models import baselines as jmodels
from macsa_tpu.train import baseline_steps as jsteps
from macsa_tpu.train import optim as joptim
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.data.loader import DataLoader
from macsa_tpu_torch.train import jax_import, train_baselines
from test_torch_port_models import jinit, randomize

SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)
MODELS = ("mroberta", "tomroberta", "efcap")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_driver_synth")
    synth.write_dataset(str(root))  # 16 train / 4 dev / 4 test reviews, 2 text layers
    return str(root)


def _argv(data, out, model, *extra, epochs=1):
    return ["--model", model, "--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", str(out), "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--num_imgs", "2", "--num_rois", "2", "--no-bf16", "--max_seq_length", "48",
            "--max_cap_length", "64", "--train_batch_size", "4", "--eval_batch_size", "4",
            "--num_train_epochs", str(epochs), "--log_every", "1", "--seed", "5", *extra]


def small_hook(dropout=None):
    """Narrow the text encoder the flags built (768 wide, from the
    tokenizer directory's config.json) and the ResNet (to stages 1, 1, 1, 1
    at 4 filters), so a run takes seconds."""
    def hook(text_cfg, rcfg):
        extra = {} if dropout is None else dict(hidden_dropout_prob=dropout,
                                                attention_probs_dropout_prob=dropout)
        return (dataclasses.replace(text_cfg, **SMALL, **extra),
                dataclasses.replace(rcfg, stage_sizes=(1, 1, 1, 1), num_filters=4))
    return hook


@pytest.mark.parametrize("model", MODELS)
def test_one_epoch_trains_evaluates_tests_and_writes_the_artifacts(data, tmp_path, model):
    result = train_baselines.main(_argv(data, tmp_path, model, "--do_train", "--do_eval",
                                        "--do_test"), config_hook=small_hook())
    for name in ("best.pt", "last.pt", "train.log", "metrics.jsonl",
                 f"test_results_{model}.txt", "test_predictions_formatted.txt"):
        assert (tmp_path / name).is_file(), name
    (epoch,) = result["epochs"]
    assert epoch["steps"] == 4 and len(epoch["losses"]) == 4
    assert np.isfinite(epoch["losses"]).all()
    assert 0.0 <= result["best_dev_f1"] <= 1.0
    report = (tmp_path / f"test_results_{model}.txt").read_text().splitlines()
    assert len(report) == 7 and report[0].startswith("Location: P=")
    dump = (tmp_path / "test_predictions_formatted.txt").read_text()
    assert dump.count("Sentence: ") == 4 and dump.count("predict=") == 24
    assert "--prng rbg: ignored" in (tmp_path / "train.log").read_text()


def test_first_losses_match_the_jax_train_step(data, tmp_path):
    """EF-CapTr (the three steps are held against JAX's in
    test_torch_port_baselines.py): dropout 0, parameters made in JAX and
    carried over, the batches the driver's loader yields, the driver's first
    two losses against `macsa_tpu`'s step (rtol 1e-4: f32 on both sides,
    sums in other orders, one AdamW update between)."""
    argv = _argv(data, tmp_path, "efcap", "--do_train")
    args = train_baselines.build_argparser().parse_args(argv)
    made = {}

    def config_hook(text_cfg, rcfg):
        made["text"], rcfg = small_hook(dropout=0.0)(text_cfg, rcfg)
        return made["text"], rcfg

    def model_hook(port, visual):
        t = made["text"]
        made["jmodel"] = jmodels.EFCapTrRoBERTa(jcfg.TextEncoderConfig(
            **{f.name: getattr(t, f.name) for f in dataclasses.fields(t)
               if f.name not in ("fused_attention", "dtype")}))
        ids = np.full((1, 64), 5, np.int32)
        made["params"] = randomize(jinit(made["jmodel"], ids, ids)["params"],
                                   np.random.default_rng(0))
        port.load_state_dict(jax_import.baseline_state_dict_from_jax(made["params"], "efcap"),
                             strict=True)

    result = train_baselines.main(argv, config_hook=config_hook, model_hook=model_hook)
    got = result["epochs"][0]["losses"][:2]

    # the JAX step on the batches the driver's loader yields in epoch 0
    from macsa_tpu_torch.data.baselines import EFCapDataset
    from macsa_tpu_torch.data.tokenizer import load_tokenizer
    from macsa_tpu_torch.train import common
    dataset = EFCapDataset(common.load_records(os.path.join(args.data_dir, "train.json")),
                           load_tokenizer(args.pretrained_hf_model), {}, num_img=2, max_len=64)
    loader = DataLoader(dataset, 4, shuffle=True, seed=args.seed, drop_last=True, num_workers=2)
    tx = joptim.make_adamw(joptim.linear_warmup_schedule(args.learning_rate, 0, 4),
                           weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm)
    state = JTrainState.create(made["params"], {}, tx)
    step = jsteps.make_baseline_train_step(made["jmodel"], None, donate=False)
    want = []
    for batch, _ in zip(loader, range(2)):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in ("_idx", "text")}
        state, metrics = step(state, jbatch, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[1]


def test_resume_adds_exactly_one_epoch(data, tmp_path):
    first = train_baselines.main(_argv(data, tmp_path, "efcap", "--do_train", epochs=2),
                                 config_hook=small_hook())
    assert [e["epoch"] for e in first["epochs"]] == [0, 1]
    last = torch.load(tmp_path / "last.pt", map_location="cpu", weights_only=True)
    assert (last["epoch"], last["step"]) == (2, 8)
    again = train_baselines.main(_argv(data, tmp_path, "efcap", "--do_train",
                                       "--resume_from_checkpoint", "last", epochs=3),
                                 config_hook=small_hook())
    assert [(e["epoch"], e["first_step"], e["steps"]) for e in again["epochs"]] == [(2, 8, 4)]
    last = torch.load(tmp_path / "last.pt", map_location="cpu", weights_only=True)
    assert (last["epoch"], last["step"]) == (3, 12)
    assert "resumed from epoch 2 (step 8)" in (tmp_path / "train.log").read_text()


def test_efcap_reads_the_caption_file(data, tmp_path):
    """The same run with and without captions: the captions reach the
    inputs (the losses differ), and the log counts them."""
    images = sorted(os.listdir(os.path.join(data, "images")))
    captions = tmp_path / "captions.json"
    captions.write_text(json.dumps({n: "phòng rộng view biển đẹp" for n in images},
                                   ensure_ascii=False))
    plain = train_baselines.main(_argv(data, tmp_path / "plain", "efcap", "--do_train"),
                                 config_hook=small_hook())
    with_captions = train_baselines.main(
        _argv(data, tmp_path / "captions", "efcap", "--do_train", "--caption_file",
              str(captions)), config_hook=small_hook())
    assert plain["epochs"][0]["losses"] != with_captions["epochs"][0]["losses"]
    log = (tmp_path / "captions" / "train.log").read_text()
    assert f"{len(images)} captions from {captions}" in log


def test_hf_backbone_weights_load_into_roberta(data, tmp_path):
    """A `pytorch_model.bin` beside the tokenizer (HF RoBERTa names under
    `roberta.`, a head the model has no place for) lands in `roberta`."""
    import shutil
    tok = tmp_path / "tok"
    shutil.copytree(os.path.join(data, "tok"), tok)
    made = {}

    def model_hook(model, visual):
        made["model"] = model

    argv = [a if a != os.path.join(data, "tok") else str(tok)
            for a in _argv(data, tmp_path / "out", "efcap")]
    train_baselines.main(argv, config_hook=small_hook(), model_hook=model_hook)
    weights = {f"roberta.{k}": torch.randn_like(v)
               for k, v in made["model"].roberta.state_dict().items()}
    weights["lm_head.bias"] = torch.zeros(3)
    torch.save(weights, tok / "pytorch_model.bin")
    train_baselines.main(argv, config_hook=small_hook(), model_hook=model_hook)
    for key, value in made["model"].roberta.state_dict().items():
        assert torch.equal(value, weights[f"roberta.{key}"]), key


def test_driver_runs_on_the_card_unless_told_otherwise(data, tmp_path):
    argv = _argv(data, tmp_path, "mroberta", "--do_train")
    if not torch.cuda.is_available():
        without_device = [a for a in argv if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_baselines.main(without_device)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        train_baselines.main(argv + ["--fused_attention", "on"])
    assert train_baselines.build_argparser().get_default("device") == "cuda"


def test_flag_surface_covers_the_jax_driver():
    from macsa_tpu.train import train_baselines as jdriver
    theirs = {a.dest: a for a in jdriver.build_argparser()._actions}
    ours = {a.dest: a for a in train_baselines.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    for dest, action in theirs.items():
        assert ours[dest].default == action.default, dest
        assert ours[dest].choices == action.choices, dest
    assert train_baselines.build_argparser().parse_args(
        ["--model", "efcap", "--data_dir", "d", "--output_dir", "o", "--no-bf16"]).bf16 is False
