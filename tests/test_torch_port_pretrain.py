"""The port's Phase-1 training path and driver against the JAX package's.

* `make_pretrain_train_step` at dropout 0 against the JAX step (its Pallas
  attention kernel in interpret mode, pixels through the frozen ResNet):
  loss, gradients (one SGD step at rate 1: each parameter moves by -grad)
  and the parameters after two AdamW updates; full-logits and chunked loss.
* The host copies (`data/iaog.py`, `tools/iaog_labels.py`, `rouge_scores`)
  against the originals byte for byte; BERTScore, the checkpoint helpers
  and the encoder transfer against the JAX package's.
* `python -m macsa_tpu_torch.train.pretrain` as `main(argv)` on the port's
  synthetic dataset with `--device cpu`: artifacts, first losses against
  the JAX step fed the batches the driver's loader yields, bitwise resume,
  then `finetune.main --pretrained_iaog_path` starts from the transferred
  encoder (the port's counterpart of `test_pretrain_then_transfer`).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.data import iaog as jiaog
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.models.seq2seq import FCMFSeq2Seq as JSeq2Seq
from macsa_tpu.models.text_encoder import TextEncoder as JTextEncoder
from macsa_tpu.ops.image_prep import pack_pixels_u8 as jax_pack
from macsa_tpu.tools import iaog_labels as jlabels
from macsa_tpu.train import checkpoints as jcheckpoints
from macsa_tpu.train import generation as jgeneration
from macsa_tpu.train import optim as joptim
from macsa_tpu.train import pretrain as jpretrain
from macsa_tpu.train import steps as jsteps
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import iaog as tiaog
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.data.loader import DataLoader
from macsa_tpu_torch.data.tokenizer import WordLevelTokenizer, load_tokenizer
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.models.seq2seq import TIED_TABLE_NAMES
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq as TSeq2Seq
from macsa_tpu_torch.models.text_encoder import TextEncoder as TTextEncoder
from macsa_tpu_torch.tools import iaog_labels as tlabels
from macsa_tpu_torch.train import checkpoints, common, finetune, generation, jax_import, optim
from macsa_tpu_torch.train import pretrain
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_pretrain_train_step
from test_torch_port_models import jinit, randomize
from test_torch_port_slice import (IMG, KW, MODEL_KW, RESNET_KW, TEXT_KW, VOCAB, _torch_batch,
                                   serving_batch)

B, L, T = 2, 40, 8
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DEC_KW = dict(vocab_size=VOCAB, hidden_size=32, num_blocks=2, num_heads=4, ffn_hidden=32,
              max_decode_len=T)


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

def _port_model(params, dropout=0.0):
    drop = dict(hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    port = TSeq2Seq(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW, **drop),
                                    text=tcfg.TextEncoderConfig(**TEXT_KW, **drop), **KW),
                    tcfg.DecoderConfig(dropout=dropout, **DEC_KW))
    port.load_state_dict(jax_import.seq2seq_state_dict_from_jax(params, 2, 2), strict=True)
    return port


@pytest.fixture(scope="module")
def pair():
    """JAX FCMFSeq2Seq at dropout 0 (K1 in interpret mode) with random
    params, the visual pair, and one loader-shaped IAOG batch on both sides."""
    rng = np.random.default_rng(5)
    model = JSeq2Seq(
        jcfg.FCMFConfig(
            model=jcfg.ModelConfig(fused_attention_interpret=True, **MODEL_KW, **NO_DROPOUT),
            text=jcfg.TextEncoderConfig(fused_attention_interpret=True, **TEXT_KW,
                                        **NO_DROPOUT), **KW),
        jcfg.DecoderConfig(dropout=0.0, **DEC_KW))
    visual = JVisual(jcfg.ResNetConfig(**RESNET_KW))
    images, img_valid, rois, roi_valid, views = serving_batch(rng)
    dec_ids = rng.integers(3, VOCAB, size=(B, T)).astype(np.int32)
    dec_ids[1, 5:] = 1  # pad
    labels = np.roll(dec_ids, -1, axis=1)
    labels[:, -1] = -100
    labels[labels == 1] = -100
    text = {"enc_input_ids": views["input_ids"][:, 0], "dec_input_ids": dec_ids,
            "labels": labels, "token_type_ids": views["token_type_ids"][:, 0],
            "attention_mask": views["attention_mask"][:, 0],
            "added_mask": views["added_mask"][:, 0], "roi_coors": views["roi_coors"]}
    params = randomize(jinit(
        model, text["enc_input_ids"], dec_ids, np.zeros((B, 2, 4, 128), np.float32),
        np.zeros((B, 2, 2, 128), np.float32), text["roi_coors"], None,
        text["attention_mask"], text["added_mask"])["params"], rng)
    params["decoder"]["out_bias"] = rng.normal(0, 0.1, size=(VOCAB,)).astype(np.float32)
    visual_params = randomize(jinit(visual, np.zeros((1, IMG, IMG, 3), np.float32)), rng)
    jbatch = {k: jnp.asarray(v) for k, v in text.items()}
    jbatch["images"] = jnp.asarray(jax_pack(images, img_valid))
    jbatch["roi_images"] = jnp.asarray(jax_pack(rois, roi_valid))
    tbatch = _torch_batch(images, img_valid, rois, roi_valid, text)
    port_visual = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    port_visual.load_state_dict(
        jax_import.visual_state_dict_from_jax(visual_params["params"]), strict=True)
    return model, visual, params, visual_params, jbatch, port_visual, tbatch


def _jax_run(pair, tx, steps, vocab_chunk=0):
    model, visual, params, visual_params, jbatch, _, _ = pair
    state = JTrainState.create(params, visual_params, tx)
    step = jsteps.make_pretrain_train_step(model, visual, donate=False, vocab_chunk=vocab_chunk)
    metrics = []
    for _ in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


@pytest.mark.parametrize("vocab_chunk", [0, 24], ids=["full-logits", "chunked"])
def test_pretrain_step_loss_and_gradients_match_jax(pair, vocab_chunk):
    """One SGD step at rate 1: each parameter moves by -grad on both sides;
    the tied table by the sum of its three uses' gradients."""
    params, tbatch = pair[2], pair[6]
    new_params, (want,) = _jax_run(pair, optax.sgd(1.0), 1, vocab_chunk)
    port = _port_model(params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = TrainState.create(port, pair[5], torch.optim.SGD(port.parameters(), lr=1.0))
    got = make_pretrain_train_step(state, vocab_chunk=vocab_chunk)(tbatch, seed=0)
    assert state.step == 1 and not got["loss"].requires_grad
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["token_accuracy"]), want["token_accuracy"], rtol=1e-6)
    want_sd = jax_import.seq2seq_state_dict_from_jax(new_params, 2, 2)
    want_old = jax_import.seq2seq_state_dict_from_jax(params, 2, 2)
    moved = 0
    for name, now in port.state_dict().items():
        got_delta = (now - before[name]).numpy()
        want_delta = (want_sd[name] - want_old[name]).numpy()
        moved += bool(np.abs(want_delta).max() > 0)
        # summation order through 2+3 layers, 2 blocks and their backward, in
        # f32: 1e-4 of the largest gradient of that parameter, or 1e-6
        tol = max(1e-4 * np.abs(want_delta).max(), 1e-6)
        np.testing.assert_allclose(got_delta, want_delta, rtol=0, atol=tol, err_msg=name)
    assert moved > 0.9 * len(want_sd)
    assert not torch.equal(port.shared_embedding.detach(), before[TIED_TABLE_NAMES[0]])


def test_pretrain_step_adamw_parameters_match_jax(pair):
    """Two updates of the driver's single-rate AdamW (wd 1e-5, clipping at
    1.0) at rate 1e-3, the tied table decayed and moved once: parameters
    within 1e-6.  Adam divides each gradient by its own size, so where a
    gradient is far below its parameter's largest, the two sides' rounding
    (1e-4 of the largest) is a larger share of it and moves the update by
    more: at most one element in a thousand may be beyond 1e-6, none
    beyond 1e-5 (an update is 1e-3 at most).  The attention key biases are
    left out: their exact gradient is 0 (softmax is shift-invariant), so
    Adam scales each side's rounding noise up to a whole update."""
    params, tbatch = pair[2], pair[6]
    tx = joptim.make_adamw(1e-3, weight_decay=1e-5, eps=1e-8, max_grad_norm=1.0)
    new_params, want = _jax_run(pair, tx, 2)
    port = _port_model(params)
    opt = optim.AdamW(port, 1e-3, weight_decay=1e-5, eps=1e-8, max_grad_norm=1.0)
    step = make_pretrain_train_step(TrainState.create(port, pair[5], opt))
    got = [float(step(tbatch, seed=0)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, [m["loss"] for m in want], rtol=1e-5)
    want_sd = jax_import.seq2seq_state_dict_from_jax(new_params, 2, 2)
    beyond, total = 0, 0
    for name, now in port.state_dict().items():
        diff = (now - want_sd[name]).abs()
        if name.endswith("attention.self.key.bias"):
            assert diff.max() <= 4e-3, name  # two updates of 1e-3, opposite ways at worst
            continue
        assert diff.max() <= 1e-5, name
        beyond, total = beyond + int((diff > 1e-6).sum()), total + diff.numel()
    assert beyond <= 1e-3 * total, (beyond, total)
    assert len(opt.optimizer.state) == len(list(port.parameters()))


def test_pretrain_step_with_dropout_is_seeded_runs_on_cached_features_and_learns(pair):
    params, tbatch = pair[2], pair[6]
    with torch.no_grad():
        from macsa_tpu_torch.train.steps import extract_visual
        grid, roi = extract_visual(pair[5], tbatch["images"], tbatch["roi_images"])
    cached = {k: v for k, v in tbatch.items() if k not in ("images", "roi_images")}
    cached.update(grid=grid, roi=roi)

    def run(seed, steps, batch):
        port = _port_model(params, dropout=0.1)
        opt = optim.AdamW(port, optim.linear_warmup_schedule(2e-3, 2, 100), weight_decay=1e-5)
        step = make_pretrain_train_step(TrainState.create(port, pair[5], opt))
        return [float(step(batch, seed)["loss"]) for _ in range(steps)]

    first = run(0, 9, tbatch)
    assert np.isfinite(first).all() and first[-1] < first[0], first
    assert run(0, 2, tbatch) == first[:2]
    assert run(1, 2, tbatch) != first[:2]
    assert run(0, 2, cached) == first[:2]  # the features the ResNet would have made


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_synth")
    synth.write_dataset(str(root))  # 16 train / 4 dev reviews, 2 text layers
    return str(root)


def _records(data, split="train"):
    return common.load_records(os.path.join(data, "data", f"{split}_with_iaog.json"))


def test_iaog_dataset_is_the_original_byte_for_byte(data):
    boxes, dict_img, dict_roi = common.load_metadata(os.path.join(data, "data"))
    tok = load_tokenizer(os.path.join(data, "tok"))
    args = (tok, os.path.join(data, "images"), boxes, dict_img, dict_roi)
    kw = dict(num_img=2, num_roi=2, max_text_len=48, max_len_decoder=8, pixel_mode="packed")
    ours = tiaog.IAOGDataset(pretrain.preprocess_iaog_records(_records(data)), *args, **kw)
    theirs = jiaog.IAOGDataset(jpretrain.preprocess_iaog_records(_records(data)), *args, **kw)
    assert ours.records == theirs.records and ours.samples == theirs.samples
    assert len(ours) == len(theirs) > 16  # more than one aspect for some reviews
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k], k
            else:  # the packed frames: int32 words here, the same bytes as uint32 there
                assert a[k].dtype == b[k].dtype or k in ("images", "roi_images"), (i, k)
                assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), (i, k)
    sample = ours[0]
    assert sample["labels"][-1] == -100 and (sample["labels"] != -100).any()
    assert tiaog.group_iaog_labels(["a#Food", "b#Food", "a#Food", "c#Nowhere", "d"]) == \
        jiaog.group_iaog_labels(["a#Food", "b#Food", "a#Food", "c#Nowhere", "d"]) == \
        {"Food": ["a", "b"]}
    # the reader of tokenizer.json (what a machine without `transformers` gets)
    plain = tiaog.IAOGDataset(ours.records, WordLevelTokenizer.from_dir(
        os.path.join(data, "tok")), *args[1:], load_images=False, **kw)
    for k in ("enc_input_ids", "dec_input_ids", "labels", "attention_mask"):
        assert plain[3][k].tobytes() == ours[3][k].tobytes(), k


def test_iaog_labels_tool_writes_the_originals_files(data, tmp_path, capsys):
    lexicon = tmp_path / "emolex.csv"
    lexicon.write_text("word,positive,negative\nđẹp,1,0\nbẩn,0,1\nngon,1,0\ntốt,0,0\nsạch sẽ,1,0\n",
                       encoding="utf-8")
    adjectives = tmp_path / "adjectives.txt"
    adjectives.write_text("đẹp\nbẩn\nngon\ntốt\nsạch sẽ\n", encoding="utf-8")
    outputs = {}
    for name, tool in (("ours", tlabels), ("theirs", jlabels)):
        out = tmp_path / name
        out.mkdir()
        tool.main(["--data_dir", os.path.join(data, "data"), "--output_dir", str(out),
                   "--emolex", str(lexicon), "--adjective_lexicon", str(adjectives)])
        printed = capsys.readouterr().out.replace(str(out), "<out>")
        outputs[name] = (printed, {f: (out / f).read_bytes() for f in sorted(os.listdir(out))})
    assert outputs["ours"] == outputs["theirs"]
    printed, files = outputs["ours"]
    assert sorted(files) == ["dev_with_iaog.json", "test_with_iaog.json", "train_with_iaog.json"]
    assert "records with iaog_labels" in printed
    assert any(r["iaog_labels"] for r in json.loads(files["train_with_iaog.json"]))
    assert tlabels.implicit_aspects(["Food#Positive", "Room#Negative"], ["Room#Negative"]) == \
        jlabels.implicit_aspects(["Food#Positive", "Room#Negative"], ["Room#Negative"]) == ["Food"]


@pytest.mark.parametrize("pred,ref", [
    ("room đẹp , sạch", "room sạch , đẹp"), ("a b c d", "a c d e f"), ("", "a b"),
    ("a a a", "a"), ("food ngon", "food ngon")])
def test_rouge_scores_equal_the_originals(pred, ref):
    assert generation.rouge_scores(pred, ref) == jgeneration.rouge_scores(pred, ref)


def test_bert_score_matches_the_jax_one_on_a_random_backbone(data):
    rng = np.random.default_rng(9)
    tok = load_tokenizer(os.path.join(data, "tok"))
    kw = dict(vocab_size=len(tok), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=80)
    jenc = JTextEncoder(jcfg.TextEncoderConfig(**kw))
    params = randomize(jinit(jenc, np.full((1, 64), 5, np.int32))["params"], rng)
    port = TTextEncoder(tcfg.TextEncoderConfig(**kw))
    port.load_state_dict(jax_import.text_encoder_state_dict_from_jax(params, 2), strict=True)
    port.train()
    cands = ["room đẹp , sạch sẽ", "food ngon", "", "service chậm tệ"]
    refs = ["room sạch sẽ", "food ngon , rẻ", "location tốt", "service nhanh"]
    want = jgeneration.bert_score_f1(cands, refs, jenc, params, tok, batch_size=3)
    got = generation.bert_score_f1(cands, refs, port, tok, batch_size=3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0.0 < got < 1.0 and port.training  # the mode it was found in
    assert generation.bert_score_f1(refs, refs, port, tok) == pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------------------------------
# checkpoints and the encoder transfer
# ---------------------------------------------------------------------------

def test_resolve_iaog_checkpoint(tmp_path):
    """As `tests/test_checkpoints.py::test_resolve_iaog_checkpoint`, on
    files: an output directory (`best` first), a checkpoint file, nothing."""
    out = tmp_path / "out_pre"
    out.mkdir()
    (out / "last.pt").write_bytes(b"x")
    assert checkpoints.resolve_iaog_checkpoint(str(out)) == str(out / "last.pt")
    assert checkpoints.resolve_iaog_checkpoint(str(out / "last.pt")) == str(out / "last.pt")
    (out / "best.pt").write_bytes(b"x")
    assert checkpoints.resolve_iaog_checkpoint(str(out)) == str(out / "best.pt")
    assert checkpoints.resolve_iaog_checkpoint(str(tmp_path / "missing")) is None
    (tmp_path / "empty").mkdir()
    assert checkpoints.resolve_iaog_checkpoint(str(tmp_path / "empty")) is None


@pytest.mark.parametrize("new_size", [4, 6, 9])
def test_resize_embedding_extends_with_the_jax_packages_rows(new_size):
    table = np.arange(12, dtype=np.float32).reshape(6, 2)
    want = jcheckpoints.resize_embedding(table, new_size)
    got = checkpoints.resize_embedding(torch.from_numpy(table), new_size)
    assert got.dtype == torch.float32 and got.shape == (new_size, 2)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("fcmf_vocab", [VOCAB, VOCAB + 7, VOCAB - 5],
                         ids=["same-vocab", "larger", "smaller"])
def test_transfer_encoder_params_matches_jax(pair, fcmf_vocab):
    seq_params = pair[2]
    text_kw = {**TEXT_KW, "vocab_size": fcmf_vocab}
    jmodel = __import__("macsa_tpu.models.fcmf", fromlist=["FCMF"]).FCMF(jcfg.FCMFConfig(
        model=jcfg.ModelConfig(**MODEL_KW), text=jcfg.TextEncoderConfig(**text_kw), **KW))
    rng = np.random.default_rng(17)
    ids = np.full((1, L), 5, np.int32)
    fcmf_params = randomize(jinit(
        jmodel, ids, np.zeros((1, 2, 4, 128), np.float32), np.zeros((1, 2, 2, 128), np.float32),
        np.zeros((1, 2, 2, 4), np.float32), None, np.ones_like(ids),
        np.ones((1, L + 4), np.int32))["params"], rng)
    fcmf_params = jax.tree_util.tree_map(np.asarray, fcmf_params)
    want = jax_import.fcmf_state_dict_from_jax(
        jcheckpoints.transfer_encoder_params(seq_params, fcmf_params), 2)

    seq_sd = jax_import.seq2seq_state_dict_from_jax(seq_params, 2, 2)
    fcmf_sd = jax_import.fcmf_state_dict_from_jax(fcmf_params, 2)
    got = checkpoints.transfer_encoder_params(seq_sd, fcmf_sd)
    assert got.keys() == want.keys() == fcmf_sd.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    heads = [n for n in got if not n.startswith("encoder.")]
    assert sorted(heads) == ["classifier.bias", "classifier.weight", "text_pooler.dense.bias",
                             "text_pooler.dense.weight"]
    assert all(torch.equal(got[n], fcmf_sd[n]) for n in heads)  # the fresh init
    moved = [n for n in got if n.startswith("encoder.") and not torch.equal(got[n], fcmf_sd[n])]
    assert len(moved) > 0.9 * (len(got) - 4)
    assert got[checkpoints.WORD_EMBEDDINGS].shape[0] == fcmf_vocab
    # the port's classifier takes it whole
    port = TFCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                                 text=tcfg.TextEncoderConfig(**text_kw), **KW))
    port.load_state_dict(got, strict=True)
    # a state dict that names the table under the backbone's name only
    once = {k: v for k, v in seq_sd.items() if k not in TIED_TABLE_NAMES[:2]}
    again = checkpoints.transfer_encoder_params(once, fcmf_sd)
    assert all(torch.equal(again[n], got[n]) for n in got)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)


def _argv(data, out, *extra, epochs=2):
    return ["--pretrained_data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", str(out), "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--resnet_stages", "1,1,1,1",
            "--num_imgs", "2", "--num_rois", "2", "--no-bf16", "--max_seq_length", "48",
            "--max_len_decoder", "8", "--train_batch_size", "4", "--eval_batch_size", "4",
            "--num_train_epochs", str(epochs), "--log_every", "1", "--seed", "5", *extra]


def small_hook(dropout=None):
    """Narrow the models the flags built (the widths come from the tokenizer
    directory's config.json, 768) so that a run takes seconds."""
    def hook(cfg, dec_cfg, rcfg):
        extra = {} if dropout is None else dict(hidden_dropout_prob=dropout,
                                                attention_probs_dropout_prob=dropout)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **SMALL, **extra),
            text=dataclasses.replace(cfg.text, **SMALL, **extra),
            visual_feat_dim=4 * 32, box_heads=8)
        dec_cfg = dataclasses.replace(
            dec_cfg, hidden_size=32, num_heads=4, ffn_hidden=32, num_blocks=2,
            **({} if dropout is None else {"dropout": dropout}))
        return cfg, dec_cfg, dataclasses.replace(rcfg, num_filters=4)
    return hook


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def phase1(data, tmp_path_factory):
    """One Phase-1 run, two epochs with eval, a shared disk feature cache."""
    root = tmp_path_factory.mktemp("phase1")
    result = pretrain.main(_argv(data, root / "out", "--do_train", "--do_eval",
                                 "--debug_decode_every", "3", "--feature_cache_dir",
                                 str(root / "features")), config_hook=small_hook())
    return root, result


def test_driver_pretrains_evaluates_and_writes_the_artifacts(phase1):
    root, result = phase1
    out = root / "out"
    for name in ("best.pt", "last.pt", "train.log", "metrics.jsonl"):
        assert (out / name).is_file(), name
    cold, warm = result["epochs"]
    steps = cold["steps"]
    assert steps == warm["steps"] >= 5 and warm["first_step"] == steps
    assert len(cold["losses"]) == len(warm["losses"]) == steps
    assert np.isfinite(cold["losses"] + warm["losses"]).all()
    assert warm["mean_loss"] < cold["mean_loss"]
    assert result["best_train_loss"] == warm["mean_loss"]
    np.testing.assert_allclose(warm["mean_loss"], np.mean(warm["losses"]), rtol=1e-6)
    assert set(result["generation"]) == {"rouge1", "rougeL", "bertscore_f1"}
    assert all(0.0 <= v <= 1.0 for v in result["generation"].values())
    records = _metrics(out)
    assert [r["epoch_steps"] for r in records if "epoch_steps" in r] == [steps, steps]
    assert [r["step"] for r in records if "token_accuracy" in r] == list(range(1, 2 * steps + 1))
    log = (out / "train.log").read_text()
    assert "visual feature cache:" in log and "--prng rbg, --scan_decoder on: ignored" in log
    assert log.count("[debug] src=") == 2 * 2 * (steps // 3) and "dev generation:" in log
    best = torch.load(out / "best.pt", map_location="cpu", weights_only=True)
    assert best["epoch"] == 2 and best["best_score"] == -warm["mean_loss"]
    assert set(TIED_TABLE_NAMES) <= set(best["model"])
    # one feature-cache entry a review, not one a sample
    assert len([n for n in os.listdir(root / "features") if n.endswith(".grid.npy")]) == 16


def test_finetune_starts_from_the_transferred_encoder(phase1, data, tmp_path):
    """The port's counterpart of `test_e2e_driver.py::test_pretrain_then_transfer`:
    `--pretrained_iaog_path <Phase-1 output>` loads `best.pt`'s encoder and
    token table, keeps the head's init, and finds Phase 1's disk features."""
    root, _ = phase1
    seen = {}

    def hook(cfg, rcfg):
        cfg, _, rcfg = small_hook()(cfg, tcfg.DecoderConfig(), rcfg)
        return cfg, rcfg

    argv = ["--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--pretrained_hf_model", os.path.join(data, "tok"),
            "--device", "cpu", "--resnet_stages", "1,1,1,1", "--num_imgs", "2", "--num_rois",
            "2", "--no-bf16", "--max_seq_length", "48", "--train_batch_size", "4",
            "--num_train_epochs", "1", "--log_every", "1", "--seed", "5", "--do_train"]
    result = finetune.main(
        argv + ["--output_dir", str(tmp_path / "ft"), "--pretrained_iaog_path",
                str(root / "out"), "--feature_cache_dir", str(root / "features")],
        config_hook=hook,
        model_hook=lambda model, visual: seen.update(
            {k: v.clone() for k, v in model.state_dict().items()}))
    phase1_model = torch.load(root / "out" / "best.pt", map_location="cpu",
                              weights_only=True)["model"]
    encoder = [k for k in seen if k.startswith("encoder.")]
    assert len(encoder) > 60
    for name in encoder:
        assert torch.equal(seen[name], phase1_model[name]), name
    assert torch.equal(seen[checkpoints.WORD_EMBEDDINGS], phase1_model["decoder.embedding.weight"])
    log = (tmp_path / "ft" / "train.log").read_text()
    assert "Transferring IAOG encoder from" in log and "best.pt" in log
    assert "prefilled 16/16 rows from disk" in log  # Phase 1's extraction, found by content
    assert result["epochs"][0]["steps"] == 4 and np.isfinite(result["epochs"][0]["losses"]).all()

    # the head keeps the init a run without the transfer gets; nothing found -> from scratch
    scratch = {}
    finetune.main(argv + ["--output_dir", str(tmp_path / "scratch"), "--pretrained_iaog_path",
                          str(tmp_path / "nowhere"), "--num_train_epochs", "0"],
                  config_hook=hook,
                  model_hook=lambda model, visual: scratch.update(
                      {k: v.clone() for k, v in model.state_dict().items()}))
    assert "no IAOG checkpoint under" in (tmp_path / "scratch" / "train.log").read_text()
    same = {name for name in seen if torch.equal(seen[name], scratch[name])}
    assert {"classifier.weight", "classifier.bias", "text_pooler.dense.weight"} <= same
    # Phase 1 moved the encoder (but for what its loss does not reach, as the
    # backbone's pooler, which both drivers draw alike from one seed)
    assert len([n for n in encoder if n not in same]) > 0.9 * len(encoder)
    # a checkpoint file instead of the directory
    direct = {}
    finetune.main(argv + ["--output_dir", str(tmp_path / "direct"), "--pretrained_iaog_path",
                          str(root / "out" / "last.pt"), "--num_train_epochs", "0"],
                  config_hook=hook,
                  model_hook=lambda model, visual: direct.update(model.state_dict()))
    assert all(torch.equal(direct[k], seen[k]) for k in seen)  # best and last: one payload


def test_first_losses_match_the_jax_train_step(data, tmp_path):
    """Dropout 0, parameters made in JAX and carried over, the batches the
    driver's loader yields: the driver's first two losses against
    `macsa_tpu`'s pretrain step.  rtol 1e-4: f32 on both sides, sums in
    other orders through the ResNet, five transformer layers and two
    decoder blocks, one AdamW update between."""
    argv = _argv(data, tmp_path, "--do_train", "--debug_decode_every", "0", epochs=1)
    args = pretrain.build_argparser().parse_args(argv)
    made = {}

    def config_hook(cfg, dec_cfg, rcfg):
        made["cfg"], made["dec"], made["rcfg"] = small_hook(dropout=0.0)(cfg, dec_cfg, rcfg)
        return made["cfg"], made["dec"], made["rcfg"]

    def model_hook(model, visual):
        cfg, dec, rcfg = made["cfg"], made["dec"], made["rcfg"]
        kw = dict(**NO_DROPOUT, **SMALL)
        jconfig = jcfg.FCMFConfig(
            model=jcfg.ModelConfig(**kw),
            text=jcfg.TextEncoderConfig(
                vocab_size=cfg.text.vocab_size, num_hidden_layers=cfg.text.num_hidden_layers,
                max_position_embeddings=cfg.text.max_position_embeddings,
                type_vocab_size=cfg.text.type_vocab_size, **kw),
            num_imgs=2, num_roi=2, visual_feat_dim=cfg.visual_feat_dim, max_text_len=48)
        jmodel = JSeq2Seq(jconfig, jcfg.DecoderConfig(
            vocab_size=dec.vocab_size, hidden_size=32, num_blocks=2, num_heads=4, ffn_hidden=32,
            max_decode_len=8, dropout=0.0))
        jvisual = JVisual(jcfg.ResNetConfig(stage_sizes=rcfg.stage_sizes, num_filters=4,
                                            dtype="float32"))
        rng = np.random.default_rng(0)
        ids = np.full((1, 48), 5, np.int32)
        params = randomize(jinit(
            jmodel, ids, np.full((1, 8), 5, np.int32), np.zeros((1, 2, 49, 128), np.float32),
            np.zeros((1, 2, 2, 128), np.float32), np.zeros((1, 2, 2, 4), np.float32), None,
            np.ones_like(ids), np.ones((1, 48 + 49), np.int32))["params"], rng)
        visual_params = randomize(jinit(jvisual, np.zeros((1, 224, 224, 3), np.float32)), rng)
        model.load_state_dict(jax_import.seq2seq_state_dict_from_jax(params, 2, 2), strict=True)
        visual.load_state_dict(jax_import.visual_state_dict_from_jax(visual_params["params"]),
                               strict=True)
        made.update(jmodel=jmodel, jvisual=jvisual, params=params, visual_params=visual_params)

    result = pretrain.main(argv, config_hook=config_hook, model_hook=model_hook)
    steps = result["epochs"][0]["steps"]
    got = result["epochs"][0]["losses"][:2]

    boxes, dict_img, dict_roi = common.load_metadata(args.pretrained_data_dir)
    dataset = tiaog.IAOGDataset(
        pretrain.preprocess_iaog_records(_records(data)), load_tokenizer(args.pretrained_hf_model),
        args.image_dir, boxes, dict_img, dict_roi, num_img=2, num_roi=2, max_text_len=48,
        max_len_decoder=8, pixel_mode="packed")
    loader = DataLoader(dataset, 4, shuffle=True, seed=args.seed, drop_last=True, num_workers=2)
    tx = joptim.make_adamw(
        joptim.linear_warmup_schedule(args.learning_rate, int(steps * 0.1), steps),
        weight_decay=args.weight_decay, eps=args.adam_epsilon, max_grad_norm=args.max_grad_norm)
    state = JTrainState.create(made["params"], made["visual_params"], tx)
    step = jsteps.make_pretrain_train_step(made["jmodel"], made["jvisual"], donate=False)
    want = []
    for batch, _ in zip(loader, range(2)):
        jbatch = {k: jnp.asarray(v.view(np.uint32) if k in ("images", "roi_images") else v)
                  for k, v in batch.items()
                  if k not in ("_idx", "text", "target_aspect", "orig_idx")}
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
    return flat, {k: got[k] for k in ("step", "epoch")}


def test_driver_resumes_bitwise(data, tmp_path, monkeypatch):
    """Three epochs straight, against the same run stopped right after its
    second epoch's checkpoint and resumed from `last`: dropout is on, the
    schedule is the same, the caches start empty again, and the final
    checkpoints hold the same bits."""
    hook = small_hook()
    extra = ("--do_train", "--debug_decode_every", "4", "--vocab_chunk", "16")
    straight = pretrain.main(_argv(data, tmp_path / "straight", *extra, epochs=3),
                             config_hook=hook)
    save, copy = checkpoints.CheckpointManager.save, checkpoints.CheckpointManager.copy
    saved = []

    def save_then_stop(self, tag, state, epoch, best_score=0.0):
        save(self, tag, state, epoch, best_score)
        saved.append(epoch)
        if epoch == 2 and tag == "last":
            raise _Stop

    def copy_then_stop(self, src, dst):  # an epoch that improves saves `best`, copies it to `last`
        copy(self, src, dst)
        if saved[-1] == 2:
            raise _Stop

    stopped_argv = _argv(data, tmp_path / "stopped", *extra, epochs=3)
    with monkeypatch.context() as patch:
        patch.setattr(checkpoints.CheckpointManager, "save", save_then_stop)
        patch.setattr(checkpoints.CheckpointManager, "copy", copy_then_stop)
        with pytest.raises(_Stop):
            pretrain.main(stopped_argv, config_hook=hook)
    resumed = pretrain.main(stopped_argv + ["--resume_from_checkpoint", "last"],
                            config_hook=hook)
    steps = straight["epochs"][0]["steps"]
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    assert resumed["epochs"][0]["first_step"] == 2 * steps
    assert resumed["epochs"][0]["losses"] == straight["epochs"][2]["losses"]
    assert resumed["best_train_loss"] == straight["best_train_loss"]
    want, want_meta = _last_tensors(tmp_path / "straight")
    got, got_meta = _last_tensors(tmp_path / "stopped")
    assert got_meta == want_meta == {"step": 3 * steps, "epoch": 3}
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_flag_surface_covers_the_jax_drivers_and_the_card_is_the_default(data, tmp_path):
    theirs = {a.dest: a for a in jpretrain.build_argparser()._actions}
    ours = {a.dest: a for a in pretrain.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) <= set(ours)
    for dest, action in theirs.items():
        assert ours[dest].default == action.default, dest
        assert ours[dest].choices == action.choices, dest
    assert pretrain.build_argparser().get_default("device") == "cuda"
    for flag in ("--prng", "--scan_decoder"):
        assert "ignored" in next(a.help for a in ours.values() if flag in a.option_strings)
    argv = _argv(data, tmp_path / "out", "--do_train")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        pretrain.main(argv + ["--fused_attention", "on"])


@pytest.mark.parametrize("flags,reason", [
    (["--mp", "2"], "--mp 2 does not divide the 1 processes of the run")])
def test_driver_refuses_what_is_not_ported_with_its_reason(data, tmp_path, flags, reason):
    # tensor parallelism is ported (tests/test_torch_port_tp.py); what is
    # refused is an mp that does not divide the processes
    with pytest.raises(ValueError, match=reason):
        pretrain.main(_argv(data, tmp_path, "--do_train", *flags))
    assert not os.listdir(tmp_path)  # refused before anything is written


def test_hf_backbone_file_fills_the_tied_table_resized_to_the_tokenizer(data, tmp_path):
    """A `pytorch_model.bin` beside the tokenizer: its word embeddings (of
    another vocabulary size) become the tied table, truncated or extended
    to the tokenizer's length as `resize_embedding` does."""
    import shutil
    tok_dir = tmp_path / "tok"
    shutil.copytree(os.path.join(data, "tok"), tok_dir)
    hf_config = json.loads((tok_dir / "config.json").read_text())
    text_cfg = common.text_config_from_hf(hf_config, "float32")
    text_cfg = dataclasses.replace(text_cfg, **SMALL)
    donor = TTextEncoder(text_cfg)
    from macsa_tpu_torch.models.layers import init_weights
    init_weights(donor, torch.Generator().manual_seed(3), 0.02)
    vocab = len(load_tokenizer(str(tok_dir)))
    sd = {f"roberta.{k}": v for k, v in donor.state_dict().items()}
    table = torch.randn(vocab - 6, 32, generator=torch.Generator().manual_seed(4))
    sd["roberta.embeddings.word_embeddings.weight"] = table
    torch.save(sd, tok_dir / "pytorch_model.bin")
    seen = {}
    argv = _argv(data, tmp_path / "out", epochs=0)
    argv[argv.index("--pretrained_hf_model") + 1] = str(tok_dir)
    pretrain.main(argv, config_hook=small_hook(),
                  model_hook=lambda model, visual: seen.update(model.state_dict()))
    want = checkpoints.resize_embedding(table, vocab)
    for name in TIED_TABLE_NAMES:
        assert torch.equal(seen[name], want), name
    assert torch.equal(seen["encoder.bert.cell.pooler.dense.weight"],
                       donor.state_dict()["pooler.dense.weight"])
    assert "tied token table resized to" in (tmp_path / "out" / "train.log").read_text()
