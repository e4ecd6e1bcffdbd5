"""Data parallelism in the port (`macsa_tpu_torch/parallel/mesh.py`): two
processes over gloo on the CPU against one process at the same global batch.

One two-rank job (subprocesses on a free port, as
`tests/test_multiprocess.py` runs the JAX package's) runs, in order:
* `fetch_global` on rank-tagged rows: every rank gets all rows, rank order;
* the Phase-2 train step at dropout 0, global batch 4 (2 a rank), 3 AdamW
  steps on cached features: the global loss of each step and the
  parameters after them equal one process on the 4 rows;
* the Phase-1 train step with UNEQUAL valid-token counts between the ranks
  (2 and 6 a row): the loss is the mean over the global batch's valid
  tokens, so losses and parameters after 2 steps equal one process's;
* the visual feature cache when a row reaches a rank after a peer filled
  it (a Phase-1 review whose samples sit on both sides of the train
  shards' boundary): the rank extracts the row itself and never reads a
  row of its cache that it did not fill;
* `finetune.main` on a tiny synthetic set (4 train rows, one step an
  epoch, 2 epochs, dropout 0): its losses, its dev and test reports equal
  one process's at the global batch, and only rank 0 writes files.  (The
  LR schedule counts len(train) / --train_batch_size steps, as the JAX
  driver and the reference do, so two ranks stretch it twofold; the
  first two updates take rate 0 and the base rate either way.)
* `pretrain.main` the same way (3 epochs), over 3 reviews whose 6 samples
  put review 1 on both ranks, with the feature cache on (the later epochs
  read it) and on disk, and `train_baselines.main` with TomBERT.
Dropout is 0 throughout: each data-parallel rank draws its own masks
(`DropoutRng` keyed by its index, K1's seed offset by it;
`tests/test_torch_port_rank_streams.py`), and one process draws one set
over the global batch, so with dropout on two ranks do not reproduce one
process bit for bit, only in distribution (as JAX's global mask and the
port's per-rank ones do).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.data.iaog import group_iaog_labels
from macsa_tpu_torch.train import finetune, optim, pretrain, train_baselines
from macsa_tpu_torch.train.feature_cache import FeatureCacheFeeder
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import (
    extract_visual,
    make_finetune_train_step,
    make_pretrain_train_step,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD, GLOBAL_B, VOCAB, L, T = 2, 4, 64, 12, 8
PRETRAIN_SAMPLES = 6  # the aspect samples of the Phase-1 set's 3 reviews
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32,
             fused_attention=False, **NO_DROPOUT)
TEXT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=64, fused_attention=False,
            **NO_DROPOUT)
FCMF_ARGS = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=L,
                 box_heads=4)
SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)


def _cfg() -> tcfg.FCMFConfig:
    return tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL), text=tcfg.TextEncoderConfig(**TEXT),
                           **FCMF_ARGS)


def _features(rng, b):
    return {"grid": rng.normal(size=(b, 2, 4, 128)).astype(np.float32),
            "roi": rng.normal(size=(b, 2, 2, 128)).astype(np.float32),
            "roi_coors": rng.uniform(0, 1, size=(b, 2, 2, 4)).astype(np.float32)}


def _local(batch: dict) -> dict:
    """This process's rows of the global batch: its contiguous share."""
    r, n = mesh.process_index(), mesh.process_count()
    per = GLOBAL_B // n
    return {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}


def _state(model) -> TrainState:
    """Seeded weights and AdamW.  Its eps is 1e-4, not 1e-8: a gradient that
    is zero in exact arithmetic (an attention key's bias: softmax ignores a
    shift shared by every key) is rounding noise of ~1e-9 that depends on
    the summation order, and at eps 1e-8 Adam would scale that noise up to
    a step of the learning rate's size."""
    init_weights(model, torch.Generator().manual_seed(0), 0.2)
    visual = VisualFeatures(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                              dtype="float32"))
    return TrainState.create(model, visual, optim.AdamW(model, 1e-3, eps=1e-4))


def phase2_run(steps: int = 3) -> dict:
    """The Phase-2 train step on the global batch (this rank's share of it)."""
    rng = np.random.default_rng(0)
    a = len(tcfg.ASPECTS)
    batch = {"input_ids": rng.integers(2, VOCAB, size=(GLOBAL_B, a, L)).astype(np.int32),
             "token_type_ids": np.zeros((GLOBAL_B, a, L), np.int32),
             "attention_mask": (np.arange(L) < rng.integers(3, L + 1, size=(GLOBAL_B, a, 1))
                                ).astype(np.int32),
             "added_mask": np.ones((GLOBAL_B, a, L + 4), np.int32),
             "labels": rng.integers(0, 4, size=(GLOBAL_B, a)).astype(np.int32),
             **_features(rng, GLOBAL_B)}
    state = _state(FCMF(_cfg()))
    mesh.replicate(state.model)
    step = make_finetune_train_step(state)
    local = _local(batch)
    losses = [float(mesh.all_mean(step(local, 7)["loss"])) for _ in range(steps)]
    return {"losses": losses, "params": {k: v.numpy().copy()
                                         for k, v in state.model.state_dict().items()}}


def phase1_run(steps: int = 2) -> dict:
    """The Phase-1 train step; rank 0's rows hold 2 valid label tokens
    each, rank 1's 6."""
    rng = np.random.default_rng(1)
    dec = rng.integers(3, VOCAB, size=(GLOBAL_B, T)).astype(np.int32)
    labels = np.roll(dec, -1, axis=1)
    labels[:2, 2:] = -100
    labels[2:, 6:] = -100
    batch = {"enc_input_ids": rng.integers(2, VOCAB, size=(GLOBAL_B, L)).astype(np.int32),
             "dec_input_ids": dec, "labels": labels,
             "token_type_ids": np.zeros((GLOBAL_B, L), np.int32),
             "attention_mask": np.ones((GLOBAL_B, L), np.int32),
             "added_mask": np.ones((GLOBAL_B, L + 4), np.int32), **_features(rng, GLOBAL_B)}
    dec_cfg = tcfg.DecoderConfig(vocab_size=VOCAB, hidden_size=32, num_blocks=1, num_heads=4,
                                 ffn_hidden=32, max_decode_len=T, dropout=0.0)
    state = _state(FCMFSeq2Seq(_cfg(), dec_cfg))
    mesh.replicate(state.model)
    step = make_pretrain_train_step(state)
    local = _local(batch)
    losses, accs = [], []
    for _ in range(steps):
        metrics = step(local, 7)
        losses.append(float(mesh.all_mean(metrics["loss"])))
        accs.append(float(metrics["token_accuracy"]))
    return {"losses": losses, "accuracy": accs,
            "params": {k: v.numpy().copy() for k, v in state.model.state_dict().items()}}


def _visual() -> VisualFeatures:
    visual = VisualFeatures(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                              dtype="float32"))
    init_weights(visual, torch.Generator().manual_seed(1))
    return visual


def _pixels(rows) -> dict:
    """Each row's uint8 images and ROI crops, made from the row's index."""
    out = {"images": [], "roi_images": []}
    for r in rows:
        rng = np.random.default_rng(100 + r)
        out["images"].append(rng.integers(0, 256, (2, 224, 224, 3), np.uint8))
        out["roi_images"].append(rng.integers(0, 256, (2, 2, 32, 32, 3), np.uint8))
    return {k: np.stack(v) for k, v in out.items()}


# the feeder's rows on (rank 0, rank 1), step by step: row 1 reaches rank 1
# at step 1, after rank 0 alone filled it at step 0
FEEDER_ROWS = (((0, 1), (2, 3)), ((0, 1), (1, 2)))


def feeder_run() -> dict:
    """The Phase-1 feature cache (`orig_idx` rows) over FEEDER_ROWS: each
    step's features, and the rows filled and owned after each step."""
    cfg = dataclasses.replace(_cfg(), num_patches=49)  # the ResNet's 7 x 7 grid
    feeder = FeatureCacheFeeder(_visual(), cfg, 4, torch.device("cpu"), "orig_idx")
    out = []
    for rows in FEEDER_ROWS:
        mine = rows[mesh.process_index()]
        sent = feeder({"orig_idx": np.asarray(mine), **_pixels(mine)})
        out.append({"rows": mine, "grid": sent["grid"].numpy(), "roi": sent["roi"].numpy(),
                    "filled": np.nonzero(feeder.filled)[0].tolist(),
                    "owned": np.nonzero(feeder.owned)[0].tolist()})
    return {"steps": out}


def driver_hook(cfg, rcfg):
    """The fine-tune driver's model at the test's width, dropout 0."""
    rcfg = dataclasses.replace(rcfg, num_filters=4)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **SMALL, **NO_DROPOUT),
        text=dataclasses.replace(cfg.text, **SMALL, **NO_DROPOUT),
        visual_feat_dim=4 * 32, box_heads=8)
    return cfg, rcfg


def driver_argv(data: str, out: str, batch: int) -> list:
    return ["--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--resnet_stages", "1,1,1,1",
            "--num_imgs", "2", "--num_rois", "2", "--no-bf16", "--max_seq_length", "48",
            "--train_batch_size", str(batch), "--eval_batch_size", str(batch),
            "--num_train_epochs", "2", "--log_every", "1", "--seed", "5",
            "--do_train", "--do_eval", "--do_test"]


def driver_run(data: str, out: str) -> dict:
    """`finetune.main` at the global batch of 4: 2 a rank under two ranks."""
    result = finetune.main(driver_argv(data, out, GLOBAL_B // mesh.process_count()),
                           config_hook=driver_hook)
    return {"losses": [e["losses"] for e in result["epochs"]],
            "best_dev_f1": result["best_dev_f1"], "test": result["test"]}


def pretrain_hook(cfg, dec_cfg, rcfg):
    """The Phase-1 driver's models at the test's width, dropout 0."""
    cfg, rcfg = driver_hook(cfg, rcfg)
    dec_cfg = dataclasses.replace(dec_cfg, hidden_size=32, num_heads=4, ffn_hidden=32,
                                  num_blocks=1, dropout=0.0)
    return cfg, dec_cfg, rcfg


def pretrain_run(data: str, out: str) -> dict:
    """`pretrain.main` over PRETRAIN_SAMPLES samples, all of them in the
    global batch: half a rank under two ranks."""
    batch = PRETRAIN_SAMPLES // mesh.process_count()
    argv = ["--pretrained_data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--resnet_stages", "1,1,1,1",
            "--num_imgs", "2", "--num_rois", "2", "--no-bf16", "--max_seq_length", "48",
            "--max_len_decoder", "8", "--train_batch_size", str(batch),
            "--num_train_epochs", "3", "--log_every", "1", "--seed", "5", "--do_train",
            "--debug_decode_every", "1", "--cache_visual_features", "on",
            "--feature_cache_dir", os.path.join(out, "features")]
    result = pretrain.main(argv, config_hook=pretrain_hook)
    return {"losses": [e["losses"] for e in result["epochs"]],
            "mean_losses": [e["mean_loss"] for e in result["epochs"]],
            "best_train_loss": result["best_train_loss"]}


def baseline_hook(text_cfg, rcfg):
    """The baseline driver's TomBERT at the test's width, dropout 0."""
    return (dataclasses.replace(text_cfg, **SMALL, **NO_DROPOUT),
            dataclasses.replace(rcfg, stage_sizes=(1, 1, 1, 1), num_filters=4))


def baseline_run(data: str, out: str) -> dict:
    """`train_baselines.main --model tomroberta` at the global batch of 4."""
    batch = str(GLOBAL_B // mesh.process_count())
    argv = ["--model", "tomroberta", "--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
            os.path.join(data, "tok"), "--device", "cpu", "--num_imgs", "2", "--num_rois",
            "2", "--no-bf16", "--max_seq_length", "48", "--train_batch_size", batch,
            "--eval_batch_size", batch, "--num_train_epochs", "2", "--log_every", "1",
            "--seed", "5", "--do_train", "--do_eval", "--do_test"]
    result = train_baselines.main(argv, config_hook=baseline_hook)
    return {"losses": [e["losses"] for e in result["epochs"]],
            "best_dev_f1": result["best_dev_f1"], "test": result["test"]}


def worker(rank: int, port: int, out: str, data: str, pdata: str) -> None:
    """One rank of the two-rank job: every check's numbers to `out`."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    try:
        rows = mesh.fetch_global(np.full((3, 2), rank, np.int32) + np.arange(3)[:, None] * 10)
        got = {"fetch": rows.tolist(), "phase2": phase2_run(), "phase1": phase1_run(),
               "feeder": feeder_run(),
               "driver": driver_run(data, os.path.join(out, "driver")),
               "pretrain": pretrain_run(pdata, os.path.join(out, "pretrain")),
               "baseline": baseline_run(data, os.path.join(out, "baseline"))}
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The two-rank job's results, and the synthetic files it trained on."""
    root = tmp_path_factory.mktemp("ddp")
    data = str(root / "synth")
    synth.write_dataset(data, n_train=GLOBAL_B, n_dev=5, n_test=4)
    pdata = str(root / "synth_iaog")
    synth.write_dataset(pdata, n_train=3, n_dev=4, n_test=4, seed=0)
    out = root / "job"
    out.mkdir()
    port = _free_port()
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); sys.path.insert(0, {REPO!r}); "
            "import test_torch_port_ddp as t; "
            "t.worker(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(out), data,
                               pdata],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "data": data, "pdata": pdata, "out": out, "logs": logs}


def _close(got: dict, want: dict, rtol=1e-5, atol=1e-6) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol, atol=atol)
    assert set(got["params"]) == set(want["params"])
    for name, value in want["params"].items():
        np.testing.assert_allclose(got["params"][name], value, rtol=rtol, atol=atol,
                                   err_msg=name)


def test_fetch_global_concatenates_in_rank_order(job):
    want = [[0, 0], [10, 10], [20, 20], [1, 1], [11, 11], [21, 21]]
    assert [r["fetch"] for r in job["ranks"]] == [want, want]
    assert mesh.process_count() == 1 and mesh.fetch_global(np.ones(2)).tolist() == [1, 1]


def test_phase2_step_matches_one_process_at_the_global_batch(job):
    want = phase2_run()
    for rank in job["ranks"]:
        _close(rank["phase2"], want)
    assert want["losses"][0] != want["losses"][-1]  # the steps moved the model


def test_phase1_step_with_unequal_valid_tokens_matches_one_process(job):
    want = phase1_run()
    for rank in job["ranks"]:
        _close(rank["phase1"], want)
        np.testing.assert_allclose(rank["phase1"]["accuracy"], want["accuracy"], atol=1e-6)
    # a mean of the two ranks' own means would weight rank 0's 4 tokens
    # like rank 1's 12: not the global mean the step takes
    assert want["losses"][0] != want["losses"][1]


def test_finetune_driver_under_two_ranks_matches_one_process(job, tmp_path):
    want = driver_run(job["data"], str(tmp_path / "single"))
    for rank in job["ranks"]:
        got = rank["driver"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]),
                                   rtol=0, atol=1e-4)
        assert got["test"] == want["test"] and got["best_dev_f1"] == want["best_dev_f1"]
    out = job["out"] / "driver"
    # rank 0 alone wrote: one metrics line a step and an epoch as one process
    for name in ("best.pt", "last.pt", "train.log", "metrics.jsonl", "test_results_fcmf.txt",
                 "test_predictions_formatted.txt"):
        assert (out / name).is_file(), name
    single = (tmp_path / "single" / "metrics.jsonl").read_text().splitlines()
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in lines] == [sorted(json.loads(x)) for x in single]
    assert (out / "test_results_fcmf.txt").read_text() == \
        (tmp_path / "single" / "test_results_fcmf.txt").read_text()
    assert not [n for n in os.listdir(out) if n.endswith(".tmp") or "copy-tmp" in n]


def test_feature_cache_rank_extracts_a_row_a_peer_filled(job):
    """Row 1 is filled by rank 0 at step 0; at step 1 it reaches rank 1,
    whose step is cold on that rank although every row of the global step
    is owned: rank 1 extracts it from its pixels, as one process would."""
    visual = _visual()
    for rank, got in enumerate(job["ranks"]):
        for step, rows in zip(got["feeder"]["steps"], FEEDER_ROWS):
            assert step["rows"] == rows[rank]
            px = {k: torch.from_numpy(v) for k, v in _pixels(rows[rank]).items()}
            with torch.no_grad():
                grid, roi = extract_visual(visual, px["images"], px["roi_images"],
                                           out_dtype=torch.float32)
            np.testing.assert_allclose(step["grid"], grid.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(step["roi"], roi.numpy(), rtol=1e-6, atol=1e-6)
            assert torch.isfinite(grid).all() and (grid.abs().reshape(2, -1).amax(1) > 0).all()
            assert step["owned"] == [0, 1, 2, 3]
        filled = [[0, 1], [0, 1]] if rank == 0 else [[2, 3], [1, 2, 3]]
        assert [s["filled"] for s in got["feeder"]["steps"]] == filled


def test_pretrain_driver_under_two_ranks_matches_one_process(job, tmp_path):
    pdata = job["pdata"]
    recs = json.loads(open(os.path.join(pdata, "data", "train_with_iaog.json")).read())
    orig = [i for i, r in enumerate(recs) for _ in group_iaog_labels(r.get("iaog_labels"))]
    # review 1's samples sit on both ranks' shards, and all fit one global step
    assert len(orig) == PRETRAIN_SAMPLES and orig[2] == orig[3] == 1
    want = pretrain_run(pdata, str(tmp_path / "single"))
    # update 0 takes rate 0 (the schedule's warmup), update 1 the base rate
    # under one process and two ranks alike: epoch 2's loss shows it
    assert want["losses"][0] == want["losses"][1] != want["losses"][2]
    for rank in job["ranks"]:
        got = rank["pretrain"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["best_train_loss"], want["best_train_loss"],
                                   rtol=0, atol=1e-4)
    out = job["out"] / "pretrain"
    for name in ("best.pt", "last.pt", "train.log", "metrics.jsonl"):
        assert (out / name).is_file(), name
    single = (tmp_path / "single" / "metrics.jsonl").read_text().splitlines()
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in lines] == [sorted(json.loads(x)) for x in single]
    # one disk feature-cache entry a review, review 1 written by both ranks
    assert len([n for n in os.listdir(out / "features") if n.endswith(".grid.npy")]) == 3
    log = (out / "train.log").read_text()
    assert log.count("[debug] src=") == 3 * 2  # rank 0 alone: 2 samples a step


def test_baseline_driver_under_two_ranks_matches_one_process(job, tmp_path):
    want = baseline_run(job["data"], str(tmp_path / "single"))
    for rank in job["ranks"]:
        got = rank["baseline"]
        np.testing.assert_allclose(np.asarray(got["losses"]), np.asarray(want["losses"]),
                                   rtol=0, atol=1e-4)
        assert got["test"] == want["test"] and got["best_dev_f1"] == want["best_dev_f1"]
    out = job["out"] / "baseline"
    for name in ("last.pt", "train.log", "metrics.jsonl", "test_results_tomroberta.txt"):
        assert (out / name).is_file(), name
    single = (tmp_path / "single" / "metrics.jsonl").read_text().splitlines()
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in lines] == [sorted(json.loads(x)) for x in single]
    assert (out / "test_results_tomroberta.txt").read_text() == \
        (tmp_path / "single" / "test_results_tomroberta.txt").read_text()
