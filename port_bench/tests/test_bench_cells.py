"""Whole runs of the harness on the CPU at a tiny width, past its look for
a card: a cell added as files alone is found and runs, and each fault a
cell can have, planted in the timed path, turns `correct` false."""

import json
import os

import pytest
import torch

from port_bench.lib import bench

SEED = 3 * 2 ** 30 + 5


def run(tiny_bench, cell, trace=False):
    files, manifest = tiny_bench
    return bench.run_cell(files, manifest, cell, SEED, 0.3, trace, torch.device("cpu"))


def test_a_cell_added_as_files_alone(tiny_bench, tmp_path):
    files, manifest = tiny_bench
    cfg = files.json("configs", "fcmf_visobert")
    cfg["num_imgs"] = 3
    with open(os.path.join(files.root, "configs", "fcmf_three_images.json"), "w") as f:
        json.dump(cfg, f)
    cell = files.json("workloads", "finetune.cached")
    cell["config"] = "fcmf_three_images"
    cell["check"] = {"loss_gap": 1e-2, "grad_gap": 0.1, "change_gap": 0.1}
    with open(os.path.join(files.root, "workloads", "finetune.three_images.json"), "w") as f:
        json.dump(cell, f)
    manifest = json.loads(json.dumps(manifest))
    manifest["workloads"].append({"name": "finetune.three_images", "config": "fcmf_three_images",
                                  "traffic": "three", "chips": 1, "why": "a test's cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("finetune.three_images")
    out = bench.run_cell(files, manifest, "finetune.three_images", SEED, 0.3, False,
                         torch.device("cpu"))
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    line = json.loads(bench.result_line(out, False))
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("cell", ["finetune.cached", "pretrain.cached", "serve.f32",
                                  "finetune.pixels"])
def test_sound_runs_are_correct(tiny_bench, cell):
    out = run(tiny_bench, cell)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("cell", ["finetune.pixels", "serve.f32"])
def test_a_traced_run_reads_its_metrics(tiny_bench, cell):
    """The traced stretches and the readers, on the host's trace alone (the
    CPU has no device operations: those readers find nothing and are left out)."""
    out = run(tiny_bench, cell, trace=True)
    assert out["correct"], out["check"]
    mfu = "mfu.train" if cell != "serve.f32" else "mfu.serve"
    assert 0 < out["metrics"][mfu]["value"] < 100
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def _unchanged_state(monkeypatch):
    from macsa_tpu_torch.train.state import TrainState

    def apply_gradients(self):  # the step leaves its state as it found it
        self.optimizer.zero_grad()
        self.step += 1

    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def _half_batch(monkeypatch):
    from macsa_tpu_torch.train import steps

    aspect, seq = steps.aspect_loss, steps.seq2seq_loss
    monkeypatch.setattr(steps, "aspect_loss",
                        lambda logits, labels: aspect(logits[:1], labels[:1]))
    monkeypatch.setattr(steps, "seq2seq_loss",
                        lambda logits, labels, **kw: seq(logits[:1], labels[:1]))


def _altered_answer(monkeypatch):
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq

    for cls in (FCMF, FCMFSeq2Seq):
        forward = cls.forward

        def altered(self, *a, _forward=forward, **kw):
            out = _forward(self, *a, **kw).clone()
            out[0] = 0.0  # the first row's answer lost where it is produced
            return out

        monkeypatch.setattr(cls, "forward", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("finetune.cached", "pretrain.cached", "finetune.pixels") for f in FAULTS
] + [("serve.f32", "altered_answer")])
def test_a_planted_fault_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = run(tiny_bench, cell)
    assert not out["correct"], out["check"]


@pytest.mark.gpu
def test_a_cell_on_the_card(card, tmp_path):
    import subprocess
    import sys

    from conftest import CHECKOUT

    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve.f32",
                           "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                          cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
