"""The port's spans (`macsa_tpu_torch/utils/logging.py` `span`), on the CPU.

* With no profiler recording, `span` returns one shared no-op and records
  nothing.
* Under a CPU `torch.profiler`, each span keeps its name, parent, step,
  host interval and counts, and shows in the exported Chrome trace as a
  `user_annotation` event; the train steps, the eval step and `to_device`
  record the layers' spans (`train_step`, `visual`, `text_encoder`,
  `fusion`, `decoder`, `backward`, `optimizer`, `eval_step`, `h2d`).
* Two traced episodes in one process do not mix; the ring drops its
  oldest spans and counts them.
* `torch.export` of the FCMF serving forward holds no profiler operation,
  with or without a profiler recording.
"""

import json

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.inference import export
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
from macsa_tpu_torch.train import optim
from macsa_tpu_torch.train.common import to_device
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import (make_finetune_eval_step, make_finetune_train_step,
                                         make_pretrain_train_step)
from macsa_tpu_torch.utils import logging as tlogging

B, A, L, T, VOCAB, IMGS, ROIS, PATCHES, FEAT = 2, 6, 12, 6, 64, 2, 2, 4, 16
MODEL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32)
TEXT = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=64)
FCMF_KW = dict(num_imgs=IMGS, num_roi=ROIS, num_patches=PATCHES, visual_feat_dim=FEAT,
               max_text_len=L, box_heads=4)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def fcmf_config(**kw):
    return tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL), text=tcfg.TextEncoderConfig(**TEXT),
                           **{**FCMF_KW, **kw})


def host_batch(rng, views=True):
    """A loader-shaped batch with cached features (`grid`, `roi`)."""
    shape = (B, A, L) if views else (B, L)
    out = {"input_ids": rng.integers(2, VOCAB, size=shape).astype(np.int32),
           "token_type_ids": np.zeros(shape, np.int32),
           "attention_mask": np.ones(shape, np.int32),
           "added_mask": np.ones(shape[:-1] + (L + PATCHES,), np.int32),
           "roi_coors": rng.uniform(0, 1, size=(B, IMGS, ROIS, 4)).astype(np.float32),
           "grid": rng.normal(size=(B, IMGS, PATCHES, FEAT)).astype(np.float32),
           "roi": rng.normal(size=(B, IMGS, ROIS, FEAT)).astype(np.float32)}
    if views:
        out["labels"] = rng.integers(0, 4, size=(B, A)).astype(np.int32)
    else:
        out["enc_input_ids"] = out.pop("input_ids")
        out["dec_input_ids"] = rng.integers(3, VOCAB, size=(B, T)).astype(np.int32)
        out["labels"] = rng.integers(3, VOCAB, size=(B, T)).astype(np.int32)
    return out


def names(store=None):
    return [s.name for s in (store or tlogging.SPANS).spans]


def end_episode():
    with tlogging.span("outside any profile"):
        pass


def test_off_returns_the_shared_noop_and_records_nothing():
    end_episode()
    before = tlogging.SPANS.snapshot()
    ctx = tlogging.span("text_encoder")
    assert ctx is tlogging._OFF and tlogging.span("h2d") is ctx
    with ctx as s:
        assert s is None  # a block sets no counts while no profiler records
    assert tlogging.SPANS.snapshot() == before
    assert not tlogging.SPANS.live
    assert tlogging.span_median("text_encoder") is None


def test_a_traced_span_keeps_its_record_and_its_annotation(tmp_path):
    end_episode()
    with profiled() as prof:
        for _ in range(3):
            with tlogging.span("h2d") as s:
                s.counts["bytes"] = 100
                torch.ones(4)
            with tlogging.span("train_step", step=True) as root:
                with tlogging.span("backward"):
                    torch.ones(4).sum()
    spans = list(tlogging.SPANS.spans)
    assert names() == ["h2d", "backward", "train_step"] * 3
    assert [s.step for s in spans] == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert [s.parent for s in spans[:3]] == [None, "train_step", None]
    assert all(0 < s.start_ns < s.end_ns for s in spans)
    assert spans[0].counts == {"bytes": 100} and spans[1].counts == {}
    assert root.start_ns <= spans[-2].start_ns <= spans[-2].end_ns <= root.end_ns
    assert tlogging.span_median("h2d", "bytes") == 100
    assert 0 < tlogging.span_median("backward") <= tlogging.span_median("train_step")
    assert tlogging.span_median("backward", "device_ms") is None  # no CUDA events here
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annotated = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(annotated) == sorted(["h2d", "train_step", "backward"] * 3)


def test_two_traced_episodes_do_not_mix():
    end_episode()
    before = tlogging.SPANS.host_ns.get("fusion", 0)
    with profiled():
        for _ in range(2):
            with tlogging.span("fusion"):
                pass
    assert tlogging.span_median("fusion") is not None
    fused = tlogging.SPANS.host_ns["fusion"]
    end_episode()  # the untraced steps between two traced stretches
    with profiled():
        with tlogging.span("decoder"):
            pass
    assert names() == ["decoder"]
    assert tlogging.span_median("fusion") is None
    # the host totals run on over every episode
    assert tlogging.SPANS.host_ns["fusion"] == fused > before


def test_the_ring_drops_its_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(tlogging, "SPANS", tlogging.SpanStore(capacity=4))
    with profiled():
        for i in range(6):
            with tlogging.span(f"s{i}", step=True):
                pass
    assert names() == ["s2", "s3", "s4", "s5"]
    assert tlogging.SPANS.dropped == 2
    assert [s.step for s in tlogging.SPANS.spans] == [2, 3, 4, 5]
    assert "s0" in tlogging.SPANS.host_ns and tlogging.SPANS.steps_total == 6
    assert tlogging.span_median("s5") is None  # no median over a ring that dropped spans
    end_episode()
    with profiled():
        with tlogging.span("s6", step=True):
            pass
    assert tlogging.SPANS.dropped == 0 and tlogging.span_median("s6") is not None


def test_the_steps_record_the_layers_spans():
    """Each layer's span once a step, under its parent, with `h2d` before
    the step it feeds; the eval step is a root of its own."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    model = FCMF(fcmf_config())
    init_weights(model, torch.Generator().manual_seed(0), 0.2)
    ft = make_finetune_train_step(TrainState.create(model, torch.nn.Module(),
                                                    optim.AdamW(model, 1e-3)), 0)
    seq = FCMFSeq2Seq(fcmf_config(), tcfg.DecoderConfig(vocab_size=VOCAB, hidden_size=32,
                                                        num_blocks=1, num_heads=4,
                                                        ffn_hidden=32, max_decode_len=T))
    init_weights(seq, torch.Generator().manual_seed(1), 0.2)
    pt = make_pretrain_train_step(TrainState.create(seq, torch.nn.Module(),
                                                    optim.AdamW(seq, 1e-3)), dp_index=0)
    ev = make_finetune_eval_step(model, torch.nn.Module())
    dev = torch.device("cpu")
    end_episode()
    with profiled():
        ft(to_device(host_batch(rng), dev), 7)
        pt(to_device(host_batch(rng, views=False), dev), 7)
        ev(to_device(host_batch(rng), dev))
    got = [(s.name, s.parent, s.step) for s in tlogging.SPANS.spans]
    layers = [("visual", "train_step"), ("text_encoder", "train_step"),
              ("fusion", "train_step")]
    assert got == (
        [("h2d", None, 0)] + [(n, p, 0) for n, p in layers]
        + [("backward", "train_step", 0), ("optimizer", "train_step", 0),
           ("train_step", None, 0), ("h2d", None, 1)] + [(n, p, 1) for n, p in layers]
        + [("decoder", "train_step", 1), ("backward", "train_step", 1),
           ("optimizer", "train_step", 1), ("train_step", None, 1), ("h2d", None, 2),
           ("visual", "eval_step", 2), ("text_encoder", "eval_step", 2),
           ("fusion", "eval_step", 2), ("eval_step", None, 2)])
    sent = sum(v.nbytes for k, v in host_batch(np.random.default_rng(0)).items())
    assert tlogging.SPANS.spans[0].counts == {"bytes": sent}
    # the spans whose card time a reader takes are the ones that ask for events
    assert {s.name for s in tlogging.SPANS.spans if s.device} == {"h2d", "visual", "eval_step"}


@pytest.mark.parametrize("recording", [False, True])
def test_the_exported_serving_forward_holds_no_profiler_op(recording):
    cfg = fcmf_config(max_text_len=8, visual_feat_dim=128)  # the ResNet's 32 x 4 filters
    model = FCMF(cfg).eval().requires_grad_(False)
    init_weights(model, torch.Generator().manual_seed(0), 0.2)
    visual = VisualFeatures(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                              grid_size=2, dtype="float32"))
    visual = visual.eval().requires_grad_(False)
    program = export.ServingForward(model, visual)
    spec = export._batch_spec(cfg, 1, 64)
    example = tuple(torch.zeros(shape, dtype=getattr(torch, dt))
                    for shape, dt in (spec[k] for k in export.INPUTS))
    end_episode()
    with torch.no_grad():
        if recording:
            with profiled():
                exported = torch.export.export(program, example)
        else:
            exported = torch.export.export(program, example)
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert tlogging.span_median("text_encoder") is None  # nothing recorded while tracing
