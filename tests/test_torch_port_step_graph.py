"""The train step's CUDA graph (`macsa_tpu_torch/train/step_graph.py`), on
the CPU: everything of it but the capture and the replay themselves, which
`tests/test_torch_port_step_graph_gpu.py` holds on the card.

* `graph_mode`, the one rule: each condition that keeps a call eager, the
  signature's first call, its capture and its replays, and a
  `load_state_dict` of the model or of the optimizer dropping the graphs,
* the K1 seeds a replay writes for (seed, step) are the draws the eager
  step makes, in order, over 12 layers and several steps,
* a replay (its graph mocked) advances the host's state as an eager step
  does: `state.step`, `AdamW.updates`, the rates, `cuda_lib.launch_counts`,
* the benchmark's reader `graph_replays.train` on a synthetic span store,
* an eager step on the CPU records `replayed` 0 on its root span,
* K1's C calls take a seed word by address and an int by value; a seed
  word takes CUDA tensors only.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.config import DeepseekV2Config
from macsa_tpu_torch.models.deepseek_v2 import MoE
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import DropoutRng, init_weights
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops import fused_attention as fa
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train import optim, step_graph
from macsa_tpu_torch.train.common import to_device
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_train_step
from macsa_tpu_torch.utils import logging as tlogging

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345  # the benchmark's seeds pass 32 signed bits
LAYERS = 12


def tiny_state(accumulate_steps=1, moe=False):
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.LayerNorm(4))
    if moe:
        model.add_module("moe", MoE(DeepseekV2Config(), device="meta"))
    opt = optim.AdamW(model, optim.linear_warmup_schedule(1e-3, 2, 10),
                      accumulate_steps=accumulate_steps)
    return TrainState.create(model, torch.nn.Module(), opt)


def signature(device="cuda", shape=(8, 6, 170)):
    return (("input_ids", shape, torch.int32, device), ("labels", shape[:2], torch.int32, device))


@pytest.mark.parametrize("case,want", [
    ("cpu_batch", step_graph.EAGER),
    ("not_tensors", step_graph.EAGER),
    ("process_group", step_graph.EAGER),
    ("accumulate_2", step_graph.EAGER),
    ("not_adamw", step_graph.EAGER),
    ("moe_layer", step_graph.EAGER),
    ("new_signature", step_graph.WARM),
    ("seen_once", step_graph.CAPTURE),
    ("captured", step_graph.REPLAY),
    ("other_shape_of_a_captured_step", step_graph.WARM),
    ("optimizer_loaded_after_capture", step_graph.CAPTURE),
    ("model_loaded_after_capture", step_graph.CAPTURE),
])
def test_graph_rule(monkeypatch, case, want):
    state = tiny_state(accumulate_steps=2 if case == "accumulate_2" else 1,
                       moe=case == "moe_layer")
    graphs = step_graph.TrainStep(state, body=None, dp_index=0)
    sig = signature("cpu" if case == "cpu_batch" else "cuda")
    if case == "not_tensors":
        sig = step_graph.batch_signature({"input_ids": torch.zeros(2), "text": ["a", "b"]})
    if case == "process_group":
        monkeypatch.setattr(mesh, "_initialized", lambda: True)
    if case == "not_adamw":
        state.optimizer = optim.BertAdam(state.model.parameters(), lr=1e-3)
    if case != "new_signature":
        graphs.seen.add(signature())
    if case in ("captured", "other_shape_of_a_captured_step") or case.endswith("after_capture"):
        graphs.captured[signature()] = object()
    if case == "other_shape_of_a_captured_step":
        sig = signature(shape=(3, 6, 170))  # an epoch's short last batch
    if case == "optimizer_loaded_after_capture":
        state.optimizer.load_state_dict(state.optimizer.state_dict())
    if case == "model_loaded_after_capture":
        state.model.load_state_dict(state.model.state_dict())
    assert step_graph.graph_mode(sig, state, graphs) == want
    if case.endswith("after_capture"):
        assert not graphs.captured  # the graphs are dropped; the signature stays seen
        assert step_graph.graph_mode(sig, state, graphs) == step_graph.CAPTURE


def test_batch_signature_holds_keys_shapes_dtypes_and_devices():
    batch = {"labels": torch.zeros(2, 6, dtype=torch.int32), "grid": torch.zeros(2, 3)}
    assert step_graph.batch_signature(batch) == (
        ("grid", (2, 3), torch.float32, "cpu"), ("labels", (2, 6), torch.int32, "cpu"))


def eager_draws(seed, step, dp_index, offsets):
    rng = DropoutRng.for_step(seed, step, "cpu", dp_index)
    return [rng.attention_seed(off) & 0xFFFFFFFF for off in offsets]


@pytest.mark.parametrize("dp_index", [0, 1])
def test_replay_kernel_seeds_are_the_eager_steps_draws(dp_index):
    """12 layers' K1 seeds (tensor-parallel offsets of a rank in them), over
    several steps: the same ints, in the same order, and a new set each step."""
    offsets = [dp_index * 2 + (layer % 2) for layer in range(LAYERS)]
    seen = set()
    for step in (0, 1, 2, 7, 1000):
        want = eager_draws(SEED, step, dp_index, offsets)
        assert step_graph.replay_kernel_seeds(SEED, step, dp_index, offsets) == want
        seen.add(tuple(want))
    assert len(seen) == 5


def test_captured_words_take_the_replays_seeds_in_draw_order():
    """While a step is captured, each K1 call gets the next device word and
    its offset is kept; before a replay the words are written with that
    step's draws."""
    words = step_graph.SeedWords(torch.device("cpu"))
    _, host_seed = DropoutRng.step_seeds(SEED, 0, 0)
    rng = DropoutRng(torch.Generator(), torch.Generator().manual_seed(host_seed), 0, words)
    got = [rng.attention_seed(layer % 3) for layer in range(LAYERS)]
    assert [w.data_ptr() for w in got] == [words.words[i:].data_ptr() for i in range(LAYERS)]
    assert words.offsets == [layer % 3 for layer in range(LAYERS)]
    for step in (0, 5, 6):
        words.write(step_graph.replay_kernel_seeds(SEED, step, 0, words.offsets))
        want = eager_draws(SEED, step, 0, words.offsets)
        assert words.words[:LAYERS].numpy().view(np.uint32).tolist() == want
        assert [int(w.numpy().view(np.uint32)[0]) for w in got] == want


def test_a_replay_advances_the_host_state_as_an_eager_step_does(monkeypatch):
    """The graph mocked: each replay copies the batch into the static
    buffers, writes the step's seeds, re-seeds the generator, sets the
    rates of the update it takes, adds the captured step's launch counts,
    advances `state.step` and `AdamW.updates`, and returns fresh metrics."""
    monkeypatch.setattr(cuda_lib, "launch_counts", type(cuda_lib.launch_counts)())
    cuda_lib.launch_counts.update({"fused_self_attention": 5, "other": 1})
    state = tiny_state()
    state.optimizer.make_capturable()
    state.step = state.optimizer.updates = 3
    words = step_graph.SeedWords(torch.device("cpu"))
    for layer in range(LAYERS):
        words.word(0, 0)
    graph, generator = mock.Mock(), torch.Generator()
    static = {"input_ids": torch.zeros(2, 5, dtype=torch.int32)}
    out = {"loss": torch.tensor(1.5)}
    counts = {"fused_self_attention": 12, "fused_self_attention.wgmma": 12,
              "fused_self_attention_bwd": 12}
    captured = step_graph.CapturedStep(graph, static, out, words, generator, counts)
    for k in range(4):
        batch = {"input_ids": torch.full((2, 5), k, dtype=torch.int32)}
        got = captured.replay(batch, SEED, state, 0)
        step = 3 + k
        assert torch.equal(static["input_ids"], batch["input_ids"])
        assert words.words[:LAYERS].numpy().view(np.uint32).tolist() == eager_draws(
            SEED, step, 0, [0] * LAYERS)
        assert generator.initial_seed() == DropoutRng.step_seeds(SEED, step, 0)[0]
        assert [float(g["lr"]) for g in state.optimizer.optimizer.param_groups] == [
            pytest.approx(state.optimizer.schedules[g["part"]](step))
            for g in state.optimizer.optimizer.param_groups]
        assert got["loss"] is not out["loss"] and torch.equal(got["loss"], out["loss"])
    assert graph.replay.call_count == 4
    assert (state.step, state.optimizer.updates) == (7, 7)
    assert dict(cuda_lib.launch_counts) == {"fused_self_attention": 5 + 48, "other": 1,
                                            "fused_self_attention.wgmma": 48,
                                            "fused_self_attention_bwd": 48}


def test_capturable_adamw_keeps_its_mode_through_a_load():
    state = tiny_state()
    opt = state.optimizer
    opt.make_capturable()
    rates = [g["lr"] for g in opt.optimizer.param_groups]
    assert all(isinstance(r, torch.Tensor) and r.dtype == torch.float32 for r in rates)
    assert all(g["capturable"] for g in opt.optimizer.param_groups)
    saved = opt.state_dict()
    fresh = tiny_state().optimizer
    fresh.load_state_dict(saved)  # a default optimizer takes float rates back
    assert all(not isinstance(g["lr"], torch.Tensor) and not g["capturable"]
               for g in fresh.optimizer.param_groups)
    opt.load_state_dict(saved)
    assert opt.loads == 1
    assert all(isinstance(g["lr"], torch.Tensor) and g["capturable"]
               for g in opt.optimizer.param_groups)


def reader():
    path = ROOT / "port_bench" / "metrics" / "graph_replays.train.py"
    spec = importlib.util.spec_from_file_location("graph_replays_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("replayed,want", [
    ([1, 1, 1, 1], 100.0), ([0, 1, 1, 1], 75.0), ([0, 0, 0], 0.0),
    ([None, None], None), ([], None)])
def test_graph_replays_reader_on_a_synthetic_span_store(monkeypatch, replayed, want):
    store = tlogging.SpanStore()
    for flag in replayed:
        for name, root in (("h2d", False), ("train_step", True)):
            s = tlogging.Span(store, name, root, False)
            if root and flag is not None:
                s.counts["replayed"] = flag
            store._open(s)
            store._close(s)
    monkeypatch.setattr(tlogging, "SPANS", store)
    assert reader().read({}) == want


def test_an_eager_cpu_step_records_replayed_zero():
    cfg = tcfg.FCMFConfig(
        model=tcfg.ModelConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
                               intermediate_size=32),
        text=tcfg.TextEncoderConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                                    num_attention_heads=4, intermediate_size=32,
                                    max_position_embeddings=64),
        num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=16, max_text_len=12, box_heads=4)
    model = init_weights(FCMF(cfg), torch.Generator().manual_seed(0))
    state = TrainState.create(model, torch.nn.Module(), optim.AdamW(model, 1e-3))
    step = make_finetune_train_step(state, 0)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(2, 64, size=(2, 6, 12)).astype(np.int32),
             "token_type_ids": np.zeros((2, 6, 12), np.int32),
             "attention_mask": np.ones((2, 6, 12), np.int32),
             "added_mask": np.ones((2, 6, 16), np.int32),
             "roi_coors": rng.uniform(0, 1, size=(2, 2, 2, 4)).astype(np.float32),
             "grid": rng.normal(size=(2, 2, 4, 16)).astype(np.float32),
             "roi": rng.normal(size=(2, 2, 2, 16)).astype(np.float32),
             "labels": rng.integers(0, 4, size=(2, 6)).astype(np.int32)}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            step(to_device(batch, torch.device("cpu")), SEED)
    assert tlogging.SPANS.per_step("train_step", "replayed") == [0, 0]
    assert dict(step.calls) == {step_graph.EAGER: 2}
    assert reader().read({}) == 0.0
    assert not state.optimizer.capturable  # the eager path keeps the default AdamW
    with tlogging.span("outside any profile"):
        pass


def test_k1_passes_a_seed_word_by_address_and_an_int_by_value():
    word = torch.zeros(1, dtype=torch.int32)
    assert fa._dropout_args(0.1, word) == (1, fa.keep_threshold(0.1), fa._inv_keep(0.1), 0,
                                           word.data_ptr())
    assert fa._dropout_args(0.1, 2 ** 32 + 5) == (1, fa.keep_threshold(0.1), fa._inv_keep(0.1),
                                                  5, None)
    assert fa._dropout_args(0.0, word) == (0, 0, 1.0, 0, None)  # rate 0 reads no seed


def test_a_seed_word_takes_cuda_tensors_only():
    q = torch.zeros(2, 40, 64, requires_grad=True)
    with pytest.raises(ValueError, match="seed word"):
        fa.fused_self_attention(q, q, q, torch.zeros(2, 40), 1, 0.1,
                                torch.zeros(1, dtype=torch.int32))
