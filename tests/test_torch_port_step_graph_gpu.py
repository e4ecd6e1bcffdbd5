"""The train step's CUDA graph (`macsa_tpu_torch/train/step_graph.py`) on
the card, and K1's seed word.

* K1's forward and backward read the seed from a device word bit for bit
  as they take it by value, in all three variants,
* the benchmark's three ViSoBERT training cells at full width
  (`finetune.cached`, `finetune.pixels`, `pretrain.cached`, built by
  `port_bench`'s entries): five steps from a graph (one eager, one
  captured, three replays) give the losses and every parameter of five
  eager steps with the same optimizer settings (`AdamW.make_capturable`),
  bit for bit, and count the same launches,
* after a `load_state_dict` of the model and the optimizer the step is
  captured again and stays right,
* `--fine_tune_cnn` (the ResNet trains) is graphed and matches its eager
  step bit for bit.

Every test needs a CUDA device and `nvcc` and skips without them.  The
file imports no JAX:

    python -m pytest tests/test_torch_port_step_graph_gpu.py -m gpu --noconftest -q
"""

import gc
from pathlib import Path

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops import fused_attention as fa
from macsa_tpu_torch.ops import image_prep
from macsa_tpu_torch.train import optim, step_graph
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_train_step

pytestmark = pytest.mark.gpu
PORT_BENCH = Path(__file__).resolve().parents[1] / "port_bench"
SEED = 2 ** 31 + 977  # past 32 signed bits, as the benchmark's seeds are
STEPS = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,head_dim,variant", [(torch.bfloat16, 64, "wgmma"),
                                                    (torch.float32, 64, "tf32x3"),
                                                    (torch.float32, 32, "simt")])
@pytest.mark.parametrize("l", [170, 256])  # wgmma: the one-launch and the streamed backward
def test_k1_reads_its_seed_from_a_device_word_as_from_an_int(cuda, dtype, head_dim, variant, l):
    g = torch.Generator(cuda).manual_seed(0)
    b, heads, rate, seed = 4, 768 // 64 if head_dim == 64 else 4, 0.1, 3_000_000_123
    q, k, v, gout = (torch.randn(b, l, heads * head_dim, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    mask = torch.zeros(b, l, device=cuda)
    mask[1, l // 2:] = -10000.0
    word = torch.from_numpy(np.array([seed], np.uint32).view(np.int32)).to(cuda)  # its 32 bits
    assert fa.attention_variant(dtype, head_dim, l) == variant
    out_int, lse_int = fa._launch_fwd(q, k, v, mask, heads, rate, seed, with_lse=True)
    out_word, lse_word = fa._launch_fwd(q, k, v, mask, heads, rate, word, with_lse=True)
    grads_int = fa._launch_bwd(q, k, v, mask, lse_int, gout, heads, rate, seed)
    grads_word = fa._launch_bwd(q, k, v, mask, lse_int, gout, heads, rate, word)
    other = fa._launch_fwd(q, k, v, mask, heads, rate, seed + 1, with_lse=False)[0]
    torch.cuda.synchronize()
    assert torch.equal(out_int, out_word) and torch.equal(lse_int, lse_word)
    for a, w in zip(grads_int, grads_word):
        assert torch.equal(a, w)
    assert not torch.equal(out_int, other)  # the seed keys the mask


def all_eager(monkeypatch):
    """Every call of a train step eager from here on (the yardstick)."""
    monkeypatch.setattr(step_graph, "graph_mode", lambda *_: step_graph.EAGER)


def bench_program(cell: str, graph: bool):
    """The benchmark cell's program (its entry's `build_program`) at full
    width; with `graph` False with the graphed path's optimizer settings
    (the caller keeps its calls eager: `all_eager`)."""
    from port_bench.lib import bench
    files = bench.Files(str(PORT_BENCH))
    workload = files.json("workloads", cell)
    ctx = bench.Ctx(cell, workload, files.json("configs", workload["config"]), SEED, 1.0,
                    False, torch.device("cuda", 0), 0.0)
    entry = files.module("entries", workload["entry"])
    prog = entry.build_program(ctx, *entry.inputs(ctx))
    if not graph:
        prog.state.optimizer.make_capturable()
    return prog


def run_steps(prog, ks, reload_after=None) -> dict:
    """Steps `ks` -> losses, launches of the last two steps, the parameters
    (on the host).  `reload_after`: load the model's and the optimizer's
    own state after that many steps."""
    losses = []
    for i, k in enumerate(ks):
        if i == reload_after:
            state = prog.state
            state.model.load_state_dict({n: t.clone() for n, t in
                                         state.model.state_dict().items()})
            state.optimizer.load_state_dict(state.optimizer.state_dict())
        if i == len(ks) - 2:
            before = dict(cuda_lib.launch_counts)
        losses.append(prog.step(prog.batch(k), SEED)["loss"])
    torch.cuda.synchronize()
    return {"loss": torch.stack(losses).float().cpu(),
            "launches": {key: n - before.get(key, 0) for key, n in cuda_lib.launch_counts.items()
                         if n != before.get(key, 0)},
            "params": {n: p.detach().cpu() for n, p in prog.state.model.named_parameters()},
            "calls": dict(prog.step.calls), "step": prog.state.step,
            "updates": prog.state.optimizer.updates}


def free(prog):
    prog.state = prog.step = prog.batch = None
    gc.collect()  # the step and its model's load hook hold each other
    torch.cuda.empty_cache()


# ViSoBERT's token-type table has one row (`type_vocab_size` 1): its backward
# sums all of a step's 8,160 (48 x 170) token rows into it, in an order
# PyTorch's embedding backward does not fix, so two eager runs of the same
# five steps can differ there in the last bit (one element by 2.3e-13, in 1
# of 2 eager runs on an H100); every other leaf repeats bit for bit
ORDER_FREE = ("token_type_embeddings.weight",)


def assert_same(got: dict, want: dict):
    assert torch.equal(got["loss"], want["loss"]), (got["loss"], want["loss"])
    assert got["launches"] == want["launches"]
    assert (got["step"], got["updates"]) == (want["step"], want["updates"])
    differ = [n for n, p in want["params"].items()
              if not n.endswith(ORDER_FREE) and not torch.equal(got["params"][n], p)]
    assert not differ, f"{len(differ)} parameters differ, first {differ[:3]}"
    for n, p in want["params"].items():
        if n.endswith(ORDER_FREE):
            torch.testing.assert_close(got["params"][n], p, rtol=1e-6, atol=1e-10, msg=n)


@pytest.mark.parametrize("cell", ["finetune.cached", "finetune.pixels", "pretrain.cached"])
def test_graphed_steps_equal_eager_steps_bit_for_bit(cuda, cell, monkeypatch):
    prog = bench_program(cell, graph=True)
    got = run_steps(prog, range(STEPS))
    free(prog)
    all_eager(monkeypatch)
    prog = bench_program(cell, graph=False)
    want = run_steps(prog, range(STEPS))
    free(prog)
    assert got["calls"] == {step_graph.WARM: 1, step_graph.CAPTURE: 1,
                            step_graph.REPLAY: STEPS - 2}
    assert want["calls"] == {step_graph.EAGER: STEPS}
    assert got["launches"]["fused_self_attention"] == 2 * 12  # the last two steps' K1 calls
    assert_same(got, want)
    assert len(set(got["loss"].tolist())) == STEPS


def test_a_load_drops_the_graph_and_the_step_is_captured_again(cuda):
    prog = bench_program("finetune.cached", graph=True)
    want = run_steps(prog, range(STEPS))
    free(prog)
    prog = bench_program("finetune.cached", graph=True)
    got = run_steps(prog, range(STEPS), reload_after=3)
    free(prog)
    assert got["calls"] == {step_graph.WARM: 1, step_graph.CAPTURE: 2,
                            step_graph.REPLAY: STEPS - 3}
    assert_same(got, want)


def test_fine_tune_cnn_is_graphed_and_matches_its_eager_step(cuda, monkeypatch):
    """The ResNet trains (its convolutions' backward and the FrozenBatchNorm
    tensors inside the graph), bf16, at small widths."""
    def program(graph: bool):
        torch.manual_seed(0)
        kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=256, dtype="bfloat16")
        cfg = config.FCMFConfig(
            model=config.ModelConfig(**kw),
            text=config.TextEncoderConfig(vocab_size=64, max_position_embeddings=64, **kw),
            num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=40)
        model = init_weights(FCMF(cfg, device=cuda), torch.Generator(cuda).manual_seed(0))
        visual = init_weights(VisualFeatures(config.ResNetConfig(
            stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="bfloat16"),
            device=cuda), torch.Generator(cuda).manual_seed(1))
        opt = optim.AdamW(model, optim.linear_warmup_schedule(1e-3, 2, 20))
        state = TrainState.create(model, visual, opt, fine_tune_cnn=True)
        if not graph:
            opt.make_capturable()
            all_eager(monkeypatch)
        return state, make_finetune_train_step(state, 0)

    def batch(k):
        rng = np.random.default_rng(k)
        b, a, l = 2, 6, 40
        host = {"images": image_prep.pack_pixels_u8(
                    rng.integers(0, 256, size=(b, 2, 64, 64, 3), dtype=np.uint8)),
                "roi_images": image_prep.pack_pixels_u8(
                    rng.integers(0, 256, size=(b, 2, 2, 64, 64, 3), dtype=np.uint8)),
                "roi_coors": rng.uniform(size=(b, 2, 2, 4)).astype(np.float32),
                "input_ids": rng.integers(2, 64, size=(b, a, l)).astype(np.int32),
                "token_type_ids": np.zeros((b, a, l), np.int32),
                "attention_mask": np.ones((b, a, l), np.int32),
                "added_mask": np.ones((b, a, l + 4), np.int32),
                "labels": rng.integers(0, 4, size=(b, a)).astype(np.int32)}
        return {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}

    results = []
    for graph in (True, False):
        state, step = program(graph)
        losses = [step(batch(k), SEED)["loss"] for k in range(STEPS)]
        torch.cuda.synchronize()
        results.append((torch.stack(losses).float().cpu(), dict(step.calls),
                        {n: p.detach().cpu() for mod in (state.model, state.visual)
                         for n, p in mod.named_parameters(prefix=type(mod).__name__)}))
    (got, calls, got_params), (want, _, want_params) = results
    assert calls == {step_graph.WARM: 1, step_graph.CAPTURE: 1, step_graph.REPLAY: STEPS - 2}
    assert torch.equal(got, want), (got, want)
    differ = [n for n, p in want_params.items() if not torch.equal(got_params[n], p)]
    assert not differ, f"{len(differ)} parameters differ, first {differ[:3]}"
