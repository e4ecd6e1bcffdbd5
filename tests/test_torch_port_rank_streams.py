"""Each data-parallel rank's own randomness, and BertAdam's mean over the
ranks (`models/layers.DropoutRng`, `train/optim.BertAdam`).

* Dropout under data parallelism: two ranks that hold identical local
  batches draw different masks, where JAX draws one mask over the global
  batch, whose rows differ.  `DropoutRng.for_step` folds the rank's
  data-parallel index into its seed sequence, and K1's seed is offset by
  the linear mesh index (dp_index * mp + mp_index), as JAX's sharded K1
  offsets it (`macsa_tpu/ops/fused_attention.py:286-291`).  Held on the
  plain path (the two ranks' losses differ) and on the seeds handed to
  `fused_self_attention`.
* A world of one is bitwise what it was: `for_step` gives the generators
  of `SeedSequence([seed, step])`, and K1's seed has no offset; a train
  step at dropout 0.1 equals one whose generators are built that way by
  hand, bit for bit.
* `BertAdam.step` takes the gradients' mean over the ranks before its
  clip, as `AdamW.step` does: two ranks with different local gradients
  end with equal parameters, those of one process at the mean gradient.

One two-rank gloo job (subprocesses on a free port that import this
module, as `tests/test_torch_port_ddp.py` runs its job).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import DropoutRng, init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train import optim
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD, B, L, SEED = 2, 2, 32, 7
MODEL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=32,
             hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)


def _cfg(fused: bool) -> tcfg.FCMFConfig:
    return tcfg.FCMFConfig(
        model=tcfg.ModelConfig(**MODEL, fused_attention=fused),
        text=tcfg.TextEncoderConfig(vocab_size=64, max_position_embeddings=64, **MODEL,
                                    fused_attention=fused),
        num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=L, box_heads=4)


def _batch() -> dict:
    """One local batch, the same on every rank."""
    rng = np.random.default_rng(0)
    a = len(tcfg.ASPECTS)
    batch = {"input_ids": rng.integers(2, 64, size=(B, a, L)).astype(np.int32),
             "token_type_ids": np.zeros((B, a, L), np.int32),
             "attention_mask": np.ones((B, a, L), np.int32),
             "added_mask": np.ones((B, a, L + 4), np.int32),
             "labels": rng.integers(0, 4, size=(B, a)).astype(np.int32),
             "grid": rng.normal(size=(B, 2, 4, 128)).astype(np.float32),
             "roi": rng.normal(size=(B, 2, 2, 128)).astype(np.float32),
             "roi_coors": rng.uniform(0, 1, size=(B, 2, 2, 4)).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def train_step(fused: bool, monkeypatch_seeds: bool = True) -> dict:
    """One step at dropout 0.1 from seeded weights: this rank's local loss,
    the seeds K1's wrapper got, the parameters after the update."""
    model = init_weights(FCMF(_cfg(fused)), torch.Generator().manual_seed(0))
    visual = VisualFeatures(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), num_filters=4,
                                              dtype="float32"))
    state = TrainState.create(model, visual, optim.AdamW(model, 1e-3))
    seeds, wrapped = [], layers.fused_self_attention

    def record(q, k, v, mask, num_heads, rate, seed):
        seeds.append(seed)
        return wrapped(q, k, v, mask, num_heads, rate, seed)

    layers.fused_self_attention = record
    try:
        loss = float(make_finetune_train_step(state)(_batch(), SEED)["loss"])
    finally:
        layers.fused_self_attention = wrapped
    return {"loss": loss, "seeds": seeds,
            "params": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


def _linear() -> torch.nn.Linear:
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        lin.weight.copy_(torch.randn(3, 4, generator=g))
        lin.bias.copy_(torch.randn(3, generator=g))
    return lin


def _gradients(rank: int) -> list:
    g = torch.Generator().manual_seed(10 + rank)
    return [torch.randn(3, 4, generator=g) * (1 + rank), torch.randn(3, generator=g)]


def bert_adam_run(grads_of_steps) -> dict:
    """2 BertAdam steps with the given gradients (a list a step)."""
    lin = _linear()
    opt = optim.BertAdam(lin.parameters(), lr=0.1, max_grad_norm=1.0)
    for grads in grads_of_steps:
        for p, g in zip(lin.parameters(), grads):
            p.grad = g.clone()
        opt.step()
        opt.zero_grad()
    return {k: v.detach().numpy().copy() for k, v in lin.state_dict().items()}


def worker(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=WORLD)
    try:
        got = {"dp_index": mesh.dp_index(), "plain": train_step(False),
               "fused": train_step(True),
               "bert_adam": bert_adam_run([_gradients(rank), _gradients(rank + 5)])}
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_streams")
    code = (f"import sys; sys.path.insert(0, {TESTS!r}); sys.path.insert(0, {REPO!r}); "
            "import test_torch_port_rank_streams as t; "
            "t.worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _parent_for_step(seed: int, step: int, device) -> DropoutRng:
    """`DropoutRng.for_step` as the port drew it before the ranks had
    streams of their own: from (seed, step) alone."""
    dev_seed, host_seed = np.random.SeedSequence([seed, step]).generate_state(2)
    return DropoutRng(torch.Generator(torch.device(device)).manual_seed(int(dev_seed)),
                      torch.Generator().manual_seed(int(host_seed)))


def _kernel_seeds(rng: DropoutRng, n: int) -> list:
    return [rng.kernel_seed() for _ in range(n)]


def test_two_ranks_with_equal_batches_draw_different_masks(job):
    r0, r1 = job
    assert [r0["dp_index"], r1["dp_index"]] == [0, 1]
    # the plain path: every elementwise mask, the attention's included
    assert r0["plain"]["loss"] != r1["plain"]["loss"]
    # K1: one call a text layer; rank 1 draws from its own stream, offset by
    # its mesh index (dp_index 1 * mp 1 + mp_index 0)
    n = MODEL["num_hidden_layers"]
    assert r0["fused"]["seeds"] == _kernel_seeds(_parent_for_step(SEED, 0, "cpu"), n)
    want1 = [s + 1 for s in _kernel_seeds(DropoutRng.for_step(SEED, 0, "cpu", 1), n)]
    assert r1["fused"]["seeds"] == want1
    assert not set(r0["fused"]["seeds"]) & set(r1["fused"]["seeds"])
    assert r0["fused"]["loss"] != r1["fused"]["loss"]
    # the update is the mean of both ranks' gradients: one model on both
    for name, value in r0["plain"]["params"].items():
        np.testing.assert_array_equal(value, r1["plain"]["params"][name], err_msg=name)


def test_one_process_draws_what_it_drew_before_the_ranks_had_streams(monkeypatch):
    for seed, step in ((0, 0), (SEED, 3)):
        for rng in (DropoutRng.for_step(seed, step, "cpu"),
                    DropoutRng.for_step(seed, step, "cpu", dp_index=0)):
            parent = _parent_for_step(seed, step, "cpu")
            assert torch.equal(rng.device.get_state(), parent.device.get_state())
            assert torch.equal(rng.host.get_state(), parent.host.get_state())
            assert rng.dp_index == 0
    assert torch.equal(DropoutRng.for_step(0, 0, "cpu").keep_mask((64,), 0.5, "cpu"),
                       _parent_for_step(0, 0, "cpu").keep_mask((64,), 0.5, "cpu"))
    assert not torch.equal(DropoutRng.for_step(0, 0, "cpu", 1).keep_mask((64,), 0.5, "cpu"),
                           _parent_for_step(0, 0, "cpu").keep_mask((64,), 0.5, "cpu"))
    for fused in (False, True):
        now = train_step(fused)
        if fused:  # K1's seeds carry no offset in a world of one
            n = MODEL["num_hidden_layers"]
            assert now["seeds"] == _kernel_seeds(_parent_for_step(SEED, 0, "cpu"), n)
        with monkeypatch.context() as m:
            m.setattr(DropoutRng, "for_step",
                      staticmethod(lambda seed, step, device, dp_index=0:
                                   _parent_for_step(seed, step, device)))
            before = train_step(fused)
        assert now["loss"] == before["loss"] and now["seeds"] == before["seeds"]
        for name, value in before["params"].items():
            np.testing.assert_array_equal(now["params"][name], value, err_msg=name)


def test_bert_adam_takes_the_mean_gradient_over_the_ranks(job):
    r0, r1 = job
    for name, value in r0["bert_adam"].items():
        np.testing.assert_array_equal(value, r1["bert_adam"][name], err_msg=name)
    mean = [[(a + b) / 2 for a, b in zip(_gradients(s), _gradients(s + 1))] for s in (0, 5)]
    want = bert_adam_run(mean)
    alone = bert_adam_run([_gradients(0), _gradients(5)])  # rank 0's gradients alone
    for name, value in want.items():
        np.testing.assert_allclose(r0["bert_adam"][name], value, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        assert not np.allclose(alone[name], value)
