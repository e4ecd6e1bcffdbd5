"""`--fine_tune_cnn` in the port against the JAX package: the ResNet trains.

* F4: every FrozenBatchNorm trains all four of its tensors and the
  optimizer decays the statistics, as JAX, where `scale`, `bias`, `mean`
  and `var` are params of `visual_params` and `_decay_mask` exempts only
  `bias`, `out_bias` and `scale`: the decay sets are compared name for name
  (a version that trained only `weight` and `bias` fails here and below).
* The step at dropout 0 against `make_finetune_train_step` with
  `TrainState.create(..., fine_tune_cnn=True)` (K1 in interpret mode): the
  loss, and the gradient of every ResNet tensor (SGD at rate 1 moves each
  JAX parameter by -grad).
* Two AdamW updates of `make_adamw` over `(params, visual_params)`: the
  model's and the ResNet's parameters after them.
* The driver with `--fine_tune_cnn --device cpu`: one epoch trains the
  ResNet with the feature cache off, and a stopped run resumes bitwise.
"""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch

from macsa_tpu.train import optim as joptim
from macsa_tpu.train import steps as jsteps
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch.models.resnet import FrozenBatchNorm
from macsa_tpu_torch.train import checkpoints, finetune, jax_import, optim
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import finetune_loss, make_finetune_train_step
from test_torch_port_finetune import _argv, small_hook
from test_torch_port_train import NO_DROPOUT, _port_model, pair  # noqa: F401 (fixture)


def _visual_names(visual_params):
    """Port ResNet name -> path of the JAX `visual_params` leaf."""
    return jax_import._param_paths(jax_import.visual_state_dict_from_jax,
                                   visual_params["params"])


def _jax_run(pair, tx, steps):
    model, visual, params, visual_params, jbatch, _, _ = pair
    state = JTrainState.create(params, visual_params, tx, fine_tune_cnn=True)
    step = jsteps.make_finetune_train_step(model, visual, donate=False)
    losses = []
    for _ in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return state, losses


def _port_state(pair, opt_kw):
    port = _port_model(pair[2], **NO_DROPOUT)
    visual = copy.deepcopy(pair[5])  # the fixture's ResNet stays frozen for other tests
    opt = optim.AdamW(port, **opt_kw)
    return TrainState.create(port, visual, opt, fine_tune_cnn=True)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_batchnorm_trains_all_four_tensors_and_decays_the_statistics_as_jax(pair):
    params, visual_params = pair[2], pair[3]
    state = _port_state(pair, dict(learning_rate=1e-3))
    bn = [m for m in state.visual.modules() if isinstance(m, FrozenBatchNorm)]
    assert bn and all(isinstance(getattr(m, n), torch.nn.Parameter)
                      for m in bn for n in FrozenBatchNorm.TENSORS)
    names = {id(p): n for n, p in state.model.named_parameters()}
    names.update({id(p): f"visual.{n}" for n, p in state.visual.named_parameters()})
    held = {names[id(p)] for g in state.optimizer.optimizer.param_groups for p in g["params"]}
    decayed = {names[id(p)] for g in state.optimizer.optimizer.param_groups
               if g["weight_decay"] > 0 for p in g["params"]}

    mask_params, mask_visual = joptim._decay_mask((params, visual_params))
    want = {n for n, path in jax_import.fcmf_param_paths(params, 2).items()
            if _get(mask_params, path)}
    visual_paths = _visual_names(visual_params)
    want |= {f"visual.{n}" for n, path in visual_paths.items()
             if _get(mask_visual["params"], path)}
    assert held == set(names.values())  # the optimizer holds every parameter, once
    assert {f"visual.{n}" for n in visual_paths} <= held
    assert decayed == want
    stats = {n for n in decayed if n.endswith(("running_mean", "running_var"))}
    assert len(stats) == 2 * len(bn)  # the statistics decay; weight and bias do not
    # the ResNet takes the encoder's rate: none of its names holds a head keyword
    parts = {names[id(p)]: g["part"] for g in state.optimizer.optimizer.param_groups
             for p in g["params"]}
    assert {parts[n] for n in held if n.startswith("visual.")} == {"encoder"}


def test_step_loss_and_resnet_gradients_match_jax(pair):
    """One SGD step at rate 1 on the JAX side: each ResNet leaf moves by
    -grad; the port's gradients come from the same loss's backward."""
    _, _, _, visual_params, _, _, tbatch = pair
    new_state, (want_loss,) = _jax_run(pair, optax.sgd(1.0), 1)
    state = _port_state(pair, dict(learning_rate=1e-3))
    state.model.train()
    loss, _ = finetune_loss(state.model, state.visual, tbatch, None, fine_tune_cnn=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    old = jax_import.visual_state_dict_from_jax(visual_params["params"])
    new = jax_import.visual_state_dict_from_jax(new_state.visual_params["params"])
    grads = dict(state.visual.named_parameters())
    assert set(grads) == set(old)
    for name, p in grads.items():
        want = (old[name] - new[name]).numpy()
        assert np.abs(want).max() > 0, name
        # f32, sums in other orders through the ResNet and 2+3 layers
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_two_adamw_updates_match_jax(pair):
    """`make_adamw` at rates 1e-3 (encoder, and so the ResNet) and 2e-3
    (head), weight decay 0.01, clipping at 1.0 over both trees: every
    parameter of both within 1e-6 after two updates, but for the attention
    key biases and at most one element in a thousand (Adam scales a
    gradient that is rounding noise up to a whole update)."""
    sched = lambda lr: joptim.linear_warmup_schedule(lr, 1, 100)
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    tx = joptim.make_adamw(sched(1e-3), head_learning_rate=sched(2e-3), **kw)
    new_state, want = _jax_run(pair, tx, 2)
    state = _port_state(pair, dict(learning_rate=optim.linear_warmup_schedule(1e-3, 1, 100),
                                   head_learning_rate=optim.linear_warmup_schedule(
                                       2e-3, 1, 100), **kw))
    step = make_finetune_train_step(state)
    got = [float(step(pair[6], seed=0)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_sd = {**jax_import.fcmf_state_dict_from_jax(new_state.params, 2),
               **{f"visual.{k}": v for k, v in jax_import.visual_state_dict_from_jax(
                   new_state.visual_params["params"]).items()}}
    now = {**state.model.state_dict(),
           **{f"visual.{k}": v for k, v in state.visual.state_dict().items()}}
    assert set(now) == set(want_sd)
    beyond, total, moved = 0, 0, 0
    before = jax_import.visual_state_dict_from_jax(pair[3]["params"])
    for name, value in now.items():
        diff = (value - want_sd[name]).abs()
        if name.endswith("attention.self.key.bias"):
            assert diff.max() <= 4e-3, name
            continue
        assert diff.max() <= 1e-5, name
        beyond, total = beyond + int((diff > 1e-6).sum()), total + diff.numel()
        if name.startswith("visual."):
            moved += not torch.equal(value, before[name[len("visual."):]])
    assert beyond <= 1e-3 * total, (beyond, total)
    assert moved == len(before)  # every ResNet tensor, the statistics included


def _last(out):
    got = torch.load(os.path.join(out, "last.pt"), map_location="cpu", weights_only=True)
    flat = {f"model.{k}": v for k, v in got["model"].items()}
    flat.update({f"visual.{k}": v for k, v in got["visual"].items()})
    for index, entry in got["optimizer"]["optimizer"]["state"].items():
        flat.update({f"opt.{index}.{k}": torch.as_tensor(v) for k, v in entry.items()})
    return flat, {k: got[k] for k in ("step", "epoch")}


class _Stop(Exception):
    pass


def test_driver_trains_the_resnet_and_resumes_bitwise(tmp_path, monkeypatch):
    from macsa_tpu_torch.data import synth
    data = str(tmp_path / "synth")
    synth.write_dataset(data)
    hook, seen = small_hook(), {}
    argv = _argv(data, tmp_path / "straight", "--do_train", "--fine_tune_cnn", epochs=2)
    straight = finetune.main(argv, config_hook=hook, model_hook=lambda model, visual: seen.update(
        n_model=len(list(model.parameters())),
        visual={k: v.clone() for k, v in visual.state_dict().items()}))
    assert [e["steps"] for e in straight["epochs"]] == [4, 4]
    assert np.isfinite(sum((e["losses"] for e in straight["epochs"]), [])).all()
    assert "visual feature cache" not in (tmp_path / "straight" / "train.log").read_text()
    want, want_meta = _last(tmp_path / "straight")
    visual = seen["visual"]
    trained = [k for k in visual if not torch.equal(visual[k], want[f"visual.{k}"])]
    assert len(trained) == len(visual)  # convolutions and all four BN tensors moved
    # the checkpoint holds the moments of every model and ResNet parameter
    assert len({k.split(".")[1] for k in want if k.startswith("opt.")}) == \
        seen["n_model"] + len(visual)

    save = checkpoints.CheckpointManager.save

    def save_then_stop(self, tag, state, epoch, best_score=0.0):
        save(self, tag, state, epoch, best_score)
        if epoch == 1:
            raise _Stop

    stopped = _argv(data, tmp_path / "stopped", "--do_train", "--fine_tune_cnn", epochs=2)
    with monkeypatch.context() as patch:
        patch.setattr(checkpoints.CheckpointManager, "save", save_then_stop)
        with pytest.raises(_Stop):
            finetune.main(stopped, config_hook=hook)
    resumed = finetune.main(stopped + ["--resume_from_checkpoint", "last"], config_hook=hook)
    assert resumed["epochs"][0]["losses"] == straight["epochs"][1]["losses"]
    got, got_meta = _last(tmp_path / "stopped")
    assert got_meta == want_meta == {"step": 8, "epoch": 2}
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
