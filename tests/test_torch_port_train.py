"""The port's training path against the JAX package's.

* K1's backward: the port's plain backward and autograd through its CPU
  path, against `jax.vjp` of the Pallas kernel in interpret mode.
* The hashed dropout mask of K1: a function of (seed, b, h, i, j) alone,
  one mask for the forward and the backward.
* The fine-tune train step at dropout 0 against `make_finetune_train_step`
  (K1's forward and backward Pallas kernels in interpret mode): SGD makes
  each parameter's change -lr * grad, so the gradients are compared; then
  three AdamW steps.  With dropout: seeded, and it learns.
* The cached-feature input and the eval step's mode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.ops import fused_attention as jfa
from macsa_tpu.ops.image_prep import pack_pixels_u8 as jax_pack
from macsa_tpu.train import optim as joptim
from macsa_tpu.train import steps as jsteps
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.ops import fused_attention as tfa
from macsa_tpu_torch.train import jax_import, optim
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import (fcmf_forward_all_aspects, make_finetune_eval_step,
                                         make_finetune_train_step)
from test_torch_port_models import jinit, randomize
from test_torch_port_slice import (IMG, KW, MODEL_KW, RESNET_KW, TEXT_KW, _torch_batch,
                                   serving_batch)

B, A, L = 2, 6, 40
MASKS = {"neg10000": -10000.0, "finfo_min": float(np.finfo(np.float32).min)}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _qkv_mask(rng, b=2, l=40, h=4, d=8, neg=-10000.0):
    q, k, v, g = (rng.normal(size=(b, l, h * d)).astype(np.float32) for _ in range(4))
    mask = np.zeros((b, l), np.float32)
    mask[1, 23:] = neg  # padded keys
    return q, k, v, mask, g


# ---------------------------------------------------------------------------
# K1's backward and its dropout mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", sorted(MASKS))
def test_attention_backward_matches_jax_vjp(rng, mask_kind):
    q, k, v, mask, g = _qkv_mask(rng, neg=MASKS[mask_kind])
    _, vjp = jax.vjp(lambda *x: jfa.fused_self_attention(
        *x, jnp.asarray(mask), jnp.zeros((1,), jnp.int32), 4, 0.0, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv, tm, tg = (torch.from_numpy(x) for x in (q, k, v, mask, g))
    plain = tfa.attention_backward_reference(tq, tk, tv, tm, tg, 4)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    tfa.fused_self_attention(*leaves, tm, 4).backward(tg)
    for got in (plain, [x.grad for x in leaves]):
        for name, x, w in zip("qkv", got, want):
            np.testing.assert_allclose(x.numpy(), w, rtol=0, atol=1e-5, err_msg=name)


def _coords(b, n, l):
    ar = torch.arange
    return ar(b)[:, None, None, None], ar(n)[None, :, None, None], ar(l)[:, None], ar(l)


def test_dropout_mask_is_a_function_of_the_coordinates():
    b, n, l, rate = 3, 4, 50, 0.1
    full = tfa.dropout_keep(7, *_coords(b, n, l), rate)
    assert full.shape == (b, n, l, l)
    assert torch.equal(full, tfa.dropout_keep(7, *_coords(b, n, l), rate))
    # any tiling draws the same bits: a block of rows and columns alone
    bb, hh, ii, jj = torch.tensor([2]), torch.tensor([1, 3]), torch.arange(17, 33), \
        torch.arange(40, 50)
    block = tfa.dropout_keep(7, bb[:, None, None, None], hh[None, :, None, None],
                             ii[:, None], jj, rate)
    assert torch.equal(block, full[2:3][:, [1, 3]][:, :, 17:33, 40:50])
    # and one element at a time
    assert bool(tfa.dropout_keep(7, 1, 2, 3, 4, rate)) == bool(full[1, 2, 3, 4])
    assert not torch.equal(full, tfa.dropout_keep(8, *_coords(b, n, l), rate))
    # the keep rate: 30,000 draws, 4 standard deviations
    assert abs(full.float().mean().item() - 0.9) < 4 * (0.09 / full.numel()) ** 0.5
    assert tfa.dropout_keep(7, *_coords(b, n, l), 0.0).all()


def test_dropout_forward_is_the_explicit_mask_formula_and_backward_agrees(rng):
    q, k, v, mask, g = _qkv_mask(rng)
    tq, tk, tv, tm, tg = (torch.from_numpy(x) for x in (q, k, v, mask, g))
    rate, seed = 0.3, 11
    keep = tfa.dropout_keep(seed, *_coords(2, 4, 40), rate)

    def formula(q, k, v):
        qh, kh, vh = (tfa.split_heads(x, 4) for x in (q, k, v))
        p = torch.softmax(qh @ kh.transpose(-1, -2) / 8 ** 0.5 + tm[:, None, None, :], -1)
        return tfa.merge_heads((p * keep / (1 - rate)) @ vh)

    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = tfa.fused_self_attention(*leaves, tm, 4, rate, seed)
    np.testing.assert_allclose(out.detach().numpy(), formula(tq, tk, tv).numpy(),
                               rtol=0, atol=1e-6)
    out.backward(tg)
    ref_leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    formula(*ref_leaves).backward(tg)
    plain = tfa.attention_backward_reference(tq, tk, tv, tm, tg, 4, rate, seed)
    for name, got, want, p in zip("qkv", leaves, ref_leaves, plain):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(p.numpy(), want.grad.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the train step against the JAX package's
# ---------------------------------------------------------------------------

def _jax_cfg(**dropout):
    return jcfg.FCMFConfig(
        model=jcfg.ModelConfig(fused_attention_interpret=True, **MODEL_KW, **dropout),
        text=jcfg.TextEncoderConfig(fused_attention_interpret=True, **TEXT_KW, **dropout),
        **KW)


def _port_cfg(**dropout):
    return tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW, **dropout),
                           text=tcfg.TextEncoderConfig(**TEXT_KW, **dropout), **KW)


@pytest.fixture(scope="module")
def pair():
    """JAX FCMF at dropout 0 with random params, the port's with the same
    weights, the visual pair, and one loader-shaped batch with labels."""
    rng = np.random.default_rng(3)
    model, visual = JFCMF(_jax_cfg(**NO_DROPOUT)), JVisual(jcfg.ResNetConfig(**RESNET_KW))
    images, img_valid, rois, roi_valid, text = serving_batch(rng)
    params = randomize(jinit(
        model, text["input_ids"][:, 0], np.zeros((B, 2, 4, 128), np.float32),
        np.zeros((B, 2, 2, 128), np.float32), text["roi_coors"], None,
        text["attention_mask"][:, 0], text["added_mask"][:, 0])["params"], rng)
    visual_params = randomize(jinit(visual, np.zeros((1, IMG, IMG, 3), np.float32)), rng)
    labels = rng.integers(0, 4, size=(B, A)).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in text.items()}
    jbatch["images"] = jnp.asarray(jax_pack(images, img_valid))
    jbatch["roi_images"] = jnp.asarray(jax_pack(rois, roi_valid))
    jbatch["labels"] = jnp.asarray(labels)
    tbatch = _torch_batch(images, img_valid, rois, roi_valid, text)
    tbatch["labels"] = torch.from_numpy(labels)
    port_visual = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    port_visual.load_state_dict(
        jax_import.visual_state_dict_from_jax(visual_params["params"]), strict=True)
    return model, visual, params, visual_params, jbatch, port_visual, tbatch


def _port_model(params, **dropout):
    port = TFCMF(_port_cfg(**dropout))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    return port


def _jax_run(pair, tx, steps):
    model, visual, params, visual_params, jbatch, _, _ = pair
    state = JTrainState.create(params, visual_params, tx)
    step = jsteps.make_finetune_train_step(model, visual, donate=False)
    metrics = []
    for _ in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


def test_train_step_gradients_match_jax(pair):
    """One SGD step at lr 1: each parameter moves by -grad on both sides."""
    params, tbatch = pair[2], pair[6]
    new_params, (want,) = _jax_run(pair, optax.sgd(1.0), 1)
    port = _port_model(params, **NO_DROPOUT)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = TrainState.create(port, pair[5], torch.optim.SGD(port.parameters(), lr=1.0))
    got = make_finetune_train_step(state)(tbatch, seed=0)
    assert state.step == 1
    # f32 on both sides; the loss sums 6 aspects' CE of logits that agree to ~1e-5
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    # the same count of right views (the two means round 5/12 differently)
    np.testing.assert_allclose(float(got["accuracy"]), want["accuracy"], rtol=1e-6)
    want_sd = jax_import.fcmf_state_dict_from_jax(new_params, 2)
    want_old = jax_import.fcmf_state_dict_from_jax(params, 2)
    moved = 0
    for name, now in port.state_dict().items():
        got_delta = (now - before[name]).numpy()
        want_delta = (want_sd[name] - want_old[name]).numpy()
        moved += bool(np.abs(want_delta).max() > 0)
        # summation order through 2+3 layers and their backward, in f32:
        # 1e-4 of the largest gradient of that parameter, or 1e-6
        tol = max(1e-4 * np.abs(want_delta).max(), 1e-6)
        np.testing.assert_allclose(got_delta, want_delta, rtol=0, atol=tol, err_msg=name)
    assert moved > 0.9 * len(want_sd)  # all but the unused pooler and alike


def test_train_step_adamw_losses_match_jax(pair):
    params, tbatch = pair[2], pair[6]
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    tx = joptim.make_adamw(joptim.linear_warmup_schedule(1e-3, 1, 100),
                           head_learning_rate=joptim.linear_warmup_schedule(1e-2, 1, 100),
                           **kw)
    _, want = _jax_run(pair, tx, 3)
    port = _port_model(params, **NO_DROPOUT)
    opt = optim.AdamW(port, optim.linear_warmup_schedule(1e-3, 1, 100),
                      head_learning_rate=optim.linear_warmup_schedule(1e-2, 1, 100), **kw)
    step = make_finetune_train_step(TrainState.create(port, pair[5], opt))
    got = [float(step(tbatch, seed=0)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got, [m["loss"] for m in want], rtol=1e-4)
    assert got[2] < got[0]


def test_train_step_with_dropout_is_seeded_and_learns(pair):
    params, tbatch = pair[2], pair[6]

    def run(seed, steps):
        port = _port_model(params)  # dropout 0.1 everywhere, the reference rates
        opt = optim.AdamW(port, optim.linear_warmup_schedule(1e-3, 2, 100),
                          head_learning_rate=optim.linear_warmup_schedule(1e-2, 2, 100))
        step = make_finetune_train_step(TrainState.create(port, pair[5], opt))
        return [float(step(tbatch, seed)["loss"]) for _ in range(steps)]

    first = run(0, 9)
    assert np.isfinite(first).all()
    assert first[-1] < first[0], first  # overfits a fixed batch
    assert run(0, 2) == first[:2]
    assert run(1, 2) != first[:2]


def test_train_state_does_not_train_the_cnn_yet(pair):
    port = _port_model(pair[2])
    with pytest.raises(NotImplementedError):
        TrainState.create(port, pair[5], torch.optim.SGD(port.parameters(), lr=1.0),
                          fine_tune_cnn=True)


def test_cached_features_match_jax(pair, rng):
    """A batch carrying `grid`/`roi` features skips the ResNet, as the JAX
    forward does for its frozen-CNN feature cache."""
    model, _, params, _, jbatch, _, tbatch = pair
    grid = rng.normal(size=(B, 2, 4, 128)).astype(np.float32)
    roi = rng.normal(size=(B, 2, 2, 128)).astype(np.float32)
    jb = {k: v for k, v in jbatch.items() if k not in ("images", "roi_images")}
    want = jax.jit(lambda p, b: jsteps.fcmf_forward_all_aspects(model, p, None, None, b))(
        params, {**jb, "grid": jnp.asarray(grid), "roi": jnp.asarray(roi)})
    tb = {k: v for k, v in tbatch.items() if k not in ("images", "roi_images")}
    tb.update(grid=torch.from_numpy(grid), roi=torch.from_numpy(roi))
    port = _port_model(params, **NO_DROPOUT)
    with torch.no_grad():
        got = fcmf_forward_all_aspects(port, None, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    _, logits = make_finetune_eval_step(port, None)(tb)
    assert torch.equal(logits, got)


def test_eval_step_runs_in_eval_mode_and_restores_it(pair):
    port = _port_model(pair[2])
    snapshot = copy.deepcopy(port.state_dict())
    seen = []
    port.encoder.register_forward_pre_hook(lambda m, args: seen.append(m.training))
    eval_step = make_finetune_eval_step(port, pair[5])
    _, before = eval_step(pair[6])
    opt = optim.AdamW(port, 1e-3)
    make_finetune_train_step(TrainState.create(port, pair[5], opt))(pair[6], seed=0)
    assert port.training  # the train step leaves the model in training mode
    port.load_state_dict(snapshot)
    _, after = eval_step(pair[6])
    _, again = eval_step(pair[6])
    assert seen == [False, True, False, False]
    assert port.training  # restored
    assert torch.equal(after, before) and torch.equal(again, after)
