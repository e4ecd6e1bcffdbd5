"""The port's box-attention kernel option (K3) against the JAX package.

K3's plain version against the JAX Pallas kernel run in interpret mode,
its analytic backward against `jax.vjp` of that kernel, and the box head
and the FCMF eval step with `use_pallas_box_attention=True` on both
sides.  The JAX model calls its kernel without `interpret`, so these tests
route that call through interpret mode by patching the JAX module's
attribute for the length of the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.box_attention import BoxMultiHeadedAttention as JBox
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.ops import box_attention_kernel as jbk
from macsa_tpu.ops.image_prep import pack_pixels_u8 as jax_pack
from macsa_tpu.train.steps import make_finetune_eval_step as jax_eval_step
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models import box_attention as tbox_module
from macsa_tpu_torch.models.box_attention import BoxMultiHeadedAttention as TBox
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.layers import DropoutRng
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.ops import box_attention as tba
from macsa_tpu_torch.train import jax_import
from macsa_tpu_torch.train.steps import make_finetune_eval_step
from test_torch_port_models import jinit, randomize
from test_torch_port_slice import (B, KW, MODEL_KW, RESNET_KW, TEXT_KW, IMG, _torch_batch,
                                   serving_batch)

SHAPES = [(6, 4, 96), (6, 3, 96), (6, 5, 96)]  # N = 3 and 5: the TPU kernel pads them


@pytest.fixture
def jax_kernel_interpreted(monkeypatch):
    """The JAX models' `fused_box_attention` call, run in interpret mode."""
    kernel = jbk.fused_box_attention
    monkeypatch.setattr(jbk, "fused_box_attention",
                        lambda q, k, v, gates: kernel(q, k, v, gates, True))


def _inputs(rng, bh, n, d):
    q, k, v = (rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3))
    gates = np.maximum(rng.normal(size=(bh, n, n)), 0.0).astype(np.float32)  # ~half are 0
    return q, k, v, gates


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_jax(rng, shape):
    q, k, v, gates = _inputs(rng, *shape)
    want = jbk.fused_box_attention(*map(jnp.asarray, (q, k, v, gates)), True)
    got = tba.fused_box_attention(*map(torch.from_numpy, (q, k, v, gates)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_reference_matches_jax_vjp(rng, shape):
    q, k, v, gates = _inputs(rng, *shape)
    g = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jbk.fused_box_attention(*a, True),
                     *map(jnp.asarray, (q, k, v, gates)))
    wants = vjp(jnp.asarray(g))
    gots = tba.box_attention_backward_reference(*map(torch.from_numpy, (q, k, v, gates, g)))
    for name, got, want in zip(("dq", "dk", "dv", "dgates"), gots, wants):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert (gates == 0).any()
    assert not gots[3].numpy()[gates == 0].any()  # exactly 0 where a gate is 0


def test_autograd_of_the_plain_version_is_the_backward_reference(rng):
    """On the CPU, fused_box_attention is the plain version under autograd;
    its gradients are the analytic backward's."""
    arrays = _inputs(rng, 6, 4, 96)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    g = torch.from_numpy(rng.normal(size=(6, 4, 96)).astype(np.float32))
    out = tba.fused_box_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    wants = tba.box_attention_backward_reference(*map(torch.from_numpy, arrays), g)
    for got, want in zip(grads, wants):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_box_head_kernel_option_matches_jax(rng, jax_kernel_interpreted):
    hidden = 32
    x = rng.normal(size=(3, 4, hidden)).astype(np.float32)
    boxes = rng.uniform(0, 1, size=(3, 4, 4)).astype(np.float32)
    boxes[2, 3] = 0.0  # an empty ROI slot
    mod = JBox(num_heads=8, d_model=hidden, use_pallas_kernel=True)
    params = randomize(jinit(mod, x, x, x, boxes), rng)
    want = jax.jit(mod.apply)(params, x, x, x, boxes)
    box = TBox(8, hidden, use_pallas_kernel=True)
    box.load_state_dict(jax_import.box_head_state_dict(params["params"]))
    got = box(*map(torch.from_numpy, (x, x, x, boxes)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("training,with_rng,takes_kernel", [
    (False, False, True), (False, True, True), (True, False, True), (True, True, False)])
def test_box_head_runs_the_kernel_unless_dropout_is_active(monkeypatch, training, with_rng,
                                                           takes_kernel):
    """As in the JAX module: the kernel runs when no dropout applies, the
    plain path (which draws the dropout) when it does."""
    calls = []

    def counting(*args):
        calls.append(1)
        return tba.fused_box_attention(*args)

    monkeypatch.setattr(tbox_module, "fused_box_attention", counting)
    box = TBox(8, 32, dropout_rate=0.1, use_pallas_kernel=True)
    torch.nn.init.normal_(box.linears[0].weight)
    box.train(training)
    x = torch.randn(2, 4, 32, generator=torch.Generator().manual_seed(0))
    rng = DropoutRng.for_step(0, 0, "cpu") if with_rng else None
    out = box(x, x, x, torch.rand(2, 4, 4, generator=torch.Generator().manual_seed(1)), rng)
    assert out.shape == (2, 4, 32)
    assert len(calls) == int(takes_kernel)


def test_eval_step_with_box_kernel_matches_jax(rng, jax_kernel_interpreted):
    jcfg_ = jcfg.FCMFConfig(
        model=jcfg.ModelConfig(fused_attention_interpret=True, **MODEL_KW),
        text=jcfg.TextEncoderConfig(fused_attention_interpret=True, **TEXT_KW),
        use_pallas_box_attention=True, **KW)
    model, visual = JFCMF(jcfg_), JVisual(jcfg.ResNetConfig(**RESNET_KW))
    images, img_valid, rois, roi_valid, text = serving_batch(rng)
    params = randomize(jinit(
        model, text["input_ids"][:, 0], np.zeros((B, 2, 4, 128), np.float32),
        np.zeros((B, 2, 2, 128), np.float32), text["roi_coors"], None,
        text["attention_mask"][:, 0], text["added_mask"][:, 0])["params"], rng)
    visual_params = randomize(jinit(visual, np.zeros((1, IMG, IMG, 3), np.float32)), rng)
    jbatch = {k: jnp.asarray(v) for k, v in text.items()}
    jbatch["images"] = jnp.asarray(jax_pack(images, img_valid))
    jbatch["roi_images"] = jnp.asarray(jax_pack(rois, roi_valid))
    want_preds, want_logits = jax_eval_step(model, visual)(params, visual_params, jbatch)

    port = TFCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                                 text=tcfg.TextEncoderConfig(**TEXT_KW),
                                 use_pallas_box_attention=True, **KW))
    assert port.encoder.box_head.use_pallas_kernel
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    port_visual = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    port_visual.load_state_dict(
        jax_import.visual_state_dict_from_jax(visual_params["params"]), strict=True)
    preds, logits = make_finetune_eval_step(port, port_visual)(
        _torch_batch(images, img_valid, rois, roi_valid, text))

    assert logits.shape == (B, 6, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))
