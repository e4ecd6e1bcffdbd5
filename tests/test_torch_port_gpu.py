"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and the CUDA toolkit (`nvcc`), and
skips without them.  The file imports no JAX (the card's machine has
none), so on the card it runs without the suite's conftest:

    python -m pytest tests/test_torch_port_gpu.py -m gpu --noconftest -q
"""

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
from macsa_tpu_torch.train.steps import finetune_loss, make_finetune_eval_step

pytestmark = pytest.mark.gpu
MASKS = {"neg10000": -10000.0, "finfo_min": float(np.finfo(np.float32).min)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32: summation order only; bf16: the plain version rounds the scores to
# bf16 (they leave the matmul in the operand dtype), the kernel keeps f32
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mask_kind", sorted(MASKS))
@pytest.mark.parametrize("heads,head_dim", [(12, 64), (4, 32)])
@pytest.mark.parametrize("l", [40, 170, 514])  # 514 = max_position_embeddings
def test_attention_kernel_matches_plain(cuda, dtype, atol, mask_kind, heads, head_dim, l):
    g = torch.Generator(cuda).manual_seed(0)
    b = 4
    q, k, v = (torch.randn(b, l, heads * head_dim, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    lens = torch.tensor([l, 1, l // 3, l - 1], device=cuda)
    mask = torch.zeros(b, l, device=cuda).masked_fill(
        torch.arange(l, device=cuda) >= lens[:, None], MASKS[mask_kind])
    before = cuda_lib.launch_counts["fused_self_attention"]
    out = fa.fused_self_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_self_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = fa.attention_reference(q, k, v, mask, heads)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# relative to max|ref|.  f32: summation order only.  bf16: the kernels and
# the plain versions round at the same points (probs before P@V and dV, ds
# before dQ/dK), but one flipped rounding of a bf16 operand moves a sum by
# one bf16 ulp of that term; the plain forward also rounds the scores to bf16
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("heads,head_dim", [(12, 64), (4, 32)])
@pytest.mark.parametrize("l", [40, 170, 514])
def test_attention_forward_and_backward_kernels_match_plain(cuda, dtype, tol, rate, heads,
                                                            head_dim, l):
    g = torch.Generator(cuda).manual_seed(1)
    b, seed = 3, 1234
    q, k, v, gout = (torch.randn(b, l, heads * head_dim, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    lens = torch.tensor([l, 1, l // 3], device=cuda)
    mask = torch.zeros(b, l, device=cuda).masked_fill(
        torch.arange(l, device=cuda) >= lens[:, None], MASKS["finfo_min"])
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    before = dict(cuda_lib.launch_counts)
    out = fa.fused_self_attention(qg, kg, vg, mask, heads, rate, seed)
    out.backward(gout)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_self_attention"] == \
        before.get("fused_self_attention", 0) + 1
    assert cuda_lib.launch_counts["fused_self_attention_bwd"] == \
        before.get("fused_self_attention_bwd", 0) + 1
    want = fa.attention_reference(q, k, v, mask, heads, rate, seed)
    assert _rel_err(out, want) <= tol
    wants = fa.attention_backward_reference(q, k, v, mask, gout, heads, rate, seed)
    for name, got, w in zip("qkv", (qg.grad, kg.grad, vg.grad), wants):
        assert got.dtype == dtype
        assert _rel_err(got, w) <= tol, name


def test_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 40, 96, device=cuda)
    mask = torch.zeros(2, 40, device=cuda)
    with pytest.raises(ValueError):  # head dim 8
        fa.fused_self_attention(q, q, q, mask, 12)
    with pytest.raises(ValueError):  # not contiguous
        fa.fused_self_attention(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, mask, 3)
    with pytest.raises(TypeError):
        fa.fused_self_attention(q.half(), q.half(), q.half(), mask, 3)
    with pytest.raises(ValueError):  # not a dropout rate
        fa.fused_self_attention(q, q, q, mask, 3, rate=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_kernels_match_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(3, 5, 32, 32, 3), dtype=np.uint8)
    valid = rng.uniform(size=(3, 5)) > 0.3
    words = torch.from_numpy(image_prep.pack_pixels_u8(images, valid)).to(cuda)
    raw = torch.from_numpy(images).to(cuda)
    odd = torch.from_numpy(images[0, 0, :5, :5]).to(cuda)  # 75 bytes: a ragged tail
    for got, want in ((image_prep.unpack_normalize_pixels(words, dtype),
                       image_prep.unpack_normalize_pixels_reference(words, dtype)),
                      (image_prep.normalize_images_u8(raw, dtype),
                       image_prep.normalize_images_u8_reference(raw, dtype)),
                      (image_prep.normalize_images_u8(odd, dtype),
                       image_prep.normalize_images_u8_reference(odd, dtype))):
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _small_model_and_batch(**dropout):
    """A 2-layer FCMF at width 128 (head dim 32, one the kernels take), a
    small ResNet, and a loader-shaped batch with labels, all on the CPU."""
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=256, **dropout)
    cfg = config.FCMFConfig(
        model=config.ModelConfig(**kw),
        text=config.TextEncoderConfig(vocab_size=64, max_position_embeddings=64, **kw),
        num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=40)
    model = init_weights(FCMF(cfg), torch.Generator().manual_seed(0))
    visual = init_weights(VisualFeatures(config.ResNetConfig(
        stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="float32")),
        torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    b, a, l = 2, 6, 40
    valid = np.ones((b, 2), bool)
    valid[1, 1] = False
    attn = (np.arange(l) < rng.integers(8, l + 1, size=(b, a, 1))).astype(np.int32)
    batch = {
        "images": image_prep.pack_pixels_u8(
            rng.integers(0, 256, size=(b, 2, 64, 64, 3), dtype=np.uint8), valid),
        "roi_images": image_prep.pack_pixels_u8(
            rng.integers(0, 256, size=(b, 2, 2, 64, 64, 3), dtype=np.uint8)),
        "roi_coors": rng.uniform(size=(b, 2, 2, 4)).astype(np.float32),
        "input_ids": np.where(attn == 1, rng.integers(2, 64, size=(b, a, l)), 1).astype(np.int32),
        "token_type_ids": np.zeros((b, a, l), np.int32),
        "attention_mask": attn,
        "added_mask": np.ones((b, a, l + 4), np.int32),
        "labels": rng.integers(0, 4, size=(b, a)).astype(np.int32),
    }
    return model, visual, {k: torch.from_numpy(v) for k, v in batch.items()}


def test_eval_step_on_gpu_matches_cpu(cuda):
    """The eval step on the card (both kernels) against the same weights
    and batch on the CPU (their plain versions), f32 with TF32 off."""
    model, visual, batch = _small_model_and_batch()
    want_preds, want = make_finetune_eval_step(model, visual)(batch)
    cuda_lib.reset_launch_counts()
    preds, logits = make_finetune_eval_step(model.to(cuda), visual.to(cuda))(
        {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_self_attention"] == 2
    assert cuda_lib.launch_counts["device_normalize"] == 2
    torch.testing.assert_close(logits.cpu(), want, rtol=0, atol=1e-3)
    assert torch.equal(preds.cpu(), want_preds)


def test_train_step_gradients_on_gpu_match_cpu(cuda):
    """The train step's loss and gradients at dropout 0 on the card (K1's
    forward and backward kernels, K2) against the CPU (plain versions),
    f32 with TF32 off: summation order only, 1e-4 of each parameter's
    largest gradient."""
    model, visual, batch = _small_model_and_batch(hidden_dropout_prob=0.0,
                                                  attention_probs_dropout_prob=0.0)
    model.train()
    loss, acc = finetune_loss(model, visual, batch)
    loss.backward()
    want = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model, visual = model.to(cuda), visual.to(cuda)
    cuda_lib.reset_launch_counts()
    got_loss, got_acc = finetune_loss(model, visual, {k: v.to(cuda) for k, v in batch.items()})
    got_loss.backward()
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"fused_self_attention": 2,
                                            "fused_self_attention_bwd": 2,
                                            "device_normalize": 2}
    torch.testing.assert_close(got_loss.cpu(), loss.detach(), rtol=1e-5, atol=0)
    assert got_acc.item() == acc.item()
    for name, p in model.named_parameters():
        if name not in want:
            assert p.grad is None, name
            continue
        tol = max(1e-4 * want[name].abs().max().item(), 1e-7)
        torch.testing.assert_close(p.grad.cpu(), want[name], rtol=0, atol=tol, msg=name)
