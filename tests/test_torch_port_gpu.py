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
from macsa_tpu_torch.models import fused_backbone
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.ops import box_attention as ba
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops import fused_attention as fa
from macsa_tpu_torch.ops import fused_resnet as fr
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


# K3.  f32: summation order only.  bf16: both sides round the probabilities
# and the output to bf16 from f32 sums taken in another order, so an
# output may differ by one bf16 ulp (2^-7 of its value at most) and a
# probability by one ulp (~1e-3 x |v|)
BOX_TOL = {torch.float32: dict(rtol=0, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,d", [(2688, 4, 96), (7, 1, 40), (9, 8, 33)])
def test_box_attention_kernel_matches_plain(cuda, dtype, bh, n, d):
    """[2688, 4, 96] is the serving shape: 8 samples x 6 aspects x 7 images x 8 heads."""
    g = torch.Generator(cuda).manual_seed(3)
    q, k, v, gout = (torch.randn(bh, n, d, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    gates = torch.relu(torch.randn(bh, n, n, device=cuda, generator=g)).to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, gates)]
    before = cuda_lib.launch_counts["box_attention"]
    out = ba.fused_box_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, gout)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["box_attention"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ba.box_attention_reference(q, k, v, gates).float(),
                               **BOX_TOL[dtype])
    # the gradient is the plain analytic backward itself (with one ROI, dq
    # and dk are exactly 0)
    for got, want in zip(grads, ba.box_attention_backward_reference(q, k, v, gates, gout)):
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max() <= 1e-6 * want.float().abs().max()


# K4 and K5.  Relative to max|ref|.  f32: summation order only.  bf16: the
# kernels and the plain versions round at the outputs (and K5 at a1 and a2)
# from f32 sums taken in another order, one bf16 ulp (2^-8 relative) where
# a rounding flips; K5's plain version also rounds the conv1 and conv3
# products to bf16 where the kernel keeps them in f32
RESNET_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bn_affine(g, channels, device):
    """Random frozen-BN statistics -> the f32 (mul, add) FrozenBatchNorm makes."""
    weight, var = (torch.rand(channels, device=device, generator=g) + 0.5 for _ in range(2))
    bias, mean = (0.1 * torch.randn(channels, device=device, generator=g) for _ in range(2))
    inv = torch.rsqrt(var + 1e-5)
    return weight * inv, bias - mean * weight * inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 24, 40), (300, 64, 256), (1037, 256, 64),
                                   (777, 100, 130)])
@pytest.mark.parametrize("has_res,relu", [(True, True), (False, True), (True, False)])
def test_matmul_bn_act_kernel_matches_plain(cuda, dtype, m, k, n, has_res, relu):
    g = torch.Generator(cuda).manual_seed(4)
    x2 = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w = (torch.randn(k, n, device=cuda, generator=g) / k ** 0.5).to(dtype)
    mul, add = _bn_affine(g, n, cuda)
    res = torch.randn(m, n, device=cuda, generator=g).to(dtype) if has_res else None
    before = cuda_lib.launch_counts["fused_matmul_bn_act"]
    out = fr.fused_matmul_bn_act(x2, w, mul, add, res, relu)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_matmul_bn_act"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    assert _rel_err(out, fr.fused_matmul_bn_act_reference(x2, w, mul, add, res, relu)) \
        <= RESNET_TOL[dtype]


def _bottleneck_args(g, n, h, w, c, f, dtype, device):
    x2 = torch.relu(torch.randn(n * h * w, c, device=device, generator=g)).to(dtype)
    w1 = torch.randn(c, f, device=device, generator=g) / c ** 0.5
    w2 = torch.randn(9, f, f, device=device, generator=g) / (9 * f) ** 0.5
    w3 = torch.randn(f, c, device=device, generator=g) / f ** 0.5
    return (x2, w1, *_bn_affine(g, f, device), w2, *_bn_affine(g, f, device), w3,
            *_bn_affine(g, c, device))


# (h, w, C, F): the identity blocks of ResNet-152's four stages, and tiny ones
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,f", [(56, 56, 256, 64), (28, 28, 512, 128),
                                     (14, 14, 1024, 256), (7, 7, 2048, 512),
                                     (8, 8, 32, 8), (6, 10, 32, 8)])
def test_bottleneck_kernel_matches_plain(cuda, dtype, h, w, c, f):
    g = torch.Generator(cuda).manual_seed(5)
    n = 3
    args = _bottleneck_args(g, n, h, w, c, f, dtype, cuda)
    before = cuda_lib.launch_counts["fused_bottleneck"]
    out = fr.fused_bottleneck(*args, n, h, w)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["fused_bottleneck"] == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    cast = [t.to(dtype) if i in (1, 4, 7) else t for i, t in enumerate(args)]
    assert _rel_err(out, fr.bottleneck_reference(*cast, n, h, w)) <= K5_TOL[dtype]


def test_fused_resnet_gradients_match_plain_autograd(cuda):
    """Gradients through K4's and K5's autograd Functions against autograd
    of the plain versions, f32 with TF32 off."""
    g = torch.Generator(cuda).manual_seed(6)
    x2 = torch.randn(300, 64, device=cuda, generator=g)
    w = torch.randn(64, 96, device=cuda, generator=g) / 8
    mul, add = _bn_affine(g, 96, cuda)
    res = torch.randn(300, 96, device=cuda, generator=g)
    cases = [(fr.fused_matmul_bn_act, fr.fused_matmul_bn_act_reference, "fused_matmul_bn_act",
              (x2, w, mul, add, res), ()),
             (fr.fused_bottleneck, fr.bottleneck_reference, "fused_bottleneck",
              _bottleneck_args(g, 2, 8, 8, 64, 16, torch.float32, cuda), (2, 8, 8))]
    for kernel, plain, name, args, geometry in cases:
        leaves = [t.clone().requires_grad_(True) for t in args]
        before = cuda_lib.launch_counts[name]
        got = torch.autograd.grad((kernel(*leaves, *geometry) ** 2).sum(), leaves)
        torch.cuda.synchronize()
        assert cuda_lib.launch_counts[name] == before + 1
        leaves = [t.clone().requires_grad_(True) for t in args]
        want = torch.autograd.grad((plain(*leaves, *geometry) ** 2).sum(), leaves)
        for i, (a, b) in enumerate(zip(got, want)):
            assert _rel_err(a, b) <= 1e-4, (name, i)


def test_fused_backbone_on_gpu_matches_plain(cuda):
    """`extract_features` with every stage fused: one K5 launch per identity
    block.  f32: against the module's own grid/pooled heads on the card,
    summation order only.  bf16: both paths against the f32 heads; the
    plain blocks round their conv outputs and BN factors to bf16 where K5
    keeps f32, so K5 must come no further from f32 than twice the plain
    bf16 path's distance."""
    kw = dict(stage_sizes=(2, 2, 3, 2), num_filters=8, grid_size=2)
    visual = init_weights(VisualFeatures(config.ResNetConfig(dtype="float32", **kw)),
                          torch.Generator().manual_seed(7)).to(cuda)
    visual16 = VisualFeatures(config.ResNetConfig(dtype="bfloat16", **kw), device=cuda)
    visual16.load_state_dict(visual.state_dict())
    g = torch.Generator(cuda).manual_seed(8)
    x = torch.randn(2, 3, 64, 64, 3, device=cuda, generator=g)
    rois = torch.randn(2, 3, 2, 64, 64, 3, device=cuda, generator=g)
    with torch.no_grad():
        feats = {}
        for name, module in (("f32", visual), ("bf16", visual16)):
            cuda_lib.reset_launch_counts()
            feats[name] = fused_backbone.extract_features(module, x, rois, stages=(1, 2, 3, 4))
            torch.cuda.synchronize()
            assert dict(cuda_lib.launch_counts) == {"fused_bottleneck": 1 + 1 + 2 + 1}
            feats["plain_" + name] = (module.grid_features(x), module.pooled_features(rois))
    for i in range(2):  # grid, roi
        want = feats["plain_f32"][i]
        assert feats["f32"][i].shape == want.shape
        assert _rel_err(feats["f32"][i], want) <= 1e-4
        assert _rel_err(feats["bf16"][i], want) <= 2 * _rel_err(feats["plain_bf16"][i], want)
