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
    variant = _k1_variant(dtype, head_dim)
    assert fa.attention_variant(dtype, head_dim, l) == variant
    cuda_lib.reset_launch_counts()
    out = fa.fused_self_attention(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"fused_self_attention": 1,
                                            f"fused_self_attention.{variant}": 1}
    assert out.dtype == dtype and out.shape == q.shape
    want = fa.attention_reference(q, k, v, mask, heads)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)


def _k1_variant(dtype, head_dim):
    """The K1 kernel a dtype and head width run, both ways: at head width
    64 bf16 on the tensor cores ("wgmma") and f32 as three TF32 products on
    them ("tf32x3"); at head width 32 the CUDA-core kernel ("simt")."""
    if head_dim != 64:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


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
    _check_forward_and_backward(q, k, v, mask, gout, heads, rate, seed, tol)


def _check_forward_and_backward(q, k, v, mask, gout, heads, rate, seed, tol):
    """K1's forward and backward kernels on leaves of q, k, v against the
    plain versions, each launched once on the variant the rule names."""
    dtype, (_, l, hd) = q.dtype, q.shape
    fwd = fa.attention_variant(dtype, hd // heads, l)
    bwd = fa.attention_variant(dtype, hd // heads, l, backward=True)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    cuda_lib.reset_launch_counts()
    out = fa.fused_self_attention(qg, kg, vg, mask, heads, rate, seed)
    out.backward(gout)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {
        "fused_self_attention": 1, f"fused_self_attention.{fwd}": 1,
        "fused_self_attention_bwd": 1, f"fused_self_attention_bwd.{bwd}": 1}
    want = fa.attention_reference(q, k, v, mask, heads, rate, seed)
    assert _rel_err(out, want) <= tol
    wants = fa.attention_backward_reference(q, k, v, mask, gout, heads, rate, seed)
    for name, got, w in zip("qkv", (qg.grad, kg.grad, vg.grad), wants):
        assert got.dtype == dtype
        # a gradient that is exactly 0 (one row: ds = 0) has no scale to be relative to
        scale = w.float().abs().max().item()
        assert (got.float() - w.float()).abs().max().item() <= tol * scale, name


# the tensor-core variants' edges: one row, a ragged first tile, whole tiles
# and one row more (64, 65; 192 is the longest row the bf16 one-launch
# backward holds; past it the bf16 forward walks ring passes of 128 keys and
# the backward streams tiles in two launches: 193, 255, 256 = EF-CapTr's
# rows, 257, 320, 514 = max_position_embeddings; f32 walks 64-key tiles at
# every length), at 64 x 12 (row, head) pairs: 768 one-launch backward
# blocks, 768 blocks per query or key tile otherwise, several waves over the
# card's 132 SMs
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("l", [1, 31, 64, 65, 192, 193, 255, 256, 257, 320, 514])
def test_attention_tensor_core_kernels_at_tile_edges(cuda, dtype, tol, rate, l):
    g = torch.Generator(cuda).manual_seed(2)
    b, heads, seed = 64, 12, 4321
    q, k, v, gout = (torch.randn(b, l, heads * 64, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    lens = torch.randint(1, l + 1, (b,), device=cuda, generator=g)
    lens[0] = l
    mask = torch.zeros(b, l, device=cuda).masked_fill(
        torch.arange(l, device=cuda) >= lens[:, None], MASKS["neg10000"])
    assert fa.attention_variant(q.dtype, 64, l) == _k1_variant(dtype, 64)
    assert fa.attention_variant(q.dtype, 64, l, backward=True) == _k1_variant(dtype, 64)
    _check_forward_and_backward(q, k, v, mask, gout, heads, rate, seed, tol)


# Phase 1's shapes: the train step and the eval decode send K1 [16, 170, 768],
# the driver's debug decode [2, 170, 768], BERTScore [<= 16, 64, 768]
# (forward only); the decoder's own attention never reaches K1
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,l", [(16, 170), (2, 170), (16, 64)])
def test_attention_kernels_at_the_phase1_shapes(cuda, dtype, tol, rate, b, l):
    g = torch.Generator(cuda).manual_seed(3)
    heads, seed = 12, 99
    q, k, v, gout = (torch.randn(b, l, heads * 64, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    lens = torch.randint(8, l + 1, (b,), device=cuda, generator=g)
    lens[0] = l
    mask = torch.zeros(b, l, device=cuda).masked_fill(
        torch.arange(l, device=cuda) >= lens[:, None], MASKS["finfo_min"])
    variant = _k1_variant(dtype, 64)
    assert fa.attention_variant(dtype, 64, l) == variant
    assert fa.attention_variant(dtype, 64, l, backward=True) == variant
    _check_forward_and_backward(q, k, v, mask, gout, heads, rate, seed, tol)


def test_seq2seq_decode_on_gpu_matches_cpu(cuda):
    """The Phase-1 model at a small width: teacher-forcing logits and the
    greedy and beam-3 tokens on the card (K1 in the text encoder) against
    the CPU's (its plain version), in f32."""
    from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128)
    cfg = config.FCMFConfig(model=config.ModelConfig(**kw),
                            text=config.TextEncoderConfig(vocab_size=96,
                                                          max_position_embeddings=64, **kw),
                            num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=32,
                            max_text_len=40, box_heads=8)
    dec = config.DecoderConfig(vocab_size=96, hidden_size=64, num_blocks=2, num_heads=2,
                               ffn_hidden=64, max_decode_len=8)
    cpu_model = FCMFSeq2Seq(cfg, dec)
    init_weights(cpu_model, torch.Generator().manual_seed(0), 0.3)
    gpu_model = FCMFSeq2Seq(cfg, dec, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    assert gpu_model.decoder.dense.weight is gpu_model.shared_embedding
    g = torch.Generator().manual_seed(1)
    b = 3
    ids = torch.randint(3, 96, (b, 40), generator=g, dtype=torch.int32)
    mask = torch.ones(b, 40, dtype=torch.int32)
    mask[1, 25:] = 0
    dec_ids = torch.randint(3, 96, (b, 8), generator=g, dtype=torch.int32)
    feats = (torch.randn(b, 2, 4, 32, generator=g), torch.randn(b, 2, 2, 32, generator=g),
             torch.rand(b, 2, 2, 4, generator=g))
    added = torch.ones(b, 44, dtype=torch.int32)
    on = lambda *xs: [x.to(cuda) for x in xs]
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        want = cpu_model(ids, dec_ids, *feats, None, mask, added)
        got = gpu_model(*on(ids, dec_ids, *feats), None, *on(mask, added))
    assert cuda_lib.launch_counts["fused_self_attention"] == 2
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    kw = dict(attention_mask=mask, added_attention_mask=added)
    gkw = {k: v.to(cuda) for k, v in kw.items()}
    assert torch.equal(gpu_model.greedy_decode(*on(ids, *feats), 0, 2, **gkw).cpu(),
                       cpu_model.greedy_decode(ids, *feats, 0, 2, **kw))
    seqs, scores = gpu_model.beam_decode(*on(ids, *feats), 0, 2, beam_size=3, **gkw)
    cpu_seqs, cpu_scores = cpu_model.beam_decode(ids, *feats, 0, 2, beam_size=3, **kw)
    assert torch.equal(seqs.cpu(), cpu_seqs)
    torch.testing.assert_close(scores.cpu(), cpu_scores, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [170, 256])  # bf16: the one-launch and the two-launch backward
def test_attention_backward_is_bitwise_repeatable(cuda, dtype, l):
    """No atomics in either variant: a block owns every sum it writes, so
    two backward calls on the same inputs give the same bits."""
    g = torch.Generator(cuda).manual_seed(3)
    b, heads = 48, 12
    q, k, v, gout = (torch.randn(b, l, heads * 64, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    mask = torch.zeros(b, l, device=cuda)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    out = fa.fused_self_attention(*leaves, mask, heads, 0.1, 99)
    first = torch.autograd.grad(out, leaves, gout, retain_graph=True)
    second = torch.autograd.grad(out, leaves, gout, retain_graph=True)
    out2 = fa.fused_self_attention(*leaves, mask, heads, 0.1, 99)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


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


def test_kernels_launch_on_the_tensors_device_whatever_device_is_current(cuda):
    """A rank's tensors on cuda:1 while device 0 is current: K1 forward and
    backward, K3 and K2 launch on the tensors' card (each wrapper runs
    under `torch.cuda.device(x.device)`) and match their plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    g = torch.Generator(dev).manual_seed(11)
    q, k, v, gout = (torch.randn(2, 40, 768, device=dev, generator=g) for _ in range(4))
    mask = torch.zeros(2, 40, device=dev)
    bq, bk, bv = (torch.randn(48, 4, 96, device=dev, generator=g) for _ in range(3))
    gates = torch.rand(48, 4, 4, device=dev, generator=g)
    pixels = torch.randint(0, 256, (3, 224, 224, 3), dtype=torch.uint8, device=dev,
                           generator=g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    cuda_lib.reset_launch_counts()
    with torch.cuda.device(0):
        out = fa.fused_self_attention(*leaves, mask, 12)
        grads = torch.autograd.grad(out, leaves, gout)
        box = ba.fused_box_attention(bq, bk, bv, gates)
        normalized = image_prep.normalize_images_u8(pixels, torch.float32)
    torch.cuda.synchronize(dev)
    assert {name: cuda_lib.launch_counts[name] for name in (
        "fused_self_attention", "fused_self_attention_bwd", "box_attention",
        "device_normalize")} == dict.fromkeys(("fused_self_attention", "fused_self_attention_bwd",
                                               "box_attention", "device_normalize"), 1)
    assert out.device == box.device == normalized.device == dev
    torch.testing.assert_close(out, fa.attention_reference(q, k, v, mask, 12), rtol=0,
                               atol=1e-5)
    for got, want in zip(grads, fa.attention_backward_reference(q, k, v, mask, gout, 12)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(box, ba.box_attention_reference(bq, bk, bv, gates), rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(normalized,
                               image_prep.normalize_images_u8_reference(pixels, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_launch_the_kernels(cuda, dtype):
    """Without autograd the wrappers call the registered ops, whose CUDA
    implementations are the kernels' launches (what an exported bundle
    runs)."""
    g = torch.Generator(cuda).manual_seed(12)
    q, k, v = (torch.randn(4, 170, 768, device=cuda, generator=g).to(dtype) for _ in range(3))
    mask = torch.zeros(4, 170, device=cuda)
    bq, bk, bv = (torch.randn(56, 4, 96, device=cuda, generator=g).to(dtype) for _ in range(3))
    gates = torch.rand(56, 4, 4, device=cuda, generator=g).to(dtype)
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        out = fa.fused_self_attention(q, k, v, mask, 12)
        box = ba.fused_box_attention(bq, bk, bv, gates)
    direct = torch.ops.macsa_tpu_torch.fused_self_attention(q, k, v, mask, 12, 0.0, 0)
    direct_box = torch.ops.macsa_tpu_torch.box_attention(bq, bk, bv, gates)
    torch.cuda.synchronize()
    variant = _k1_variant(dtype, 64)
    assert dict(cuda_lib.launch_counts) == {"fused_self_attention": 2,
                                            f"fused_self_attention.{variant}": 2,
                                            "box_attention": 2}
    assert torch.equal(out, direct) and torch.equal(box, direct_box)
    with pytest.raises(ValueError):  # the CUDA implementation checks what the kernel takes
        torch.ops.macsa_tpu_torch.fused_self_attention(q[:, :, :96], k[:, :, :96],
                                                       v[:, :, :96], mask, 12, 0.0, 0)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid_kind", ["all_valid", "all_invalid", "mixed"])
@pytest.mark.parametrize("size", [224, 32, 30, 6, 2])
def test_packed_normalize_kernel_over_frame_sizes(cuda, dtype, valid_kind, size):
    """Bit for bit over frames whose word count is odd (224, 32: an even
    count of pixel words, the tiled kernel, 224 with several tiles a frame)
    and even (30, 6, 2: an odd count, the one-word-per-thread kernel in
    bf16), all valid, all invalid and mixed; invalid frames are exact zeros."""
    rng = np.random.default_rng(size)
    lead = (3, 5) if size > 100 else (4, 7, 3)
    images = rng.integers(0, 256, size=lead + (size, size, 3), dtype=np.uint8)
    valid = {"all_valid": np.ones(lead, bool), "all_invalid": np.zeros(lead, bool),
             "mixed": rng.uniform(size=lead) > 0.4}[valid_kind]
    words = torch.from_numpy(image_prep.pack_pixels_u8(images, valid)).to(cuda)
    assert (words.shape[-1] % 2 == 1) == (size in (224, 32))
    before = cuda_lib.launch_counts["device_normalize"]
    got = image_prep.unpack_normalize_pixels(words, dtype)
    want = image_prep.unpack_normalize_pixels_reference(words, dtype)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts["device_normalize"] == before + 1
    assert torch.equal(got, want)
    assert not got[torch.from_numpy(~valid).to(cuda)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_bytes", [3, 12, 75, 4 * 2688 * 3, 4 * 2688 * 3 + 6, 1_000_003 * 3])
def test_raw_normalize_kernel_over_lengths(cuda, dtype, n_bytes):
    """Raw uint8 of lengths below a word, at and across tile edges, with
    ragged tails, and from a view that starts off a 16-byte boundary."""
    rng = np.random.default_rng(n_bytes)
    flat = torch.from_numpy(rng.integers(0, 256, size=n_bytes + 12, dtype=np.uint8)).to(cuda)
    for offset in (0, 4, 12):
        raw = flat[offset:offset + n_bytes].view(-1, 3)
        got = image_prep.normalize_images_u8(raw, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, image_prep.normalize_images_u8_reference(raw, dtype))


def _small_model_and_batch(fcmf_kw=None, **dropout):
    """A 2-layer FCMF at width 128 (head dim 32, one the kernels take), a
    small ResNet, and a loader-shaped batch with labels, all on the CPU."""
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=256, **dropout)
    cfg = config.FCMFConfig(
        model=config.ModelConfig(**kw),
        text=config.TextEncoderConfig(vocab_size=64, max_position_embeddings=64, **kw),
        num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128, max_text_len=40,
        **(fcmf_kw or {}))
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
                                            "fused_self_attention.simt": 2,
                                            "fused_self_attention_bwd": 2,
                                            "fused_self_attention_bwd.simt": 2,
                                            "device_normalize": 2}
    torch.testing.assert_close(got_loss.cpu(), loss.detach(), rtol=1e-5, atol=0)
    assert got_acc.item() == acc.item()
    for name, p in model.named_parameters():
        if name not in want:
            assert p.grad is None, name
            continue
        tol = max(1e-4 * want[name].abs().max().item(), 1e-7)
        torch.testing.assert_close(p.grad.cpu(), want[name], rtol=0, atol=tol, msg=name)


def _grads_on_cpu_and_card(cuda, model, visual, batch, fine_tune_cnn):
    """Loss and gradients of `finetune_loss` at dropout 0 on the CPU, then
    on the card -> (cpu loss, cpu grads, card loss, card grads, launches)."""
    def run(device):
        m, v = model.to(device), visual.to(device)
        m.zero_grad(set_to_none=True)
        v.zero_grad(set_to_none=True)
        cuda_lib.reset_launch_counts()
        loss, _ = finetune_loss(m, v, {k: t.to(device) for k, t in batch.items()},
                                fine_tune_cnn=fine_tune_cnn)
        loss.backward()
        # copies: moving the module to another device later moves its grads too
        grads = {f"{prefix}{n}": p.grad.to("cpu", copy=True)
                 for prefix, mod in (("", m), ("visual.", v))
                 for n, p in mod.named_parameters() if p.grad is not None}
        return loss.item(), grads
    model.train()
    loss, grads = run(torch.device("cpu"))
    got_loss, got_grads = run(cuda)
    torch.cuda.synchronize()
    return loss, grads, got_loss, got_grads, dict(cuda_lib.launch_counts)


def test_fine_tune_cnn_gradients_on_gpu_match_cpu(cuda):
    """`--fine_tune_cnn`: the ResNet's convolutions and all four tensors of
    each FrozenBatchNorm get gradients on the card (K2, K1, K1b) equal to
    the CPU's (plain versions) within 1e-4 of each one's largest (f32)."""
    from macsa_tpu_torch.models.resnet import trainable_batchnorm_
    model, visual, batch = _small_model_and_batch(hidden_dropout_prob=0.0,
                                                  attention_probs_dropout_prob=0.0)
    trainable_batchnorm_(visual).requires_grad_(True)
    loss, want, got_loss, got, launches = _grads_on_cpu_and_card(cuda, model, visual, batch,
                                                                 fine_tune_cnn=True)
    assert launches == {"fused_self_attention": 2, "fused_self_attention.simt": 2,
                        "fused_self_attention_bwd": 2, "fused_self_attention_bwd.simt": 2,
                        "device_normalize": 2}
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    bn_stats = [n for n in got if n.endswith(("running_mean", "running_var"))]
    assert got.keys() == want.keys() and len(bn_stats) == 2 * 17  # every BN of (1,1,1,1)
    for name, g in want.items():
        tol = max(1e-4 * g.abs().max().item(), 1e-7)
        torch.testing.assert_close(got[name], g, rtol=0, atol=tol, msg=name)


def test_mde_model_on_gpu_matches_cpu(cuda):
    """The FCMF with the MDE (alpha 0.7): logits and gradients on the card
    against the CPU, f32; the guidance attention gets no gradient."""
    model, visual, batch = _small_model_and_batch(
        dict(use_mde=True, alpha=0.7), hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    assert model.encoder.mde is not None
    want_preds, want = make_finetune_eval_step(model, visual)(batch)
    preds, logits = make_finetune_eval_step(model.to(cuda), visual.to(cuda))(
        {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(logits.cpu(), want, rtol=0, atol=1e-4)
    assert torch.equal(preds.cpu(), want_preds)
    loss, want_g, got_loss, got_g, _ = _grads_on_cpu_and_card(cuda, model, visual, batch,
                                                              fine_tune_cnn=False)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert got_g.keys() == want_g.keys()
    assert not any(n.startswith("encoder.mde.") for n in got_g)
    for name, g in want_g.items():
        tol = max(1e-4 * g.abs().max().item(), 1e-7)
        torch.testing.assert_close(got_g[name], g, rtol=0, atol=tol, msg=name)


def test_cli_on_gpu_matches_cpu(cuda, tmp_path):
    """`inference.cli` in batch mode on the card (K1 in f32) and on the
    CPU from one checkpoint and the same files: the same JSONL."""
    import dataclasses
    import json
    import os
    from macsa_tpu_torch.data import synth
    from macsa_tpu_torch.inference import cli
    from macsa_tpu_torch.train import checkpoints, optim
    from macsa_tpu_torch.train.state import TrainState
    data = str(tmp_path / "synth")
    synth.write_dataset(data)
    small = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256)
    cfg_path = os.path.join(data, "tok", "config.json")
    with open(cfg_path) as f:
        hf = json.load(f)
    with open(cfg_path, "w") as f:
        json.dump({**hf, **small}, f)
    hook = lambda cfg, rcfg: (dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **small)), rcfg)
    args = ["--pretrained_hf_model", os.path.join(data, "tok"), "--num_imgs", "2",
            "--num_rois", "2", "--max_seq_length", "48", "--resnet_stages", "1,1,1,1",
            "--roi_csv", os.path.join(data, "data", "roi_data.csv")]
    # a checkpoint of seeded weights, written as the drivers write one
    from macsa_tpu_torch.train import common
    model_cfg = config.FCMFConfig(model=config.ModelConfig(**small),
                                  text=common.text_config_from_hf({**hf, **small}, "float32"),
                                  num_imgs=2, num_roi=2, max_text_len=48)
    model = init_weights(FCMF(model_cfg), torch.Generator().manual_seed(0))
    visual = init_weights(VisualFeatures(config.ResNetConfig(stage_sizes=(1, 1, 1, 1),
                                                             dtype="float32")),
                          torch.Generator().manual_seed(1))
    checkpoints.CheckpointManager(str(tmp_path / "ckpt")).save(
        "best", TrainState.create(model, visual, optim.AdamW(model, 1e-3)), 1)
    with open(os.path.join(data, "data", "train.json")) as f:
        records = [{"text": r["comment"],
                    "image_list": [os.path.join(data, "images", n) for n in r["list_img"]]}
                   for r in json.load(f)[:6]]
    with open(tmp_path / "records.json", "w") as f:
        json.dump(records, f)
    rows = {}
    for device in ("cpu", "cuda"):
        out = str(tmp_path / f"{device}.jsonl")
        cuda_lib.reset_launch_counts()
        cli.main(args + ["--checkpoint", str(tmp_path / "ckpt"), "--input_json",
                         str(tmp_path / "records.json"), "--batch_size", "4", "--output_file",
                         out, "--device", device], config_hook=hook)
        assert dict(cuda_lib.launch_counts) == (
            {} if device == "cpu" else {"fused_self_attention": 4,
                                        "fused_self_attention.simt": 4})
        with open(out) as f:
            rows[device] = [json.loads(line) for line in f]
    assert rows["cuda"] == rows["cpu"] and len(rows["cpu"]) == 6


# K3.  f32: summation order only.  bf16: both sides round the probabilities
# and the output to bf16 from f32 sums taken in another order, so an
# output may differ by one bf16 ulp (2^-7 of its value at most) and a
# probability by one ulp (~1e-3 x |v|)
BOX_TOL = {torch.float32: dict(rtol=0, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,n,d", [(2688, 4, 96), (7, 1, 40), (9, 8, 33)]
                         + [(37, n, d) for n in range(1, 9) for d in (32, 64, 96, 100)]
                         + [(5, 3, 256), (5, 4, 264)])
def test_box_attention_kernel_matches_plain(cuda, dtype, bh, n, d):
    """[2688, 4, 96] is the serving shape: 8 samples x 6 aspects x 7 images
    x 8 heads.  Widths 32, 64 and 96 are whole 16-byte chunks in both dtypes
    (8, 16 or 32 lanes a slice); 100 is in f32 only, 33 and 40 in neither,
    264 is too wide in both: those take the one-warp-per-slice kernel."""
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
                                   (777, 100, 130), (54880, 1024, 256), (130, 64, 512),
                                   (1037, 128, 256), (1037, 64, 1024), (113, 192, 192)])
@pytest.mark.parametrize("has_res,relu", [(True, True), (False, True), (True, False)])
def test_matmul_bn_act_kernel_matches_plain(cuda, dtype, m, k, n, has_res, relu):
    """Ragged M throughout (1037 rows: 9 tiles of 112 and 29 rows, or 8 of
    128 and 13); K and N multiples of 64 must run the tensor-core variant,
    bf16 "wgmma" and f32 "tf32x3" (N a multiple of 256: 112 x 256 tiles;
    else 128 x 64), everything else the CUDA-core one."""
    g = torch.Generator(cuda).manual_seed(4)
    x2 = torch.randn(m, k, device=cuda, generator=g).to(dtype)
    w = (torch.randn(k, n, device=cuda, generator=g) / k ** 0.5).to(dtype)
    mul, add = _bn_affine(g, n, cuda)
    res = torch.randn(m, n, device=cuda, generator=g).to(dtype) if has_res else None
    variant = "simt"
    if k % 64 == 0 and n % 64 == 0:
        variant = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert fr.matmul_variant(dtype, m, n, k) == variant
    cuda_lib.reset_launch_counts()
    out = fr.fused_matmul_bn_act(x2, w, mul, add, res, relu)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"fused_matmul_bn_act": 1,
                                            f"fused_matmul_bn_act.{variant}": 1}
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


# (n, h, w, C, F): the identity blocks of ResNet-152's four stages (on the
# tensor cores), tiny ones, one image, h != w at a width the tensor-core
# kernels are built for (64) and at one they are not (16), and images whose
# rows leave a ragged last tile (20 rows in bf16's tiles of 7; in f32's
# tiles 13 rows as 5, 5, 3, 17 as 5, 5, 5, 2, 9 as 5, 4)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,f", [(3, 56, 56, 256, 64), (3, 28, 28, 512, 128),
                                       (3, 14, 14, 1024, 256), (3, 7, 7, 2048, 512),
                                       (3, 8, 8, 32, 8), (3, 6, 10, 32, 8),
                                       (1, 6, 10, 64, 16), (1, 6, 10, 256, 64),
                                       (2, 20, 14, 1024, 256), (2, 13, 14, 1024, 256),
                                       (1, 17, 28, 512, 128), (2, 9, 7, 2048, 512)])
def test_bottleneck_kernel_matches_plain(cuda, dtype, n, h, w, c, f):
    g = torch.Generator(cuda).manual_seed(5)
    args = _bottleneck_args(g, n, h, w, c, f, dtype, cuda)
    variant = "simt"
    if f >= 64:
        variant = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert fr.bottleneck_variant(dtype, h, w, c, f) == variant
    cuda_lib.reset_launch_counts()
    out = fr.fused_bottleneck(*args, n, h, w)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"fused_bottleneck": 1,
                                            f"fused_bottleneck.{variant}": 1}
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


def test_fused_backbone_bf16_runs_the_tensor_core_kernel(cuda):
    """A backbone at ResNet widths (64 filters), bf16: every identity block
    of every stage goes through the tensor-core K5, and the features stay
    no further from the f32 module path's than twice the bf16 module
    path's (`stages=()`: the heads themselves route stage 1 to K5)."""
    kw = dict(stage_sizes=(2, 2, 2, 2), num_filters=64, grid_size=2)
    visual = init_weights(VisualFeatures(config.ResNetConfig(dtype="float32", **kw)),
                          torch.Generator().manual_seed(9)).to(cuda)
    visual16 = VisualFeatures(config.ResNetConfig(dtype="bfloat16", **kw), device=cuda)
    visual16.load_state_dict(visual.state_dict())
    g = torch.Generator(cuda).manual_seed(10)
    x = torch.randn(1, 2, 64, 64, 3, device=cuda, generator=g)
    rois = torch.randn(1, 2, 2, 64, 64, 3, device=cuda, generator=g)
    with torch.no_grad():
        cuda_lib.reset_launch_counts()
        fused = fused_backbone.extract_features(visual16, x, rois, stages=(1, 2, 3, 4))
        torch.cuda.synchronize()
        assert dict(cuda_lib.launch_counts) == {"fused_bottleneck": 4, "fused_bottleneck.wgmma": 4}
        plain = fused_backbone.extract_features(visual16, x, rois, stages=())
        want = fused_backbone.extract_features(visual, x, rois, stages=())
    for i in range(2):
        assert _rel_err(fused[i], want[i]) <= 2 * _rel_err(plain[i], want[i])


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
            # 8 filters: only stage 4 (F = 64, C = 256) has a width the
            # tensor-core kernels are built for
            want = {"fused_bottleneck": 5, "fused_bottleneck.simt": 4,
                    "fused_bottleneck.wgmma" if name == "bf16" else "fused_bottleneck.tf32x3": 1}
            assert dict(cuda_lib.launch_counts) == want
            feats["plain_" + name] = (module.grid_features(x), module.pooled_features(rois))
    for i in range(2):  # grid, roi
        want = feats["plain_f32"][i]
        assert feats["f32"][i].shape == want.shape
        assert _rel_err(feats["f32"][i], want) <= 1e-4
        assert _rel_err(feats["bf16"][i], want) <= 2 * _rel_err(feats["plain_bf16"][i], want)


# EF-CapTrRoBERTa's 256 rows (`--max_cap_length`): bf16 runs both ways on
# the tensor cores (the forward's ring passes, the backward's two launches)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_at_the_efcap_shape(cuda, dtype, tol, rate):
    g = torch.Generator(cuda).manual_seed(4)
    b, l, heads, seed = 6, 256, 12, 77
    q, k, v, gout = (torch.randn(b, l, heads * 64, device=cuda, generator=g).to(dtype)
                     for _ in range(4))
    lens = torch.randint(40, l + 1, (b,), device=cuda, generator=g)
    lens[0] = l
    mask = torch.zeros(b, l, device=cuda).masked_fill(
        torch.arange(l, device=cuda) >= lens[:, None], MASKS["finfo_min"])
    variant = _k1_variant(dtype, 64)
    assert fa.attention_variant(dtype, 64, l) == variant
    assert fa.attention_variant(dtype, 64, l, backward=True) == variant
    _check_forward_and_backward(q, k, v, mask, gout, heads, rate, seed, tol)


def _baseline_and_batch(name, length, dtype="float32"):
    """A 2-layer baseline at width 128 (head dim 64) on the CPU, a small
    ResNet, and a batch of 2 reviews x 6 aspects with labels."""
    from macsa_tpu_torch.models.baselines import build_baseline
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=256, vocab_size=64, max_position_embeddings=300,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype=dtype)
    model = init_weights(build_baseline(name, config.TextEncoderConfig(**kw), 128),
                         torch.Generator().manual_seed(0), 0.05)
    visual = init_weights(VisualFeatures(config.ResNetConfig(
        stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype=dtype)),
        torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    b, a = 2, 6

    def ids(l):
        mask = (np.arange(l) < rng.integers(4, l + 1, size=(b, a, 1))).astype(np.int32)
        return np.where(mask == 1, rng.integers(2, 64, size=(b, a, l)), 1).astype(np.int32), mask

    input_ids, attention_mask = ids(length)
    batch = {"input_ids": input_ids, "attention_mask": attention_mask,
             "labels": rng.integers(0, 4, size=(b, a)).astype(np.int32)}
    if name != "efcap":
        batch["images"] = rng.normal(size=(b, 2, 64, 64, 3)).astype(np.float32)
        batch["roi_images"] = rng.normal(size=(b, 2, 2, 64, 64, 3)).astype(np.float32)
    if name == "tomroberta":
        batch["target_ids"], batch["target_mask"] = ids(16)
    return model, (visual if name != "efcap" else None), {
        k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,length", [("mroberta", 40), ("tomroberta", 40),
                                         ("efcap", 256)])
def test_baseline_kernel_path_matches_plain(cuda, name, length):
    """Each baseline on the card, f32 with TF32 off, its text encoder through
    K1 (the same model with `fused_attention` off is the plain path): eval
    logits, and one step's loss and gradients at dropout 0 (K1's backward;
    at 256 rows on the CUDA-core variant).  No K2: the frames are
    host-normalized floats, as the baseline datasets ship them."""
    import dataclasses as dc
    from macsa_tpu_torch.train.baseline_steps import baseline_forward, make_baseline_eval_step
    from macsa_tpu_torch.train.steps import aspect_loss
    model, visual, batch = _baseline_and_batch(name, length)
    model, batch = model.to(cuda), {k: v.to(cuda) for k, v in batch.items()}
    visual = visual.to(cuda) if visual is not None else None
    results = {}
    for fused in (False, True):
        for m in model.modules():
            if hasattr(m, "config") and hasattr(m.config, "fused_attention"):
                m.config = dc.replace(m.config, fused_attention=fused)
        cuda_lib.reset_launch_counts()
        _, logits = make_baseline_eval_step(model, visual)(batch)
        model.train()
        model.zero_grad(set_to_none=True)
        loss, _ = aspect_loss(baseline_forward(model, visual, batch), batch["labels"])
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        results[fused] = (logits, loss.item(), grads, dict(cuda_lib.launch_counts))
    logits, loss, grads, launches = results[True]
    want_logits, want_loss, want_grads, plain_launches = results[False]
    # 2 layers, in the eval step and the step's forward (TomBERT's 16-row
    # target stays plain); f32 at head width 64 runs the 3xTF32 variants
    assert plain_launches == {}
    assert launches == {"fused_self_attention": 4, "fused_self_attention.tf32x3": 4,
                        "fused_self_attention_bwd": 2, "fused_self_attention_bwd.tf32x3": 2}
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-4)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want_grads)
    for n, g in want_grads.items():
        tol = max(1e-4 * g.abs().max().item(), 1e-7)
        torch.testing.assert_close(grads[n], g, rtol=0, atol=tol, msg=n)
