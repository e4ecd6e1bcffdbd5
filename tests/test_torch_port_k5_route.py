"""The frozen ResNet's route through K5, on the CPU.

`models/resnet.takes_k5` decides, from what the code sees, whether the
stride-1 identity bottlenecks of a stage run as K5 launches
(`ops/fused_resnet.fused_bottleneck`) or as their modules: a CUDA tensor,
autograd off for the stage, a tensor-core shape, a feature map at least
`K5_MIN_MAP` wide.  Here: the rule over ResNet-152's blocks at 224^2; K5's
registered op (CPU implementation, fake, `opcheck`); the CPU path, which
the rule never routes, against the module loop bit for bit; and the
shared loop itself with the rule's device test satisfied on the CPU, so
that its K5 blocks run the op's CPU implementation (the plain version):
which blocks, their rows, autograd, and a program exported through it.

The file imports no JAX: `tests/test_torch_port_k5_route_gpu.py` reuses
its helpers on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from macsa_tpu_torch import config
from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.inference.export import ServingForward
from macsa_tpu_torch.models import fused_backbone, resnet
from macsa_tpu_torch.models.aspect_classifier import AspectClassifier
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.ops import fused_resnet as fr
from macsa_tpu_torch.train.steps import make_finetune_eval_step

DTYPES = (torch.float32, torch.bfloat16)
# ResNet widths (64 filters, so F and C are K5's tensor-core shapes), few blocks
WIDE = dict(stage_sizes=(2, 2, 2, 2), num_filters=64, grid_size=1, dtype="float32")
K5_OP = "macsa_tpu_torch.fused_bottleneck.default"


def resnet152_blocks(image_size: int = 224):
    """(stage, identity, side, c_in, f) of every bottleneck of ResNet-152
    over image_size^2 frames, in order; stages 1-indexed."""
    cfg, side, c_in = ResNetConfig(), image_size // 4, 64
    blocks = []
    for stage, num_blocks in enumerate(cfg.stage_sizes):
        f = cfg.num_filters * 2 ** stage
        if stage > 0:
            side //= 2
        for block in range(num_blocks):
            blocks.append((stage + 1, block > 0, side, c_in, f))
            c_in = 4 * f
    return blocks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frames", [56, 224])  # a serving batch's two passes
def test_the_rule_over_resnet152_at_224(dtype, frames):
    """Identity blocks of stages 1-3 yes; stage 4 (7 wide) no; strided and
    downsampling blocks 0 no; with autograd no; on the CPU no; over fewer
    than `K5_MIN_FRAMES` frames (the CLI's taggers: one) no."""
    blocks = resnet152_blocks()
    assert [side for stage, _, side, _, _ in blocks if stage == 4] == [7, 7, 7]
    for stage, identity, side, c, f in blocks:
        want = identity and stage < 4
        assert resnet.takes_k5("cuda", False, identity, dtype, frames, side, side, c, f) == \
            want, (stage, identity)
        assert not resnet.takes_k5("cuda", True, identity, dtype, frames, side, side, c, f)
        assert not resnet.takes_k5("cpu", False, identity, dtype, frames, side, side, c, f)
        for few in (1, resnet.K5_MIN_FRAMES - 1):
            assert not resnet.takes_k5("cuda", False, identity, dtype, few, side, side, c, f)
    assert sum(identity and stage < 4 for stage, identity, *_ in blocks) == 44
    cfg = ResNetConfig(dtype=str(dtype)[6:])
    assert resnet.k5_blocks(cfg, 224, frames) == 44
    assert resnet.k5_blocks(cfg, 224, resnet.K5_MIN_FRAMES) == 44
    assert resnet.k5_blocks(cfg, 224, 1) == 0
    assert resnet.k5_blocks(cfg, 224, frames, autograd=True) == 0
    assert resnet.k5_blocks(cfg, 224, frames, device_type="cpu") == 0


def test_the_rule_leaves_cuda_core_shapes_to_the_module():
    """A width the tensor-core K5 is not built for (8 filters) stays on the
    module at any map size: the CUDA-core K5 loses to cuDNN everywhere."""
    assert fr.bottleneck_variant(torch.float32, 56, 56, 32, 8) == "simt"
    assert not resnet.takes_k5("cuda", False, True, torch.float32, 224, 56, 56, 32, 8)
    narrow = ResNetConfig(stage_sizes=(3, 8, 36, 3), num_filters=8, dtype="float32")
    assert resnet.k5_blocks(narrow, 224, 224) == 0
    assert resnet.k5_blocks(ResNetConfig(), 448, 56) == 46  # at 448^2 stage 4 is 14 wide


def _k5_args(g, n, h, w, c, f, dtype):
    x2 = torch.relu(torch.randn(n * h * w, c, generator=g)).to(dtype)
    mats = [torch.randn(*s, generator=g) / np.sqrt(s[-2]) for s in ((c, f), (9, f, f), (f, c))]
    aff = [(0.5 + torch.rand(k, generator=g), 0.1 * torch.randn(k, generator=g))
           for k in (f, f, c)]
    return (x2, mats[0].to(dtype), *aff[0], mats[1].to(dtype), *aff[1], mats[2].to(dtype),
            *aff[2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_registered_op_on_the_cpu_and_its_fake(dtype):
    g = torch.Generator().manual_seed(0)
    n, h, w = 2, 5, 3
    args = _k5_args(g, n, h, w, 16, 8, dtype)
    assert torch.equal(fr.bottleneck_op(*args, n, h, w),
                       fr.bottleneck_reference(*args, n, h, w))
    torch.library.opcheck(fr.bottleneck_op, (*args, n, h, w))
    with FakeTensorMode():
        fake = [torch.empty(t.shape, dtype=t.dtype, device="cuda") for t in args]
        out = fr.bottleneck_op(*fake, n, h, w)
        assert out.shape == args[0].shape and out.dtype == dtype and out.device.type == "cuda"


def test_the_wrapper_takes_the_op_without_autograd(monkeypatch):
    g = torch.Generator().manual_seed(1)
    args = _k5_args(g, 1, 4, 4, 16, 8, torch.float32)
    seen = []
    monkeypatch.setattr(fr, "bottleneck_op", lambda *a: seen.append(a) or a[0])
    with torch.no_grad():
        fr.fused_bottleneck(*args, 1, 4, 4)
    assert len(seen) == 1
    leaves = [t.clone().requires_grad_(True) for t in args]
    out = fr.fused_bottleneck(*leaves, 1, 4, 4)  # autograd: the plain version, not the op
    assert len(seen) == 1 and out.requires_grad


def module_path(visual: resnet.ResNet, x: torch.Tensor) -> torch.Tensor:
    """The forward before the route: every block its module."""
    x = x.to(visual.config.torch_dtype)
    x = F.relu(visual.bn1(visual.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage in range(visual.num_stages):
        for block in getattr(visual, f"layer{stage + 1}"):
            x = block(x)
    return x


def wide_visual(seed: int = 0, dtype: str = "float32", device=None, **kw):
    """A VisualFeatures at ResNet widths with random weights and frozen-BN
    statistics (its BN the identity would hide a mixed-up affine)."""
    visual = init_weights(resnet.VisualFeatures(ResNetConfig(**{**WIDE, "dtype": "float32",
                                                                **kw})),
                          torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for bn in visual.modules():
            if isinstance(bn, resnet.FrozenBatchNorm):
                k = bn.weight.shape[0]
                bn.weight.copy_(0.7 + 0.6 * torch.rand(k, generator=g))
                bn.bias.copy_(0.1 * torch.randn(k, generator=g))
                bn.running_mean.copy_(0.1 * torch.randn(k, generator=g))
                bn.running_var.copy_(0.7 + 0.6 * torch.rand(k, generator=g))
    if dtype == "float32" and device is None:
        return visual
    out = resnet.VisualFeatures(ResNetConfig(**{**WIDE, "dtype": dtype, **kw}), device=device)
    out.load_state_dict(visual.state_dict())
    return out


def _no_k5(*args, **kwargs):
    raise AssertionError("the CPU path reached K5")


@pytest.mark.parametrize("grad", [False, True])
def test_the_cpu_path_is_the_module_path_bit_for_bit(monkeypatch, grad):
    """On the CPU the rule routes nothing: the heads, the forward and the
    aspect classifier's features are the module loop's, bit for bit, with
    and without autograd."""
    monkeypatch.setattr(resnet, "fused_bottleneck", _no_k5)
    visual = wide_visual(2, grid_size=2)
    x = torch.randn(2, 1, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    nchw = x.flatten(0, 1).permute(0, 3, 1, 2)
    with torch.set_grad_enabled(grad):
        want = module_path(visual, nchw)
        assert torch.equal(visual(nchw), want)
        feat = want.permute(0, 2, 3, 1)
        assert torch.equal(visual.grid_features(x), feat.reshape(2, 1, 4, -1))
        assert torch.equal(visual.pooled_features(x), feat.mean(dim=(1, 2)).reshape(2, 1, -1))
        tagger = AspectClassifier(3, visual.config)
        tagger.feature_extractor.load_state_dict(visual.state_dict())
        assert torch.equal(tagger.features(x), want.mean(dim=(2, 3)).reshape(2, 1, -1))


@pytest.fixture
def route_on_the_cpu(monkeypatch):
    """The rule with its device test satisfied by CPU tensors, and a record
    of every K5 call of the shared loop: (rows, channels, n, h, w).  Tests
    that run fewer frames than `K5_MIN_FRAMES` lower it themselves."""
    rule, k5, calls = resnet.takes_k5, resnet.fused_bottleneck, []

    def takes_k5(device_type, *args):
        return rule("cuda", *args)

    def counted(x2, *args):
        calls.append((*x2.shape, *args[-3:]))
        return k5(x2, *args)

    monkeypatch.setattr(resnet, "takes_k5", takes_k5)
    monkeypatch.setattr(resnet, "fused_bottleneck", counted)
    return calls


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def test_the_loop_sends_the_blocks_the_rule_names(route_on_the_cpu, monkeypatch):
    """At 224^2 the identity blocks of stages 1-3 (56, 28, 14 wide) go to
    K5 on [n*h*w, C] rows and stage 4 (7 wide) stays on its modules; the
    features are the module path's to f32's summation order."""
    calls = route_on_the_cpu
    monkeypatch.setattr(resnet, "K5_MIN_FRAMES", 1)  # one frame of 224^2 on the CPU
    visual = wide_visual(4)
    x = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(5))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = visual(x)
        want = module_path(visual, x)
    assert calls == [(56 * 56, 256, 1, 56, 56), (28 * 28, 512, 1, 28, 28),
                     (14 * 14, 1024, 1, 14, 14)]
    assert len(calls) == resnet.k5_blocks(visual.config, 224, 1)
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) <= 1e-5


def test_the_loop_keeps_autograd_on_the_modules(route_on_the_cpu, monkeypatch):
    """With autograd on for the blocks (`--fine_tune_cnn`, the trainable-BN
    labelers, an input that requires grad) no block goes to K5 and the
    forward is the module path's, bit for bit; the same tensors without
    autograd go to K5."""
    calls = route_on_the_cpu
    monkeypatch.setattr(resnet, "K5_MIN_FRAMES", 2)
    visual = wide_visual(6, stage_sizes=(2, 1, 1, 1))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    x = x.contiguous(memory_format=torch.channels_last)
    assert torch.equal(visual(x), module_path(visual, x))  # parameters require grad
    resnet.trainable_batchnorm_(visual.requires_grad_(False))
    assert torch.equal(visual(x), module_path(visual, x))  # the BN tensors train
    visual.requires_grad_(False)
    assert torch.equal(visual(x.requires_grad_(True)), module_path(visual, x))
    assert calls == []
    with torch.no_grad():
        visual(x)
    assert len(calls) == 1 == resnet.k5_blocks(visual.config, 64, 2)


def test_few_frames_stay_on_the_modules(route_on_the_cpu):
    """Under `K5_MIN_FRAMES` frames (a tagger's single image) the loop runs
    the modules, bit for bit."""
    calls = route_on_the_cpu
    visual = wide_visual(13, stage_sizes=(2, 1, 1, 1))
    x = torch.randn(resnet.K5_MIN_FRAMES - 1, 3, 64, 64,
                    generator=torch.Generator().manual_seed(14))
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(visual(x), module_path(visual, x))
    assert calls == []


def test_the_fused_runner_is_a_caller_of_the_loop(route_on_the_cpu):
    """`fused_backbone.run_backbone` names the stages itself, whatever the
    rule says: `stages=()` is the module path, bit for bit."""
    calls = route_on_the_cpu
    visual = wide_visual(8, stage_sizes=(2, 2, 1, 1))
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        plain = fused_backbone.run_backbone(visual, x, stages=())
        assert calls == []
        assert torch.equal(plain, module_path(visual, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        fused_backbone.run_backbone(visual, x, stages=(2,))
    assert calls == [(8 * 8, 512, 1, 8, 8)]  # 8 wide: under the rule's map, named anyway


TEXT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=32, max_position_embeddings=64)
SMALL = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4, intermediate_size=32)


def small_program(device=None, dtype: str = "float32"):
    """A small FCMF on a ResNet at ResNet widths (stage 1 16 wide at 64^2,
    so its identity block is K5's) and an input batch of 16 reviews (32
    images, 64 ROI crops: over `K5_MIN_FRAMES`)."""
    cfg = config.FCMFConfig(model=config.ModelConfig(**SMALL, dtype=dtype),
                            text=config.TextEncoderConfig(**TEXT, dtype=dtype), num_imgs=2,
                            num_roi=2, num_patches=4, visual_feat_dim=2048, max_text_len=12,
                            box_heads=4)
    model = init_weights(FCMF(cfg), torch.Generator().manual_seed(10), 0.2).to(device)
    visual = wide_visual(11, dtype, device, stage_sizes=(2, 1, 1, 1), grid_size=2)
    g, b, a, l = torch.Generator().manual_seed(12), 16, len(config.ASPECTS), cfg.max_text_len
    batch = {
        "images": torch.randn(b, 2, 64, 64, 3, generator=g),
        "roi_images": torch.randn(b, 2, 2, 64, 64, 3, generator=g),
        "roi_coors": torch.rand(b, 2, 2, 4, generator=g),
        "input_ids": torch.randint(2, 64, (b, a, l), generator=g, dtype=torch.int32),
        "token_type_ids": torch.zeros(b, a, l, dtype=torch.int32),
        "attention_mask": (torch.arange(l) < torch.randint(3, l + 1, (b, a, 1), generator=g)
                           ).to(torch.int32),
        "added_mask": torch.ones(b, a, l + 4, dtype=torch.int32),
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    return model, visual, batch


def export_serving(model, visual, batch):
    """-> (the exported serving forward, the live eval step's logits)."""
    from macsa_tpu_torch.inference.export import INPUTS

    program = ServingForward(model, visual).eval().requires_grad_(False)
    inputs = tuple(batch[k] for k in INPUTS)
    with torch.no_grad():
        exported = torch.export.export(program, inputs)
    _, live = make_finetune_eval_step(model, visual)(batch)
    return exported, inputs, live


def test_the_exported_program_holds_the_op(route_on_the_cpu):
    """The serving forward exported through the loop holds K5's registered
    op, one call a pass (images, ROI crops), and equals the live step."""
    calls = route_on_the_cpu
    exported, inputs, live = export_serving(*small_program())
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count(K5_OP) == 2
    assert len(calls) == 4  # traced once, run once live
    with torch.no_grad():
        got = exported.module()(*inputs)
    torch.testing.assert_close(got, live, rtol=0, atol=1e-6)
