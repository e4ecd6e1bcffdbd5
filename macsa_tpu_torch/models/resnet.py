"""ResNet-152 visual feature extractor in PyTorch (frozen BatchNorm).

Counterpart of `macsa_tpu/models/resnet.py` (reference:
fcmf_framework/resnet_utils.py): `grid_features` returns the 7x7x2048
attention grid and `pooled_features` the spatially averaged 2048-d vector.

* Key names are torchvision's (`conv1`, `bn1.running_mean`,
  `layerN.i.downsample.{0,1}`), so `macsa_tpu.models.resnet.
  import_torchvision_resnet` consumes the state dict with nothing left over.
* BatchNorm is frozen: the eval-mode affine of its four tensors, computed
  in f32, then cast to the conv dtype, in training too (the JAX model has
  no train mode for it).  The four tensors are buffers while the CNN is
  frozen; `trainable_batchnorm_` makes them parameters, all four as in
  JAX, where `scale`, `bias`, `mean` and `var` are params (`--fine_tune_cnn`,
  the offline aspect labelers).
* Public functions take the JAX layout `[..., H, W, 3]`.  Inside, the
  tensors are NCHW in `torch.channels_last` memory format: the same bytes
  as NHWC, so the permutes in and out copy nothing.  The convolutions go
  to cuDNN (on the CPU, oneDNN) through `F.conv2d`.
* The stride-1 identity bottlenecks of a stage run as one K5 launch each
  (`ops/fused_resnet.fused_bottleneck`) where `takes_k5` says K5 beats
  the module: on a CUDA tensor, with autograd off for the stage, at a
  tensor-core shape, a feature map at least `K5_MIN_MAP` wide (stages 1-3
  at 224^2) and at least `K5_MIN_FRAMES` frames.  Such a stage keeps its
  activation as the [N*h*w, C] rows of the channels-last tensor from
  block to block.  Everything else (the stem, every block 0, stage 4, a
  tagger's single image, any block under autograd, the CPU) runs the
  modules.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.ops.fused_resnet import bottleneck_variant, fused_bottleneck

# ImageNet normalization used by every dataset path (vimacsa_dataset.py:25-30)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm as a per-channel affine with imported stats."""

    TENSORS = ("weight", "bias", "running_mean", "running_var")

    def __init__(self, features: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.register_buffer("weight", torch.ones(features, device=device))
        self.register_buffer("bias", torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def make_trainable_(self) -> None:
        """Turn the four buffers into parameters, under the same names (a
        state dict does not change).  Their gradients flow through
        `affine`: the statistics train too, as in JAX."""
        for name in self.TENSORS:
            if name in self._buffers:
                value = self._buffers.pop(name)
                self.register_parameter(name, nn.Parameter(value))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The f32 per-channel (mul, add) of the frozen statistics."""
        inv = torch.rsqrt(self.running_var + self.eps)
        return self.weight * inv, self.bias - self.running_mean * self.weight * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul, add = (t.to(self.compute_dtype) for t in self.affine())
        return x * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1)


def trainable_batchnorm_(module: nn.Module) -> nn.Module:
    """Make every FrozenBatchNorm under `module` trainable (in place)."""
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.make_trainable_()
    return module


class Conv2d(nn.Module):
    """Bias-free square convolution with an f32 weight kept channels-last,
    computed in `compute_dtype`; padding is kernel // 2 as in the JAX model."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.stride, self.padding = stride, kernel // 2
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel, kernel, device=device
        ).contiguous(memory_format=torch.channels_last))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        # LeCun normal over the fan-in, flax's default conv init
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(self.compute_dtype), stride=self.stride,
                        padding=self.padding)


class Bottleneck(nn.Module):
    """torchvision-style bottleneck (stride on the 3x3 conv)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 downsample: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        dt, out_ch = compute_dtype, features * 4
        self.conv1 = Conv2d(in_ch, features, 1, compute_dtype=dt, device=device)
        self.bn1 = FrozenBatchNorm(features, compute_dtype=dt, device=device)
        self.conv2 = Conv2d(features, features, 3, stride, compute_dtype=dt, device=device)
        self.bn2 = FrozenBatchNorm(features, compute_dtype=dt, device=device)
        self.conv3 = Conv2d(features, out_ch, 1, compute_dtype=dt, device=device)
        self.bn3 = FrozenBatchNorm(out_ch, compute_dtype=dt, device=device)
        self.downsample = (nn.Sequential(
            Conv2d(in_ch, out_ch, 1, stride, compute_dtype=dt, device=device),
            FrozenBatchNorm(out_ch, compute_dtype=dt, device=device))
            if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


# Where K5 beats the Bottleneck module on an H100 (`chip_smoke.py` phase k5,
# device time; PERF.md section 6): over the 56 and 224 frames of a serving
# batch's two passes at feature maps 56, 28 and 14 wide, in both dtypes; not
# at 7 wide, nor over 16 frames or fewer at 14 wide in f32, where its three
# blocks a frame leave most of the card idle.
K5_MIN_MAP = 14
K5_MIN_FRAMES = 28


def takes_k5(device_type: str, autograd: bool, identity: bool, dtype: torch.dtype,
             n: int, h: int, w: int, c: int, f: int) -> bool:
    """Whether a bottleneck over [n, c, h, w] of width f runs as K5 rather
    than as its module: a stride-1 identity block, on a CUDA tensor, with
    autograd off for it, at a shape K5 takes on the tensor cores, a feature
    map no narrower than `K5_MIN_MAP` and no fewer than `K5_MIN_FRAMES`
    frames."""
    return (identity and device_type == "cuda" and not autograd and n >= K5_MIN_FRAMES
            and min(h, w) >= K5_MIN_MAP and bottleneck_variant(dtype, h, w, c, f) != "simt")


def k5_blocks(config: ResNetConfig, image_size: int, frames: int, device_type: str = "cuda",
              autograd: bool = False) -> int:
    """Identity blocks of one forward over `frames` frames of image_size^2
    that `takes_k5` sends to K5 (44 of ResNet-152's 46 at 224^2 from
    `K5_MIN_FRAMES` frames up: stages 1-3)."""
    side = (image_size - 1) // 2 + 1  # the stem's stride-2 conv
    side = (side - 1) // 2 + 1        # the max-pool
    count = 0
    for stage, num_blocks in enumerate(config.stage_sizes):
        if stage > 0:
            side = (side - 1) // 2 + 1  # block 0's stride-2 3x3 conv
        f = config.num_filters * 2 ** stage
        if takes_k5(device_type, autograd, True, config.torch_dtype, frames, side, side, 4 * f,
                    f):
            count += num_blocks - 1
    return count


def block_args(block: Bottleneck) -> Tuple[torch.Tensor, ...]:
    """A bottleneck's weights and f32 BN affines as K5 takes them:
    (w1 [C, F], mul1, add1, w2 [9, F, F], mul2, add2, w3 [F, C], mul3, add3),
    with w2[dy*3 + dx] = conv2.weight[:, :, dy, dx].T."""
    f = block.conv1.weight.shape[0]
    w1 = block.conv1.weight[:, :, 0, 0].t()
    w2 = block.conv2.weight.permute(2, 3, 1, 0).reshape(9, f, f)
    w3 = block.conv3.weight[:, :, 0, 0].t()
    return (w1, *block.bn1.affine(), w2, *block.bn2.affine(), w3, *block.bn3.affine())


class ResNet(nn.Module):
    """torchvision-compatible ResNet backbone up to layer4 (no fc)."""

    def __init__(self, config: ResNetConfig = ResNetConfig(), device=None):
        super().__init__()
        self.config = config
        dt, nf = config.torch_dtype, config.num_filters
        self.conv1 = Conv2d(3, nf, 7, 2, compute_dtype=dt, device=device)
        self.bn1 = FrozenBatchNorm(nf, compute_dtype=dt, device=device)
        in_ch = nf
        for stage, num_blocks in enumerate(config.stage_sizes):
            features = nf * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(in_ch, features, stride, downsample=block == 0,
                                         compute_dtype=dt, device=device))
                in_ch = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(config.stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, H, W] normalized (channels-last) -> [N, C, H/32, W/32]."""
        return self.trunk(x)

    def trunk(self, x: torch.Tensor, k5_stages: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The forward, with the identity blocks of a stage through K5 where
        `takes_k5` says so, or, given `k5_stages`, in exactly the listed
        stages (1-indexed; `models/fused_backbone.run_backbone`)."""
        x = x.to(self.config.torch_dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            blocks = getattr(self, f"layer{stage + 1}")
            x = blocks[0](x)
            identity = list(blocks)[1:]
            if not identity:
                continue
            n, c, h, w = x.shape
            if k5_stages is None:
                fused = takes_k5(x.device.type, _autograd(x, identity), True, x.dtype, n, h, w,
                                 c, identity[0].conv1.weight.shape[0])
            else:
                fused = stage + 1 in k5_stages
            if not fused:
                for block in identity:
                    x = block(x)
                continue
            rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)  # a view of channels-last
            for block in identity:
                rows = fused_bottleneck(rows, *block_args(block), n, h, w)
            x = rows.reshape(n, h, w, c).permute(0, 3, 1, 2)
        return x


def _autograd(x: torch.Tensor, blocks: Sequence[nn.Module]) -> bool:
    """Whether autograd records `blocks` over x: grad mode on, and x or a
    parameter or BN tensor of a block requires grad."""
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(t.requires_grad for b in blocks
                                  for t in (*b.parameters(), *b.buffers()))


class VisualFeatures(ResNet):
    """Grid (7x7x2048) and pooled (2048) feature heads over the ResNet.

    Folds any leading sample/image axes into the batch before the conv
    stack.  It IS the backbone (not a wrapper around one), so its state
    dict carries torchvision's top-level names."""

    def _run(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """[..., H, W, 3] -> (NHWC features [N, h, w, C], leading shape)."""
        lead = tuple(images.shape[:-3])
        flat = images.reshape((-1,) + tuple(images.shape[-3:]))
        feat = self(flat.permute(0, 3, 1, 2))  # channels-last NCHW view
        return feat.permute(0, 2, 3, 1), lead

    def grid_features(self, images: torch.Tensor) -> torch.Tensor:
        """[..., H, W, 3] -> [..., grid*grid, C] (adaptive average pool,
        resnet_utils.py:24; the identity at 224 -> 7x7)."""
        att = self.config.grid_size
        feat, lead = self._run(images)
        n, h, w, c = feat.shape
        if (h, w) != (att, att):
            if h % att or w % att:
                raise ValueError(f"feature map {h}x{w} does not pool to {att}x{att}")
            feat = feat.reshape(n, att, h // att, att, w // att, c).mean(dim=(2, 4))
        return feat.reshape(lead + (att * att, c))

    def pooled_features(self, images: torch.Tensor) -> torch.Tensor:
        """[..., H, W, 3] -> [..., C] spatial mean (resnet_utils.py:50)."""
        feat, lead = self._run(images)
        return feat.mean(dim=(1, 2)).reshape(lead + (feat.shape[-1],))
