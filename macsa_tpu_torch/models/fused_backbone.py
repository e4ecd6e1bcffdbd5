"""ResNet backbone runner whose identity bottlenecks run through K5.

Counterpart of the runner half of `tools_dev/fused_resnet_experiment.py`
(`run_backbone`, `extract_features`, `_block_args`, `_affine`).  It runs
the port's own `VisualFeatures` module, with its parameters and frozen
statistics: the stem and max-pool, every strided downsampling block 0,
and every block of a stage not in `stages` run the module's `Bottleneck`s
(the math of `_bottleneck_xla_block`).  The stride-1 identity blocks of
the stages in `stages` (1-indexed) run `fused_bottleneck`, one launch
each on a CUDA tensor, on the [N*h*w, C] rows of the channels-last
activation, which stay rows from block to block.  The JAX experiment's
VMEM feasibility test (`block_images`) is TPU tiling: K5 takes every
ResNet-152 stage shape, so no stage falls back here.

Gradients flow to the module's parameters (and to its BN statistics, if
they are made to require grad) through both kinds of block.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from macsa_tpu_torch.models.resnet import Bottleneck, ResNet
from macsa_tpu_torch.ops.fused_resnet import fused_bottleneck


def block_args(block: Bottleneck) -> Tuple[torch.Tensor, ...]:
    """A bottleneck's weights and f32 BN affines as K5 takes them:
    (w1 [C, F], mul1, add1, w2 [9, F, F], mul2, add2, w3 [F, C], mul3, add3),
    with w2[dy*3 + dx] = conv2.weight[:, :, dy, dx].T."""
    f = block.conv1.weight.shape[0]
    w1 = block.conv1.weight[:, :, 0, 0].t()
    w2 = block.conv2.weight.permute(2, 3, 1, 0).reshape(9, f, f)
    w3 = block.conv3.weight[:, :, 0, 0].t()
    return (w1, *block.bn1.affine(), w2, *block.bn2.affine(), w3, *block.bn3.affine())


def run_backbone(visual: ResNet, x: torch.Tensor, stages: Sequence[int] = (3,)) -> torch.Tensor:
    """[N, H, W, 3] normalized float -> NHWC [N, H/32, W/32, 2048]: the
    module's forward, with the identity blocks of `stages` through K5."""
    x = x.to(visual.config.torch_dtype).permute(0, 3, 1, 2)  # channels-last NCHW view
    x = F.relu(visual.bn1(visual.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for stage in range(visual.num_stages):
        blocks = getattr(visual, f"layer{stage + 1}")
        x = blocks[0](x)
        if stage + 1 not in stages:
            for block in blocks[1:]:
                x = block(x)
            continue
        n, c, h, w = x.shape
        rows = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
        for block in blocks[1:]:
            rows = fused_bottleneck(rows, *block_args(block), n, h, w)
        x = rows.reshape(n, h, w, c).permute(0, 3, 1, 2)
    return x.permute(0, 2, 3, 1)


def extract_features(visual: ResNet, images: torch.Tensor, roi_images: torch.Tensor,
                     stages: Sequence[int] = (3,)) -> Tuple[torch.Tensor, torch.Tensor]:
    """One trunk pass over the images and ROI crops together.

    images [B, I, H, W, 3], roi_images [B, I, R, H, W, 3] (normalized) ->
    grid [B, I, att*att, C], roi [B, I, R, C], the outputs of
    `VisualFeatures.grid_features` and `pooled_features`."""
    b, i = images.shape[:2]
    r = roi_images.shape[2]
    hw = tuple(images.shape[-3:])
    flat = torch.cat([images.reshape((-1,) + hw), roi_images.reshape((-1,) + hw)])
    feat = run_backbone(visual, flat, stages)
    n, h, w, c = feat.shape
    att = visual.config.grid_size
    grid = feat[:b * i]
    if (h, w) != (att, att):  # adaptive mean pool (224 -> 7x7 is the identity)
        if h % att or w % att:
            raise ValueError(f"feature map {h}x{w} does not pool to {att}x{att}")
        grid = grid.reshape(b * i, att, h // att, att, w // att, c).mean(dim=(2, 4))
    roi = feat[b * i:].mean(dim=(1, 2))
    return grid.reshape(b, i, att * att, c), roi.reshape(b, i, r, c)
