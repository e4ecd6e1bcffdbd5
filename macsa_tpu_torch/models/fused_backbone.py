"""ResNet backbone runner with the identity bottlenecks of chosen stages
through K5.

Counterpart of the runner half of `tools_dev/fused_resnet_experiment.py`
(`run_backbone`, `extract_features`).  The loop is the port's own
`ResNet.trunk`, which the module's forward runs with its rule
(`models/resnet.takes_k5`); here the caller names the stages (1-indexed)
whose stride-1 identity blocks run `fused_bottleneck`, on any device and
under autograd too, and every other block runs its module: `stages=()`
is the module path throughout.  The JAX experiment's VMEM feasibility
test (`block_images`) is TPU tiling: K5 takes every ResNet-152 stage
shape, so no stage falls back here.

Gradients flow to the module's parameters (and to its BN statistics, if
they are made to require grad) through both kinds of block.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from macsa_tpu_torch.models.resnet import ResNet


def run_backbone(visual: ResNet, x: torch.Tensor, stages: Sequence[int] = (3,)) -> torch.Tensor:
    """[N, H, W, 3] normalized float -> NHWC [N, H/32, W/32, 2048]: the
    module's forward, with the identity blocks of `stages` through K5."""
    return visual.trunk(x.permute(0, 3, 1, 2), k5_stages=stages).permute(0, 2, 3, 1)


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
