"""The serving half of `macsa_tpu/train/steps.py`: the 6-aspect FCMF forward.

The reference loops over the six aspects and runs 7 + 7xR separate
ResNet-152 forwards per step (run_multimodal_fcmf.py:427-489).  As in the
JAX package, the aspect views are folded into one B*A batch through one
forward, and all images / all ROI crops go through the ResNet as one batch
each, normalized on the device first (kernel K2).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.ops.image_prep import device_normalize

Batch = Dict[str, torch.Tensor]


def extract_visual(visual: VisualFeatures, images: torch.Tensor,
                   roi_images: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, I, ...], roi_images [B, I, R, ...] -> (grid [B, I, 49, 2048],
    roi [B, I, R, 2048]).  Pixels arrive as packed int32 frames, raw uint8
    or host-normalized floats (`device_normalize`)."""
    conv_dtype = visual.config.torch_dtype
    grid = visual.grid_features(device_normalize(images, conv_dtype))
    roi = visual.pooled_features(device_normalize(roi_images, conv_dtype))
    return grid.to(out_dtype), roi.to(out_dtype)


def _fold_aspects(batch: Batch) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """[B, A, ...] text views -> [B*A, ...]; returns (folded, B, A)."""
    b, a = batch["input_ids"].shape[:2]
    return ({k: batch[k].reshape((b * a,) + tuple(batch[k].shape[2:]))
             for k in ("input_ids", "token_type_ids", "attention_mask", "added_mask")
             if k in batch}, b, a)


def _tile_visual(x: torch.Tensor, a: int) -> torch.Tensor:
    """[B, ...] -> [B*A, ...] matching the aspect fold order (b*A + a)."""
    return x.repeat_interleave(a, dim=0)


def fcmf_forward_all_aspects(model: FCMF, visual: VisualFeatures,
                             batch: Batch) -> torch.Tensor:
    """Full FCMF forward over all aspect views -> logits [B, A, num_labels]."""
    grid, roi = extract_visual(visual, batch["images"], batch["roi_images"],
                               out_dtype=model.config.model.torch_dtype)
    text, b, a = _fold_aspects(batch)
    logits = model(text["input_ids"], _tile_visual(grid, a), _tile_visual(roi, a),
                   _tile_visual(batch["roi_coors"], a), text.get("token_type_ids"),
                   text["attention_mask"], text["added_mask"])
    return logits.reshape(b, a, -1)


def make_finetune_eval_step(model: FCMF, visual: VisualFeatures) -> Callable:
    """-> step(batch) = (preds [B, A], logits [B, A, num_labels]), run
    under `torch.inference_mode()`."""

    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            logits = fcmf_forward_all_aspects(model, visual, batch)
            return logits.argmax(-1), logits

    return step
