"""Serving bundle: the FCMF inference forward exported with `torch.export`.

Counterpart of `macsa_tpu/inference/export.py`, whose bundle is StableHLO
from `jax.export`.  Here `torch.export.export` traces the 6-aspect batched
serving forward (`train/steps.fcmf_forward_all_aspects` without dropout, in
eval mode: the ResNet-152 over the images and ROI crops, then the FCMF
classifier) once, at fixed serving shapes, on the device it will serve on,
and `torch.export.save` writes the program with its weights.  A server then
needs torch, the bundle and `import macsa_tpu_torch.ops` (which registers
the kernels' ops), none of the model-building code.

Bundle layout (a directory):
    model.pt2     -- `torch.export.save` of the program, weights inside;
                     inputs (images, roi_images, roi_coors, input_ids,
                     token_type_ids, attention_mask, added_mask) -> logits
                     [B, A, 4]
    bundle.json   -- serving shapes, config dataclasses, aspect/polarity
                     vocab, the device it was exported for

What differs from the JAX module:
* The JAX export lowers with `fused_attention` off: a Mosaic `custom_call`
  would pin the StableHLO to one libtpu build.  Here the text encoder's
  attention stays kernel K1, as the registered op
  `torch.ops.macsa_tpu_torch.fused_self_attention` (and K3, the box
  attention, as `torch.ops.macsa_tpu_torch.box_attention` when the config
  turns `use_pallas_box_attention` on): the kernels build from the repo's
  sources, and each op's CPU implementation is the plain version, so a CPU
  bundle works too.  `bundle.json`'s `config.text.fused_attention` records
  what was exported.
* `--platforms` is `--device` (default `cuda`): constants made on a device
  inside the forward are part of the program, so a bundle serves on the
  device it was exported for and no other.

Usage:
    python -m macsa_tpu_torch.inference.export --checkpoint out_ft/ \\
        --output_dir bundle/ --batch_size 8 [--device cpu]
then serve with `load_bundle("bundle/").predict(batch)`, or the inference
CLI's `--bundle` flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from macsa_tpu_torch.config import (ASPECTS, POLARITIES, FCMFConfig, ModelConfig,
                                    ResNetConfig)

_MODEL_FILE = "model.pt2"
_META_FILE = "bundle.json"
INPUTS = ("images", "roi_images", "roi_coors", "input_ids", "token_type_ids",
          "attention_mask", "added_mask")


def _serving_config(cfg: FCMFConfig, dtype: str) -> FCMFConfig:
    """The exported configuration: the compute dtype, and K1 on."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype=dtype, fused_attention=True),
        text=dataclasses.replace(cfg.text, dtype=dtype, fused_attention=True))


def _batch_spec(cfg: FCMFConfig, b: int, image_size: int) -> Dict[str, list]:
    """[shape, dtype] of each input (`_abstract_batch` of the JAX module)."""
    a, l, s = len(ASPECTS), cfg.max_text_len, image_size
    f32, i32 = "float32", "int32"
    return {
        "images": [[b, cfg.num_imgs, s, s, 3], f32],
        "roi_images": [[b, cfg.num_imgs, cfg.num_roi, s, s, 3], f32],
        "roi_coors": [[b, cfg.num_imgs, cfg.num_roi, 4], f32],
        "input_ids": [[b, a, l], i32],
        "token_type_ids": [[b, a, l], i32],
        "attention_mask": [[b, a, l], i32],
        "added_mask": [[b, a, l + cfg.num_patches], i32],
    }


class ServingForward(nn.Module):
    """The program a bundle holds: seven tensors -> logits [B, A, labels]
    (eval mode: no dropout; exported without autograd)."""

    def __init__(self, model: nn.Module, visual: nn.Module):
        super().__init__()
        self.model, self.visual = model, visual

    def forward(self, images, roi_images, roi_coors, input_ids, token_type_ids,
                attention_mask, added_mask):
        from macsa_tpu_torch.train.steps import fcmf_forward_all_aspects
        batch = dict(zip(INPUTS, (images, roi_images, roi_coors, input_ids, token_type_ids,
                                  attention_mask, added_mask)))
        return fcmf_forward_all_aspects(self.model, self.visual, batch)


def export_bundle(checkpoint: str, output_dir: str, batch_size: int = 8,
                  pretrained_hf_model: Optional[str] = None,
                  resnet_weights: Optional[str] = None,
                  resnet_stages=(3, 8, 36, 3), num_imgs: int = 7,
                  num_rois: int = 4, max_seq_length: int = 170,
                  cross_mask_mode: str = "causal_quirk",
                  device: str = "cuda", logger=None,
                  fcmf_config: Optional[FCMFConfig] = None,
                  resnet_config: Optional[ResNetConfig] = None,
                  image_size: int = 224, dtype: str = "float32") -> str:
    """Export the serving forward at serving shapes and write a bundle.

    `checkpoint` accepts what the inference CLI serves: a driver's output
    directory (its `best.pt`, else `last.pt`), a checkpoint file of this
    package (with the ResNet it carries), or a reference `.pth` (legacy key
    names included; the ResNet then comes from `resnet_weights` or a seeded
    init).  `fcmf_config` / `resnet_config` replace the configs built from
    the other arguments (tests; other architectures); K1 is on and the
    FCMF's compute dtype is `dtype` either way (the ResNet's is
    `resnet_config`'s where one is given, as in JAX): "float32" gives the live eval
    step's logits, "bfloat16" is the fast serving point.
    """
    from macsa_tpu_torch.inference.cli import load_served_model
    from macsa_tpu_torch.train import common

    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"serving dtype {dtype!r}: float32|bfloat16")
    dev = common.resolve_device(device)
    if fcmf_config is None:
        fcmf_config = FCMFConfig(model=ModelConfig(),
                                 text=common.build_text_config(pretrained_hf_model, dtype),
                                 num_imgs=num_imgs, num_roi=num_rois,
                                 max_text_len=max_seq_length,
                                 decoder_cross_mask_mode=cross_mask_mode)
    cfg = _serving_config(fcmf_config, dtype)
    rcfg = resnet_config if resnet_config is not None else ResNetConfig(
        dtype=dtype, stage_sizes=tuple(resnet_stages))
    model, visual = load_served_model(checkpoint, cfg, rcfg, dev, resnet_weights, logger)
    program = ServingForward(model, visual).eval().requires_grad_(False)

    spec = _batch_spec(cfg, batch_size, image_size)
    example = tuple(torch.zeros(shape, dtype=getattr(torch, dt), device=dev)
                    for shape, dt in (spec[k] for k in INPUTS))
    with torch.no_grad():  # traced without autograd: K1 and K3 are their registered ops
        exported = torch.export.export(program, example)

    os.makedirs(output_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(output_dir, _MODEL_FILE))
    meta = {
        "batch_size": batch_size,
        "image_size": image_size,
        "aspects": list(ASPECTS),
        "polarities": list(POLARITIES),
        "device": dev.type,
        "config": dataclasses.asdict(cfg),
        "resnet_config": dataclasses.asdict(rcfg),
        "batch_spec": spec,
    }
    with open(os.path.join(output_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return output_dir


class ServingModel:
    """A loaded bundle: the exported program on its device.

    `predict(batch)` pads a partial final batch to the exported batch size
    by repeating its last row (one exported shape serves any record count)
    and returns logits [n, A, num_labels] as numpy."""

    def __init__(self, program, meta: Dict[str, Any], device: torch.device):
        self._call = program
        self.meta = meta
        self.device = device
        self.batch_size = meta["batch_size"]
        self.batch_spec = meta["batch_spec"]

    def predict(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        n = int(np.shape(batch[INPUTS[0]])[0])
        bs = self.batch_size
        if n > bs:
            raise ValueError(f"batch of {n} > exported batch size {bs}; "
                             "split into chunks")
        args = []
        for k in INPUTS:
            shape, dtype = self.batch_spec[k]
            x = np.asarray(batch[k], dtype=dtype)
            if list(x.shape)[1:] != shape[1:]:
                raise ValueError(f"{k}: got {x.shape}, bundle expects "
                                 f"[{bs}] + {shape[1:]}")
            if n < bs:
                x = np.concatenate([x, np.repeat(x[-1:], bs - n, axis=0)], axis=0)
            args.append(torch.from_numpy(x).to(self.device))
        with torch.inference_mode():
            logits = self._call(*args)
        return logits.cpu().numpy()[:n]

    def predict_labels(self, batch: Dict[str, np.ndarray]):
        """-> list (per record) of {aspect: polarity}."""
        preds = self.predict(batch).argmax(-1)
        pol, asp = self.meta["polarities"], self.meta["aspects"]
        return [{a: pol[p[i]] for i, a in enumerate(asp)} for p in preds]


def load_bundle(path: str, device=None) -> ServingModel:
    """The bundle under `path`, on the device it was exported for.  A
    `device` of another type raises: the program's constants live there."""
    import macsa_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)

    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    exported_for = torch.device(meta["device"])
    if device is not None and torch.device(device).type != exported_for.type:
        raise ValueError(f"bundle {path} was exported for {meta['device']}, not {device}: "
                         f"export it again with --device {torch.device(device).type}")
    if exported_for.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"bundle {path} was exported for cuda and no CUDA device is "
                           "available")
    program = torch.export.load(os.path.join(path, _MODEL_FILE)).module()
    return ServingModel(program, meta, exported_for)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", type=str, required=True,
                   help="driver output dir, checkpoint file of this package, or reference "
                        "torch .pth")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--pretrained_hf_model", type=str, default=None,
                   help="tokenizer/config dir (for text-encoder dims)")
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--resnet_stages", type=str, default="3,8,36,3")
    p.add_argument("--num_imgs", type=int, default=7)
    p.add_argument("--num_rois", type=int, default=4)
    p.add_argument("--max_seq_length", type=int, default=170)
    p.add_argument("--cross_mask_mode", type=str, default="causal_quirk",
                   choices=("causal_quirk", "padding"))
    p.add_argument("--device", type=str, default="cuda",
                   help="device the bundle is exported for and serves on.  The default "
                        "raises without a CUDA device; say cpu for a CPU bundle")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="serving compute dtype: float32 gives the live eval step's "
                        "logits; bfloat16 is the fast serving point")
    return p


def main(argv=None) -> str:
    from macsa_tpu_torch.utils.logging import setup_logging
    args = build_argparser().parse_args(argv)
    logger = setup_logging(None)
    out = export_bundle(
        checkpoint=args.checkpoint, output_dir=args.output_dir,
        batch_size=args.batch_size,
        pretrained_hf_model=args.pretrained_hf_model,
        resnet_weights=args.resnet_weights,
        resnet_stages=tuple(int(s) for s in args.resnet_stages.split(",")),
        num_imgs=args.num_imgs, num_rois=args.num_rois,
        max_seq_length=args.max_seq_length,
        cross_mask_mode=args.cross_mask_mode,
        device=args.device, dtype=args.dtype, logger=logger)
    logger.info(f"bundle written to {out}")
    print(json.dumps({"bundle": out}))
    return out


if __name__ == "__main__":
    main()
