"""Single-sample and batch inference CLI, on PyTorch.

Counterpart of `macsa_tpu/inference/cli.py` (reference entry point:
inference.py:332-440): normalize the text, predict image/ROI aspect tags,
build the auxiliary tag sentence, construct the visual features, then
classify all 6 aspects -> {aspect: polarity}, printed and written to a file.

    python -m macsa_tpu_torch.inference.cli --checkpoint out/ \\
        --pretrained_hf_model tok/ --text "..." --image_list a.png b.png
    python -m macsa_tpu_torch.inference.cli --checkpoint out/ \\
        --pretrained_hf_model tok/ --input_json records.json --batch_size 8

What differs from the JAX CLI:
* `--device` (default `cuda`): without a CUDA device the default raises;
  only `--device cpu` runs on the CPU.  The two aspect classifiers run on
  the same device.
* `--checkpoint` takes a checkpoint file of this package, a directory
  holding `best.pt` (else `last.pt`), or a reference `.pth`.  A checkpoint
  of this package carries the ResNet it was trained with (a
  `--fine_tune_cnn` run's trained one), and that ResNet serves, as the JAX
  CLI serves an orbax state's `visual_params`; with a reference `.pth` the
  ResNet comes from `--resnet_weights` or a seeded random init.
* `--image_model_checkpoint` / `--roi_model_checkpoint` take the files the
  port's labelers write (`tools/classifier_io.py`), or reference `.pth`s.
* The forward computes in f32, as the JAX CLI does (`dtype="float32"`): K1
  runs its "tf32x3" variant, three TF32 products on the tensor cores for
  each f32 product, within f32's tolerances.  TF32 is off in cuBLAS and
  cuDNN for the process, so f32 means f32.  The pixels are host-normalized floats, which
  `device_normalize` only casts: K2 does not run here.
* `--fused_attention auto|on|off` as in the drivers (`auto`: the kernel on
  the card).  `--scan_layers` is accepted and ignored (it picks a layout
  of the JAX program).
* `--bundle` serves a `torch.export` bundle (`inference/export.py`) in
  place of the JAX CLI's StableHLO one: exactly one of `--checkpoint` and
  `--bundle`; the shapes come from `bundle.json`, `--batch_size` is
  clamped to the bundle's, and the bundle must have been exported for
  `--device`.

Batch serving mode: `--input_json records.json` holding a list of
`{"text": ..., "image_list": [...]}` records classifies them in chunks of
`--batch_size` (the last chunk padded to the same shape), one forward a
chunk, and writes JSONL predictions.  Its summary line gives
`records_per_s` and the shares of that time spent preparing records on
the host and in the forward.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from macsa_tpu_torch.config import ASPECTS, POLARITIES, FCMFConfig, ModelConfig, ResNetConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file of this package, a directory holding best.pt "
                        "(else last.pt), or a reference torch .pth file")
    p.add_argument("--bundle", type=str, default=None,
                   help="serving bundle dir (macsa_tpu_torch.inference.export); replaces "
                        "--checkpoint and the architecture flags: shapes and config come "
                        "from bundle.json")
    p.add_argument("--pretrained_hf_model", type=str, required=True)
    p.add_argument("--image_model_checkpoint", type=str, default=None,
                   help="image aspect classifier (tools/classifier_io.py file or torch .pth)")
    p.add_argument("--roi_model_checkpoint", type=str, default=None)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--roi_csv", type=str, default=None,
                   help="precomputed roi_data.csv for the detector")
    p.add_argument("--yolo_weights", type=str, default=None)
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--image_list", type=str, nargs="*", default=[])
    p.add_argument("--input_json", type=str, default=None,
                   help="batch mode: JSON list of {text, image_list} records; "
                        "predictions written as JSONL to --output_file")
    p.add_argument("--batch_size", type=int, default=8,
                   help="records per forward in --input_json mode")
    p.add_argument("--num_imgs", type=int, default=7)
    p.add_argument("--num_rois", type=int, default=4)
    p.add_argument("--eps", type=float, default=30.0)
    p.add_argument("--max_seq_length", type=int, default=170)
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--cross_mask_mode", type=str, default="causal_quirk")
    p.add_argument("--resnet_stages", type=str, default="3,8,36,3",
                   help="ResNet stage sizes; must match the training setup")
    p.add_argument("--fused_attention", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="hand-written attention kernel (the drivers' flag); auto = on "
                        "for a CUDA device")
    p.add_argument("--scan_layers", type=str, default="on", choices=("on", "off"),
                   help="accepted for the JAX CLI's command lines and ignored: the "
                        "text encoder's layers always run unrolled here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run.  The default raises without a CUDA "
                        "device; say cpu to run on the CPU")
    return p


def load_served_model(checkpoint: str, cfg: FCMFConfig, rcfg: ResNetConfig, device,
                      resnet_weights: Optional[str] = None, logger=None):
    """(FCMF, VisualFeatures) on `device` with the weights `checkpoint`
    names (a checkpoint file of this package, a directory holding `best.pt`
    else `last.pt`, or a reference `.pth`): the classifier and the ResNet
    it was trained with (inference.py:57-139), else a seeded ResNet with
    `resnet_weights` imported."""
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.layers import init_weights
    from macsa_tpu_torch.models.resnet import VisualFeatures
    from macsa_tpu_torch.train import common
    from macsa_tpu_torch.train.checkpoints import load_state_dicts, resolve_iaog_checkpoint

    path = resolve_iaog_checkpoint(checkpoint)
    if path is None:
        raise FileNotFoundError(f"--checkpoint {checkpoint}: no checkpoint file there")
    model_sd, visual_sd = load_state_dicts(path)
    model = FCMF(cfg, device=device)
    model.load_state_dict(model_sd, strict=True)
    visual = VisualFeatures(rcfg, device=device)
    if visual_sd is not None:
        visual.load_state_dict(visual_sd, strict=True)
        if resnet_weights and logger:
            logger.warning("--resnet_weights ignored: the checkpoint carries its own ResNet")
    else:
        init_weights(visual, torch.Generator(device).manual_seed(0))
        common.import_resnet_params(visual, resnet_weights, logger)
    return model, visual


class Server:
    """What the CLI serves from its flags: the FCMF classifier and its
    ResNet on `device`, the detector, the two aspect taggers (or none) and
    the tokenizer.  `config_hook(cfg, rcfg) -> (cfg, rcfg)` edits the model
    configs built from the flags (tests only; the command line cannot
    reach it)."""

    def __init__(self, args: argparse.Namespace, config_hook: Optional[Callable] = None,
                 logger=None):
        from macsa_tpu_torch.data.images import roi_boxes_from_csv
        from macsa_tpu_torch.data.tokenizer import load_tokenizer
        from macsa_tpu_torch.inference.pipeline import PrecomputedDetector, YoloDetector
        from macsa_tpu_torch.train import common
        from macsa_tpu_torch.train.steps import make_finetune_eval_step

        self.args = args
        self.device = device = common.resolve_device(args.device)
        # f32 means f32: no TF32 in cuBLAS or cuDNN (cuDNN allows it by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.tokenizer = load_tokenizer(args.pretrained_hf_model)
        self.bundle = self.config = self.model = self.visual = self.eval_step = None
        self.image_size = 224
        if args.bundle is not None:
            # the exported program replaces the model build; the shapes the
            # host prepares come from bundle.json, so they are the program's
            from macsa_tpu_torch.inference.export import load_bundle
            self.bundle = load_bundle(args.bundle, device)
            mc = self.bundle.meta["config"]
            args.num_imgs, args.num_rois = mc["num_imgs"], mc["num_roi"]
            args.max_seq_length = mc["max_text_len"]
            self.num_patches = mc["num_patches"]
            self.image_size = self.bundle.meta["image_size"]
            if args.batch_size > self.bundle.batch_size:
                if logger:
                    logger.warning(f"--batch_size {args.batch_size} > the bundle's batch "
                                   f"{self.bundle.batch_size}; clamping")
                args.batch_size = self.bundle.batch_size
        else:
            fused = common.resolve_fused_attention(args.fused_attention, device)
            cfg = FCMFConfig(model=ModelConfig(dtype="float32", fused_attention=fused),
                             text=common.build_text_config(args.pretrained_hf_model,
                                                           "float32", fused_attention=fused),
                             num_imgs=args.num_imgs, num_roi=args.num_rois,
                             max_text_len=args.max_seq_length,
                             decoder_cross_mask_mode=args.cross_mask_mode)
            rcfg = ResNetConfig(dtype="float32", stage_sizes=tuple(
                int(s) for s in args.resnet_stages.split(",")))
            if config_hook is not None:
                cfg, rcfg = config_hook(cfg, rcfg)
            self.config, self.num_patches = cfg, cfg.num_patches
            self.model, self.visual = load_served_model(args.checkpoint, cfg, rcfg, device,
                                                        args.resnet_weights, logger)
            self.eval_step = make_finetune_eval_step(self.model, self.visual)

        if args.yolo_weights:
            self.detector = YoloDetector(args.yolo_weights)
        elif args.roi_csv:
            self.detector = PrecomputedDetector(roi_boxes_from_csv(args.roi_csv))
        else:
            self.detector = lambda path: []  # no ROI source -> zero features
            if logger:
                logger.warning("no --roi_csv / --yolo_weights; ROIs will be empty")

        # visual tag classifiers (inference.py:294): 5 classes, no Public_area
        # in the vision label space (run_image_categories.py)
        self.taggers = None
        self.tag_names = [a for a in ASPECTS if a != "Public_area"]
        if args.image_model_checkpoint and args.roi_model_checkpoint:
            from macsa_tpu_torch.tools.classifier_io import load_classifier
            self.taggers = tuple(load_classifier(p, device=device).eval()
                                 for p in (args.image_model_checkpoint,
                                           args.roi_model_checkpoint))
            for clf in self.taggers:
                if clf.linear.weight.shape[0] != len(self.tag_names):
                    raise ValueError(f"an aspect classifier has {clf.linear.weight.shape[0]} "
                                     f"classes, not {len(self.tag_names)}")

    def prep_record(self, raw_text: str, image_list: list) -> dict:
        """One record -> normalized text, tags, visual arrays, aspect views
        (inference.py:402-403, :294, :248-281)."""
        from macsa_tpu_torch.data.vimacsa import build_aspect_views
        from macsa_tpu_torch.inference.pipeline import (construct_visual_features,
                                                        predict_visual_tags)
        from macsa_tpu_torch.train.common import normalize_comment
        args = self.args
        text = normalize_comment(raw_text)
        img_tags, roi_tags = ["empty"], ["empty"]
        if self.taggers and image_list:
            img_tags, roi_tags = predict_visual_tags(self.detector, *self.taggers, image_list,
                                                     self.tag_names, eps=args.eps)
            img_tags = img_tags or ["empty"]
            roi_tags = roi_tags or ["empty"]
        images, roi_images, roi_coors = construct_visual_features(
            self.detector, image_list, args.eps, args.num_rois, args.num_imgs,
            size=self.image_size)
        views = build_aspect_views(text, img_tags, roi_tags, self.tokenizer,
                                   args.max_seq_length, self.num_patches)
        return {"text": text, "img_tags": img_tags, "roi_tags": roi_tags, "images": images,
                "roi_images": roi_images, "roi_coors": roi_coors, "views": views}

    @staticmethod
    def arrays(recs: list) -> dict:
        """Prepared records -> the forward's seven inputs as numpy arrays."""
        batch = {k: np.stack([r[k] for r in recs])
                 for k in ("images", "roi_images", "roi_coors")}
        for k in ("input_ids", "token_type_ids", "attention_mask", "added_mask"):
            batch[k] = np.stack([r["views"][k] for r in recs])
        return batch

    def batch(self, recs: list) -> dict:
        """Prepared records -> the eval step's batch, on the device."""
        from macsa_tpu_torch.train.common import to_device
        return to_device(self.arrays(recs), self.device)

    def predict(self, recs: list) -> np.ndarray:
        """Prepared records (one chunk) -> polarity indices [len(recs), A]:
        all 6 aspects of all records in one forward (inference.py:304-326
        loops over them), through the bundle's program where one is served."""
        if self.bundle is not None:
            return self.bundle.predict(self.arrays(recs)).argmax(-1)
        preds, _ = self.eval_step(self.batch(recs))
        return preds.cpu().numpy()


def report(preds: np.ndarray) -> dict:
    return {asp: POLARITIES[preds[i]] for i, asp in enumerate(ASPECTS)}


def main(argv: Optional[list] = None, *, config_hook: Optional[Callable] = None) -> dict:
    """Run the CLI -> the single-sample prediction, or the batch summary
    (`config_hook`: see `Server`)."""
    from macsa_tpu_torch.utils.logging import setup_logging

    parser = build_argparser()
    args = parser.parse_args(argv)
    if (args.text is None) == (args.input_json is None):
        parser.error("exactly one of --text / --input_json is required")
    if (args.checkpoint is None) == (args.bundle is None):
        parser.error("exactly one of --checkpoint / --bundle is required")
    server = Server(args, config_hook, setup_logging(None))

    if args.input_json is None:  # single-sample mode
        rec = server.prep_record(args.text, args.image_list)
        result = report(server.predict([rec])[0])
        print(json.dumps(result, ensure_ascii=False))
        if args.output_file:
            with open(args.output_file, "w") as f:
                json.dump({"text": args.text, "normalized": rec["text"],
                           "image_tags": rec["img_tags"], "roi_tags": rec["roi_tags"],
                           "prediction": result}, f, ensure_ascii=False, indent=2)
        return result

    # batch serving mode
    with open(args.input_json) as f:
        records = json.load(f)
    if not isinstance(records, list) or not records:
        raise SystemExit(f"--input_json must hold a non-empty JSON list, "
                         f"got {type(records).__name__}")
    bs = max(1, min(args.batch_size, len(records)))
    results, prep_s, forward_s, t0 = [], 0.0, 0.0, time.perf_counter()
    for lo in range(0, len(records), bs):
        chunk = records[lo:lo + bs]
        t1 = time.perf_counter()
        recs = [server.prep_record(r.get("text", ""), r.get("image_list", [])) for r in chunk]
        t2 = time.perf_counter()
        n = len(recs)
        recs += [recs[-1]] * (bs - n)  # pad to one shape
        preds = server.predict(recs)[:n]  # returns once the forward has ended
        prep_s, forward_s = prep_s + t2 - t1, forward_s + time.perf_counter() - t2
        for r, rec, p in zip(chunk, recs, preds):
            results.append({"text": r.get("text", ""), "normalized": rec["text"],
                            "image_tags": rec["img_tags"], "roi_tags": rec["roi_tags"],
                            "prediction": report(p)})
    dt = time.perf_counter() - t0
    out = args.output_file or (args.input_json + ".predictions.jsonl")
    with open(out, "w") as f:
        for r in results:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    summary = {"records": len(results), "batch_size": bs,
               "records_per_s": round(len(results) / dt, 3), "output_file": out,
               "host_prep_share": round(prep_s / dt, 4), "forward_share": round(forward_s / dt, 4)}
    print(json.dumps(summary, ensure_ascii=False))
    return summary


if __name__ == "__main__":
    main()
