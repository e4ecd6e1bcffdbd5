"""Offline ROI -> aspect-category labeler (trainer + exporter), on PyTorch.

Counterpart of `macsa_tpu/tools/roi_categories.py` (reference tool:
image_processing/run_roi_categories.py): a single-label ResNet-152 + Linear
classifier over ROI crops trained with cross-entropy and plain Adam over
every parameter (as `tools/image_categories.py`), an image-level leak-free
train/dev/test split (:90-115: all ROIs of an image stay in one split), and
`--get_cate` exporting the deduplicated per-image tag sets as
`resnet152_roi_label.json` (:291-338).

Label input: a CSV with columns `file_name, x1, x2, y1, y2, label` (the
roi_data.csv layout plus a label column).

    python -m macsa_tpu_torch.tools.roi_categories --do_train \\
        --roi_label_path roi_labels.csv --image_dir imgs/ --output_dir out/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.tools.image_categories import (DEFAULT_CLASSES, build_classifier,
                                                    make_train_step, softmax_ce)


def load_roi_table(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            rows.append({"file_name": row[0], "box": tuple(float(v) for v in row[1:5]),
                         "label": row[5] if len(row) > 5 else None})
    return rows


def image_level_split(rows: List[dict], seed: int = 18):
    """70/15/15 split on unique images so no ROI leaks across splits
    (run_roi_categories.py:90-115)."""
    names = sorted({r["file_name"] for r in rows})
    rng = np.random.default_rng(seed)
    rng.shuffle(names)
    n = len(names)
    train_n, dev_n = int(n * 0.7), int(n * 0.15)
    train = set(names[:train_n])
    dev = set(names[train_n:train_n + dev_n])
    test = set(names[train_n + dev_n:])
    pick = lambda s: [r for r in rows if r["file_name"] in s]
    return pick(train), pick(dev), pick(test)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--roi_label_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--classes", type=str, nargs="*", default=DEFAULT_CLASSES)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_train_epochs", type=int, default=5)
    p.add_argument("--max_rois_per_image", type=int, default=6)
    p.add_argument("--seed", type=int, default=18)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--get_cate", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device.  The default raises without a CUDA device; say "
                        "cpu to run on the CPU")
    return p


def _suffixed(name: str) -> str:
    return name if os.path.splitext(name)[1] else name + ".png"


def load_crops(rows: List[dict], image_dir: str) -> np.ndarray:
    """Normalized [N, 224, 224, 3] crops; each image decoded once."""
    from macsa_tpu_torch.data.images import crop_roi, decode_image, resize_normalize
    out = np.zeros((len(rows), 224, 224, 3), np.float32)
    cache: Dict[str, Optional[np.ndarray]] = {}
    for i, r in enumerate(rows):
        name = r["file_name"]
        if name not in cache:
            cache[name] = decode_image(os.path.join(image_dir, _suffixed(name)))
        raw = cache[name]
        if raw is None:
            continue
        crop = crop_roi(raw, r["box"])
        if crop is not None:
            out[i] = resize_normalize(crop)
    return out


def main(argv: Optional[list] = None, *, config_hook: Optional[Callable] = None) -> dict:
    """Run the tool -> {"best_dev_acc", "labels"} (what ran).
    `config_hook(rcfg) -> rcfg` edits the classifier's ResNet config
    (tests only)."""
    from macsa_tpu_torch.tools.classifier_io import load_classifier, save_classifier
    from macsa_tpu_torch.train.common import resolve_device
    from macsa_tpu_torch.utils.logging import setup_logging

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    logger = setup_logging(args.output_dir)
    classes = list(args.classes)
    cls_to_id = {c: i for i, c in enumerate(classes)}
    rcfg = ResNetConfig() if config_hook is None else config_hook(ResNetConfig())
    best_path = os.path.join(args.output_dir, "roi_classifier_best")
    result: dict = {}

    def batch(chunk):
        crops = torch.from_numpy(load_crops(chunk, args.image_dir)).to(device)
        labels = torch.tensor([cls_to_id[r["label"]] for r in chunk], device=device)
        return crops, labels

    if args.do_train:
        rows = [r for r in load_roi_table(args.roi_label_path) if r["label"] in cls_to_id]
        train, dev, test = image_level_split(rows, args.seed)
        logger.info(f"train/dev/test ROIs: {len(train)}/{len(dev)}/{len(test)}")
        model = build_classifier(len(classes), rcfg, args.seed, device, args.resnet_weights,
                                 logger)
        step = make_train_step(model, softmax_ce, args.learning_rate)
        rng = np.random.default_rng(args.seed)
        best_acc, loss = 0.0, torch.tensor(0.0)
        for epoch in range(args.num_train_epochs):
            rng.shuffle(train)
            for i in range(0, len(train) - args.batch_size + 1, args.batch_size):
                loss = step(*batch(train[i:i + args.batch_size]))
            # per-class accuracy (confusion-style report, :197-220)
            correct, total = np.zeros(len(classes)), np.zeros(len(classes))
            with torch.no_grad():
                for i in range(0, len(dev), args.batch_size):
                    crops, labels = batch(dev[i:i + args.batch_size])
                    preds, labels = model(crops).argmax(-1).cpu().numpy(), labels.cpu().numpy()
                    for c in range(len(classes)):
                        m = labels == c
                        total[c] += m.sum()
                        correct[c] += (preds[m] == c).sum()
            acc = correct.sum() / max(total.sum(), 1)
            per_class = {classes[c]: f"{correct[c] / max(total[c], 1):.3f}"
                         for c in range(len(classes))}
            logger.info(f"epoch {epoch}: loss {float(loss):.4f} dev acc {acc:.4f} "
                        f"per-class {per_class}")
            if acc >= best_acc:
                best_acc = acc
                save_classifier(best_path, model)
        result["best_dev_acc"] = float(best_acc)

    if args.get_cate:
        model = load_classifier(args.checkpoint or best_path, device=device)
        by_image: Dict[str, List[dict]] = {}
        for r in load_roi_table(args.roi_label_path):
            by_image.setdefault(r["file_name"], []).append(r)
        labels: Dict[str, List[str]] = {}
        with torch.no_grad():
            for name, img_rows in by_image.items():
                crops = load_crops(img_rows[:args.max_rois_per_image], args.image_dir)
                preds = model(torch.from_numpy(crops).to(device)).argmax(-1).cpu().tolist()
                labels[_suffixed(name)] = sorted({classes[c] for c in preds})
        out_path = os.path.join(args.output_dir, "resnet152_roi_label.json")
        with open(out_path, "w") as f:
            json.dump(labels, f, ensure_ascii=False)
        logger.info(f"wrote {out_path} with {len(labels)} entries")
        result["labels"] = labels
    return result


if __name__ == "__main__":
    main()
