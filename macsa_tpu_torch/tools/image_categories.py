"""Offline image -> aspect-category labeler (trainer + exporter), on PyTorch.

Counterpart of `macsa_tpu/tools/image_categories.py` (reference tool:
image_processing/run_image_categories.py): trains a multi-label ResNet-152 +
Linear classifier (`models/aspect_classifier.py`) with sigmoid BCE and plain
Adam over every parameter, the backbone's convolutions and all four tensors
of each FrozenBatchNorm included (`optax.adam` over the whole params tree
there); keeps the checkpoint of the best dev accuracy at `--threshold`; and
`--get_cate` labels every image under `--image_dir`, writing
`resnet152_image_label.json` (:314-356), a prerequisite of every FCMF run.

Label input: a CSV with columns `file_name, <class_0>, ..., <class_k>` (0/1
per class) or a JSON {file_name: [class names]}.  Images are read by the
port's decoders (`data/images.py`: PNG needs no PIL).  The ResNet computes
in `ResNetConfig`'s default dtype (bf16), as in JAX.  `--device` (default
`cuda`) raises without a card unless it says `cpu`.

    python -m macsa_tpu_torch.tools.image_categories --do_train \\
        --image_label_path labels.csv --image_dir imgs/ --output_dir out/
    python -m macsa_tpu_torch.tools.image_categories --get_cate ...
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from macsa_tpu_torch.config import ResNetConfig

# the reference's vision-label class space (5 classes; no Public_area)
DEFAULT_CLASSES = ["Location", "Food", "Room", "Facilities", "Service"]


def load_label_table(path: str, classes: List[str]) -> List[Tuple[str, np.ndarray]]:
    if path.endswith(".json"):
        with open(path) as f:
            table = json.load(f)
        return [(name, np.asarray([1 if c in tags else 0 for c in classes], np.float32))
                for name, tags in table.items()]
    import csv
    out = []
    with open(path) as f:
        reader = csv.reader(f)
        cols = next(reader)[1:]
        for row in reader:
            by_name = dict(zip(cols, row[1:]))
            out.append((row[0], np.asarray([float(by_name.get(c, 0) or 0) for c in classes],
                                           np.float32)))
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--image_label_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--classes", type=str, nargs="*", default=DEFAULT_CLASSES)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_train_epochs", type=int, default=5)
    p.add_argument("--threshold", type=float, default=0.45)
    p.add_argument("--seed", type=int, default=18)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="classifier checkpoint for --get_cate")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--get_cate", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device.  The default raises without a CUDA device; say "
                        "cpu to run on the CPU")
    return p


def load_images(paths: List[str], image_dir: str) -> np.ndarray:
    """Normalized [N, 224, 224, 3] floats; unreadable images are zeros."""
    from macsa_tpu_torch.data.images import decode_image, resize_normalize
    out = np.zeros((len(paths), 224, 224, 3), np.float32)
    for i, name in enumerate(paths):
        raw = decode_image(os.path.join(image_dir, name))
        if raw is not None:
            out[i] = resize_normalize(raw)
    return out


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits)).mean()


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def build_classifier(num_classes: int, rcfg: ResNetConfig, seed: int, device,
                     resnet_weights: Optional[str] = None, logger=None):
    """A seeded AspectClassifier with trainable BatchNorm, the backbone
    from `resnet_weights` where given."""
    from macsa_tpu_torch.models.aspect_classifier import AspectClassifier
    from macsa_tpu_torch.models.layers import init_weights
    from macsa_tpu_torch.models.resnet import trainable_batchnorm_
    from macsa_tpu_torch.train.common import import_resnet_params
    model = AspectClassifier(num_classes, rcfg, device=device)
    init_weights(model, torch.Generator(device).manual_seed(seed))
    import_resnet_params(model.feature_extractor, resnet_weights, logger)
    return trainable_batchnorm_(model)


def make_train_step(model, loss_fn: Callable, learning_rate: float) -> Callable:
    """-> step(images, labels) = loss: one plain Adam update (b1 0.9, b2
    0.999, eps 1e-8: `optax.adam`'s defaults) over every parameter."""
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model(images), labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


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
    rcfg = ResNetConfig() if config_hook is None else config_hook(ResNetConfig())
    best_path = os.path.join(args.output_dir, "image_classifier_best")
    result: dict = {}

    def batch(chunk):
        images = torch.from_numpy(load_images([c[0] for c in chunk], args.image_dir))
        return images.to(device), torch.from_numpy(np.stack([c[1] for c in chunk])).to(device)

    if args.do_train:
        table = load_label_table(args.image_label_path, classes)
        rng = np.random.default_rng(args.seed)
        order = rng.permutation(len(table))
        split = int(len(table) * 0.85)
        train, dev = [table[i] for i in order[:split]], [table[i] for i in order[split:]]
        model = build_classifier(len(classes), rcfg, args.seed, device, args.resnet_weights,
                                 logger)
        step = make_train_step(model, sigmoid_bce, args.learning_rate)
        best_acc, loss = 0.0, torch.tensor(float("nan"))
        for epoch in range(args.num_train_epochs):
            rng.shuffle(train)
            for i in range(0, len(train) - args.batch_size + 1, args.batch_size):
                loss = step(*batch(train[i:i + args.batch_size]))
            # dev accuracy at the threshold (reference best-acc selection, :191-224)
            correct = total = 0
            with torch.no_grad():
                for i in range(0, len(dev), args.batch_size):
                    images, labels = batch(dev[i:i + args.batch_size])
                    preds = torch.sigmoid(model(images)) > args.threshold
                    correct += int((preds == labels.bool()).sum())
                    total += labels.numel()
            acc = correct / max(total, 1)
            logger.info(f"epoch {epoch}: loss {float(loss):.4f} dev acc {acc:.4f}")
            if acc >= best_acc:
                best_acc = acc
                save_classifier(best_path, model)
        logger.info(f"best dev acc {best_acc:.4f}")
        result["best_dev_acc"] = best_acc

    if args.get_cate:
        model = load_classifier(args.checkpoint or best_path, device=device)
        names = sorted(n for n in os.listdir(args.image_dir)
                       if n.lower().endswith((".png", ".jpg", ".jpeg")))
        labels: Dict[str, List[str]] = {}
        with torch.no_grad():
            for i in range(0, len(names), args.batch_size):
                chunk = names[i:i + args.batch_size]
                images = torch.from_numpy(load_images(chunk, args.image_dir)).to(device)
                probs = torch.sigmoid(model(images)).cpu().numpy()
                for name, row in zip(chunk, probs):
                    labels[name] = [classes[j] for j in np.where(row > args.threshold)[0]]
        out_path = os.path.join(args.output_dir, "resnet152_image_label.json")
        with open(out_path, "w") as f:
            json.dump(labels, f, ensure_ascii=False)
        logger.info(f"wrote {out_path} with {len(labels)} entries")
        result["labels"] = labels
    return result


if __name__ == "__main__":
    main()
