"""Generate a fully-offline synthetic ViMACSA-shaped dataset + tokenizer.

The port's own copy of `tools_dev/make_synth_data.py`, using numpy, `json`
and the port's PNG writer only (the original needs `tokenizers` and PIL):
everything the training drivers require (see `train/common.py:load_metadata`
and the driver CLIs), so the real CLI entry points can be exercised end to
end without the (private) ViMACSA data or any network:

  <out>/tok/     tokenizer.json + tokenizer_config.json + config.json
                 (hidden_size=768: the fusion stack is fixed at 768)
  <out>/data/    train/dev/test.json, train/dev_with_iaog.json,
                 roi_data.csv, resnet152_image_label.json,
                 resnet152_roi_label.json
  <out>/images/  random PNGs

Same vocabulary and the same order of draws from the generator as the
original, so with the defaults (seed 0, 64-pixel images) every JSON and CSV
file is byte-identical to the original's and the PNGs decode to the same
pixels.  Larger images scale the ROI boxes with them.

Usage: python -m macsa_tpu_torch.data.synth <out_dir> [n_train] [n_layers] [image_size]
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

import numpy as np

from macsa_tpu_torch.data.png import write_png

ASPECTS = ["Location", "Food", "Room", "Facilities", "Service", "Public_area"]
POLARITIES = ["None", "Negative", "Neutral", "Positive"]

WORDS = ("khách sạn phòng đẹp sạch sẽ nhân viên thân thiện đồ ăn ngon vị trí "
         "thuận tiện giá rẻ tốt tệ bẩn cũ ồn view biển hồ bơi rộng nhỏ "
         "thoải mái tuyệt vời bình thường dịch vụ chậm nhanh").split()
BASE_IMAGE_SIZE = 64  # the original's; its ROI boxes are drawn for this size


def vocabulary() -> dict:
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, ",": 4, ".": 5,
             "empty": 6}
    for w in WORDS:
        for piece in w.split():
            vocab.setdefault(piece, len(vocab))
    for asp in ASPECTS:
        for piece in asp.lower().replace("_", " ").split():
            vocab.setdefault(piece, len(vocab))
    return vocab


def tokenizer_json(vocab: dict) -> str:
    """The `tokenizer.json` the `tokenizers` package saves for a WordLevel
    model behind a Whitespace pre-tokenizer with the XLM-R style template
    (`<s> $A </s>`, `<s> $A </s> </s> $B </s>`, all type ids 0) and
    truncation at 170."""
    def special(tok):
        return {"SpecialToken": {"id": tok, "type_id": 0}}

    def sequence(name):
        return {"Sequence": {"id": name, "type_id": 0}}

    spec = {
        "version": "1.0",
        "truncation": {"direction": "Right", "max_length": 170,
                       "strategy": "LongestFirst", "stride": 0},
        "padding": None,
        "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special("<s>"), sequence("A"), special("</s>")],
            "pair": [special("<s>"), sequence("A"), special("</s>"), special("</s>"),
                     sequence("B"), special("</s>")],
            "special_tokens": {tok: {"id": tok, "ids": [vocab[tok]], "tokens": [tok]}
                               for tok in ("</s>", "<s>")},
        },
        "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    return json.dumps(spec, indent=2, ensure_ascii=False)


def make_tokenizer(tok_dir: str, n_layers: int = 2,
                   intermediate: int = 1024) -> None:
    vocab = vocabulary()
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        f.write(tokenizer_json(vocab))
    with open(os.path.join(tok_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "sep_token": "</s>", "cls_token": "<s>",
                   "pad_token": "<pad>", "unk_token": "<unk>",
                   "model_max_length": 512}, f)
    with open(os.path.join(tok_dir, "config.json"), "w") as f:
        json.dump({"model_type": "xlm-roberta", "vocab_size": len(vocab),
                   "hidden_size": 768, "num_hidden_layers": n_layers,
                   "num_attention_heads": 12,
                   "intermediate_size": intermediate,
                   "max_position_embeddings": 514, "type_vocab_size": 1,
                   "pad_token_id": 1, "layer_norm_eps": 1e-5}, f)


def make_images(img_dir: str, n: int, rng: np.random.Generator,
                image_size: int = BASE_IMAGE_SIZE) -> list:
    os.makedirs(img_dir, exist_ok=True)
    names = []
    for i in range(n):
        name = f"img_{i:03d}.png"
        arr = rng.integers(0, 255, (image_size, image_size, 3), dtype=np.uint8)
        write_png(os.path.join(img_dir, name), arr)
        names.append(name)
    return names


def make_records(n: int, img_names: list, rng: np.random.Generator,
                 with_iaog: bool) -> list:
    records = []
    for i in range(n):
        text = " ".join(rng.choice(WORDS, size=rng.integers(6, 15)))
        k = int(rng.integers(1, 4))
        imgs = [str(x) for x in rng.choice(img_names, size=k, replace=False)]
        n_lab = int(rng.integers(1, 4))
        asps = rng.choice(ASPECTS, size=n_lab, replace=False)
        labels = [f"{a}#{rng.choice(POLARITIES[1:])}" for a in asps]
        rec = {"comment": text, "list_img": imgs, "text_img_label": labels}
        if with_iaog:
            rec["iaog_labels"] = [
                f"{rng.choice(WORDS)}#{a}" for a in asps]
        records.append(rec)
    return records


def write_dataset(out: str, n_train: int = 16, n_layers: int = 2,
                  image_size: int = BASE_IMAGE_SIZE, seed: int = 0,
                  n_dev: Optional[int] = None, n_test: Optional[int] = None,
                  n_images: int = 12) -> None:
    """Write tok/, data/ and images/ under `out`."""
    if image_size % BASE_IMAGE_SIZE:
        raise ValueError(f"image_size must be a multiple of {BASE_IMAGE_SIZE}, got {image_size}")
    # full-scale runs use 12 layers / 3072 intermediate, the ViSoBERT /
    # XLM-R-base geometry; the smoke-test default stays tiny
    intermediate = 3072 if n_layers >= 12 else 1024
    rng = np.random.default_rng(seed)

    make_tokenizer(os.path.join(out, "tok"), n_layers, intermediate)
    img_names = make_images(os.path.join(out, "images"), n_images, rng, image_size)

    data_dir = os.path.join(out, "data")
    os.makedirs(data_dir, exist_ok=True)
    # *_with_iaog.json holds the SAME reviews as the plain split plus the
    # iaog_labels field: the real dataset's relationship (the IAOG files
    # are produced by annotating train/dev.json), which the cross-stage
    # feature cache relies on (shared images => keys)
    sizes = [("train", n_train),
             ("dev", max(4, n_train // 4) if n_dev is None else n_dev),
             ("test", max(4, n_train // 4) if n_test is None else n_test)]
    for split, n in sizes:
        records = make_records(n, img_names, rng, True)
        if split != "test":
            with open(os.path.join(data_dir, f"{split}_with_iaog.json"),
                      "w") as f:
                json.dump(records, f, ensure_ascii=False)
        for rec in records:
            rec.pop("iaog_labels", None)
        with open(os.path.join(data_dir, f"{split}.json"), "w") as f:
            json.dump(records, f, ensure_ascii=False)

    # roi_data.csv: file_name (no suffix), x1, x2, y1, y2
    scale = image_size // BASE_IMAGE_SIZE
    with open(os.path.join(data_dir, "roi_data.csv"), "w") as f:
        f.write("file_name,x1,x2,y1,y2\n")
        for name in img_names:
            stem = name[:-4]
            for _ in range(int(rng.integers(1, 4))):
                x1, y1 = (int(v) * scale for v in rng.integers(0, 32, 2))
                f.write(f"{stem},{x1},{x1 + 24 * scale},{y1},{y1 + 24 * scale}\n")

    img_aspect = {n: [str(a) for a in rng.choice(ASPECTS, size=rng.integers(1, 3),
                                                 replace=False)] for n in img_names}
    roi_aspect = {n: [str(a) for a in rng.choice(ASPECTS, size=rng.integers(1, 3),
                                                 replace=False)] for n in img_names}
    with open(os.path.join(data_dir, "resnet152_image_label.json"), "w") as f:
        json.dump(img_aspect, f)
    with open(os.path.join(data_dir, "resnet152_roi_label.json"), "w") as f:
        json.dump(roi_aspect, f)


def main(argv: Optional[list] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: python -m macsa_tpu_torch.data.synth "
                         "<out_dir> [n_train] [n_layers] [image_size]")
    out = argv[0]
    n_train = int(argv[1]) if len(argv) > 1 else 16
    n_layers = int(argv[2]) if len(argv) > 2 else 2
    image_size = int(argv[3]) if len(argv) > 3 else BASE_IMAGE_SIZE
    write_dataset(out, n_train, n_layers, image_size)
    print(f"synthetic dataset written to {out}")


if __name__ == "__main__":
    main()
