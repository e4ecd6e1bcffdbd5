"""Visual caption generation -> the captions JSON that EF-CapTrRoBERTa reads.

Counterpart of `macsa_tpu/tools/generate_captions.py` (reference:
EF-CapTrRoBERTa/Caption_Generation/generate_captions_vi.py:50-177): every
image under `--image_dir` (sorted by name) gets a caption, written as
{image_name: caption} with `ensure_ascii=False`.  `EFCapDataset`
(`data/baselines.py`) reads the file through `train_baselines.py
--caption_file`.

The captioner is one of:
* `--catr_checkpoint <path.pth> --bert_tokenizer <dir>`: the reference's
  torch-hub CATR (`models/catr.py`) on the card, its greedy decode encoding
  each batch once; the ids are decoded by the port's `vocab.txt` reader
  (`data/tokenizer.WordPieceDecoder`, `BertTokenizer.decode`'s output
  without `transformers`),
* `--hf_caption_model <dir>`: a local HF image-to-text checkpoint through
  `transformers`' pipeline (an optional import: without `transformers` it
  raises, saying so),
* `--placeholder`: the dataset's fallback caption ("hình ảnh bình
  thường", train_ef_captr_roberta.py:78-79) for every image.

`--device` follows the drivers: `cuda` by default, which raises without a
card; `--device cpu` runs on the CPU.  The captioner computes in f32 with
TF32 off, as the inference CLI does.

Run: python -m macsa_tpu_torch.tools.generate_captions --image_dir ... \\
    --output_file captions.json --catr_checkpoint catr.pth --bert_tokenizer tok/
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

PLACEHOLDER = "hình ảnh bình thường"
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def build_argparser() -> argparse.ArgumentParser:
    """The flags of `macsa_tpu.tools.generate_captions.build_argparser`,
    plus `--device`."""
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--output_file", type=str, required=True)
    p.add_argument("--catr_checkpoint", type=str, default=None,
                   help="local CATR torch checkpoint (.pth state dict)")
    p.add_argument("--bert_tokenizer", type=str, default=None,
                   help="local bert-base-uncased tokenizer dir with its vocab.txt (for CATR)")
    p.add_argument("--hf_caption_model", type=str, default=None,
                   help="local HF image-to-text model dir (needs transformers)")
    p.add_argument("--placeholder", action="store_true",
                   help="emit the fallback caption for every image")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the captioner.  The default raises "
                        "without a CUDA device; say cpu to run on the CPU")
    return p


def square_pad_resize(path: str, size: int = 299) -> np.ndarray:
    """SquarePad (zero-pad to a square, the image centred at ((m-w)//2,
    (m-h)//2)) + resize + ImageNet normalize -> [size, size, 3] float32
    (reference: generate_captions_vi.py:22-39).  The resize is PIL's
    BILINEAR byte for byte (`data/images.resize_u8_pil`), without PIL."""
    from macsa_tpu_torch.data.images import decode_image, resize_u8_pil

    img = decode_image(path)
    if img is None:
        raise ValueError(f"cannot decode {path}")
    h, w = img.shape[:2]
    m = max(w, h)
    sq = np.zeros((m, m, 3), np.uint8)
    top, left = (m - h) // 2, (m - w) // 2
    sq[top:top + h, left:left + w] = img
    arr = resize_u8_pil(sq, size).astype(np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_catr(checkpoint: str, device: torch.device):
    """A hub CATR `.pth` (a state dict, or a dict holding one under
    `model`) -> the model in eval mode on `device`."""
    from macsa_tpu_torch.models.catr import CATR, infer_catr_config

    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "keys"):
        sd = sd["model"]
    model = CATR(infer_catr_config(sd), device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def catr_captioner(checkpoint: str, tokenizer_dir: str, batch_size: int,
                   device: torch.device) -> Callable[[List[str]], List[str]]:
    """CATR greedy captioner from a torch-hub checkpoint."""
    from macsa_tpu_torch.data.tokenizer import WordPieceDecoder
    from macsa_tpu_torch.models.catr import greedy_decode

    model = load_catr(checkpoint, device)
    tok = WordPieceDecoder.from_dir(tokenizer_dir)
    end = model.cfg.end_token

    def run(paths: List[str]) -> List[str]:
        imgs = np.stack([square_pad_resize(p) for p in paths])
        n = len(paths)
        if n < batch_size:  # the tail batch is padded to the batch size
            imgs = np.concatenate([imgs, np.zeros((batch_size - n,) + imgs.shape[1:],
                                                  np.float32)])
        tokens = greedy_decode(model, torch.from_numpy(imgs).to(device))[:n].cpu().tolist()
        caps = []
        for row in tokens:
            if end in row:
                row = row[:row.index(end)]
            caps.append(tok.decode(row, skip_special_tokens=True).capitalize())
        return caps

    return run


def hf_captioner(model_dir: str, batch_size: int, device: torch.device
                 ) -> Callable[[List[str]], List[str]]:
    try:
        from transformers import pipeline
    except ImportError as err:
        raise RuntimeError(f"--hf_caption_model needs the transformers package ({err}); "
                           "use --catr_checkpoint or --placeholder without it") from err
    pipe = pipeline("image-to-text", model=model_dir, device=device)

    def run(paths: List[str]) -> List[str]:
        outs = pipe(paths, batch_size=batch_size)
        return [(o[0]["generated_text"] if isinstance(o, list)
                 else o["generated_text"]).strip() for o in outs]

    return run


def generate(image_dir: str, captioner: Optional[Callable], batch_size: int = 8
             ) -> Dict[str, str]:
    names = sorted(n for n in os.listdir(image_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg")))
    if captioner is None:
        return {n: PLACEHOLDER for n in names}
    result: Dict[str, str] = {}
    for i in range(0, len(names), batch_size):
        chunk = names[i:i + batch_size]
        result.update(zip(chunk, captioner([os.path.join(image_dir, n) for n in chunk])))
    return result


def main(argv: Optional[list] = None) -> Dict[str, str]:
    from macsa_tpu_torch.train.common import resolve_device

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    # f32 means f32: no TF32 in cuBLAS or cuDNN (cuDNN allows it by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    captioner = None
    if args.catr_checkpoint:
        if not args.bert_tokenizer:
            raise SystemExit("--catr_checkpoint needs --bert_tokenizer <dir>")
        captioner = catr_captioner(args.catr_checkpoint, args.bert_tokenizer,
                                   args.batch_size, device)
    elif args.hf_caption_model:
        captioner = hf_captioner(args.hf_caption_model, args.batch_size, device)
    elif not args.placeholder:
        raise SystemExit("provide --catr_checkpoint <pth>, "
                         "--hf_caption_model <dir>, or --placeholder")
    result = generate(args.image_dir, captioner, args.batch_size)
    with open(args.output_file, "w") as f:
        json.dump(result, f, ensure_ascii=False)
    print(f"wrote {args.output_file} with {len(result)} captions")
    return result


if __name__ == "__main__":
    main()
