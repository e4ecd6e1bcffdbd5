"""The one traffic generator: every cell's inputs, from its workload file's
`traffic` parameters and the run's seed.

Host arrays (what a loader hands the step: token ids, masks, labels, box
coordinates, decoder targets, host-normalized frames) are numpy, drawn from
a `numpy.random.Generator`; device data (cached features) is drawn on the
device by a `torch.Generator` in one call a tensor.  Every seed gets the
same sizes: texts are padded to the same length, frames have the same
shape, so a seed changes values and order, never the work.

Parameters (all in the workload file's `traffic`):
  rows          reviews in the split (the cache's rows; an epoch's order)
  batch         reviews a step or a served batch
  text_len      [lo, hi] valid tokens of a text, drawn uniformly
  label_probs   the 4 polarities' shares (None first)
  decoder_len   [lo, hi] decoder target tokens (Phase 1)
  visual        "cached" | "packed" | "normalized"
  images_valid  share of the 7 image slots that hold an image
  rois_valid    share of the ROI slots that hold a crop
  pool          distinct host batches cycled through (pixel cells)
"""

from __future__ import annotations

import numpy as np
import torch

IMAGE_SIZE = 224
IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)
BOS, PAD, EOS = 0, 1, 2  # ViSoBERT's <s>, <pad>, </s>


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def derived_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for one stream of the run's draws."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1)[0])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(derived_seed(seed, stream))


def texts(rng: np.random.Generator, lead: tuple, length: int, vocab: int, lo_hi) -> dict:
    """Token ids [*lead, L] of texts of lo..hi valid tokens (<s> first, </s>
    last, <pad> after), with their attention masks."""
    lens = rng.integers(lo_hi[0], lo_hi[1] + 1, size=lead)
    ids = rng.integers(3, vocab, size=lead + (length,), dtype=np.int64).astype(np.int32)
    pos = np.arange(length)
    ids[..., 0] = BOS
    ids = np.where(pos == lens[..., None] - 1, EOS, ids)
    valid = pos < lens[..., None]
    return {"ids": np.where(valid, ids, PAD).astype(np.int32),
            "mask": valid.astype(np.int32)}


def aspect_views(rng, rows: int, aspects: int, length: int, patches: int, vocab: int,
                 lo_hi) -> dict:
    """The classifier's 6 views of each review: [rows, A, L] arrays."""
    t = texts(rng, (rows, aspects), length, vocab, lo_hi)
    return {"input_ids": t["ids"], "attention_mask": t["mask"],
            "token_type_ids": np.zeros_like(t["ids"]),
            "added_mask": np.ones((rows, aspects, length + patches), np.int32)}


def labels(rng, rows: int, aspects: int, probs) -> np.ndarray:
    p = np.asarray(probs, np.float64)
    return rng.choice(len(p), size=(rows, aspects), p=p / p.sum()).astype(np.int32)


def boxes(rng, lead: tuple) -> np.ndarray:
    """ROI boxes (x_min, x_max, y_min, y_max) in pixels of a 224 frame."""
    x = np.sort(rng.uniform(0, IMAGE_SIZE, size=lead + (2,)), -1)
    y = np.sort(rng.uniform(0, IMAGE_SIZE, size=lead + (2,)), -1)
    return np.concatenate([x, y], -1).astype(np.float32)


def decoder_targets(rng, rows: int, t: int, vocab: int, lo_hi) -> dict:
    """IAOG decoder inputs [rows, T] (<s>, then 3..hi-1 words, </s>, pads)
    and labels: the inputs shifted left, -100 at pads and the last slot."""
    d = texts(rng, (rows,), t, vocab, lo_hi)
    ids = d["ids"]
    lab = np.roll(ids, -1, axis=1)
    lab[:, -1] = -100
    lab[lab == PAD] = -100
    return {"dec_input_ids": ids, "labels": lab.astype(np.int32)}


def fill_features_(g: torch.Generator, *tensors: torch.Tensor) -> None:
    """Fill feature tensors in place, non-negative as pooled post-ReLU
    features are: 4 u^2, u uniform, drawn in each tensor's own dtype."""
    for t in tensors:
        t.uniform_(generator=g).square_().mul_(4)


def frames(g: torch.Generator, lead: tuple, valid_share: float, encoding: str, device,
           size: int = IMAGE_SIZE) -> np.ndarray:
    """Frames [*lead, ...] on the host, drawn on the device: "packed" as the
    loader ships them (int32 words: a validity word, then the RGB bytes),
    "normalized" as the CLI ships them (f32 (x/255 - mean)/std, zeros where
    a slot is empty)."""
    pixels = torch.randint(0, 256, lead + (size, size, 3), generator=g, device=device,
                           dtype=torch.uint8)
    valid = torch.rand(lead, generator=g, device=device) < valid_share
    if encoding == "packed":
        words = pixels.reshape(lead + (size * size * 3,)).view(torch.int32)
        return torch.cat([valid.to(torch.int32)[..., None], words], -1).cpu().numpy()
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    x = (pixels.float() * (1.0 / 255.0) - mean) * (1.0 / std)
    return torch.where(valid[..., None, None, None], x, 0.0).cpu().numpy()


def epoch_order(seed: int, rows: int, batch: int, steps: int) -> np.ndarray:
    """Row indices of `steps` batches [steps, batch]: each epoch a new
    permutation, its last incomplete batch dropped (`drop_last`)."""
    rng = host_rng(seed, 7)
    per_epoch = rows // batch
    out = []
    while len(out) < steps:
        perm = rng.permutation(rows)
        out += [perm[i * batch:(i + 1) * batch] for i in range(per_epoch)]
    return np.stack(out[:steps])
