"""Cross-stage on-disk visual feature cache.

The pipeline runs pretrain -> finetune -> inference as separate processes,
and each stage re-decodes + re-extracts frozen-CNN features for the SAME
images (the reference even re-decodes every epoch,
vimacsa_dataset.py:123-199).  The in-process HBM cache
(train/feature_cache.py) already dedupes across epochs; this layer persists
those features to disk so the NEXT stage's epoch 0 is a bulk load instead
of a decode + ResNet pass over the whole split.

Keying: content-addressed.  A record's key is a SHA-1 over
* the ordered image list and each image FILE's content hash (missing files
  hash as absent — they produce zero frames either way),
* the per-image ROI boxes actually used (first `num_roi` of roi_data.csv),
* the tensor-shaping config (num_img, num_roi, image size), and
* the extractor fingerprint (ResNet weights source + stage sizes + dtype +
  grid size — train/common.py:resnet_fingerprint).
So a cache entry is valid iff the features it stores are what extraction
would recompute — edits to an image, its boxes, or the backbone weights
miss cleanly.  IAOG and MACSA records from the same review share images
and boxes, hence keys, hence entries (the cross-stage reuse).

Storage: one .npy pair per record ({key}.grid.npy / {key}.roi.npy, bf16
stored as a uint16 view), ~1.5 MB/record at reference shapes — a full
ViMACSA train split is ~4.4 GB, written asynchronously on a background
thread so cold-epoch steps never wait on disk.

A copy of `macsa_tpu/train/disk_feature_cache.py` for the PyTorch port.
The files are the same (bf16 rows as uint16), so one cache directory serves
both packages; here the rows come from and go back to torch tensors.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _to_uint16(rows) -> np.ndarray:
    """Feature rows (a tensor on any device, any float dtype) -> their bf16
    bits as a uint16 numpy array."""
    t = torch.as_tensor(rows).detach().to("cpu", torch.bfloat16).contiguous()
    return t.view(torch.int16).numpy().view(np.uint16)


def _from_uint16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def file_content_hash(path: str, _memo: Dict[str, str] = {}) -> str:
    """SHA-1 of a file's bytes, memoized per path for the process lifetime
    (an image is hashed once even if 6 aspect-expanded records share it)."""
    h = _memo.get(path)
    if h is not None:
        return h
    try:
        hasher = hashlib.sha1()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                hasher.update(chunk)
        h = hasher.hexdigest()
    except OSError:
        h = "absent"
    _memo[path] = h
    return h


def record_key(img_names: Sequence[str], img_folder: str,
               roi_boxes: Dict[str, list], num_img: int, num_roi: int,
               fingerprint: str, image_size: int = 224) -> str:
    """Content-addressed key for one record's (grid, roi) feature pair."""
    names = list(img_names or [])[:num_img]
    payload = {
        "images": [[n, file_content_hash(os.path.join(img_folder, n))]
                   for n in names],
        "boxes": [list(map(float, np.asarray(b).reshape(-1)))
                  for n in names for b in roi_boxes.get(n, [])[:num_roi]],
        "num_img": num_img, "num_roi": num_roi, "size": image_size,
        "fingerprint": fingerprint,
    }
    return hashlib.sha1(json.dumps(payload, sort_keys=True)
                        .encode()).hexdigest()


class DiskFeatureCache:
    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        # index = keys with BOTH files present at init (async writes update
        # the in-memory set on completion, so has() never races a writer)
        self._present = {
            name[:-len(".grid.npy")]
            for name in os.listdir(cache_dir) if name.endswith(".grid.npy")
            if os.path.exists(os.path.join(
                cache_dir, name[:-len(".grid.npy")] + ".roi.npy"))
        }
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._pending: list = []

    def __len__(self) -> int:
        return len(self._present)

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._present

    def _path(self, key: str, kind: str) -> str:
        return os.path.join(self.dir, f"{key}.{kind}.npy")

    def load(self, keys: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (grid [n, ...], roi [n, ...]) bf16 CPU tensors."""
        grids, rois = [], []
        for k in keys:
            grids.append(np.load(self._path(k, "grid")))
            rois.append(np.load(self._path(k, "roi")))
        return _from_uint16(np.stack(grids)), _from_uint16(np.stack(rois))

    def store_async(self, keys: Sequence[str], grid, roi,
                    skip_present: bool = True) -> None:
        """Queue per-record writes of (grid[i], roi[i]) on the background
        pool.  `grid`/`roi` may be device tensors — the host fetch happens
        on the worker thread, off the training loop."""
        def write(keys=tuple(keys)):
            g = _to_uint16(grid)
            r = _to_uint16(roi)
            for i, k in enumerate(keys):
                if skip_present and self.has(k):
                    continue
                for kind, arr in (("grid", g[i]), ("roi", r[i])):
                    # np.save appends .npy to names without it — keep the
                    # tmp name .npy-suffixed so the write lands where the
                    # atomic rename expects it (and NOT *.{kind}.npy, which
                    # the init index scan would pick up as a key)
                    tmp = self._path(k, f"{kind}.tmp{os.getpid()}")
                    np.save(tmp, np.ascontiguousarray(arr))
                    os.replace(tmp, self._path(k, kind))  # atomic publish
                with self._lock:
                    self._present.add(k)
        self._pending.append(self._pool.submit(write))

    def flush(self) -> None:
        """Block until queued writes land (end-of-run durability)."""
        for f in self._pending:
            f.result()
        self._pending.clear()


def prefill_hbm_cache(disk: DiskFeatureCache, keys: List[Optional[str]],
                      hbm_cache, chunk: int = 64) -> np.ndarray:
    """Bulk-load every disk-present row into the device feature cache.

    `keys[i]` is row i's record key (None = unknown/uncacheable).  Returns
    the boolean row mask that was loaded — the driver ORs it into its
    `cached_rows` set so the loader's needs_pixels gate skips decoding
    those rows entirely."""
    present = np.array([k is not None and disk.has(k) for k in keys])
    idxs = np.nonzero(present)[0]
    for s in range(0, len(idxs), chunk):
        rows = idxs[s:s + chunk]
        grid, roi = disk.load([keys[i] for i in rows])
        hbm_cache.update(rows.astype(np.int32), grid, roi)
    return present
