"""Device-resident visual feature cache for frozen-CNN training.

The reference re-runs all 35 ResNet-152 forwards on the SAME images every
epoch (run_multimodal_fcmf.py:448-460) even though the backbone is frozen
(`if_fine_tune=False`, resnet_utils.py:26-28): the features are constant
across epochs.  Here epoch 0 computes them once and copies them into cache
tensors on the step's device; later epochs gather by sample index and skip
both the ResNet stack and the raw-pixel host->device transfer entirely.
Exact: eval-mode BN and no autograd mean the cached features are
bit-identical to recomputation.

Counterpart of `macsa_tpu/train/feature_cache.py`, on torch tensors.

Memory: n_samples x I x (49 + R) x 2048 bf16: ~1.5 MB/sample at the
reference shapes (I=7, R=4), ~4.4 GB for the full ViMACSA train split.

`FeatureCacheFeeder` is what both drivers put between their loader and
their step: the cache of one split, the host-side record of the rows it
owns (the loader's `needs_pixels` gate reads it), the prefill from and the
writes to the on-disk cache (`train/disk_feature_cache.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train.common import to_device
from macsa_tpu_torch.train.disk_feature_cache import prefill_hbm_cache
from macsa_tpu_torch.train.steps import extract_visual


class VisualFeatureCache:
    def __init__(self, n_samples: int, num_imgs: int, num_roi: int,
                 num_patches: int = 49, feat_dim: int = 2048,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        self.n = n_samples
        self.grid = torch.zeros((n_samples, num_imgs, num_patches, feat_dim), dtype=dtype,
                                device=device)
        self.roi = torch.zeros((n_samples, num_imgs, num_roi, feat_dim), dtype=dtype,
                               device=device)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.grid, self.roi))

    def _index(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=self.grid.device)

    @torch.no_grad()
    def update(self, idx, grid: torch.Tensor, roi: torch.Tensor) -> None:
        """Rows `idx` <- (grid, roi), in place.  Padded eval rows carry
        index -1 and are dropped."""
        idx = np.asarray(idx)
        keep = np.nonzero(idx >= 0)[0]
        rows, keep = self._index(idx[keep]), self._index(keep)
        dev = self.grid.device
        self.grid.index_copy_(0, rows, grid.to(dev)[keep].to(self.grid.dtype))
        self.roi.index_copy_(0, rows, roi.to(dev)[keep].to(self.roi.dtype))

    def lookup(self, idx) -> Tuple[torch.Tensor, torch.Tensor]:
        """(grid, roi) of rows `idx`; an index of -1 reads the last row, as
        it does in the JAX cache (a pad row's output is discarded)."""
        idx = self._index(idx)
        return self.grid[idx], self.roi[idx]


class FeatureCacheFeeder:
    """Loader batches (numpy) -> device batches whose raw pixels are
    replaced with the (possibly cached) visual features of each row.

    A row of the cache belongs to `batch[index_key][i]`: the sample index
    (`_idx`) in Phase 2, the original review's index (`orig_idx`) in Phase 1,
    where the samples of one review share its images.  Built BEFORE the
    loader starts, so that rows prefilled from `disk_cache` skip host
    decoding from the first step (`needs_pixels` consults `owned`, which
    the prefill marks).  `keys[i]` is row i's content key in `disk_cache`.

    Under data parallelism each rank's cache holds the rows that rank
    computed (`filled`), where JAX's one global cache holds every rank's.
    A step is warm on a rank when all its own rows are filled, so a rank
    never reads a row a peer computed: in Phase 1 the samples of one review
    can sit on both sides of the train shards' boundary, and each rank
    extracts that review once for itself.  `owned` is the union over the
    ranks, kept from every rank's row indices of the step
    (`parallel.fetch_global`, JAX's `global_idx`): it is what the eval
    loader's pixel gate reads, which asks about the global step's rows.
    Each eval row is fed by one rank, the same every epoch, so a row owned
    is filled on the rank that feeds it, and a pixel-less batch is warm on
    every rank.  The train loader's gate is off under several processes:
    its batches always carry pixels."""

    def __init__(self, visual, cfg, n_rows: int, device, index_key: str, *,
                 disk_cache=None, keys: Optional[List[str]] = None, logger=None,
                 name: str = "", unit: str = "rows"):
        self.visual, self.device, self.index_key = visual, device, index_key
        self.dtype = cfg.model.torch_dtype
        self.cache = VisualFeatureCache(n_rows, cfg.num_imgs, cfg.num_roi, cfg.num_patches,
                                        cfg.visual_feat_dim, dtype=self.dtype, device=device)
        self.filled = np.zeros(n_rows, np.bool_)  # rows in this rank's cache
        self.owned = np.zeros(n_rows, np.bool_)  # rows in some rank's cache
        self.disk_cache, self.keys = disk_cache, keys
        if logger:
            logger.info(f"visual feature cache{name}: {self.cache.nbytes / 2**20:.0f} MiB "
                        f"on {device}")
        if disk_cache is not None:
            loaded = prefill_hbm_cache(disk_cache, keys, self.cache)
            if loaded.any():
                self.filled |= loaded
                self.owned |= loaded
                if logger:
                    logger.info(f"feature cache{name}: prefilled {int(loaded.sum())}/{n_rows} "
                                f"{unit} from disk ({disk_cache.dir})")

    def needs_pixels(self, row: int) -> bool:
        """Pixels are required only until the cache owns the row."""
        return not self.owned[row]

    def __call__(self, batch: dict) -> dict:
        """Per-batch host-side warm check: drop_last drops a *different*
        tail each epoch, so a later epoch can contain rows the first pass
        never saw: those batches recompute and fill the cache."""
        idx = np.asarray(batch[self.index_key])
        global_idx = mesh.fetch_global(idx)
        sent = to_device(batch, self.device)
        # absent when the loader sent a light (all-rows-warm) batch
        images = sent.pop("images", None)
        roi_images = sent.pop("roi_images", None)
        valid = idx >= 0  # pad rows carry -1
        if self.filled[idx[valid]].all():
            grid, roi = self.cache.lookup(idx)
        else:
            assert images is not None, (
                "cold feature-cache rows in a pixel-less batch: the "
                "loader's needs_pixels gate and the filled rows disagree")
            with torch.no_grad():
                grid, roi = extract_visual(self.visual, images, roi_images, out_dtype=self.dtype)
            self.cache.update(idx, grid, roi)
            self.filled[idx[valid]] = True
            if self.disk_cache is not None:
                rows = np.nonzero(valid)[0]
                self.disk_cache.store_async([self.keys[int(idx[r])] for r in rows],
                                            grid[rows], roi[rows])
        # every rank's rows of the step are now filled on the rank that fed them
        self.owned[global_idx[global_idx >= 0]] = True
        sent["grid"], sent["roi"] = grid, roi
        return sent
