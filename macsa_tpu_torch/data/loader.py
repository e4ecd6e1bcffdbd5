"""Host-side data loading: batching, shuffling, worker pool, prefetch,
epoch-persistent feature caching, and per-host sharding.

Replaces the reference's torch DataLoader + DistributedSampler
(reference: run_multimodal_fcmf.py:421-424, run_pretraining_fcmf.py:281) and
fixes its two throughput sinks: (a) images are decoded/resized/cropped again
every epoch (vimacsa_dataset re-reads in __getitem__) — here samples are
memoized after first touch when `cache=True`; (b) batches are prefetched on a
background thread pool so host work overlaps device steps.

A copy of `macsa_tpu/data/loader.py` for the PyTorch port (numpy batches
out).  The per-host sharding arguments stay in the signature, but more than
one host raises until data parallelism over several processes is ported.
"""

from __future__ import annotations

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]

_ARRAY_KEYS_EXCLUDED = ("text", "target_aspect")


class ThreadSafeTokenizer:
    """Per-thread tokenizer copies.

    HF *fast* tokenizers are not thread-safe (concurrent encode raises
    `RuntimeError: Already borrowed` from the Rust core); the loader's worker
    pool calls dataset.__getitem__ concurrently, so each worker thread gets
    its own lazily-deepcopied tokenizer.  Falls back to a lock if the
    tokenizer cannot be deepcopied."""

    def __init__(self, tokenizer):
        self._base = tokenizer
        self._local = threading.local()
        self._lock = threading.Lock()

    def _get(self):
        tok = getattr(self._local, "tok", None)
        if tok is None:
            try:
                tok = copy.deepcopy(self._base)
            except Exception:
                tok = None  # un-copyable: serialize through the lock
            self._local.tok = tok if tok is not None else False
            return self._local.tok
        return tok

    def __call__(self, *args, **kwargs):
        tok = self._get()
        if tok is False:
            with self._lock:
                return self._base(*args, **kwargs)
        return tok(*args, **kwargs)

    def __getattr__(self, name):  # pad_token_id, decode, ...
        return getattr(self._base, name)

    def __len__(self):
        return len(self._base)


def collate(samples: Sequence[Dict[str, Any]]) -> Batch:
    """Stack per-sample dicts into batch arrays; string fields become lists."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        if k in _ARRAY_KEYS_EXCLUDED:
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


class DataLoader:
    """`cache=True` memoizes *light* samples only — every key EXCEPT the raw
    pixel tensors (`pixel_keys`).  Caching whole samples would retain the
    float32 pixels too (~21 MB/sample at reference shapes: 35 frames x
    224^2 x 3 x 4B => ~60 GB for the 2,876-sample ViMACSA train split); the
    light entries are a few KB each (tokens/labels/coords).

    Pixels are re-read from the dataset whenever a batch still needs them,
    decided per batch by `needs_pixels(dataset_index) -> bool`:
    * None (default): every batch carries pixels (fresh decode per epoch —
      the reference's own behavior, vimacsa_dataset.py:123-199);
    * driver-provided (finetune/pretrain): backed by the HBM visual feature
      cache's seen-rows set, so pixels are decoded exactly until the feature
      cache owns that row's features, then never again.
    A batch omits the pixel keys entirely only when ALL its rows report
    warm, so collate always sees uniform keys; `needs_pixels` must be
    monotonic (False stays False), which seen-row sets are.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, num_workers: int = 8,
                 prefetch: int = 2, cache: bool = False,
                 num_hosts: int = 1, host_id: int = 0,
                 pixel_keys: Sequence[str] = ("images", "roi_images"),
                 needs_pixels: Optional[Callable[[int], bool]] = None,
                 eval_stripe: bool = False):
        if num_hosts != 1 or host_id != 0:
            raise NotImplementedError(
                f"num_hosts={num_hosts}, host_id={host_id}: multi-host loading waits for the "
                "port's data parallelism (ROADMAP queue 1, the bench item's DDP step)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        self.pixel_keys = tuple(pixel_keys)
        self._needs_pixels = needs_pixels
        self._cache: Optional[dict] = {} if cache else None
        # Lockstep eval sharding over hosts: global step s covers dataset
        # rows [s*G, (s+1)*G), G = num_hosts*batch_size; this host feeds the
        # stripe [s*G + host_id*B, ...+B).  Every host yields the SAME number
        # of full-size batches (SPMD steps must run in lockstep on every
        # host); out-of-range slots are filled with clone rows marked
        # `_idx == -1`.  Replaces replicated eval (every host computing the
        # whole dev set) — each row is computed once, on one dp shard.
        self.eval_stripe = eval_stripe
        self._eval_num_hosts, self._eval_host_id = num_hosts, host_id
        if eval_stripe:
            assert not shuffle and not drop_last, \
                "eval_stripe is for deterministic full-coverage eval"
            self._indices = list(range(len(dataset)))
            return
        # per-host shard (contiguous slice, reference style
        # run_pretraining_fcmf.py:170-172)
        n = len(dataset)
        per_host = n // num_hosts if num_hosts > 1 else n
        self._indices = (list(range(per_host * host_id, per_host * (host_id + 1)))
                         if num_hosts > 1 else list(range(n)))

    def set_epoch(self, epoch: int) -> None:
        """DistributedSampler.set_epoch equivalent (run_multimodal_fcmf.py:428)."""
        self.epoch = epoch

    def __len__(self) -> int:
        if self.eval_stripe:
            g = self._eval_num_hosts * self.batch_size
            return -(-len(self.dataset) // g)
        n = len(self._indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _strip(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        return {k: v for k, v in sample.items() if k not in self.pixel_keys}

    def _get(self, i: int, with_pixels: bool = True):
        if self._cache is None:
            sample = self.dataset[i]
            return sample if with_pixels else self._strip(sample)
        light = self._cache.get(i)
        if light is None:
            sample = self.dataset[i]
            light = self._strip(sample)
            self._cache[i] = light
            return sample if with_pixels else light
        if with_pixels:
            # rare: a warm-cached row sharing a batch with a cold row (the
            # shuffled drop_last tail differs across epochs) — re-decode
            return self.dataset[i]
        return light

    def _stripe_batches(self):
        """[(content_idxs, report_idxs, global_step_rows)] per lockstep step."""
        n = len(self.dataset)
        nh, b = self._eval_num_hosts, self.batch_size
        g = nh * b
        out = []
        for s in range(-(-n // g)):
            base = s * g + self._eval_host_id * b
            content = [i if i < n else i % n for i in range(base, base + b)]
            report = [i if i < n else -1 for i in range(base, base + b)]
            out.append((content, report, range(s * g, min((s + 1) * g, n))))
        return out

    def __iter__(self) -> Iterator[Batch]:
        if self.eval_stripe:
            return self._iter_batches(self._stripe_batches())
        order = list(self._indices)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return self._iter_batches([(b, b, b) for b in batches])

    def _iter_batches(self, batches) -> Iterator[Batch]:
        """batches: [(content_idxs, report_idxs, pixel_gate_rows)].
        `pixel_gate_rows` is the index set the needs_pixels decision is made
        over — in stripe mode the GLOBAL step rows, so every host makes the
        same light-vs-pixels call (a divergent call would feed a pixel-less
        batch into a collective compute path on one host only)."""
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # Any worker exception is forwarded to the consumer and re-raised
            # there — a silently-truncated epoch is a correctness bug.
            try:
                for idxs, report, gate_rows in batches:
                    if stop.is_set():
                        return
                    with_pixels = (self._needs_pixels is None
                                   or any(self._needs_pixels(i)
                                          for i in gate_rows))
                    samples = list(pool.map(
                        lambda i: self._get(i, with_pixels), idxs))
                    out = collate(samples)
                    # per-sample dataset indices (feature-cache keys;
                    # -1 marks clone/pad rows whose outputs are discarded)
                    out["_idx"] = np.asarray(report, np.int32)
                    q.put(out)
                q.put(None)
            except BaseException as e:  # noqa: BLE001
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)


def pad_batch(batch: Batch, target: int) -> Batch:
    """Zero-pad the batch dim to `target` (static shapes for the last partial
    batch, so the step's shapes never change); returns (padded batch incl. 'pad_mask')."""
    b = next(v for k, v in batch.items() if not isinstance(v, list)).shape[0]
    if b == target:
        out = dict(batch)
        out["pad_mask"] = np.ones((target,), np.bool_)
        return out
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = v + [v[-1]] * (target - b)
        else:
            # "_idx" pads with -1 so feature-cache scatters drop pad rows
            fill = -1 if k == "_idx" else 0
            pad = np.full((target - b,) + v.shape[1:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=0)
    mask = np.zeros((target,), np.bool_)
    mask[:b] = True
    out["pad_mask"] = mask
    return out
