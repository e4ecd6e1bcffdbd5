"""Shared driver plumbing: metadata loading, text normalization, the text
config, pretrained-weight import, the extractor's fingerprint, the device
flags, the host->device batch copy and the per-epoch record.

The device-free helpers of `macsa_tpu/train/common.py`, copied for the
PyTorch port (reference: run_multimodal_fcmf.py:170-244): roi_data.csv
(+'.png' suffix), the two offline label JSONs (hard prerequisites: explicit
errors if missing, :188-199), train/dev/test JSON with comment
normalization.  The weight importers are torch state-dict loads: a
`pytorch_model.bin` in the model directory for the text backbone, a
torchvision `.pth` for the ResNet; the random init is kept with a warning
when no file exists, as there.  The tokenizer loader lives in
`data/tokenizer.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from macsa_tpu_torch.config import TextEncoderConfig
from macsa_tpu_torch.data.images import roi_boxes_from_csv
from macsa_tpu_torch.data.text_preprocess import TextNormalize, convert_unicode
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.utils.logging import SPANS, span

_HF_FIELDS = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "intermediate_size", "max_position_embeddings")
_HF_DEFAULTS = {"type_vocab_size": 1, "pad_token_id": 1, "layer_norm_eps": 1e-5,
                "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
_BACKBONE_PREFIXES = ("roberta.", "bert.", "cell.", "model.")
_NUMPY_KEYS_NOT_SENT = ("_idx", "orig_idx", "text", "pad_mask")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; this driver runs on "
                           "the card unless --device cpu is given")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu devices are driven")
    return device


def resolve_fused_attention(flag: str, device: torch.device) -> bool:
    if flag == "off":
        return False
    if flag == "on" and device.type != "cuda":
        raise ValueError("--fused_attention on needs a CUDA device: the kernel has no CPU "
                         "form (use auto or off with --device cpu)")
    return device.type == "cuda"


def to_device(batch: dict, device: torch.device) -> dict:
    """A loader batch's arrays as tensors on `device` (indices, texts and
    the pad mask stay on the host)."""
    with span("h2d", device=True) as traced:
        sent = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
                for k, v in batch.items()
                if k not in _NUMPY_KEYS_NOT_SENT and not isinstance(v, list)}
        if traced is not None:
            traced.counts["bytes"] = sum(t.nbytes for t in sent.values())
        return sent


class EpochMeter:
    """What a driver records of one train epoch: its steps and samples, its
    seconds (`time.perf_counter`: the wall clock can step mid-epoch), the
    time the host waited for the loader, the kernels launched
    (`ops.cuda_lib.launch_counts`, the difference over the epoch) and,
    where spans ran in the epoch (under a profiler: `--profile_dir`), each
    span's host milliseconds a traced step (`span_host_ms_per_step`, from
    `utils.logging.SPANS`' totals over the step roots closed in the epoch).

        meter = EpochMeter(epoch, int(state.step))
        for batch in meter.batches(loader):
            ...step...
            meter.count(batch_size)
        record = meter.stop(losses=...)
    """

    def __init__(self, epoch: int, first_step: int):
        self._counts = cuda_lib.launch_counts
        self._launches0 = dict(self._counts)
        self._spans0 = SPANS.snapshot()
        self.epoch, self.first_step = epoch, first_step
        self.steps, self.samples, self.waited = 0, 0, 0.0
        self.t0 = time.perf_counter()

    def batches(self, loader) -> Iterator[dict]:
        it = iter(loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(it, None)
            self.waited += time.perf_counter() - t_wait
            if batch is None:
                return
            yield batch

    def count(self, batch_size: int) -> None:
        self.steps += 1
        self.samples += batch_size

    def rate(self) -> float:
        """Samples a second so far."""
        return self.samples / (time.perf_counter() - self.t0)

    def stop(self, **extra) -> dict:
        """End the epoch's clock -> its record, with `extra` added."""
        self.seconds = time.perf_counter() - self.t0
        launched = {k: v - self._launches0.get(k, 0) for k, v in self._counts.items()
                    if v != self._launches0.get(k, 0)}
        record = {"epoch": self.epoch, "first_step": self.first_step, "steps": self.steps,
                  "samples": self.samples, "seconds": self.seconds,
                  "loader_wait_seconds": self.waited, **extra, "kernel_launches": launched}
        (steps0, ns0), (steps1, ns1) = self._spans0, SPANS.snapshot()
        if steps1 > steps0:
            record["span_host_ms_per_step"] = {
                k: (v - ns0.get(k, 0)) * 1e-6 / (steps1 - steps0) for k, v in ns1.items()
                if v != ns0.get(k, 0)}
        return record

    def write(self, writer, step: int, **extra) -> None:
        """The epoch's line of `metrics.jsonl` (after `stop`)."""
        if self.steps:
            writer.write(step, epoch=self.epoch, epoch_steps=self.steps,
                         epoch_seconds=self.seconds,
                         epoch_samples_per_s=self.samples / self.seconds,
                         loader_wait_seconds=self.waited, **extra)


def normalize_comment(text: str, normalizer: Optional[TextNormalize] = None) -> str:
    """convert_unicode -> (underthesea text_normalize when available) ->
    TextNormalize.normalize — the reference's chain
    (run_multimodal_fcmf.py:204-205)."""
    normalizer = normalizer or TextNormalize()
    text = convert_unicode(text)
    try:  # optional external dependency; identity when absent
        from underthesea import text_normalize as uts_normalize
        text = uts_normalize(text)
    except ImportError:
        pass
    return normalizer.normalize(text)


def load_records(path: str, normalize: bool = True) -> List[Dict[str, Any]]:
    """A {column: {row: value}} or list-of-dicts JSON -> list of records."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # pandas orient='columns'
        cols = list(data.keys())
        row_keys = list(next(iter(data.values())).keys())
        records = [{c: data[c][rk] for c in cols} for rk in row_keys]
    else:
        records = list(data)
    if normalize:
        tn = TextNormalize()
        for rec in records:
            rec["comment"] = normalize_comment(rec.get("comment", ""), tn)
    return records


def load_metadata(data_dir: str):
    """-> (roi_boxes, dict_image_aspect, dict_roi_aspect).

    Required-file validation with explicit errors, like the reference
    (run_multimodal_fcmf.py:181-199)."""
    roi_csv = os.path.join(data_dir, "roi_data.csv")
    if not os.path.exists(roi_csv):
        raise ValueError(f"Can't find roi_data.csv under {data_dir}")
    roi_boxes = roi_boxes_from_csv(roi_csv)

    img_json = os.path.join(data_dir, "resnet152_image_label.json")
    roi_json = os.path.join(data_dir, "resnet152_roi_label.json")
    if not (os.path.exists(img_json) and os.path.exists(roi_json)):
        raise ValueError(
            "Get image/roi aspect category first. Please run "
            "tools/image_categories.py or tools/roi_categories.py")
    with open(img_json) as f:
        dict_image_aspect = json.load(f)
    with open(roi_json) as f:
        dict_roi_aspect = json.load(f)
    return roi_boxes, dict_image_aspect, dict_roi_aspect


def text_config_from_hf(hf_config: Dict[str, Any], dtype: str = "float32") -> TextEncoderConfig:
    """`TextEncoderConfig.from_hf_config` of the JAX package, on the dict
    read from a model directory's `config.json`."""
    return TextEncoderConfig(**{k: hf_config[k] for k in _HF_FIELDS},
                             **{k: hf_config.get(k, d) for k, d in _HF_DEFAULTS.items()},
                             dtype=dtype)


def build_text_config(pretrained_path: Optional[str], dtype: str = "bfloat16",
                      fused_attention: bool = False) -> TextEncoderConfig:
    if pretrained_path and os.path.exists(os.path.join(pretrained_path, "config.json")):
        with open(os.path.join(pretrained_path, "config.json")) as f:
            cfg = text_config_from_hf(json.load(f), dtype=dtype)
    else:
        cfg = TextEncoderConfig(dtype=dtype)
    return dataclasses.replace(cfg, fused_attention=bool(fused_attention))


def import_text_params(model, pretrained_path: Optional[str], logger=None,
                       resize_vocab_to: Optional[int] = None, cell=None) -> bool:
    """Load HF backbone weights (`pytorch_model.bin` under `pretrained_path`)
    into `cell` in place, by default `model.encoder.bert.cell` (the FCMF's;
    a baseline passes its `roberta`).  The random init is kept, with a
    warning, when no weight file exists.  -> whether weights were loaded.

    `resize_vocab_to` resizes the file's word-embedding table first
    (`checkpoints.resize_embedding`): the Phase-1 model's tied token table,
    which the backbone's word embeddings are, has the tokenizer's length."""
    bin_path = os.path.join(pretrained_path or "", "pytorch_model.bin")
    if not os.path.exists(bin_path):
        if logger:
            logger.warning(f"no HF weights under {pretrained_path} (no pytorch_model.bin); "
                           "keeping random init")
        return False
    cell = model.encoder.bert.cell if cell is None else cell
    wanted = set(cell.state_dict())
    sd = {}
    for key, value in torch.load(bin_path, map_location="cpu", weights_only=True).items():
        for prefix in _BACKBONE_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
        if key in wanted:  # heads and bookkeeping buffers of the checkpoint are dropped
            sd[key] = value
    table = "embeddings.word_embeddings.weight"
    if resize_vocab_to is not None and table in sd:
        from macsa_tpu_torch.train.checkpoints import resize_embedding
        sd[table] = resize_embedding(sd[table], resize_vocab_to)
    cell.load_state_dict(sd, strict=True)
    return True


def import_resnet_params(visual, weights_path: Optional[str], logger=None) -> bool:
    """Load a torchvision resnet state-dict file into `visual` in place.
    Strict but for the classifier `fc.*` and the `num_batches_tracked`
    counters, the only keys a backbone without a head has no place for."""
    if not weights_path or not os.path.exists(weights_path):
        if logger:
            logger.warning("no torchvision resnet weights; keeping random init")
        return False
    sd = {k: v for k, v in torch.load(weights_path, map_location="cpu",
                                      weights_only=True).items()
          if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}
    visual.load_state_dict(sd, strict=True)
    return True


def resnet_fingerprint(weights_path: Optional[str], rcfg, seed: int) -> str:
    """Identity of the visual extractor for the on-disk feature cache
    (train/disk_feature_cache.py): weights SOURCE (file content hash, or
    the init seed when training from random init) + the config fields that
    change the emitted features.  Hashing the source instead of the live
    parameters avoids fetching ~240 MB of device arrays per run."""
    if weights_path and os.path.exists(weights_path):
        from macsa_tpu_torch.train.disk_feature_cache import file_content_hash
        src = f"torchvision:{file_content_hash(weights_path)}"
    else:
        # not the JAX package's "randominit": the two packages draw other
        # weights from one seed, so their entries must not meet in one directory
        src = f"randominit-torch:seed{seed}"
    return (f"{src}|stages{','.join(map(str, rcfg.stage_sizes))}"
            f"|f{rcfg.num_filters}|g{rcfg.grid_size}|{rcfg.dtype}")
