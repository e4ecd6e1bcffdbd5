"""Baseline dataset builders.

Behavioral equivalents of the per-baseline Dataset classes:
* mRoBERTa (reference: mROBERTa/train_mroberta_vimacsa_full.py:52-161):
  per-aspect pair tokenization `(aspect.lower(), text.lower())`, max_len=170,
  plus image/ROI tensors (no ROI coords, no aux tag sentence),
* TomBERT (tomROBERTa/train_tomroberta_vimacsa_full.py:51-157): target =
  aspect only (max 16) and sentence = "{asp} </s></s> {text}" (max 170),
* EF-CapTrRoBERTa (EF-CapTrRoBERTa/train_ef_captr_roberta.py:50-115):
  text pair = (review, "{aspect} . {captions}") max 256, captions looked up
  per image with the "hình ảnh bình thường" fallback; text-only.

A copy of `macsa_tpu/data/baselines.py` for the PyTorch port, on the port's
image path and tokenizer (numpy arrays out; nothing here touches a
device).  Frames stay host-normalized float32 (`build_visual_tensors`'
default `pixel_mode`), as in JAX, so the device takes them as they are.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List

import numpy as np

from macsa_tpu_torch.config import ASPECTS
from macsa_tpu_torch.data.images import build_visual_tensors
from macsa_tpu_torch.data.vimacsa import POLA_TO_NUM, display_aspect, parse_labels


def _labels_array(rec: Dict[str, Any]) -> np.ndarray:
    labels = parse_labels(rec.get("text_img_label") or [])
    return np.asarray([POLA_TO_NUM[labels[display_aspect(a)]] for a in ASPECTS],
                      np.int32)


@dataclasses.dataclass
class MRoBERTaDataset:
    records: List[Dict[str, Any]]
    tokenizer: Any
    img_folder: str
    roi_boxes: Dict[str, list]
    num_img: int = 7
    num_roi: int = 7
    max_len: int = 170
    load_images: bool = True

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        text = rec["comment"]
        ids, masks = [], []
        for asp in ASPECTS:
            tok = self.tokenizer(display_aspect(asp).lower(),
                                 text.lower().replace("_", " "),
                                 padding="max_length", truncation=True,
                                 max_length=self.max_len)
            ids.append(tok["input_ids"])
            masks.append(tok["attention_mask"])
        out = {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
            "labels": _labels_array(rec),
            "text": text,
        }
        if self.load_images:
            images, rois, _ = build_visual_tensors(
                rec.get("list_img") or [], self.img_folder, self.roi_boxes,
                self.num_img, self.num_roi)
            out["images"] = images
            out["roi_images"] = rois
        return out


@dataclasses.dataclass
class TomBERTDataset:
    records: List[Dict[str, Any]]
    tokenizer: Any
    img_folder: str
    roi_boxes: Dict[str, list]
    num_img: int = 7
    num_roi: int = 7
    target_len: int = 16
    sentence_len: int = 170
    load_images: bool = True

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        text = rec["comment"]
        t_ids, t_masks, s_ids, s_masks = [], [], [], []
        for asp in ASPECTS:
            disp = display_aspect(asp)
            tgt = self.tokenizer(disp.lower(), max_length=self.target_len,
                                 padding="max_length", truncation=True)
            sent_text = f"{disp} </s></s> {text}".lower().replace("_", " ")
            sent = self.tokenizer(sent_text, max_length=self.sentence_len,
                                  padding="max_length", truncation=True)
            t_ids.append(tgt["input_ids"]); t_masks.append(tgt["attention_mask"])
            s_ids.append(sent["input_ids"]); s_masks.append(sent["attention_mask"])
        out = {
            "target_ids": np.asarray(t_ids, np.int32),
            "target_mask": np.asarray(t_masks, np.int32),
            "input_ids": np.asarray(s_ids, np.int32),
            "attention_mask": np.asarray(s_masks, np.int32),
            "labels": _labels_array(rec),
            "text": text,
        }
        if self.load_images:
            images, rois, _ = build_visual_tensors(
                rec.get("list_img") or [], self.img_folder, self.roi_boxes,
                self.num_img, self.num_roi)
            out["images"] = images
            out["roi_images"] = rois
        return out


@dataclasses.dataclass
class EFCapDataset:
    records: List[Dict[str, Any]]
    tokenizer: Any
    caption_dict: Dict[str, str]
    num_img: int = 7
    max_len: int = 256

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        text = rec["comment"]
        captions = []
        for name in (rec.get("list_img") or [])[:self.num_img]:
            cap = self.caption_dict.get(name) or self.caption_dict.get(
                os.path.basename(name))
            if cap:
                captions.append(cap)
        caption_str = ". ".join(captions) if captions else "hình ảnh bình thường"

        ids, masks = [], []
        for asp in ASPECTS:
            text_b = f"{asp.replace('_', ' ')} . {caption_str}"
            tok = self.tokenizer(text, text_b, max_length=self.max_len,
                                 padding="max_length", truncation=True)
            ids.append(tok["input_ids"])
            masks.append(tok["attention_mask"])
        return {
            "input_ids": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(masks, np.int32),
            "labels": _labels_array(rec),
            "text": text,
        }
