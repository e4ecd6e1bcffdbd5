"""ViMACSA Phase-2 dataset: 6 aspect-prompted tokenized views + visual tensors.

Behavioral equivalent of the reference MACSADataset
(reference: vimacsa_dataset.py:13-202):

* aux tags: image/ROI aspect tags gathered from the two offline-label JSON
  dicts, capped at num_img, deduplicated, 'empty' fallback (:48-65),
* labels: "Aspect#Polarity" strings parsed, missing aspects filled with None
  (:67-81),
* 6 tokenized views per sample, one per aspect:
  text pair = "{asp} </s></s> {text}" + " {img tags} </s></s>  {roi tags}",
  lowercased, '_'->' ', max_length=170, truncation='only_first',
  padding='max_length' (:89-114),
* added_input_mask = ones(170+num_patches) (:106),
* image / ROI tensors per macsa_tpu_torch.data.images.

A copy of `macsa_tpu/data/vimacsa.py` for the PyTorch port (numpy arrays
out; nothing here touches a device).

Determinism note (documented deviation): the reference deduplicates aspect
tags with `list(set(...))` whose order is hash-seed dependent
(vimacsa_dataset.py:59-60) — here first-occurrence order is kept
(dict.fromkeys), which is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np

from macsa_tpu_torch.config import ASPECTS, POLARITIES
from macsa_tpu_torch.data.images import build_visual_tensors

POLA_TO_NUM = {p: i for i, p in enumerate(POLARITIES)}


def _dedupe(items: Sequence[str]) -> List[str]:
    out = list(dict.fromkeys(items))
    return out if out else ["empty"]


def display_aspect(asp: str) -> str:
    """'Public_area' is rendered as 'Public area' (vimacsa_dataset.py:71-72,91-92)."""
    return asp.replace("_", " ") if "_" in asp else asp


def gather_visual_tags(img_names: Sequence[str], dict_image_aspect: Dict,
                       dict_roi_aspect: Dict, num_img: int):
    img_tags: List[str] = []
    roi_tags: List[str] = []
    for name in list(img_names)[:num_img]:
        img_tags.extend(dict_image_aspect.get(name, []))
        roi_tags.extend(dict_roi_aspect.get(name, []))
    return _dedupe(img_tags), _dedupe(roi_tags)


def parse_labels(text_img_label: Sequence[str]) -> Dict[str, str]:
    """["Aspect#Polarity", ...] -> {display aspect: polarity}, missing
    aspects -> 'None' (vimacsa_dataset.py:67-81)."""
    out: Dict[str, str] = {}
    for asp_pol in text_img_label:
        asp, pol = asp_pol.split("#")
        out[display_aspect(asp)] = pol
    for asp in ASPECTS:
        out.setdefault(display_aspect(asp), "None")
    return out


def build_aspect_views(text: str, img_tags: Sequence[str],
                       roi_tags: Sequence[str], tokenizer,
                       max_text_len: int = 170, num_patches: int = 49):
    """-> dict of [A, L] int32 arrays (+ added_mask [A, L+num_patches]).

    The exact tokenization format of vimacsa_dataset.py:96-106."""
    joined = f" {' , '.join(img_tags)} </s></s>  {' , '.join(roi_tags)}"
    joined = joined.lower().replace("_", " ")
    ids, types, masks = [], [], []
    for asp in ASPECTS:
        combine = f"{display_aspect(asp)} </s></s> {text}".lower().replace("_", " ")
        tok = tokenizer(combine, joined, max_length=max_text_len,
                        truncation="only_first", padding="max_length",
                        return_token_type_ids=True)
        ids.append(tok["input_ids"])
        types.append(tok["token_type_ids"])
        masks.append(tok["attention_mask"])
    a = len(ASPECTS)
    return {
        "input_ids": np.asarray(ids, np.int32),
        "token_type_ids": np.asarray(types, np.int32),
        "attention_mask": np.asarray(masks, np.int32),
        "added_mask": np.ones((a, max_text_len + num_patches), np.int32),
    }


@dataclasses.dataclass
class MACSADataset:
    """records: list of dicts with keys 'comment', 'list_img',
    'text_img_label' (the reference's pd.read_json schema,
    run_multimodal_fcmf.py:201-204)."""

    records: List[Dict[str, Any]]
    tokenizer: Any
    img_folder: str
    roi_boxes: Dict[str, list]           # file_name -> [(x1,x2,y1,y2), ...]
    dict_image_aspect: Dict[str, list]
    dict_roi_aspect: Dict[str, list]
    num_img: int = 7
    num_roi: int = 7
    max_text_len: int = 170
    num_patches: int = 49
    load_images: bool = True
    pixel_mode: str = "f32"  # f32 | packed | u8 (see images.build_visual_tensors)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.records[idx]
        text = rec["comment"]
        img_names = rec.get("list_img") or []

        img_tags, roi_tags = gather_visual_tags(
            img_names, self.dict_image_aspect, self.dict_roi_aspect, self.num_img)
        views = build_aspect_views(text, img_tags, roi_tags, self.tokenizer,
                                   self.max_text_len, self.num_patches)
        labels = parse_labels(rec.get("text_img_label") or [])
        views["labels"] = np.asarray(
            [POLA_TO_NUM[labels[display_aspect(a)]] for a in ASPECTS], np.int32)

        if self.load_images:
            images, rois, coors = build_visual_tensors(
                img_names, self.img_folder, self.roi_boxes,
                self.num_img, self.num_roi, pixel_mode=self.pixel_mode)
            views["images"] = images
            views["roi_images"] = rois
            views["roi_coors"] = coors
        views["text"] = text  # raw text for prediction dumps (:202)
        return views
