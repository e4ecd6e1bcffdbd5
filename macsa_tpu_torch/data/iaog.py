"""IAOG Phase-1 dataset: review x aspect seq2seq samples.

Behavioral equivalent of the reference IAOGDataset (reference: iaog_dataset.py):

* sample expansion: each review expands into one sample per aspect that has
  nonempty `iaog_labels` ("sentiment#Aspect"); sentiment words are grouped
  per aspect, deduplicated in order, and *sorted* when joined
  (iaog_dataset.py:30-60),
* encoder input: same aspect-prompted two-segment tokenization as Phase 2
  (:79-87),
* decoder input: "{aspect} {words , joined}" lowercased, '_'->' ', tokenized
  to max_len_decoder; labels = roll(dec_ids, -1) with the last slot and pad
  positions set to -100 (:89-96),
* same visual tensor construction.

A copy of `macsa_tpu/data/iaog.py` for the PyTorch port (numpy arrays out;
nothing here touches a device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from macsa_tpu_torch.config import ASPECTS
from macsa_tpu_torch.data.images import build_visual_tensors
from macsa_tpu_torch.data.vimacsa import display_aspect, gather_visual_tags

IGNORE_INDEX = -100


def group_iaog_labels(iaog_labels: List[str]) -> Dict[str, List[str]]:
    """["word#Aspect", ...] -> {aspect: [unique words in order]}
    (iaog_dataset.py:37-48)."""
    groups: Dict[str, List[str]] = {}
    valid = set(ASPECTS)
    for label in iaog_labels or []:
        if "#" not in label:
            continue
        word, aspect = label.split("#", 1)
        word, aspect = word.strip(), aspect.strip()
        if aspect in valid:
            bucket = groups.setdefault(aspect, [])
            if word not in bucket:
                bucket.append(word)
    return groups


def build_decoder_ids(aspect: str, words: List[str], tokenizer,
                      max_len_decoder: int):
    """-> (dec_input_ids [T], labels [T]) with shifted labels and -100 masking
    (iaog_dataset.py:89-96)."""
    target = " , ".join(sorted(words))
    dec_text = f"{aspect} {target}".lower().replace("_", " ")
    dec = tokenizer(dec_text, max_length=max_len_decoder,
                    padding="max_length", truncation=True)
    ids = np.asarray(dec["input_ids"], np.int32)
    labels = np.roll(ids, -1)
    labels[-1] = IGNORE_INDEX
    labels[labels == tokenizer.pad_token_id] = IGNORE_INDEX
    return ids, labels


@dataclasses.dataclass
class IAOGDataset:
    records: List[Dict[str, Any]]
    tokenizer: Any
    img_folder: str
    roi_boxes: Dict[str, list]
    dict_image_aspect: Dict[str, list]
    dict_roi_aspect: Dict[str, list]
    num_img: int = 7
    num_roi: int = 4
    max_text_len: int = 170
    num_patches: int = 49
    max_len_decoder: int = 20
    load_images: bool = True
    pixel_mode: str = "f32"  # f32 | packed | u8 (see images.build_visual_tensors)

    def __post_init__(self):
        self.samples = []
        for idx, rec in enumerate(self.records):
            for aspect, words in group_iaog_labels(rec.get("iaog_labels")).items():
                self.samples.append(
                    {"original_idx": idx, "target_aspect": aspect,
                     "words": words})

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self.samples[idx]
        rec = self.records[sample["original_idx"]]
        text = rec["comment"]
        img_names = rec.get("list_img") or []
        aspect = sample["target_aspect"]

        img_tags, roi_tags = gather_visual_tags(
            img_names, self.dict_image_aspect, self.dict_roi_aspect, self.num_img)
        joined = f" {' , '.join(img_tags)} </s></s>  {' , '.join(roi_tags)}"
        joined = joined.lower().replace("_", " ")
        combine = f"{display_aspect(aspect)} </s></s> {text}".lower().replace("_", " ")
        enc = self.tokenizer(combine, joined, max_length=self.max_text_len,
                             truncation="only_first", padding="max_length",
                             return_token_type_ids=True)
        dec_ids, labels = build_decoder_ids(aspect, sample["words"],
                                            self.tokenizer, self.max_len_decoder)
        out = {
            # original review index: samples from the same review share
            # images, so the frozen-CNN feature cache keys on this
            "orig_idx": np.asarray(sample["original_idx"], np.int32),
            "enc_input_ids": np.asarray(enc["input_ids"], np.int32),
            "token_type_ids": np.asarray(enc["token_type_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
            "added_mask": np.ones((self.max_text_len + self.num_patches,),
                                  np.int32),
            "dec_input_ids": dec_ids,
            "labels": labels,
            "target_aspect": aspect,
            "text": text,
        }
        if self.load_images:
            images, rois, coors = build_visual_tensors(
                img_names, self.img_folder, self.roi_boxes,
                self.num_img, self.num_roi, pixel_mode=self.pixel_mode)
            out["images"] = images
            out["roi_images"] = rois
            out["roi_coors"] = coors
        return out
