"""Online visual pipeline for single-sample and batch inference.

A copy of `macsa_tpu/inference/pipeline.py` for the PyTorch port, on the
port's image helpers (`data/images.py`): ROI detection with a class-drop
list (reference image_process.py:13-18,115-142), greedy per-category box
merging with epsilon proximity (:69-113), image/ROI aspect-tag prediction
(:144-189) with the two classifiers on their device, and
auxiliary-feature construction (:229-317).  The detector is pluggable:

* `YoloDetector`: ultralytics YOLO v8 behind a gated import (the
  reference's path; neither `ultralytics` nor its weights ship here),
* `PrecomputedDetector`: boxes from a roi_data.csv mapping (the
  training-time source of truth).

The reference's coordinate quirk is kept: detector boxes are (x1, y1, x2,
y2) in image (W, H) space, but the crop unpacks the tuple as (y1, x1, y2,
x2) (image_process.py:152,257: `y1, x1, y2, x2 = coordinates` then
`image[:, x1:x2, y1:y2]`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from macsa_tpu_torch.data.images import crop_roi, decode_image, normalize_coords, resize_normalize

# image_process.py:13-18
DROP_ROI_LIST = [
    "mortor", "car", "fork", "spoon", "knife", "cow", "bus", "cell phone",
    "carrot", "stop sign", "handbag", "train", "backpack", "suitcase",
    "scissors", "boat", "orange", "airplane", "apple", "sport ball", "truck",
    "cat", "tie", "frisbee", "traffic light", "book", "remote", "surfboard",
    "tennis racket", "dinning table", "airplane", "keyboard", "mouse",
    "skateboard", "dining table", "sheep", "teddy bear", "zebra", "kite",
    "bear", "vase", "tv",
]


def are_boxes_nearby(coords1, coords2, epsilon) -> bool:
    """All four corner deltas within epsilon (image_process.py:92-103)."""
    return all(abs(a - b) <= epsilon for a, b in zip(coords1, coords2))


def merge_coordinates(coords1, coords2):
    x1a, y1a, x1b, y1b = coords1
    x2a, y2a, x2b, y2b = coords2
    return (min(x1a, x2a), min(y1a, y2a), max(x1b, x2b), max(y1b, y2b))


def merge_boxes(boxes: List[Dict], epsilon: float) -> Dict[str, Dict]:
    """Greedy per-category merge (image_process.py:69-90), with its counter
    semantics: the suffix counter i increments once per box whose category
    was already seen (merged OR split off), so a non-nearby same-category
    box becomes 'category_<i>' with that running count."""
    merged: Dict[str, Dict] = {}
    i = 1
    for box in boxes:
        category = box["category"]
        coordinates = box["coordinates"]
        if category not in merged:
            merged[category] = {"coordinates": tuple(coordinates), "count": 1}
        else:
            current = merged[category]["coordinates"]
            if are_boxes_nearby(current, coordinates, epsilon):
                merged[category]["coordinates"] = merge_coordinates(current, coordinates)
                merged[category]["count"] += 1
            else:
                merged[f"{category}_{i}"] = {"coordinates": tuple(coordinates), "count": 1}
            i += 1
    return merged


class PrecomputedDetector:
    """Detection from a {image_name: [(x1, x2, y1, y2), ...]} mapping (the
    roi_data.csv source used at training time).  Boxes are returned in the
    detector (x1, y1, x2, y2) order expected by merge/crop."""

    def __init__(self, roi_boxes: Dict[str, list]):
        self.roi_boxes = roi_boxes

    def __call__(self, image_path: str) -> List[Dict]:
        name = os.path.basename(image_path)
        boxes = self.roi_boxes.get(name) or self.roi_boxes.get(image_path) or []
        # csv stores crop-order (x1, x2, y1, y2) on (H, W); the detector's
        # (x1, y1, x2, y2) in (W, H) makes the shared crop quirk round-trip
        return [{"category": f"roi_{j}", "coordinates": [int(y1), int(x1), int(y2), int(x2)]}
                for j, (x1, x2, y1, y2) in enumerate(boxes)]


class YoloDetector:
    """Ultralytics YOLO v8 detection with the drop list
    (image_process.py:115-142).  Optional dependency."""

    def __init__(self, weights_path: str, class_map: Optional[Dict] = None,
                 drop_list: Sequence[str] = tuple(DROP_ROI_LIST)):
        from ultralytics import YOLO  # gated import
        self.model = YOLO(weights_path)
        self.class_map = class_map
        self.drop_list = set(drop_list)

    def __call__(self, image_path: str) -> List[Dict]:
        boxes = []
        for r in self.model(image_path, verbose=False):
            names = self.class_map or r.names
            for b, c in zip(r.boxes.xyxy, r.boxes.cls):
                cls_name = names[int(c)]
                if cls_name in self.drop_list:
                    continue
                x1, y1, x2, y2 = [int(v) for v in b.tolist()]
                boxes.append({"category": cls_name, "coordinates": [x1, y1, x2, y2]})
        return boxes


def _roi_crops(detector, raw: np.ndarray, path: str, eps: float):
    """The merged detections of one image -> [(crop or None, box (x1, x2,
    y1, y2))], through the reference's (y1, x1, y2, x2) unpack quirk."""
    out = []
    for box in merge_boxes(detector(path), eps).values():
        y1, x1, y2, x2 = box["coordinates"]
        out.append((crop_roi(raw, (x1, x2, y1, y2)), (x1, x2, y1, y2)))
    return out


def construct_visual_features(
    detector, list_img_path: Sequence[str], eps: float, num_roi: int,
    num_img: int, size: int = 224,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (images [num_img, S, S, 3], roi_images [num_img, num_roi, S, S, 3],
    roi_coors [num_img, num_roi, 4]), normalized floats, NHWC
    (image_process.py:229-317)."""
    images = np.zeros((num_img, size, size, 3), np.float32)
    rois = np.zeros((num_img, num_roi, size, size, 3), np.float32)
    coors = np.zeros((num_img, num_roi, 4), np.float32)
    for i, path in enumerate(list(list_img_path)[:num_img]):
        raw = decode_image(path)
        if raw is None:
            continue
        images[i] = resize_normalize(raw, size)
        for r, (crop, box) in enumerate(_roi_crops(detector, raw, path, eps)[:num_roi]):
            if crop is not None:
                rois[i, r] = resize_normalize(crop, size)
            coors[i, r] = normalize_coords(box)
    return images, rois, coors


def predict_visual_tags(detector, image_model, roi_model, list_img_path: Sequence[str],
                        aspect_names: Sequence[str], eps: float = 30.0,
                        image_threshold: float = 0.6,
                        size: int = 224) -> Tuple[List[str], List[str]]:
    """Image-level (multi-label sigmoid) and ROI-level (argmax) aspect tags
    (image_process.py:144-211).  The two AspectClassifiers run on the
    device their parameters are on, without autograd."""
    from macsa_tpu_torch.models.aspect_classifier import (predict_image_aspects,
                                                          predict_roi_aspects)
    device = next(image_model.parameters()).device
    image_tags: List[str] = []
    roi_tags: List[str] = []
    with torch.inference_mode():
        for path in list_img_path:
            raw = decode_image(path)
            if raw is None:
                continue
            img = torch.from_numpy(resize_normalize(raw, size)[None]).to(device)
            image_tags.extend(predict_image_aspects(image_model(img), aspect_names,
                                                    image_threshold)[0])
            crops = [resize_normalize(crop, size)
                     for crop, _ in _roi_crops(detector, raw, path, eps) if crop is not None]
            if crops:
                logits = roi_model(torch.from_numpy(np.stack(crops)).to(device))
                roi_tags.extend(predict_roi_aspects(logits, aspect_names))
    return list(dict.fromkeys(image_tags)), list(dict.fromkeys(roi_tags))
