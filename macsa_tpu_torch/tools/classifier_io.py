"""Load and save AspectClassifier weights.

Counterpart of `macsa_tpu/tools/classifier_io.py`: orbax there, one torch
file here (written to a temporary name and renamed, as
`train/checkpoints.py` writes, so a reader never sees half a file), which
also records the classifier's ResNet configuration.  A reference `.pth` (a
bare MyImgModel/MyRoIModel state dict) loads too, as a ResNet-152 under
the default `ResNetConfig`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.models.aspect_classifier import AspectClassifier, reference_state_dict

FORMAT = "macsa_tpu_torch.aspect_classifier.v1"


def save_classifier(path: str, model: AspectClassifier) -> None:
    payload = {"format": FORMAT, "config": dataclasses.asdict(model.config),
               "model": {k: v.detach().to("cpu", copy=True)
                         for k, v in model.state_dict().items()}}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_classifier(path: str, model: Optional[AspectClassifier] = None,
                    device=None) -> AspectClassifier:
    """A file of `save_classifier`, or a reference `.pth`, loaded (strict)
    into `model`, or into a new AspectClassifier of the file's
    configuration on `device`."""
    got = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(got, dict) and got.get("format") == FORMAT:
        sd = got["model"]
        config = ResNetConfig(**{**got["config"],
                                 "stage_sizes": tuple(got["config"]["stage_sizes"])})
    else:
        sd, config = reference_state_dict(got), ResNetConfig()
    if model is None:
        model = AspectClassifier(sd["linear.weight"].shape[0], config, device=device)
    model.load_state_dict(sd, strict=True)
    return model
