"""ResNet-152 + Linear aspect classifiers for images and ROIs, in PyTorch.

Counterpart of `macsa_tpu/models/aspect_classifier.py` (reference:
fcmf_framework/image_process.py:29-49, image_processing/
run_image_categories.py, run_roi_categories.py): the port's ResNet, the
mean over H and W, then an f32 Linear(2048, num_classes).  The image
variant is multi-label (sigmoid > threshold), the ROI variant single-label
(argmax); the module is shared.

State-dict names are the reference MyImgModel/MyRoIModel's:
`feature_extractor.<torchvision names>` and `linear.{weight,bias}`, so
`macsa_tpu.models.aspect_classifier.import_torch_aspect_classifier` reads a
port state dict, and a reference `.pth` loads through
`reference_state_dict` (its `no_fc.*` views of the same tensors dropped).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.models.layers import Dense
from macsa_tpu_torch.models.resnet import ResNet


class AspectClassifier(nn.Module):
    def __init__(self, num_classes: int, config: ResNetConfig = ResNetConfig(), device=None):
        super().__init__()
        self.config = config
        self.feature_extractor = ResNet(config, device=device)
        width = config.num_filters * 2 ** (len(config.stage_sizes) - 1) * 4
        self.linear = Dense(width, num_classes, torch.float32, device=device)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[..., H, W, 3] normalized floats -> [..., 2048] pooled features."""
        lead = tuple(images.shape[:-3])
        flat = images.reshape((-1,) + tuple(images.shape[-3:]))
        feat = self.feature_extractor(flat.permute(0, 3, 1, 2))  # channels-last NCHW view
        return feat.mean(dim=(2, 3)).reshape(lead + (feat.shape[1],))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """[..., H, W, 3] -> f32 logits [..., num_classes]."""
        return self.linear(self.features(images).float())


def predict_image_aspects(logits: torch.Tensor, aspect_names: Sequence[str],
                          threshold: float = 0.45) -> List[List[str]]:
    """Multi-label sigmoid > threshold (run_image_categories.py:339 uses
    0.45; the inference path 0.6, image_process.py:186)."""
    probs = torch.sigmoid(logits.float()).cpu()
    return [[aspect_names[i] for i in torch.nonzero(row > threshold).flatten().tolist()]
            for row in probs]


def predict_roi_aspects(logits: torch.Tensor, aspect_names: Sequence[str]) -> List[str]:
    """Single-label argmax (image_process.py:156-158)."""
    return [aspect_names[i] for i in logits.argmax(dim=-1).cpu().tolist()]


def reference_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference MyImgModel/MyRoIModel state dict -> this module's: the
    `no_fc.*` duplicates, torchvision's unused `fc` head and the BN
    counters dropped (the JAX importer ignores the same keys)."""
    return {k: torch.as_tensor(v) for k, v in state_dict.items()
            if not k.startswith(("no_fc.", "feature_extractor.fc."))
            and not k.endswith("num_batches_tracked")}
