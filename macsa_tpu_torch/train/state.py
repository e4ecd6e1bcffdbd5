"""Train state: the trainable model, the frozen visual backbone, the
optimizer (which holds the LR schedules) and the step counter.

Counterpart of `macsa_tpu/train/state.py` (`TrainState`).  The reference
trains with the CNN frozen (`if_fine_tune=False`, resnet_utils.py:26-28),
and so does this state; `fine_tune_cnn` is not ported yet.
"""

from __future__ import annotations

import dataclasses

from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    visual: nn.Module    # frozen: runs under no_grad, never optimized
    optimizer: object    # `step()` / `zero_grad()` over the model's parameters
    step: int = 0        # train steps taken (micro-steps under accumulation)

    @classmethod
    def create(cls, model: nn.Module, visual: nn.Module, optimizer,
               fine_tune_cnn: bool = False) -> "TrainState":
        if fine_tune_cnn:
            raise NotImplementedError("fine_tune_cnn (training the ResNet) is not ported yet")
        visual.requires_grad_(False)
        return cls(model=model, visual=visual, optimizer=optimizer)

    def apply_gradients(self) -> None:
        """Take the model's `.grad`s through the optimizer and clear them."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
