"""Train state: the trainable model, the visual backbone, the optimizer
(which holds the LR schedules) and the step counter.

Counterpart of `macsa_tpu/train/state.py` (`TrainState`).  The reference
trains with the CNN frozen (`if_fine_tune=False`, resnet_utils.py:26-28),
and so does this state by default.  With `fine_tune_cnn` the ResNet trains
too: its convolutions and all four tensors of every FrozenBatchNorm join
the model's parameters in the one optimizer, as JAX hands the
`(params, visual_params)` tuple to one optax transformation.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from macsa_tpu_torch.models.resnet import trainable_batchnorm_


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    visual: nn.Module    # frozen (no_grad, never optimized) unless fine_tune_cnn
    optimizer: object    # `step()` / `zero_grad()` over the trained parameters
    step: int = 0        # train steps taken (micro-steps under accumulation)
    fine_tune_cnn: bool = False

    @classmethod
    def create(cls, model: nn.Module, visual: nn.Module, optimizer,
               fine_tune_cnn: bool = False) -> "TrainState":
        """`optimizer` is built over the model; with `fine_tune_cnn` the
        ResNet's parameters are added to it (`optim.AdamW.add_module`)."""
        if fine_tune_cnn:
            trainable_batchnorm_(visual).requires_grad_(True)
            optimizer.add_module(visual)
        else:
            visual.requires_grad_(False)
        return cls(model=model, visual=visual, optimizer=optimizer,
                   fine_tune_cnn=fine_tune_cnn)

    def apply_gradients(self) -> None:
        """Take the parameters' `.grad`s through the optimizer and clear them."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
