"""The train and eval steps of the baseline models.

Counterpart of `macsa_tpu/train/baseline_steps.py` (reference:
mROBERTa/train_mroberta_vimacsa_full.py:290-560,
tomROBERTa/train_tomroberta_vimacsa_full.py, EF-CapTrRoBERTa/
train_ef_captr_roberta.py): one forward for the three models over the
folded aspect views, the FCMF step's loss (`steps.aspect_loss`: f32 CE,
mean over the rows, summed over the aspects).  The ResNet is frozen: it
runs without autograd, as JAX stops its gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from macsa_tpu_torch.models.baselines import EFCapTrRoBERTa, MRoBERTa, TomBERT
from macsa_tpu_torch.models.layers import DropoutRng
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import _fold_aspects, _tile_visual, aspect_loss, extract_visual

Batch = Dict[str, torch.Tensor]


def baseline_forward(model, visual: Optional[VisualFeatures], batch: Batch,
                     rng: Optional[DropoutRng] = None) -> torch.Tensor:
    """-> logits [B, A, num_labels] for any of the three baselines."""
    text, b, a = _fold_aspects(batch)
    if isinstance(model, EFCapTrRoBERTa):
        logits = model(text["input_ids"], text["attention_mask"], rng=rng)
        return logits.reshape(b, a, -1)
    with torch.no_grad():
        grid, roi = extract_visual(visual, batch["images"], batch["roi_images"],
                                   out_dtype=model.config.torch_dtype)
    grid, roi = _tile_visual(grid, a), _tile_visual(roi, a)
    if isinstance(model, MRoBERTa):
        logits = model(text["input_ids"], text["attention_mask"], grid, roi, rng=rng)
    elif isinstance(model, TomBERT):
        fold = lambda x: x.reshape((b * a,) + tuple(x.shape[2:]))
        logits = model(fold(batch["target_ids"]), fold(batch["target_mask"]),
                       text["input_ids"], text["attention_mask"], grid, roi, rng=rng)
    else:
        raise TypeError(type(model))
    return logits.reshape(b, a, -1)


def make_baseline_train_step(state: TrainState, dp_index: Optional[int] = None) -> Callable:
    """-> step(batch, seed) = metrics {"loss", "accuracy"} as device tensors:
    the model in training mode with dropout drawn from (seed, state.step,
    dp_index) (`dp_index` defaults to `parallel.mesh.dp_index()`), the
    loss, its backward (K1's backward kernel in the text encoder), one
    optimizer step.  Nothing in it waits on the device."""
    dp_index = mesh.dp_index() if dp_index is None else dp_index

    def step(batch: Batch, seed: int) -> Dict[str, torch.Tensor]:
        state.model.train()
        rng = DropoutRng.for_step(seed, state.step, batch["input_ids"].device, dp_index)
        loss, acc = aspect_loss(baseline_forward(state.model, state.visual, batch, rng),
                                batch["labels"])
        loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def make_baseline_eval_step(model, visual: Optional[VisualFeatures]) -> Callable:
    """-> step(batch) = (preds [B, A], logits [B, A, num_labels]), in eval
    mode under `torch.inference_mode()`; the model's mode is restored."""

    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = baseline_forward(model, visual, batch)
                return logits.argmax(-1), logits
        finally:
            model.train(was_training)

    return step
