"""The train and eval steps of `macsa_tpu/train/steps.py`: the Phase-2
6-aspect FCMF forward with its eval and train steps, and the Phase-1 IAOG
seq2seq train step.

The reference loops over the six aspects and runs 7 + 7xR separate
ResNet-152 forwards per step (run_multimodal_fcmf.py:427-489).  As in the
JAX package, the aspect views are folded into one B*A batch through one
forward, and all images / all ROI crops go through the ResNet as one batch
each, normalized on the device first (kernel K2).  The loss is the
per-aspect mean cross-entropy summed over the aspects (:474-475).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import DropoutRng
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq, seq2seq_loss, tied_head_loss
from macsa_tpu_torch.ops.image_prep import device_normalize
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.step_graph import TrainStep
from macsa_tpu_torch.utils.logging import span

Batch = Dict[str, torch.Tensor]


def extract_visual(visual: VisualFeatures, images: torch.Tensor,
                   roi_images: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, I, ...], roi_images [B, I, R, ...] -> (grid [B, I, 49, 2048],
    roi [B, I, R, 2048]).  Pixels arrive as packed int32 frames, raw uint8
    or host-normalized floats (`device_normalize`)."""
    conv_dtype = visual.config.torch_dtype
    grid = visual.grid_features(device_normalize(images, conv_dtype))
    roi = visual.pooled_features(device_normalize(roi_images, conv_dtype))
    return grid.to(out_dtype), roi.to(out_dtype)


def _fold_aspects(batch: Batch) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """[B, A, ...] text views -> [B*A, ...]; returns (folded, B, A)."""
    b, a = batch["input_ids"].shape[:2]
    return ({k: batch[k].reshape((b * a,) + tuple(batch[k].shape[2:]))
             for k in ("input_ids", "token_type_ids", "attention_mask", "added_mask")
             if k in batch}, b, a)


def _tile_visual(x: torch.Tensor, a: int) -> torch.Tensor:
    """[B, ...] -> [B*A, ...] matching the aspect fold order (b*A + a)."""
    return x.repeat_interleave(a, dim=0)


def fcmf_forward_all_aspects(model: FCMF, visual: VisualFeatures, batch: Batch,
                             rng: Optional[DropoutRng] = None,
                             fine_tune_cnn: bool = False) -> torch.Tensor:
    """Full FCMF forward over all aspect views -> logits [B, A, num_labels].

    The ResNet runs without autograd (the frozen CNN; the JAX step's
    `stop_gradient`) unless `fine_tune_cnn`.  If the batch carries
    precomputed `grid`/`roi` features (the feature cache), the ResNet is
    skipped."""
    grid, roi = visual_features(model, visual, batch, fine_tune_cnn)
    text, b, a = _fold_aspects(batch)
    logits = model(text["input_ids"], _tile_visual(grid, a), _tile_visual(roi, a),
                   _tile_visual(batch["roi_coors"], a), text.get("token_type_ids"),
                   text["attention_mask"], text["added_mask"], rng=rng)
    return logits.reshape(b, a, -1)


def aspect_loss(logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of [B, A, num_labels] logits: CE in f32, mean over
    the batch per aspect, summed over the aspects; accuracy over all B x A
    views.  Under data parallelism every rank's batch has as many rows, so
    the mean of the ranks' gradients (`train/optim.py`) is the global
    batch's: the FCMF step and the three baselines' (`baseline_steps.py`)
    need nothing more."""
    labels = labels.long()
    ce = F.cross_entropy(logits.float().flatten(0, 1), labels.flatten(),
                         reduction="none").reshape(labels.shape)
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce.mean(0).sum(), acc


def finetune_loss(model: FCMF, visual: VisualFeatures, batch: Batch,
                  rng: Optional[DropoutRng] = None,
                  fine_tune_cnn: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of one batch (`aspect_loss`)."""
    return aspect_loss(fcmf_forward_all_aspects(model, visual, batch, rng, fine_tune_cnn),
                       batch["labels"])


def make_finetune_train_step(state: TrainState, dp_index: Optional[int] = None) -> Callable:
    """-> step(batch, seed) = metrics {"loss", "accuracy"} as device tensors.

    One step: the model in training mode with dropout drawn from generators
    derived from (seed, state.step, dp_index) (`DropoutRng.for_step`;
    `dp_index` defaults to `parallel.mesh.dp_index()`), the loss, its
    backward (K1's backward kernel in the text encoder; through the ResNet
    too when `state.fine_tune_cnn`), and one optimizer step.  Nothing in it
    waits on the device.  It runs eagerly or as a CUDA graph's replay, as
    `step_graph.graph_mode` decides."""
    dp_index = mesh.dp_index() if dp_index is None else dp_index

    def body(batch: Batch, rng: DropoutRng) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss, acc = finetune_loss(state.model, state.visual, batch, rng, state.fine_tune_cnn)
        with span("backward"):
            loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "accuracy": acc}

    return TrainStep(state, body, dp_index)


def make_finetune_eval_step(model: FCMF, visual: VisualFeatures) -> Callable:
    """-> step(batch) = (preds [B, A], logits [B, A, num_labels]), run
    deterministically under `torch.inference_mode()`, whatever mode the
    model was left in (it is restored after the call)."""

    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with span("eval_step", step=True, device=True), torch.inference_mode():
                logits = fcmf_forward_all_aspects(model, visual, batch)
                return logits.argmax(-1), logits
        finally:
            model.train(was_training)

    return step


def visual_features(model, visual: VisualFeatures, batch: Batch,
                    fine_tune_cnn: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch's (grid, roi) features in the model's compute dtype: the
    cached `grid`/`roi` where the batch carries them (the feature cache,
    filled without autograd), else the ResNet over its pixels, with
    autograd only when `fine_tune_cnn`."""
    dt = model.config.model.torch_dtype
    with span("visual", device=True):
        if "grid" in batch:
            return batch["grid"].to(dt), batch["roi"].to(dt)
        with torch.set_grad_enabled(fine_tune_cnn and torch.is_grad_enabled()):
            return extract_visual(visual, batch["images"], batch["roi_images"], out_dtype=dt)


def pretrain_loss(model: FCMFSeq2Seq, visual: VisualFeatures, batch: Batch,
                  rng: Optional[DropoutRng] = None, vocab_chunk: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, token accuracy) of one IAOG batch: CE with ignore_index -100
    over the decoder's logits (run_pretraining_fcmf.py:322-324).  Under
    data parallelism the loss is this rank's share of the global batch's
    mean (its mean over the dp ranks is the global mean) and the accuracy
    is the global batch's.
    `vocab_chunk` > 0 takes the loss and the argmax from
    `chunked_seq2seq_loss`: the [B, T, V] f32 logits are never held.  A
    vocab-parallel head (tensor parallelism) always takes that path, over
    its rows (`seq2seq.tied_head_loss`)."""
    grid, roi = visual_features(model, visual, batch)
    args = (batch["enc_input_ids"], batch["dec_input_ids"], grid, roi, batch["roi_coors"],
            batch.get("token_type_ids"), batch["attention_mask"], batch["added_mask"])
    labels = batch["labels"]
    # the mean over the GLOBAL batch's valid tokens, as JAX takes it: this
    # rank's sum over the global count, times the world size, so that the
    # optimizer's mean over the ranks is the global mean's gradient
    valid = labels != -100
    count = mesh.all_sum(valid.sum()).clamp(min=1)
    denominator = count / mesh.dp_size()
    if vocab_chunk > 0 or model.decoder.dense.tp is not None:
        hidden = model(*args, rng=rng, return_hidden=True)
        loss, pred = tied_head_loss(model.decoder.dense, hidden, labels, vocab_chunk,
                                    denominator)
    else:
        logits = model(*args, rng=rng)
        loss, pred = seq2seq_loss(logits, labels, denominator=denominator), logits.argmax(-1)
    acc = mesh.all_sum(((pred == labels) & valid).sum()) / count
    return loss, acc


def make_pretrain_train_step(state: TrainState, vocab_chunk: int = 0,
                             dp_index: Optional[int] = None) -> Callable:
    """Phase-1 IAOG seq2seq step (run_pretraining_fcmf.py:290-337)
    -> step(batch, seed) = metrics {"loss", "token_accuracy"} as device
    tensors.

    The visual backbone is frozen, whatever the state says (JAX's
    `make_pretrain_train_step` always stops its gradient): it runs under
    `no_grad`, or not at all when the batch carries cached `grid`/`roi`
    features.  Dropout is drawn
    from generators derived from (seed, state.step, dp_index), and the step
    runs eagerly or as a graph's replay, as in `make_finetune_train_step`.
    Nothing in the step waits on the device."""
    dp_index = mesh.dp_index() if dp_index is None else dp_index

    def body(batch: Batch, rng: DropoutRng) -> Dict[str, torch.Tensor]:
        state.model.train()
        loss, acc = pretrain_loss(state.model, state.visual, batch, rng, vocab_chunk)
        with span("backward"):
            loss.backward()
        state.apply_gradients()
        return {"loss": loss.detach(), "token_accuracy": acc}

    return TrainStep(state, body, dp_index)
