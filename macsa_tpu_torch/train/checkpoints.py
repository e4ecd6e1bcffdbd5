"""Checkpointing: full train-state save/resume and best/last retention, as
torch files.

Counterpart of `macsa_tpu/train/checkpoints.py` (orbax there), with the
reference's checkpoint semantics (run_multimodal_fcmf.py:40-58,316-380,
554-563):
* a checkpoint carries everything needed to resume: the model's and the
  visual backbone's state dicts, the optimizer (`torch.optim.AdamW` state,
  the update count that positions the LR schedules, the accumulation
  buffers), the step (dropout is drawn from (seed, step), so the step
  restores the randomness too), the epoch and the best score,
* `best` and `last` checkpoints are kept side by side (:554-563),
* one file per tag, `<dir>/<tag>.pt`, written to a temporary name and
  renamed, so a reader never sees a half-written file.

`restore_params_only` also reads a reference `.pth` (a bare state dict of
the reference's FCMF, legacy key names included).  The Phase-1 -> Phase-2
encoder transfer (`resolve_iaog_checkpoint`, `load_model_state_dict`,
`transfer_encoder_params`) works on state dicts.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from macsa_tpu_torch.train.jax_import import normalize_reference_keys
from macsa_tpu_torch.train.state import TrainState

FORMAT = "macsa_tpu_torch.checkpoint.v1"


def _cpu(tree: Any) -> Any:
    """A copy of a nest of dicts, lists and tensors with every tensor on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    """Tagged checkpoints (`best`, `last`, ...) under one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"{tag}.pt")

    def save(self, tag: str, state: TrainState, epoch: int, best_score: float = 0.0) -> None:
        opt = state.optimizer
        payload = {
            "format": FORMAT,
            "step": int(state.step),
            "epoch": int(epoch),
            "best_score": float(best_score),
            "model": _cpu(state.model.state_dict()),
            "visual": _cpu(state.visual.state_dict()),
            "optimizer": _cpu(opt.state_dict()),
        }
        path = self._path(tag)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def finalize(self) -> None:
        """Saves are synchronous: nothing is in flight when `save` returns."""

    def copy(self, src: str, dst: str) -> None:
        """Duplicate checkpoint `src` as `dst` with a local file copy (an
        epoch whose dev score improves saves `best` and `last` with the same
        payload).  Atomic: copies to a temporary name, then renames."""
        tmp = f"{self._path(dst)}.copy-tmp.{os.getpid()}"
        try:
            shutil.copyfile(self._path(src), tmp)
            os.replace(tmp, self._path(dst))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def exists(self, tag: str) -> bool:
        return os.path.isfile(self._path(tag))

    def _load(self, tag_or_path: str) -> Dict[str, Any]:
        path = self._path(tag_or_path) if self.exists(tag_or_path) else tag_or_path
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, tag: str, state: TrainState) -> Tuple[TrainState, int, float]:
        """Restore everything into `state` in place -> (state, epoch, best)."""
        got = self._load(tag)
        if got.get("format") != FORMAT:
            raise ValueError(f"{self._path(tag)} is not a checkpoint of this package")
        state.model.load_state_dict(got["model"], strict=True)
        state.visual.load_state_dict(got["visual"], strict=True)
        state.optimizer.load_state_dict(got["optimizer"])
        state.step = int(got["step"])
        return state, int(got["epoch"]), float(got["best_score"])

    def restore_params_only(self, tag: str, state: TrainState) -> TrainState:
        """Restore only the model's and the visual backbone's parameters
        (the `--do_test` reload of the best checkpoint,
        run_multimodal_fcmf.py:565-570).  `tag` may also be the path of a
        reference `.pth`: a bare FCMF state dict, whose legacy key names
        are normalized; the visual backbone is then left as it is."""
        got = self._load(tag)
        if isinstance(got, dict) and got.get("format") == FORMAT:
            state.model.load_state_dict(got["model"], strict=True)
            state.visual.load_state_dict(got["visual"], strict=True)
            return state
        sd = {k: torch.as_tensor(v) for k, v in normalize_reference_keys(got).items()}
        state.model.load_state_dict(sd, strict=True)
        return state


# ---------------------------------------------------------------------------
# Phase-1 -> Phase-2 encoder transfer (run_multimodal_fcmf.py:382-412)
# ---------------------------------------------------------------------------

TOKEN_TABLE = "decoder.embedding.weight"  # the Phase-1 model's tied table
WORD_EMBEDDINGS = "encoder.bert.cell.embeddings.word_embeddings.weight"


def resolve_iaog_checkpoint(path: str) -> Optional[str]:
    """Resolve `--pretrained_iaog_path` to a checkpoint file.

    Accepts either a Phase-1 output directory (holding `best.pt` / `last.pt`,
    `best` first) or a checkpoint file itself: the reference's flag points
    straight at a checkpoint file (run_multimodal_fcmf.py:382), so both
    spellings must work.  Returns None when no checkpoint is found."""
    base = os.path.abspath(path)
    if os.path.isfile(base):
        return base
    for tag in ("best", "last"):
        cand = os.path.join(base, f"{tag}.pt")
        if os.path.isfile(cand):
            return cand
    return None


def load_model_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict alone out of a checkpoint file of this package
    (the optimizer's moments, about two thirds of a Phase-1 checkpoint, are
    dropped once read), or a bare reference state dict with its legacy key
    names normalized."""
    got = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(got, dict) and got.get("format") == FORMAT:
        return got["model"]
    if isinstance(got, dict) and "model_state_dict" in got:  # run_multimodal_fcmf.py:40-58
        got = got["model_state_dict"]
    return {k: torch.as_tensor(v) for k, v in normalize_reference_keys(got).items()}


def resize_embedding(table, new_size: int, init_std: float = 0.02,
                     seed: int = 0) -> torch.Tensor:
    """HF resize_token_embeddings equivalent (fcmf_pretraining.py:159-160):
    truncate, or extend with normal(0.02) rows.  The rows come from numpy's
    generator at `seed`, as in `macsa_tpu.train.checkpoints.resize_embedding`,
    so both packages extend a table with the same rows."""
    table = torch.as_tensor(table)
    if new_size <= table.shape[0]:
        return table[:new_size]
    extra = np.random.default_rng(seed).normal(
        0.0, init_std, size=(new_size - table.shape[0], table.shape[1]))
    return torch.cat([table, torch.from_numpy(extra).to(table.dtype)], dim=0)


def transfer_encoder_params(seq2seq_state: Dict[str, torch.Tensor],
                            fcmf_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Phase-1 -> Phase-2 knowledge transfer on state dicts: a copy of the
    FCMF classifier's `fcmf_state` with every `encoder.*` entry taken from
    the FCMFSeq2Seq's `seq2seq_state` (strict=False semantics: the head
    keeps its fresh init, the decoder is left behind).  The Phase-1 token
    table (`decoder.embedding.weight`, tied three ways there) becomes the
    classifier's own word-embedding table, resized when the two
    vocabularies differ."""
    out = dict(fcmf_state)
    for name, value in seq2seq_state.items():
        if name.startswith("encoder."):
            out[name] = value
    table = seq2seq_state.get(TOKEN_TABLE, seq2seq_state.get(WORD_EMBEDDINGS))
    if table is not None:
        target = fcmf_state.get(WORD_EMBEDDINGS)
        if target is not None and target.shape[0] != table.shape[0]:
            table = resize_embedding(table, target.shape[0])
        out[WORD_EMBEDDINGS] = table
    return out
