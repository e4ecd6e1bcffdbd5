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
encoder transfer of the JAX module waits for Phase 1.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Tuple

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
