"""Optimizers and LR schedules, the counterparts of `macsa_tpu/train/optim.py`.

The reference recipe (run_multimodal_fcmf.py:247-314):
* AdamW with a no-decay group for biases and normalization weights,
  decided by module type as the JAX package decides by leaf name (`bias`,
  `out_bias`, `scale`): any bias, and the weight of any `LayerNormTF`,
  `FrozenBatchNorm` or DeepSeek-V2 `RMSNorm`, whatever the module is called,
* dual learning rates: the classifier head (`classifier`, `text_pooler`)
  gets `classifier_head_learning_rate`, the rest the encoder rate,
* HF-style linear warmup, counted in optimizer updates,
* global-norm clipping, g * min(1, max_norm / ||g||) as optax computes it
  (no `+1e-6`, unlike `torch.nn.utils.clip_grad_norm_`),
* gradient accumulation with `optax.MultiSteps` semantics: the running
  mean of k gradients, then one clipped update,
* under data parallelism (`parallel/mesh.py`) the accumulated gradient is
  averaged over the data-parallel ranks before the clip, so every rank
  takes the update of the global batch (AdamW and BertAdam alike),
* under tensor parallelism (`parallel/sharding.py`) a sharded parameter,
  its gradient and its moments are the rank's slice; the clipping norm is
  the whole model's: the sharded gradients' squares summed over mp, the
  replicated ones counted once, as JAX's norm of its global arrays,
* `BertAdam` (fcmf_framework/optimization.py): Adam without bias
  correction, decoupled weight decay, inline warmup schedules.

Both optimizers read `.grad` of their parameters in `step()`, as
`torch.optim` optimizers do.  A parameter that got no gradient is updated
with a zero one, as optax updates every leaf (its weight still decays).
`torch.optim.AdamW` carries the AdamW math: its decoupled decay
p <- p - lr * (adam + wd * p), with p taken before the update, is optax's
`adamw` (`scale_by_adam`, `add_decayed_weights`, `scale_by_learning_rate`).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch
from torch import nn

from macsa_tpu_torch.models.deepseek_v2 import RMSNorm
from macsa_tpu_torch.models.layers import LayerNormTF
from macsa_tpu_torch.models.resnet import FrozenBatchNorm
from macsa_tpu_torch.parallel import sharding
from macsa_tpu_torch.parallel.mesh import all_reduce_gradients
from macsa_tpu_torch.utils.logging import span

Schedule = Callable[[int], float]
NO_DECAY_LEAVES = ("bias", "out_bias")  # run_multimodal_fcmf.py:249
NORM_MODULES = (LayerNormTF, FrozenBatchNorm, RMSNorm)  # their `weight` is JAX's `scale`
HEAD_KEYWORDS = ("classifier", "text_pooler")  # run_multimodal_fcmf.py:252-286


def linear_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """HF `get_linear_schedule_with_warmup`: the rate of update `step`
    (counted from 0, so the first update's rate is 0)."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        return base_lr * max(0.0, (total_steps - step) / max(1.0, total_steps - warmup_steps))

    return schedule


def no_decay_names(model: nn.Module) -> set:
    """Names of the parameters that take no weight decay: every `bias` and
    `out_bias`, and the `weight` of every normalization module."""
    names = set()
    for prefix, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            if leaf in NO_DECAY_LEAVES or (leaf == "weight" and isinstance(module, NORM_MODULES)):
                names.add(f"{prefix}.{leaf}" if prefix else leaf)
    return names


def is_head(name: str) -> bool:
    """The classifier head gets its own learning rate."""
    return any(kw in part for part in name.split(".") for kw in HEAD_KEYWORDS)


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else (lambda step: lr)


def _grads(params: Sequence[torch.Tensor]) -> list:
    """Each parameter's gradient, a zero one where it has none."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         params: Optional[Sequence[torch.Tensor]] = None) -> None:
    """Scale `grads` in place by min(1, max_norm / ||grads||), on the
    device: nothing waits for the norm.  `params` (each gradient's
    parameter) tell the shards of tensor parallelism: their squares are
    summed over mp, so every mp rank takes the whole model's norm."""
    norms = torch._foreach_norm(grads)
    shards = [sharding.param_shard(p) for p in params or ()]
    split = next((s for s in shards if s is not None), None)
    if split is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        squares = torch.stack(norms).square()
        sharded = torch.tensor([s is not None for s in shards], device=squares.device)
        total = sharding.all_reduce_(torch.where(sharded, squares, 0.0).sum().reshape(1), split)
        norm = torch.sqrt(total + torch.where(sharded, 0.0, squares).sum())[0]
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))


class AdamW:
    """AdamW over a model's parameters, in four groups: encoder or head,
    with or without decay (the JAX `make_adamw`).  Parameters with
    `requires_grad` off are left out: never updated, never decayed, and not
    counted in the clipping norm (the JAX drivers' `set_to_zero` branch for
    `--freeze_encoder`)."""

    def __init__(self, model: nn.Module,
                 learning_rate: Union[float, Schedule], weight_decay: float = 0.01,
                 eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
                 head_learning_rate: Union[float, Schedule, None] = None,
                 accumulate_steps: int = 1):
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        self.schedules = {
            "encoder": _as_schedule(learning_rate),
            "head": _as_schedule(learning_rate if head_learning_rate is None
                                 else head_learning_rate)}
        self.weight_decay = weight_decay
        self.params: list = []
        groups = self._groups(model)
        self.optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=eps)
        self.max_grad_norm = max_grad_norm
        self.accumulate_steps = accumulate_steps
        self.updates = 0  # optimizer updates, the schedules' count
        self.capturable = False  # `make_capturable`
        self.loads = 0  # `load_state_dict` calls: a captured update holds the state's addresses
        self._micro = 0
        self._acc: Optional[list] = None

    def _groups(self, module: nn.Module) -> list:
        """The trainable parameters of `module` in up to four groups, added
        to `self.params`."""
        no_decay = no_decay_names(module)
        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params += [p for _, p in named]
        groups = []
        for part in ("encoder", "head"):
            for decay in (True, False):
                ps = [p for n, p in named
                      if is_head(n) == (part == "head")
                      and (n in no_decay) != decay]
                if ps:
                    groups.append({"params": ps, "part": part,
                                   "weight_decay": self.weight_decay if decay else 0.0})
        return groups

    def add_module(self, module: nn.Module) -> None:
        """Put a second module's parameters into this optimizer, under the
        same rules (the trainable ResNet beside the model: optax's one
        transformation over the `(params, visual_params)` tuple, so one
        clipping norm over both).  Before the first step only."""
        if self.updates or self._micro:
            raise RuntimeError("add_module after the optimizer has stepped")
        for group in self._groups(module):
            self.optimizer.add_param_group(group)

    @torch.no_grad()
    def step(self) -> None:
        """Take the parameters' gradients: accumulate them, or (every
        `accumulate_steps` calls) average them over the ranks, clip and
        apply one update."""
        with span("optimizer"):
            self._step()

    def make_capturable(self) -> None:
        """From now on run `torch.optim.AdamW` with `capturable=True`, so
        that a CUDA graph can capture `step` (`train/step_graph.py`): each
        group's rate is a one-element f32 device tensor, written before
        every update (`set_rates`), and the step counts and bias
        corrections live on the card.  The update is the same AdamW; its
        bias corrections are f32 products on the card where the default
        path takes them as host doubles."""
        self.capturable = True
        self._apply_mode()
        # the eager steps of a capturable optimizer are intended here: the
        # first step of each batch shape runs eagerly before its capture
        self.optimizer._warned_capturable_if_run_uncaptured = True

    def _apply_mode(self) -> None:
        """Bring the groups' rates and the step counts to this optimizer's
        mode (after `make_capturable`, and after a load)."""
        for group in self.optimizer.param_groups:
            group["capturable"] = self.capturable
            lr, device = group["lr"], group["params"][0].device
            if self.capturable and not isinstance(lr, torch.Tensor):
                group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=device)
            elif not self.capturable and isinstance(lr, torch.Tensor):
                group["lr"] = float(lr)
            for p in group["params"]:
                state = self.optimizer.state.get(p)
                if state and "step" in state:
                    state["step"] = state["step"].to(p.device if self.capturable else "cpu",
                                                     torch.float32)

    def set_rates(self) -> None:
        """Each group's rate of update `self.updates`, from its schedule;
        written into the group's device tensor where capturable (a fill on
        the stream: nothing waits)."""
        for group in self.optimizer.param_groups:
            lr = self.schedules[group["part"]](self.updates)
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def _step(self) -> None:
        grads = _grads(self.params)
        if self.accumulate_steps > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # optax.MultiSteps' running mean: acc += (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, float(self._micro + 1))
            torch._foreach_add_(self._acc, diff)
            self._micro += 1
            if self._micro < self.accumulate_steps:
                return
            self._micro = 0
            torch._foreach_copy_(grads, self._acc)
            torch._foreach_zero_(self._acc)
        # data parallelism: the mean over the ranks, once an update (JAX's
        # micro-step gradients are global already; MultiSteps averages them)
        all_reduce_gradients(grads)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm, self.params)
        # a captured update reads the rates its replays are handed
        if not (self.capturable and torch.cuda.is_current_stream_capturing()):
            self.set_rates()
        self.optimizer.step()
        self.updates += 1

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """Everything a resumed run needs to take the same next update: the
        moments, the update count (the schedules' position) and the
        accumulation in progress."""
        return {"optimizer": self.optimizer.state_dict(), "updates": self.updates,
                "micro": self._micro,
                "acc": None if self._acc is None else [a.detach().clone() for a in self._acc]}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self._apply_mode()
        self.loads += 1
        self.updates, self._micro = int(state["updates"]), int(state["micro"])
        self._acc = None if state["acc"] is None else [
            a.to(p.device, p.dtype) for a, p in zip(state["acc"], self.params)]


# ---------------------------------------------------------------------------
# BertAdam (reference fcmf_framework/optimization.py)
# ---------------------------------------------------------------------------

def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    if x < warmup:
        return x / warmup
    return 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0 - x


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


class BertAdam:
    """BERT-style Adam without bias correction, decoupled weight decay on
    every parameter, and inline warmup: the JAX `bert_adam`.  Clipping is
    global, as there (the reference clips per group), after the gradients'
    mean over the data-parallel ranks, as `AdamW.step` takes it."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 warmup: float = -1, t_total: int = -1, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, e: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.warmup, self.t_total = lr, warmup, t_total
        self.schedule = SCHEDULES[schedule]
        self.b1, self.b2, self.e = b1, b2, e
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.count = 0
        self.next_m = [torch.zeros_like(p) for p in self.params]
        self.next_v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = _grads(self.params)
        all_reduce_gradients(grads)
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            clip_by_global_norm_(grads, self.max_grad_norm, self.params)
        lr_t = self.lr
        if self.t_total != -1:
            lr_t = self.lr * self.schedule(self.count / self.t_total, self.warmup)
        for p, g, m, v in zip(self.params, grads, self.next_m, self.next_v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = m / (v.sqrt() + self.e)
            if self.weight_decay > 0.0:
                u = u + self.weight_decay * p
            p.sub_(lr_t * u)
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
