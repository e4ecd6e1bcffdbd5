"""The reference's side of a training cell's check: three steps of the
plain model under a plain AdamW, from the benchmark's weights and batches,
and the readings the comparison takes from them.

The optimizer follows the configuration's recipe as the port's driver
states it (`train/optim.py`): AdamW (beta 0.9, 0.999), no decay for biases
and normalization scales, the classifier head (`classifier`,
`text_pooler`) at its own rate, HF linear warmup counted in updates (the
first update's rate is 0), global-norm clipping g * min(1, c / ||g||).
Written out here in plain tensor operations.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from port_bench.reference.model import LayerNorm, StepRng

BETAS = (0.9, 0.999)


def warmup_rate(base: float, warmup: int, total: int, step: int) -> float:
    warmup = max(warmup, 1)
    if step < warmup:
        return base * step / warmup
    return base * max(0.0, (total - step) / max(1.0, total - warmup))


def no_decay(model: torch.nn.Module) -> set:
    out = set()
    for prefix, m in model.named_modules():
        for leaf, _ in m.named_parameters(recurse=False):
            if leaf == "bias" or (leaf == "weight" and isinstance(m, LayerNorm)):
                out.add(f"{prefix}.{leaf}" if prefix else leaf)
    return out


def is_head(name: str) -> bool:
    return any(kw in part for part in name.split(".") for kw in ("classifier", "text_pooler"))


FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def _plant(model: torch.nn.Module, batches: List, fault: str) -> List:
    """A fault in the reference's step, as a program could have it."""
    if fault == "half_batch":  # half of each batch left out, the mean over the rest
        return [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    if fault == "altered_answer":  # the first row's answer lost where it is produced
        def alter(module, args, out):
            out = out.clone()
            out[0] = 0.0
            return out
        model.register_forward_hook(alter)
    return batches


def readings(model: torch.nn.Module, loss_fn: Callable, batches: List, seed: int,
             opt: dict, steps: int = 3, fault: str = None) -> dict:
    """Train `steps` steps; -> {"loss": [per step], "grad": {leaf: norm of
    the clipped gradient of step 1}, "change": {leaf: norm of the change
    after `steps`}}.  `loss_fn(model, batch, rng)` is the step's loss;
    `opt` holds lr, head_lr, weight_decay, eps, max_grad_norm, warmup,
    total (the schedule's steps).  `fault` (one of FAULTS) plants a fault,
    for the check's own test of what it catches."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault}")
    batches = _plant(model, batches, fault)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    decay_off = no_decay(model)
    start = {n: p.detach().clone() for n, p in named}
    m = {n: torch.zeros_like(p) for n, p in named}
    v = {n: torch.zeros_like(p) for n, p in named}
    device = named[0][1].device
    losses, grad = [], {}
    for t in range(steps):
        model.train()
        loss = loss_fn(model, batches[t], StepRng(seed, t, device))
        loss.backward()
        with torch.no_grad():
            gs = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in named}
            norm = torch.sqrt(sum(g.square().sum() for g in gs.values()))
            scale = torch.clamp(opt["max_grad_norm"] / norm, max=1.0)
            bc1, bc2 = 1 - BETAS[0] ** (t + 1), 1 - BETAS[1] ** (t + 1)
            for n, p in named:
                if fault == "unchanged_state":
                    grad[n] = 0.0
                    p.grad = None
                    continue
                g = gs[n] * scale
                base = opt["head_lr"] if is_head(n) else opt["lr"]
                lr = warmup_rate(base, opt["warmup"], opt["total"], t)
                wd = 0.0 if n in decay_off else opt["weight_decay"]
                p.mul_(1 - lr * wd)
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = v[n].sqrt() / math.sqrt(bc2) + opt["eps"]
                p.addcdiv_(m[n], denom, value=-lr / bc1)
                if t == 0:
                    grad[n] = float(torch.linalg.vector_norm(m[n])) / (1 - BETAS[0])
                p.grad = None
        losses.append(float(loss.detach()))
    change = {n: float(torch.linalg.vector_norm(p.detach() - start[n])) for n, p in named}
    return {"loss": losses, "grad": grad, "change": change}


def state_for(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> dict:
    """`state` (each tied tensor under one of its names) spread over every
    name the model's state dict gives that tensor."""
    sd = model.state_dict(keep_vars=True)
    first = {}
    for name, t in sd.items():
        first.setdefault(id(t), name)
    return {name: state[first[id(t)]] for name, t in sd.items()}
