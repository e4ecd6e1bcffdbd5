"""What the training entries share: set-up that drives the step through its
first steps (the check's readings), warm-up, the timed window, the traced
stretch, and the reference's three steps after the window.

An entry hands `run_training` a `Program`: the port's train state, its
step function and a `batch(k)` that makes step k's device batch from the
host arrays as the driver's loop does; and a `reference()` callable
that, once the program is freed, builds the plain model from the same
seed and returns its readings (`reference/train.py`).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict

import torch

from port_bench.lib import check, trace as tracing

CHECKED_STEPS = 3
BETA1 = 0.9


@dataclasses.dataclass
class Program:
    state: object                   # macsa_tpu_torch TrainState
    step: Callable                  # step(batch, seed) -> {"loss": tensor, ...}
    batch: Callable[[int], dict]    # k -> step k's device batch
    samples_per_step: int
    log_every: int
    readers: Dict                   # per-layer readers' inputs known at set-up
    launch_counts: Dict[str, int]   # the port's counter, read around the traced stretch


def _program_readings(prog: Program, seed: int) -> tuple:
    """Steps 1..3 through the window's own call and feed -> (readings, k)."""
    named = [(n, p) for n, p in prog.state.model.named_parameters() if p.requires_grad]
    start = [p.detach().clone() for _, p in named]
    losses, grad = [], {}
    for k in range(CHECKED_STEPS):
        losses.append(prog.step(prog.batch(k), seed)["loss"])
        if k == 0:
            # a leaf the optimizer holds no moment of got no gradient: norm 0
            moments = prog.state.optimizer.optimizer.state
            norms = torch.stack(torch._foreach_norm(
                [moments.get(p, {}).get("exp_avg", torch.zeros_like(p)) for _, p in named]
            )).cpu() / (1 - BETA1)
            grad = {n: float(v) for (n, _), v in zip(named, norms)}
    delta = torch.stack(torch._foreach_norm(
        torch._foreach_sub([p.detach() for _, p in named], start))).cpu()
    del start
    return ({"loss": [float(x) for x in losses], "grad": grad,
             "change": {n: float(v) for (n, _), v in zip(named, delta)}}, CHECKED_STEPS)


def run_training(ctx, prog: Program, reference: Callable[[], dict], warm_steps: int,
                 trace_steps: int) -> dict:
    dev = ctx.device
    readings, k = _program_readings(prog, ctx.seed)
    for _ in range(warm_steps):
        prog.step(prog.batch(k), ctx.seed)
        k += 1
    sync(dev)
    setup_s = time.perf_counter() - ctx.started

    # the window: steps issued back to back, the loss read every log_every
    t0 = time.perf_counter()
    n = 0
    while True:
        metrics = prog.step(prog.batch(k), ctx.seed)
        k, n = k + 1, n + 1
        if n % prog.log_every == 0:
            float(metrics["loss"])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(dev)
    window = time.perf_counter() - t0
    out = {"attempted": n, "failed": 0,
           "end_to_end": {"setup_s": setup_s,
                          "train_samples_per_s": n * prog.samples_per_step / window}}

    ks = []

    def run_steps(count):
        nonlocal k
        for _ in range(count):
            prog.step(prog.batch(k), ctx.seed)
            ks.append(k)
            k += 1

    if ctx.trace:
        out.update(traced(run_steps, ks, trace_steps, dev, prog.launch_counts, prog.readers,
                          n, window))
    out["memory_peak_bytes"] = peak_bytes(dev)
    out["variants"] = {key: v for key, v in prog.launch_counts.items() if v}
    prog.state = prog.step = prog.batch = None
    free(dev)

    ref = reference()
    numbers, worst = check.training_numbers(readings, ref)
    correct, checked = check.verdict(numbers, ctx.workload["check"])
    out.update(correct=correct, check=checked,
               notes={"variants": out.pop("variants"), "worst_leaf": worst,
                      "program_loss": readings["loss"], "reference_loss": ref["loss"]})
    return out


def traced(run_steps: Callable[[int], None], traced_ks_of: list, steps: int, dev,
           counts: Dict[str, int], readers: dict, n: int, window: float) -> dict:
    """The traced stretches after a window of `n` steps in `window` seconds:
    `steps` steps with the card's activity alone (the readers' trace, the
    launch counter's calls and the step indices `traced_ks_of` collects),
    then one with the host's too, for the idle gaps' names."""
    before = dict(counts)
    card = tracing.profile(run_steps, steps, dev, host=False)
    calls = {key: counts[key] - before.get(key, 0) for key in counts}
    traced_ks = list(traced_ks_of)
    host = tracing.profile(run_steps, 1, dev, host=True)
    return {"readers": dict(readers, trace=card, calls=calls, traced_ks=traced_ks,
                            untraced_steps=n, untraced_s=window),
            "breakdown": {"device_ops": card.breakdown()["device_ops"],
                          "idle_gaps": host.breakdown()["idle_gaps"]},
            "trace_device": {"busy_s": card.busy_s, "window_s": card.window_s}}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def device_info(ctx, out: dict) -> dict:
    """The result's `device`: the card's name, one card, the peak."""
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    d = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu", "kind": kind, "count": 1,
         "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if ctx.trace:
        d.update(out.pop("trace_device"))
    return d


def optimizer_settings(step_cfg: dict, rows: int, batch: int) -> dict:
    """The driver's schedule: total = (rows // batch) * epochs updates,
    warmup = int(total * warmup_proportion)."""
    total = (rows // batch) * step_cfg["epochs"]
    return {"lr": step_cfg["lr"], "head_lr": step_cfg.get("head_lr", step_cfg["lr"]),
            "weight_decay": step_cfg["weight_decay"], "eps": step_cfg.get("eps", 1e-8),
            "max_grad_norm": step_cfg["max_grad_norm"], "total": total,
            "warmup": int(total * step_cfg["warmup_proportion"])}

