"""Logging / observability.

Mirrors the reference's logging surface (reference:
run_multimodal_fcmf.py:142-156): per-run file + console handlers, plus a
structured JSONL metric writer (an upgrade over the reference's free-text
logs) and an optional `torch.profiler` trace context for performance work
(SURVEY.md §5: the reference has no profiler hooks).

A copy of `macsa_tpu/utils/logging.py` for the PyTorch port; only
`maybe_profile` differs (it wraps `torch.profiler`)."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


def setup_logging(output_dir: Optional[str] = None,
                  name: str = "macsa_tpu_torch",
                  is_main: bool = True) -> logging.Logger:
    """`is_main=False` (non-zero SPMD process) logs warnings only — the
    reference's master-process-only logging (run_pretraining_fcmf.py:98)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if is_main else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class NullWriter:
    """The metric writer of a process that writes no files (a rank other
    than 0 under data parallelism)."""

    def write(self, step: int, **metrics: Any) -> None:
        pass


class MetricWriter:
    """Append-only JSONL metrics file."""

    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def write(self, step: int, **metrics: Any) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str], tag: str = "trace"):
    """`--profile_dir` flag support: captures a `torch.profiler` trace of
    the host and, where there is one, the card, and writes it as a Chrome
    trace `<tag>_<time>.json` under `trace_dir`.  Yields the profiler (None
    without a `trace_dir`): its `key_averages()` hold the kernels' times
    once the block has ended."""
    if not trace_dir:
        yield None
        return
    import torch
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{tag}_{int(time.time())}.json"))


def device_kernel_seconds(prof) -> Optional[float]:
    """Seconds the card spent in kernels and copies over a finished
    `maybe_profile` block (their sum: what the steps cost the card when the
    host is not the limit); None where nothing ran on a card."""
    import torch
    total = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return total / 1e6 if total > 0 else None
