"""The traced stretch of a `--trace 1` run: `torch.profiler` over a few
steady steps at the end of the window, read back from its Chrome trace.

What it gives the per-layer readers (`Trace`):
* every device operation (kernels, copies, sets) with its name and
  interval, and their union: the seconds in which the card was busy,
* the stretch's length on the host clock (the traced window),
* device time and count by operation name,
* the idle gaps between device operations, each named by the innermost
  host operation that was running at its middle: what the host was doing
  while the card waited (from a second, shorter stretch that records the
  host too; the first records the card alone, so that the profiler's
  host-side cost does not widen the gaps it measures).
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: List[dict], window_s: float, steps: int):
        self.window_s, self.steps = window_s, steps
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                     key=lambda e: e["ts"])
        self.kernels = [(e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6)
                        for e in dev if e["cat"] == "kernel"]
        spans = []
        for e in dev:
            s, t = e["ts"], e["ts"] + e["dur"]
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], t)
            else:
                spans.append([s, t])
        self.busy_s = sum(t - s for s, t in spans) * 1e-6
        self.gaps = _name_gaps(spans, events)  # (host operation, seconds)

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for name, _, dur in self.kernels:
            out[name][0] += 1
            out[name][1] += dur
        return {k: (v[0], v[1]) for k, v in out.items()}

    def matching(self, *parts: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds any of `parts`."""
        n, s = 0, 0.0
        for name, _, dur in self.kernels:
            if any(p in name for p in parts):
                n, s = n + 1, s + dur
        return n, s

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1][1])[:10]
        idle: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps:
            idle[name] += s
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:200], v[1]] for k, v in ops],
                "idle_gaps": [[k[:200], v] for k, v in gaps]}


def _name_gaps(spans: list, events: List[dict]) -> List[Tuple[str, float]]:
    """Each gap between busy spans, named by the latest-started host
    operation still running at its middle (the innermost, on one thread)."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")
                  and e.get("dur", 0) > 0)
    gaps, active, i = [], [], 0
    for (_, b), (c, _) in zip(spans, spans[1:]):
        mid = (b + c) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        gaps.append((active[0][2] if active else "host Python between operators", (c - b) * 1e-6))
    return gaps


def profile(run_steps: Callable[[int], None], steps: int, device, host: bool) -> Trace:
    """Trace `steps` steps (`run_steps(steps)`), from a drained queue to a
    drained queue: the card alone, or with `host` the host's operations too
    (which slow a host-bound step: their stretch only names the gaps)."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:  # the CPU tests trace the host alone
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        if cuda:
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window, steps)
