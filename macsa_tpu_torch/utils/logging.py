"""Logging / observability.

Mirrors the reference's logging surface (reference:
run_multimodal_fcmf.py:142-156): per-run file + console handlers, plus a
structured JSONL metric writer (an upgrade over the reference's free-text
logs), an optional `torch.profiler` trace context for performance work
(SURVEY.md §5: the reference has no profiler hooks) and the spans that
mark the port's layer boundaries while a profiler records (`span`).

A copy of `macsa_tpu/utils/logging.py` for the PyTorch port; `maybe_profile`
differs (it wraps `torch.profiler`), and the spans are the port's own."""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import statistics
import sys
import time
from typing import Any, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


# ---------------------------------------------------------------------------
# Spans: the port's layer boundaries, recorded while a torch profiler records
# ---------------------------------------------------------------------------

_OFF = contextlib.nullcontext()  # what `span` returns while no profiler records


class Span:
    """One recorded span: its name, its parent's name (None for a root), the
    step it belongs to (the count of step roots closed before it in its
    episode: a copy before a step belongs to that step), its host interval
    (`time.perf_counter_ns`), its counts and, for a span whose card time is
    read (`device`) where CUDA is in use, a pair of timing events on the
    stream that was current at its start."""

    __slots__ = ("store", "name", "step_root", "device", "counts", "parent", "step",
                 "start_ns", "end_ns", "events", "_annotation")

    def __init__(self, store: "SpanStore", name: str, step_root: bool, device: bool):
        self.store, self.name, self.step_root, self.device = store, name, step_root, device
        self.counts: dict = {}
        self.parent, self.step, self.start_ns, self.end_ns, self.events = None, 0, 0, 0, None

    def __enter__(self) -> "Span":
        self.store._open(self)
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._annotation.__exit__(*exc)
        self.store._close(self)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self) -> Optional[float]:
        """The card's milliseconds between the span's two events (waits for
        the second: read after the caller's synchronize)."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class SpanStore:
    """The spans of one episode, a ring of the last `capacity` (older ones
    are counted in `dropped`), and the host nanoseconds by name and the
    step roots closed over every episode (`EpochMeter` reads them).

    The episode is the spans recorded since a span last ran with no
    profiler recording (that span forgets them), so a reader sees only its
    own run's traced stretches.  Spans are opened by the thread that issues
    the steps (the loader's threads open none), so the store takes no lock."""

    def __init__(self, capacity: int = 4096):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.steps = 0  # step roots closed in the episode
        self.steps_total = 0  # ... and in every episode
        self.host_ns: Dict[str, int] = {}  # by name, over every episode
        self.live = False  # the episode holds spans
        self._open_spans: list = []

    def _open(self, s: Span) -> None:
        self.live = True
        s.parent = self._open_spans[-1].name if self._open_spans else None
        s.step = self.steps
        self._open_spans.append(s)

    def _close(self, s: Span) -> None:
        if self._open_spans and self._open_spans[-1] is s:
            self._open_spans.pop()
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        self.spans.append(s)
        self.host_ns[s.name] = self.host_ns.get(s.name, 0) + s.end_ns - s.start_ns
        if s.step_root:
            self.steps += 1
            self.steps_total += 1

    def end_episode(self) -> None:
        """Forget the episode's spans (the host totals run on)."""
        self.spans.clear()
        self._open_spans.clear()
        self.dropped, self.steps, self.live = 0, 0, False

    def snapshot(self) -> tuple:
        """(step roots closed, {name: host ns}) over every episode so far."""
        return self.steps_total, dict(self.host_ns)

    def per_step(self, name: str, of: str = "host_ms") -> Optional[list]:
        """The episode's spans named `name`, summed by step, in step order:
        their host milliseconds ("host_ms"), the card's ("device_ms"), or a
        count (such as "bytes").  None where there is none, where one of
        them has no such reading (no events: the CPU), or where the ring
        dropped spans of the episode (its oldest steps would be partial)."""
        if self.dropped:
            return None
        by_step: Dict[int, float] = {}
        for s in (s for s in self.spans if s.name == name):
            if of == "host_ms":
                v = s.host_ms
            elif of == "device_ms":
                v = s.device_ms()
            else:
                v = s.counts.get(of)
                if isinstance(v, torch.Tensor):  # a device count, read once the stretch is done
                    v = float(v)
            if v is None:
                return None
            by_step[s.step] = by_step.get(s.step, 0) + v
        return [by_step[k] for k in sorted(by_step)] or None


SPANS = SpanStore()


def span(name: str, step: bool = False, device: bool = False):
    """A span of the port's layer `name` around a block: `with span("fusion"):`.

    While no torch profiler records (the default, and every untraced step)
    it returns one shared no-op after one check of the profiler's flag: no
    torch operation, no CUDA event, no allocation; `with ... as s` gives
    None.  While one records, the block runs inside
    `torch.profiler.record_function(name)` (a `user_annotation` in the
    profiler's trace, on the kernels' clock), and the span is kept in
    `SPANS` with its parent, step, host interval and the counts the block
    sets on `s.counts` (such as `bytes`).  `step=True` marks a step's root
    (`train_step`, `eval_step`); `device=True` also records two CUDA timing
    events where CUDA is in use, on the spans whose card time is read
    (`h2d`, `visual`, `eval_step`: each event is host time while a profiler
    records, and the card idles whenever it waits on the host).  A count
    may be a 0-d device tensor (the MoE layer's `rows`), so that the block
    never waits for the card: `SpanStore.per_step` reads it afterwards.  Under `torch.compile` or `torch.export` it is a
    `nullcontext`: the traced graph holds no profiler operation; so it is
    while a CUDA graph captures (`train/step_graph.py`): no replay repeats
    the block's host work, and its events would join the graph."""
    if not _autograd_profiler._is_profiler_enabled:
        if SPANS.live:
            SPANS.end_episode()
        return _OFF
    if torch.compiler.is_compiling() or (torch.cuda.is_initialized()
                                         and torch.cuda.is_current_stream_capturing()):
        return contextlib.nullcontext()
    return Span(SPANS, name, step, device)


def span_median(name: str, of: str = "host_ms") -> Optional[float]:
    """The median over the episode's steps of what a step spent
    in spans named `name`: host milliseconds ("host_ms"), the card's
    milliseconds between their CUDA events ("device_ms"), or a count (such
    as "bytes"); None where `SpanStore.per_step` gives none."""
    per_step = SPANS.per_step(name, of)
    return statistics.median(per_step) if per_step else None
