#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card: serving path, train steps of both
phases, decode, the two drivers from files (Phase 1, then Phase 2 on its
encoder), the trainable CNN, the offline labelers, the MDE, the inference CLI,
the CATR captioner and the paper's three baselines.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit (`nvcc`).  It builds the port's kernels from `macsa_tpu_torch/csrc`,
holds each kernel against its plain PyTorch version at the shapes of the
paths below (K2 at both phases' batches; K1's forward and backward with
dropout on and off, bf16 on its tensor-core variant and f32 on its
3xTF32 tensor-core variant, also at Phase 1's batches and its eval's, and at
EF-CapTrRoBERTa's 256 rows, where bf16's forward walks ring passes and its
backward streams tiles in two launches; the CUDA-core K1, which no path
reaches, at head width 32, both dtypes and ways; K3,
the box attention, at the serving shape; K4, the 1x1 conv with its
frozen-BN epilogue, at ResNet-152 stage 3 over 280 images, and K5, the
whole identity bottleneck, at all four stages, then beside the Bottleneck
module over the frame counts of the ResNet's passes (where
`resnet.takes_k5` sends the main path's blocks to K5); both must run their
tensor-core variants, bf16 "wgmma" and f32 "tf32x3" (three TF32 products
for each f32 product); the CUDA-core K4 and K5 in f32 at one shape each
that no ResNet width has), times each beside its plain version, its bound on
the card (bytes moved over the memory rate, or operations over the peak
rate of their type) and, where one PyTorch call computes the same function,
that call (`library_ms`: a yardstick only, the port never calls it), then,
at the full width of the FCMF model
(ViSoBERT-sized 12-layer text encoder at L=170, ResNet-152 over 7 images
and 28 ROI crops per sample, batch 8, random weights from a seed):
* runs `make_finetune_eval_step` (the serving forward) and holds its
  logits against the plain path's,
* runs the serving forward with the fused backbone runner
  (`models/fused_backbone.extract_features`, stage 3 through K5) feeding
  the FCMF forward with `use_pallas_box_attention=True` (K3), and holds
  its features and logits against the plain path's,
* runs `make_finetune_train_step` (dropout 0.1, AdamW with the defaults
  of `finetune.py`) for a few steps on one batch in f32 and bf16 (their
  losses must fall), after holding one step's loss and gradients through
  the kernels (K3's included) against the plain path's at dropout 0,
* writes a synthetic dataset (`data/synth.py`: 64 train / 16 dev / 16 test
  reviews, 256x256 PNGs, a 12-layer text config) and runs the fine-tune
  driver on it from files (`train/finetune.main`, the defaults: ResNet-152,
  L = 170, 7 images, 4 ROIs, batch 8, bf16; train, eval and test, 2
  epochs), checks its artifacts, that the second epoch ran on cached
  features (no K2 launch, 12 K1 forward and backward launches a step), and
  that a second call resumes from `last` for exactly one more epoch,
* runs the Phase-1 seq2seq model (FCMF encoder + 12 decoder blocks, tied
  vocabulary table of 15004 rows, T = 20) at batch 16: one step's loss and
  gradients through the kernels against the plain path at dropout 0 in
  f32, the chunked loss against the full one, then steps of
  `make_pretrain_train_step` in f32 and bf16 on cached features and cold,
* decodes greedily and with beam 3 (20 steps): the kernel path's tokens
  against the plain path's, greedy against beam 1, the incremental logits
  against teacher forcing; the bf16 calls timed,
* runs the Phase-1 driver from the synthetic files (`train/pretrain.main`,
  2 epochs with the generation eval, then a resume), and the fine-tune
  driver on its output (`--pretrained_iaog_path`, a shared
  `--feature_cache_dir`): the two-phase pipeline end to end,
* then, on a second synthetic dataset (16 train reviews, 12 images):
  `--fine_tune_cnn` (one f32 step's loss and gradients, the ResNet's
  convolutions and all four tensors of every BatchNorm included, through
  the kernels against the plain path at batch 1; timed bf16 steps at the
  largest batch of 8, 4, 2 that fits, with peak memory; the driver for one
  epoch), both offline aspect labelers (`tools/image_categories.py`,
  `tools/roi_categories.py`: train one epoch, label every image), the FCMF
  with the Multimodal Denoising Encoder (alpha 0.7; forward and gradients
  in f32 and bf16 against the plain path), and the inference CLI
  (`inference/cli.py`, f32: batch mode over 16 records at batch 8 and one
  single-sample call, serving the `--fine_tune_cnn` checkpoint with the
  labelers' taggers, against the plain path on the same tensors), the CATR
  captioner (`tools/generate_captions.py` at v3's architecture, ResNet-101,
  random weights under the torch-hub names, over the 12 images; teacher-
  forced logits against the CPU) and the three baselines (mRoBERTa, TomBERT,
  EF-CapTrRoBERTa at ViSoBERT's width, ResNet-152 over 7 images and 49 ROI
  crops a review: a gradient and logit check in f32 against the plain path,
  timed bf16 steps at batch 8, `train/train_baselines.main` for one epoch
  with dev and test, EF-CapTr on the captions just written),
* tensor parallelism at (dp 1, mp 2): two ranks over gloo on the one card,
  each with half of every sharded tensor and K1/K1b on 6 of the 12 heads
  (K1 and K1b also held to their plain versions at that [48, 170, 384]):
  2 f32 and 2 bf16 full-width fine-tune steps and one Phase-1 step against
  one process, then `finetune.main --mp 2` for one bf16 epoch,
* and, at the end, reads the device time of K1's and SDPA's backward at
  170 rows, queued behind a spin kernel (the host out of the way),
and checks that each path went through its kernels.  Each phase prints
its lines; any failure raises and the exit code is not 0.  The
second-to-last line lists the kernels as JSON; the last line is the run's
JSON verdict.  Without a CUDA device it exits non-zero and prints no result.

The steps and forwards of the benchmark's cells (`BENCHMARK.json`) are
timed there and nowhere here: this script times each kernel alone, and
the entry points no cell runs.  K1's and K2's work comes from
`port_bench/flops/counts.py`, and every kernel's bound from its `bound_s`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.flops import counts

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_ASPECTS, TRAIN_STEPS = 8, 6, 10
STAGE3_IMAGES = BATCH * (7 + 28)  # one serving batch: 8 x (7 images + 28 ROI crops)
# frames of a ResNet pass: a tagger's one image, one review's images, two
# reviews', one review's ROI crops (`resnet.K5_MIN_FRAMES`), a batch's
# images, its ROI crops
K5_FRAMES = (1, 7, 16, 28, BATCH * 7, BATCH * 28)
P1_BATCH, P1_STEPS = 16, 3  # Phase 1: the driver's batch; steps after the first on each feed


# (h = w, C, F) of the identity bottlenecks of ResNet-152's four stages at 224^2
RESNET_STAGES = {1: (56, 256, 64), 2: (28, 512, 128), 3: (14, 1024, 256), 4: (7, 2048, 512)}
# The peak a kernel's bound divides its operations by (its bytes go at
# `counts.HBM_BYTES_S`): bf16 products on the tensor cores; f32 products as
# the "tf32x3" kernels take them, three TF32 products each; f32 on the CUDA
# cores (K2, K3 in f32, and the column beside every "tf32x3" bound).  The
# benchmark's `k1_*_roofline` metrics count an f32 product once at
# `counts.PEAK_TF32`: in f32 their bound is up to 3x smaller than this one.
PEAK_FLOPS = {torch.bfloat16: counts.PEAK_BF16, "tf32x3": counts.PEAK_TF32 / 3,
              torch.float32: 67e12}


def bound(work: dict, dtype) -> dict:
    """The least time the card could take for `work` (its "flop" and its
    "bytes": each input read once, each output written once):
    `counts.bound_s` at the peak of `dtype`, and the side that sets it."""
    peak = PEAK_FLOPS[dtype]
    seconds = counts.bound_s(work, peak)
    by_bytes = counts.bound_s({**work, "flop": 0.0}, peak)
    return {"bound_ms": seconds * 1e3,
            "bound_by": "operations" if seconds > by_bytes else "bytes",
            "flops": work["flop"], "bytes": work["bytes"]}


def kernel_bound(work: dict, dtype) -> dict:
    """`bound` of a kernel on the tensor cores: in f32 the operations
    counted as the kernels take them, three TF32 products for each f32
    product (`bound_ms`), and beside that as f32 on the CUDA cores
    (`cuda_cores_bound_ms`); in bf16 as bf16 products."""
    if dtype == torch.float32:
        return {**bound(work, "tf32x3"),
                "cuda_cores_bound_ms": bound(work, torch.float32)["bound_ms"]}
    return bound(work, dtype)


def attention_bound(b, l, h, d, dtype, backward: bool) -> dict:
    """K1's (`counts.k1_forward`, no logsumexp: the calls timed here write
    none) or K1b's (`counts.k1_backward`) bound at [b, l, h * d], h heads
    (`kernel_bound`: f32 as three TF32 products, the CUDA-core one beside)."""
    elt = torch.finfo(dtype).bits // 8
    work = (counts.k1_backward(b, l, h * d, h, elt) if backward
            else counts.k1_forward(b, l, h * d, h, elt, with_lse=False))
    return kernel_bound(work, dtype)


def pixels_bound(frames: int, valid: int, dtype) -> dict:
    """K2's bound over `frames` 224^2 frames, `valid` of them valid, written
    in `dtype` (`counts.k2_unpack`; a raw uint8 batch is counted as packed
    frames all valid: 4 bytes a frame over, the validity word it lacks), at
    the CUDA cores' f32 rate."""
    return bound(counts.k2_unpack(frames, valid, 224, torch.finfo(dtype).bits // 8),
                 torch.float32)


def bound_text(b: dict) -> str:
    cores = ("" if "cuda_cores_bound_ms" not in b else
             f"; {b['cuda_cores_bound_ms']:.4f} with f32 on the CUDA cores")
    return (f"bound_ms={b['bound_ms']:.4f} by {b['bound_by']} ({b['flops'] / 1e9:.4g} GFLOP, "
            f"{b['bytes'] / 1e6:.4g} MB{cores})")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back launches."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 50, warmup: int = 5, spin_cycles: int = 200_000_000) -> tuple:
    """Mean device time of `fn` with the host out of the way and without a
    profiler: a spin kernel (~0.1 s) holds the stream while the host queues
    `iters` calls behind it, so the events around the calls see the card
    run them back to back.  For calls whose host time rivals their device
    time (autograd's backward), where back-to-back calls time the host.
    -> (ms, whether the host had queued every call before the spin ended)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()  # the spin still held the stream when the host was done
    end.synchronize()
    return start.elapsed_time(end) / iters, ahead


def graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Mean device time of `fn` with the host out of the way: `per_graph`
    calls captured in a CUDA graph, the graph replayed `replays` times
    between events.  For kernels so short that one Python call of their
    wrapper costs the host more than the card."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    for _ in range(3):
        graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def device_profile(fn, iters: int, warmup: int, host_too: bool = True) -> list:
    """(device microseconds, calls, name) of every kernel that `iters` calls
    of `fn` run on the card, from `torch.profiler`, largest first.  Without
    `host_too` only the card's activity is recorded: for calls of tens of
    thousands of tiny operators, whose host events cost more than the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host_too:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
             e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            # a span such as the optimizer's covers kernels that are listed themselves
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    if not sum(r[0] for r in rows) > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return sorted(rows, reverse=True)


# K1's variant at head width 64, both ways (`attention_variant`); head width
# 32, which no path reaches, runs "simt" (phase k1_head_width_32)
K1_VARIANT = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}


def expect_counts(cuda_lib, want: dict, what: str) -> None:
    if dict(cuda_lib.launch_counts) != want:
        raise AssertionError(f"{what}: launches {dict(cuda_lib.launch_counts)}, not {want}")


def k5_counts(passes: dict, frames: int = BATCH * 7) -> dict:
    """K5's entries of `launch_counts` after frozen ResNet-152 passes at
    224^2 without autograd, {dtype name: passes} of `frames` frames each
    (a batch's images, the fewest of its two passes): one launch per
    identity block that `resnet.takes_k5` names (`resnet.k5_blocks`),
    "tf32x3" in f32 and "wgmma" in bf16."""
    from macsa_tpu_torch.config import ResNetConfig
    from macsa_tpu_torch.models import resnet

    out = collections.Counter()
    for dtype, n in passes.items():
        k = resnet.k5_blocks(ResNetConfig(dtype=dtype), 224, frames) * n
        if k:
            out["fused_bottleneck"] += k
            out["fused_bottleneck." + ("wgmma" if dtype == "bfloat16" else "tf32x3")] += k
    return dict(out)


@contextlib.contextmanager
def resnet_modules_only():
    """Every ResNet block on its module while the block runs (`takes_k5`
    says no): the visual layer of a plain path, which launches no kernel."""
    from macsa_tpu_torch.models import resnet

    rule = resnet.takes_k5
    resnet.takes_k5 = lambda *args: False
    try:
        yield
    finally:
        resnet.takes_k5 = rule


def f32_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element of `got` within one float32 ulp of `want`."""
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=want.device)) - want.abs()
    return bool(((got - want).abs() <= ulp).all())


def phase_k2_phase1_shapes(dev, image_prep) -> float:
    """K2 against its plain version on the packed batches Phase 1 sends it
    (batch 16: the train step, the driver's cold epoch, the eval decode),
    both dtypes, with invalid frames: f32 within one ulp, bf16 equal, as
    phase k2.  Not timed.  -> worst absolute error."""
    g = torch.Generator(dev).manual_seed(1)
    worst = 0.0
    for lead in ((P1_BATCH, 7), (P1_BATCH, 7, 4)):
        pixels = torch.randint(0, 256, lead + (224, 224, 3), dtype=torch.uint8, device=dev,
                               generator=g)
        valid = torch.rand(lead, device=dev, generator=g) > 0.25
        valid[(0,) * len(lead)], valid[(-1,) * len(lead)] = True, False
        x = torch.cat([valid.to(torch.int32)[..., None],
                       pixels.reshape(lead + (-1,)).view(torch.int32)], dim=-1).contiguous()
        assert x.shape == lead + (37633,)
        for dtype in (torch.float32, torch.bfloat16):
            got = image_prep.unpack_normalize_pixels(x, dtype)
            want = image_prep.unpack_normalize_pixels_reference(x, dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = f32_ulp_ok(got, want) if dtype == torch.float32 else torch.equal(got, want)
            if not ok or got[~valid].abs().max().item() != 0.0:
                raise AssertionError(f"K2 {tuple(x.shape)} {dtype}: kernel disagrees with plain "
                                     f"(max abs err {err}), or an invalid frame is not zeros")
            worst = max(worst, err)
            print(f"phase k2 packed {str(dtype)[6:]} Phase-1 shape {tuple(x.shape)}, "
                  f"{int((~valid).sum())} invalid frames: max_abs_err={err:.3g} (f32 <= 1 ulp, "
                  f"bf16 equal)")
        del pixels, x, got, want
    return worst


def phase_k2(dev, image_prep):
    """K2 against its plain version on serving-shaped pixel batches."""
    g = torch.Generator(dev).manual_seed(0)
    size = 224
    raw = torch.randint(0, 256, (BATCH, 7, size, size, 3), dtype=torch.uint8,
                        device=dev, generator=g)
    roi_raw = torch.randint(0, 256, (BATCH, 7, 4, size, size, 3), dtype=torch.uint8,
                            device=dev, generator=g)

    def pack(pixels, valid):
        words = pixels.reshape(pixels.shape[:-3] + (-1,)).view(torch.int32)
        return torch.cat([valid.to(torch.int32)[..., None], words], dim=-1).contiguous()

    img_valid = torch.ones(BATCH, 7, dtype=torch.bool, device=dev)
    img_valid[0, 6] = img_valid[-1, 2] = False
    roi_valid = torch.rand(BATCH, 7, 4, device=dev, generator=g) > 0.25
    cases = {
        "packed_images": (image_prep.unpack_normalize_pixels,
                          image_prep.unpack_normalize_pixels_reference,
                          pack(raw, img_valid), img_valid),
        "packed_rois": (image_prep.unpack_normalize_pixels,
                        image_prep.unpack_normalize_pixels_reference,
                        pack(roi_raw, roi_valid), roi_valid),
        "raw_u8_images": (image_prep.normalize_images_u8,
                          image_prep.normalize_images_u8_reference, raw, None),
    }
    assert cases["packed_rois"][2].shape == (BATCH, 7, 4, 37633)
    report = {}
    for name, (kernel, plain, x, valid) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            got, want = kernel(x, dtype), plain(x, dtype)
            torch.cuda.synchronize()
            if valid is not None and got[~valid].abs().max().item() != 0.0:
                raise AssertionError(f"K2 {name}: invalid frames are not exact zeros")
            err = (got.float() - want.float()).abs().max().item()
            ok = f32_ulp_ok(got, want) if dtype == torch.float32 else torch.equal(got, want)
            if not ok:
                raise AssertionError(f"K2 {name} {dtype}: kernel disagrees with plain "
                                     f"(max abs err {err})")
            call_ms = cuda_ms(lambda: kernel(x, dtype))
            ms = graph_ms(lambda: kernel(x, dtype))
            # the plain version copies its constants from the host in every
            # call, which no CUDA graph can capture; its passes over the
            # whole batch keep the card busy, so back-to-back calls time the card
            plain_ms = plain_call_ms = cuda_ms(lambda: plain(x, dtype))
            # an invalid frame needs only its validity word read
            frames = got.numel() // (224 * 224 * 3)
            b = pixels_bound(frames, frames if valid is None else int(valid.sum()), dtype)
            report[(name, dtype)] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                     "call_ms": call_ms, "plain_call_ms": plain_call_ms, **b}
            print(f"phase k2 {name} {str(dtype)[6:]} {tuple(x.shape)}: max_abs_err={err:.3g} "
                  f"(f32 <= 1 ulp, bf16 equal) kernel_ms={ms:.4f} (device time, 20 launches in "
                  f"a CUDA graph; {call_ms:.4f} a call of the wrapper back to back) "
                  f"plain_ms={plain_ms:.4f} (calls back to back: it cannot be captured) "
                  f"{bound_text(b)}")
    return report


def sdpa_inputs(q, k, v, mask, heads):
    """[B, L, H*d] q/k/v and the additive [B, L] key mask as
    `F.scaled_dot_product_attention` takes them: [B, H, L, d] views and a
    [B, 1, 1, L] mask in q's dtype."""
    b, l, hd = q.shape
    split = lambda x: x.view(b, l, heads, hd // heads).transpose(1, 2)
    return split(q), split(k), split(v), mask.to(q.dtype)[:, None, None, :]


def phase_k1(dev, cuda_lib, fa):
    """K1 against its plain version at the text encoder's serving shape
    (bf16 must run the tensor-core variant, f32 the 3xTF32 one), beside
    `F.scaled_dot_product_attention` with the same additive mask."""
    g = torch.Generator(dev).manual_seed(1)
    b, l, h, d = BATCH * NUM_ASPECTS, 170, 12, 64
    lens = torch.randint(1, l + 1, (b,), device=dev, generator=g)
    lens[:8] = l  # some views fill the whole window
    pad = torch.arange(l, device=dev)[None, :] >= lens[:, None]
    q, k, v = (torch.randn(b, l, h * d, device=dev, generator=g) for _ in range(3))
    # f32: summation order only; bf16: the plain version rounds the scores
    # to bf16 (they leave the matmul in the operand dtype), the kernel keeps f32
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    report = {}
    for neg_name, neg in (("-10000", -10000.0), ("finfo.min", torch.finfo(torch.float32).min)):
        mask = torch.zeros(b, l, device=dev).masked_fill(pad, neg)
        for dtype, atol in tolerance.items():
            qc, kc, vc = q.to(dtype), k.to(dtype), v.to(dtype)
            variant = K1_VARIANT[dtype]
            cuda_lib.reset_launch_counts()
            got = fa.fused_self_attention(qc, kc, vc, mask, h)
            expect_counts(cuda_lib, {"fused_self_attention": 1,
                                     f"fused_self_attention.{variant}": 1}, f"K1 {dtype}")
            want = fa.attention_reference(qc, kc, vc, mask, h)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= atol:
                raise AssertionError(f"K1 {dtype} mask {neg_name}: max abs err {err} > {atol}")
            # the kernel's time: its launches back to back; then the same
            # through the wrapper, whose no-autograd call is the registered op
            ms = cuda_ms(lambda: fa._launch_fwd(qc, kc, vc, mask, h, 0.0, 0, False), iters=100)
            call_ms = cuda_ms(lambda: fa.fused_self_attention(qc, kc, vc, mask, h), iters=100)
            plain_ms = cuda_ms(lambda: fa.attention_reference(qc, kc, vc, mask, h))
            q4, k4, v4, m4 = sdpa_inputs(qc, kc, vc, mask, h)
            lib = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)
            lib_err = (lib.transpose(1, 2).reshape(b, l, h * d).float()
                       - want.float()).abs().max().item()
            if not lib_err <= 5 * atol:
                raise AssertionError(f"SDPA is not the same function: {lib_err}")
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                                        attn_mask=m4), iters=100)
            bd = attention_bound(b, l, h, d, dtype, backward=False)
            report[(neg_name, dtype)] = {"err": err, "ms": ms, "call_ms": call_ms,
                                         "plain_ms": plain_ms, "library_ms": library_ms, **bd}
            print(f"phase k1 {str(dtype)[6:]} ({variant}) mask {neg_name} [{b},{l},{h * d}] h={h}: "
                  f"max_abs_err={err:.3g} (atol {atol}) kernel_ms={ms:.4f} (the op's calls: "
                  f"{call_ms:.4f}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA, "
                  f"additive mask) "
                  f"{bound_text(bd)}")
    return report


def phase_k1_bwd(dev, cuda_lib, fa):
    """K1 forward with dropout and K1's backward against their plain
    versions (same seed, so the same mask) at the train step's shape; bf16
    must run the tensor-core variants, f32 the 3xTF32 ones.  The
    backward and its yardstick, SDPA's backward, are each timed twice over
    100 back-to-back calls by CUDA events (two readings must agree for
    either to be a target).  SDPA's backward can only be called through
    autograd, which costs the host more than the card, so
    `phase_k1_bwd_queued` reads the device time of both once more."""
    g = torch.Generator(dev).manual_seed(5)
    b, l, h, d, seed = BATCH * NUM_ASPECTS, 170, 12, 64, 20240917
    lens = torch.randint(1, l + 1, (b,), device=dev, generator=g)
    lens[:8] = l
    pad = torch.arange(l, device=dev)[None, :] >= lens[:, None]
    q, k, v, gout = (torch.randn(b, l, h * d, device=dev, generator=g) for _ in range(4))
    ar = lambda n: torch.arange(n, device=dev)
    keep = fa.dropout_keep(seed, ar(b)[:, None, None, None], ar(h)[None, :, None, None],
                           ar(l)[:, None], ar(l), 0.1).float().mean().item()
    if abs(keep - 0.9) > 0.002:
        raise AssertionError(f"K1 dropout keep fraction {keep} not within 0.9 +- 0.002")
    print(f"phase k1_bwd keep fraction of the rate-0.1 mask over [{b},{h},{l},{l}]: {keep:.5f}")
    # relative to max|ref|.  f32: summation order only.  bf16: the same
    # rounding points on both sides, but one flipped rounding of a bf16
    # operand moves a sum by a bf16 ulp of that term, and the plain forward
    # rounds the scores to bf16 where the kernel keeps them in f32
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    report = {}
    for neg_name, neg in (("-10000", -10000.0), ("finfo.min", torch.finfo(torch.float32).min)):
        mask = torch.zeros(b, l, device=dev).masked_fill(pad, neg)
        for dtype, tol in tolerance.items():
            for rate in (0.0, 0.1):
                qc, kc, vc, gc = (x.to(dtype) for x in (q, k, v, gout))
                leaves = [x.clone().requires_grad_(True) for x in (qc, kc, vc)]
                variant = K1_VARIANT[dtype]
                cuda_lib.reset_launch_counts()
                out = fa.fused_self_attention(*leaves, mask, h, rate, seed)
                grads = torch.autograd.grad(out, leaves, gc, retain_graph=True)
                expect_counts(cuda_lib, {"fused_self_attention": 1,
                                         f"fused_self_attention.{variant}": 1,
                                         "fused_self_attention_bwd": 1,
                                         f"fused_self_attention_bwd.{variant}": 1},
                              f"K1 forward and backward {dtype}")
                want_out = fa.attention_reference(qc, kc, vc, mask, h, rate, seed)
                wants = fa.attention_backward_reference(qc, kc, vc, mask, gc, h, rate, seed)
                torch.cuda.synchronize()
                abs_err, rel_err = {}, {}
                for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                                           (want_out, *wants)):
                    abs_err[name] = (got.float() - want.float()).abs().max().item()
                    rel_err[name] = abs_err[name] / want.float().abs().max().item()
                    if not rel_err[name] <= tol:
                        raise AssertionError(f"K1 {name} {dtype} rate {rate} mask {neg_name}: "
                                             f"error {rel_err[name]} of max|ref| > {tol}")
                fwd_ms = cuda_ms(lambda: fa._launch_fwd(qc, kc, vc, mask, h, rate, seed, False),
                                 iters=100)
                fwd_plain = cuda_ms(lambda: fa.attention_reference(qc, kc, vc, mask, h, rate,
                                                                   seed))
                # the backward as autograd calls it: the wrapper on the saved tensors
                lse = fa._launch_fwd(qc, kc, vc, mask, h, rate, seed, with_lse=True)[1]
                backward = functools.partial(fa._launch_bwd, qc, kc, vc, mask, lse, gc, h, rate,
                                             seed)
                readings = [cuda_ms(backward, iters=100, warmup=10) for _ in range(2)]
                bwd_ms = min(readings)
                bwd_plain = cuda_ms(lambda: fa.attention_backward_reference(
                    qc, kc, vc, mask, gc, h, rate, seed))
                library_ms, timing, calls = None, "", None
                if rate == 0.0:  # SDPA's own dropout draws another mask
                    q4, k4, v4, m4 = sdpa_inputs(*leaves, mask, h)
                    lib = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)
                    g4 = sdpa_inputs(gc, gc, gc, mask, h)[0]
                    lib_backward = functools.partial(torch.autograd.grad, lib, leaves, g4,
                                                     retain_graph=True)
                    lib_readings = [cuda_ms(lib_backward, iters=100, warmup=10)
                                    for _ in range(2)]
                    through_autograd = cuda_ms(lambda: torch.autograd.grad(
                        out, leaves, gc, retain_graph=True), iters=100, warmup=10)
                    library_ms = min(lib_readings)
                    steady = all(max(pair) <= 1.1 * min(pair)
                                 for pair in (readings, lib_readings))
                    timing = (f"; 100 calls twice (within 10%: {'yes' if steady else 'NO'}): "
                              f"kernel {readings[0]:.4f} {readings[1]:.4f}, "
                              f"SDPA backward through autograd {lib_readings[0]:.4f} "
                              f"{lib_readings[1]:.4f}, K1 backward through autograd "
                              f"{through_autograd:.4f}")
                    calls = (backward, lib_backward)
                bd = attention_bound(b, l, h, d, dtype, backward=True)
                report[(neg_name, dtype, rate)] = {
                    "err": abs_err, "fwd_ms": fwd_ms, "fwd_plain_ms": fwd_plain, "ms": bwd_ms,
                    "plain_ms": bwd_plain, "library_ms": library_ms, "calls": calls, **bd}
                print(f"phase k1_bwd {str(dtype)[6:]} ({variant}) rate {rate} mask {neg_name} "
                      f"[{b},{l},{h * d}] h={h}: rel_err "
                      + " ".join(f"{n}={e:.3g}" for n, e in rel_err.items())
                      + f" (tol {tol} of max|ref|); fwd kernel_ms={fwd_ms:.4f} "
                      f"plain_ms={fwd_plain:.4f}; bwd kernel_ms={bwd_ms:.4f} "
                      f"plain_ms={bwd_plain:.4f} library_ms="
                      + ("none" if library_ms is None else f"{library_ms:.4f} (SDPA backward)")
                      + f" {bound_text(bd)}" + timing)
    return report


def phase_k1_head_width_32(dev, cuda_lib, fa) -> dict:
    """The CUDA-core K1 ("simt", `csrc/fused_attention.cu`), which no path
    reaches since head width 64 went to the tensor cores in both dtypes, held
    against its plain versions at [8, 170, 384], 12 heads of 32, f32 and
    bf16, rates 0 and 0.1, forward and backward, with the tolerances of
    phases k1 and k1_bwd, so that no kernel the library builds goes
    unchecked; each timed once beside its plain version.
    -> {"out", "grad": worst absolute errors, (dtype, rate): times}."""
    b, l, h, d, seed = BATCH, 170, 12, 32, 4242
    fwd_tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of max|ref|
    g = torch.Generator(dev).manual_seed(37)
    lens = torch.randint(1, l + 1, (b,), device=dev, generator=g)
    lens[0] = l
    mask = torch.zeros(b, l, device=dev).masked_fill(
        torch.arange(l, device=dev)[None, :] >= lens[:, None], -10000.0)
    q, k, v, gout = (torch.randn(b, l, h * d, device=dev, generator=g) for _ in range(4))
    report = {"out": 0.0, "grad": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        qc, kc, vc, gc = (x.to(dtype) for x in (q, k, v, gout))
        for rate in (0.0, 0.1):
            leaves = [x.clone().requires_grad_(True) for x in (qc, kc, vc)]
            cuda_lib.reset_launch_counts()
            out = fa.fused_self_attention(*leaves, mask, h, rate, seed)
            grads = torch.autograd.grad(out, leaves, gc)
            expect_counts(cuda_lib, {"fused_self_attention": 1, "fused_self_attention.simt": 1,
                                     "fused_self_attention_bwd": 1,
                                     "fused_self_attention_bwd.simt": 1},
                          f"K1 head width 32 {dtype} rate {rate}")
            wants = (fa.attention_reference(qc, kc, vc, mask, h, rate, seed),
                     *fa.attention_backward_reference(qc, kc, vc, mask, gc, h, rate, seed))
            errs = {}
            for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), wants):
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                absolute = (name, rate) == ("out", 0.0)
                if not (err <= fwd_tol[dtype] if absolute else rel <= bwd_tol[dtype]):
                    raise AssertionError(f"K1 simt {name} [{b},{l},{h * d}] {dtype} rate {rate}: "
                                         f"error {err} ({rel} of max|ref|)")
                errs[name] = err if absolute else rel
                key = "out" if name == "out" else "grad"
                report[key] = max(report[key], err)
            lse = fa._launch_fwd(qc, kc, vc, mask, h, rate, seed, with_lse=True)[1]
            times = {"fwd_ms": cuda_ms(lambda: fa._launch_fwd(qc, kc, vc, mask, h, rate, seed,
                                                              False), iters=50),
                     "bwd_ms": cuda_ms(functools.partial(fa._launch_bwd, qc, kc, vc, mask, lse,
                                                         gc, h, rate, seed), iters=50),
                     "fwd_plain_ms": cuda_ms(lambda: fa.attention_reference(
                         qc, kc, vc, mask, h, rate, seed), iters=5),
                     "bwd_plain_ms": cuda_ms(lambda: fa.attention_backward_reference(
                         qc, kc, vc, mask, gc, h, rate, seed), iters=5)}
            report[(dtype, rate)] = times
            print(f"phase k1 simt (head width 32, on no path) {str(dtype)[6:]} [{b},{l},{h * d}] "
                  f"h={h} mask -10000 rate {rate}: errors "
                  + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
                  + f" (out at rate 0 absolute, atol {fwd_tol[dtype]}; else of max|ref|, tol "
                  f"{bwd_tol[dtype]}); fwd kernel_ms={times['fwd_ms']:.4f} plain_ms="
                  f"{times['fwd_plain_ms']:.4f}; bwd kernel_ms={times['bwd_ms']:.4f} plain_ms="
                  f"{times['bwd_plain_ms']:.4f}")
            del leaves, out, grads, wants, lse
    cuda_lib.reset_launch_counts()
    return report


def phase_k1_bwd_queued(k1_bwd) -> None:
    """The device time of K1's backward and of SDPA's backward at rate 0,
    both dtypes, each read twice over 50 calls queued behind a spin kernel
    (`queued_ms`: the host out of the way, no profiler, which under-reads
    late in the script).  Where the host is the limit of a call through
    autograd this is the smaller figure, and SDPA's becomes the yardstick
    (`library_ms`).  Run after every timed path."""
    for (neg_name, dtype, rate), entry in k1_bwd.items():
        if entry["calls"] is None or neg_name != "-10000":
            continue
        backward, lib_backward = entry.pop("calls")
        ours = [queued_ms(backward) for _ in range(2)]
        lib = [queued_ms(lib_backward) for _ in range(2)]
        entry["library_ms"] = min(entry["library_ms"], *(ms for ms, _ in lib))
        steady = all(max(pair) <= 1.1 * min(pair)
                     for pair in ([ms for ms, _ in ours], [ms for ms, _ in lib]))
        ahead = all(a for _, a in ours + lib)
        print(f"phase k1_bwd {str(dtype)[6:]} rate {rate} queued behind a spin kernel, 50 calls "
              f"twice (within 10%: {'yes' if steady else 'NO'}; host ahead: {ahead}): K1 backward "
              f"{ours[0][0]:.4f} {ours[1][0]:.4f}, SDPA backward {lib[0][0]:.4f} {lib[1][0]:.4f}; "
              f"library_ms={entry['library_ms']:.4f}, kernel_ms={entry['ms']:.4f} (CUDA events, "
              f"back to back)")


def phase_k1_phase1_shapes(dev, cuda_lib, fa) -> dict:
    """K1's forward and backward against their plain versions at the
    shapes Phase 1 gives them: [16, 170, 768] (the train step, the eval
    decode) and [2, 170, 768] (the driver's debug decode), rate 0.1, with
    the tolerances of phases k1 and k1_bwd; and the forward alone at
    [16, 64, 768] and [5, 64, 768], the generation eval's BERTScore batches
    (64 tokens, short texts, a ragged last batch).  -> worst absolute errors."""
    h, d, seed = 12, 64, 7
    fwd_tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of max|ref|
    worst = {"out": 0.0, "grad": 0.0}
    for b, l, backward in ((P1_BATCH, 170, True), (2, 170, True), (P1_BATCH, 64, False),
                           (5, 64, False)):
        g = torch.Generator(dev).manual_seed(17 + b + l)
        lens = torch.randint(24 if backward else 2, l + 1, (b,), device=dev, generator=g)
        lens[0] = l
        mask = torch.zeros(b, l, device=dev).masked_fill(
            torch.arange(l, device=dev)[None, :] >= lens[:, None], torch.finfo(torch.float32).min)
        q, k, v, gout = (torch.randn(b, l, h * d, device=dev, generator=g) for _ in range(4))
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc, gc = (x.to(dtype) for x in (q, k, v, gout))
            variant = K1_VARIANT[dtype]
            cuda_lib.reset_launch_counts()
            got0 = fa.fused_self_attention(qc, kc, vc, mask, h)
            expect_counts(cuda_lib, {"fused_self_attention": 1,
                                     f"fused_self_attention.{variant}": 1},
                          f"K1 forward [{b},{l},{h * d}] {dtype}")
            want0 = fa.attention_reference(qc, kc, vc, mask, h)
            err0 = (got0.float() - want0.float()).abs().max().item()
            if not err0 <= fwd_tol[dtype]:
                raise AssertionError(f"K1 [{b},{l},{h * d}] {dtype}: max abs err {err0} > "
                                     f"{fwd_tol[dtype]}")
            worst["out"] = max(worst["out"], err0)
            if not backward:
                print(f"phase k1 {str(dtype)[6:]} ({variant}) BERTScore shape [{b},{l},{h * d}] "
                      f"h={h} mask finfo.min, {int(lens.min())}-{int(lens.max())} tokens a row: "
                      f"forward max_abs_err={err0:.3g} (atol {fwd_tol[dtype]})")
                continue
            leaves = [x.clone().requires_grad_(True) for x in (qc, kc, vc)]
            cuda_lib.reset_launch_counts()
            out = fa.fused_self_attention(*leaves, mask, h, 0.1, seed)
            grads = torch.autograd.grad(out, leaves, gc)
            expect_counts(cuda_lib, {"fused_self_attention": 1,
                                     f"fused_self_attention.{variant}": 1,
                                     "fused_self_attention_bwd": 1,
                                     f"fused_self_attention_bwd.{variant}": 1},
                          f"K1 [{b},{l},{h * d}] {dtype}")
            wants = (fa.attention_reference(qc, kc, vc, mask, h, 0.1, seed),
                     *fa.attention_backward_reference(qc, kc, vc, mask, gc, h, 0.1, seed))
            rels = {}
            for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), wants):
                err = (got.float() - want.float()).abs().max().item()
                rels[name] = err / want.float().abs().max().item()
                if not rels[name] <= bwd_tol[dtype]:
                    raise AssertionError(f"K1 {name} [{b},{l},{h * d}] {dtype}: error "
                                         f"{rels[name]} of max|ref| > {bwd_tol[dtype]}")
                key = "out" if name == "out" else "grad"
                worst[key] = max(worst[key], err)
            ms = cuda_ms(lambda: fa._launch_fwd(qc, kc, vc, mask, h, 0.1, seed, False),
                         iters=50)
            lse = fa._launch_fwd(qc, kc, vc, mask, h, 0.1, seed, with_lse=True)[1]
            bwd_ms = cuda_ms(functools.partial(fa._launch_bwd, qc, kc, vc, mask, lse, gc, h, 0.1,
                                               seed), iters=50)
            print(f"phase k1 {str(dtype)[6:]} ({variant}) Phase-1 shape [{b},{l},{h * d}] h={h} "
                  f"mask finfo.min: rate 0 max_abs_err={err0:.3g} (atol {fwd_tol[dtype]}); rate "
                  f"0.1 rel_err " + " ".join(f"{n}={e:.3g}" for n, e in rels.items())
                  + f" (tol {bwd_tol[dtype]} of max|ref|); fwd kernel_ms={ms:.4f} bwd "
                  f"kernel_ms={bwd_ms:.4f}")
    cuda_lib.reset_launch_counts()
    return worst


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_k3(dev, ba, cuda_lib):
    """K3 against its plain version at the serving shape, forward and
    backward (the backward is the plain analytic function itself).  One
    call of the wrapper costs the host more than the kernel costs the card,
    so the kernel's time is the device's (launches replayed from a CUDA
    graph), beside an empty kernel's timed the same way: the floor."""
    stream = cuda_lib.stream_handle
    with tempfile.TemporaryDirectory() as tmp:
        # a measuring aid, built here into a library of its own: it is no
        # part of the port's kernel library
        so = os.path.join(tmp, "empty_launch.so")
        nvcc = [cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", so,
                str(cuda_lib.CSRC / "measure" / "empty_launch.cu")]
        built = subprocess.run(nvcc, capture_output=True, text=True, timeout=300)
        if built.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(nvcc)}\n{built.stdout}\n{built.stderr}")
        empty = ctypes.CDLL(so).macsa_empty_launch
        empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
        empty_ms = graph_ms(lambda: cuda_lib.check(empty(stream(dev)), "macsa_empty_launch"))
    print(f"phase k3 an empty kernel, 20 launches in a CUDA graph: {empty_ms:.4f} ms a launch")
    g = torch.Generator(dev).manual_seed(9)
    bh, n, d = BATCH * NUM_ASPECTS * 7 * 8, 4, 96  # samples x aspects x images x heads
    q, k, v, gout = (torch.randn(bh, n, d, device=dev, generator=g) for _ in range(4))
    gates = torch.relu(torch.randn(bh, n, n, device=dev, generator=g))  # about half are 0
    # f32: summation order only.  bf16: both round the probabilities and the
    # output from f32 sums taken in another order: an output may move by one
    # bf16 ulp (2^-7 of it at most), a probability by one (~1e-3 x |v|)
    tolerance = {torch.float32: (0.0, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
    report = {}
    for dtype, (rtol, atol) in tolerance.items():
        qc, kc, vc, gc, goc = (x.to(dtype) for x in (q, k, v, gates, gout))
        leaves = [x.clone().requires_grad_(True) for x in (qc, kc, vc, gc)]
        out = ba.fused_box_attention(*leaves)
        grads = torch.autograd.grad(out, leaves, goc)
        want = ba.box_attention_reference(qc, kc, vc, gc)
        wants = ba.box_attention_backward_reference(qc, kc, vc, gc, goc)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        err = diff.max().item()
        if not (diff <= atol + rtol * want.float().abs()).all():
            raise AssertionError(f"K3 {dtype}: max abs err {err} beyond atol {atol} + "
                                 f"rtol {rtol}")
        grad_err = max(rel_err(a, b) for a, b in zip(grads, wants))
        if not grad_err <= 1e-6 or grads[3][gc.float() <= 1e-6].any():
            raise AssertionError(f"K3 {dtype} backward: rel err {grad_err}, or a gradient "
                                 f"at a zero gate")
        call_ms = cuda_ms(lambda: ba.fused_box_attention(qc, kc, vc, gc))
        ms = graph_ms(lambda: ba.fused_box_attention(qc, kc, vc, gc))
        plain_call_ms = cuda_ms(lambda: ba.box_attention_reference(qc, kc, vc, gc))
        plain_ms = graph_ms(lambda: ba.box_attention_reference(qc, kc, vc, gc))
        # scores and the weighted sum: 4 bh n^2 d operations
        bd = bound({"flop": 4.0 * bh * n * n * d, "bytes": nbytes(qc, kc, vc, gc, want)}, dtype)
        report[dtype] = {"err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                         "plain_call_ms": plain_call_ms, **bd}
        print(f"phase k3 {str(dtype)[6:]} [{bh},{n},{d}] gates {gc.eq(0).float().mean():.3f} "
              f"zero: max_abs_err={err:.3g} (atol {atol} + rtol {rtol}); backward rel err "
              f"{grad_err:.3g}, zero dgates at zero gates; kernel_ms={ms:.4f} (device time, 20 "
              f"launches in a CUDA graph; {call_ms:.4f} a call of the wrapper back to back: the "
              f"host's) plain_ms={plain_ms:.4f} (timed the same way; {plain_call_ms:.4f} a call "
              f"back to back) {bound_text(bd)}")
    return report


def bn_affine(g, channels, dev):
    """Random frozen-BN statistics -> the f32 (mul, add) FrozenBatchNorm makes."""
    weight, var = (torch.rand(channels, device=dev, generator=g) + 0.5 for _ in range(2))
    bias, mean = (0.1 * torch.randn(channels, device=dev, generator=g) for _ in range(2))
    inv = torch.rsqrt(var + 1e-5)
    return weight * inv, bias - mean * weight * inv


def phase_k4(dev, cuda_lib, fr):
    """K4 against its plain version at the 1x1 convs of ResNet-152's stage
    3 over 280 images.  No path of the JAX package or of the port calls K4
    (the JAX runner uses K5 only), so this phase drives it: one call per
    case and dtype, with the counts set to 0 just before and read just
    after (the bf16 cases must have run the tensor-core variant "wgmma",
    the f32 ones "tf32x3", three TF32 products for each f32 product), then
    the comparisons and the timing, beside a `torch.mm` in the same dtype
    (f32 with TF32 off) followed by the epilogue's elementwise passes."""
    g = torch.Generator(dev).manual_seed(10)
    hw, c, f = RESNET_STAGES[3]
    m = STAGE3_IMAGES * hw * hw
    cases = {f"conv1 [{m},{c}]->{f} relu": (c, f, False, True),
             f"conv3 [{m},{f}]->{c} +res relu": (f, c, True, True),
             f"conv3 [{m},{f}]->{c} +res": (f, c, True, False)}
    # relative to max|ref|.  f32: summation order only.  bf16: both sum in
    # f32 and round the output: one bf16 ulp (2^-8 relative) where it flips
    tolerance = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    calls = {}
    for name, (k, n, has_res, relu) in cases.items():
        x = torch.relu(torch.randn(m, k, device=dev, generator=g))
        w = torch.randn(k, n, device=dev, generator=g) / math.sqrt(k)
        mul, add = bn_affine(g, n, dev)
        res = torch.randn(m, n, device=dev, generator=g) if has_res else None
        for dtype in tolerance:
            calls[(name, dtype)] = (x.to(dtype), w.to(dtype), mul, add,
                                    None if res is None else res.to(dtype), relu)
    cuda_lib.reset_launch_counts()
    outs = {key: fr.fused_matmul_bn_act(*args) for key, args in calls.items()}
    torch.cuda.synchronize()
    launches = cuda_lib.launch_counts["fused_matmul_bn_act"]
    variants = {v: cuda_lib.launch_counts[f"fused_matmul_bn_act.{v}"]
                for v in ("wgmma", "tf32x3", "simt")}
    if variants != {"wgmma": len(cases), "tf32x3": len(cases), "simt": 0}:
        raise AssertionError(f"K4 variants {variants}: the bf16 cases must run on the tensor "
                             f"cores as wgmma, the f32 ones as tf32x3")

    def library(x, w, mul, add, res, relu):
        y = torch.mm(x, w).float() * mul + add
        if res is not None:
            y = y + res.float()
        return (torch.clamp_min(y, 0.0) if relu else y).to(x.dtype)

    report = {}
    for (name, dtype), args in calls.items():
        got, want = outs.pop((name, dtype)), fr.fused_matmul_bn_act_reference(*args)
        torch.cuda.synchronize()
        err, rel = (got.float() - want.float()).abs().max().item(), rel_err(got, want)
        tol = tolerance[dtype]
        if not rel <= tol:
            raise AssertionError(f"K4 {name} {dtype}: error {rel} of max|ref| > {tol}")
        del got, want
        ms = cuda_ms(lambda: fr.fused_matmul_bn_act(*args), iters=10)
        plain_ms = cuda_ms(lambda: fr.fused_matmul_bn_act_reference(*args), iters=10)
        # `torch.mm` in the same dtype (f32: TF32 off, as everywhere in this
        # script), then the epilogue's passes
        library_ms = cuda_ms(lambda: library(*args), iters=10)
        x, w, mul, add, res, _ = args
        bd = kernel_bound({"flop": 2.0 * x.shape[0] * x.shape[1] * w.shape[1],
                           "bytes": nbytes(x, w, mul, add, res)
                           + x.shape[0] * w.shape[1] * x.element_size()}, dtype)
        report[(name, dtype)] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": library_ms, "variant": fr.matmul_variant(
                                     dtype, x.shape[0], w.shape[1], x.shape[1]), **bd}
        print(f"phase k4 {str(dtype)[6:]} {name}: max_abs_err={err:.3g} rel {rel:.3g} "
              f"(tol {tol} of max|ref|) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} ({str(dtype)[6:]} mm + passes) {bound_text(bd)}")
    print(f"phase k4 launches driving the {len(calls)} cases: {launches} ({variants})")
    return report, launches


def random_bn_(module, g) -> None:
    """Random frozen-BN statistics in every FrozenBatchNorm of `module`."""
    for bn in module.modules():
        if hasattr(bn, "running_var"):
            n, dev = bn.weight.shape[0], bn.weight.device
            bn.weight.copy_(0.7 + 0.6 * torch.rand(n, device=dev, generator=g))
            bn.bias.copy_(0.1 * torch.randn(n, device=dev, generator=g))
            bn.running_mean.copy_(0.1 * torch.randn(n, device=dev, generator=g))
            bn.running_var.copy_(0.7 + 0.6 * torch.rand(n, device=dev, generator=g))


def phase_k5(dev, cuda_lib, layers, resnet, fused_backbone, fr):
    """K5 against its plain version on one identity bottleneck of each
    ResNet-152 stage over 280 images, in f32 (the 3xTF32 tensor-core
    variant "tf32x3") and bf16 ("wgmma"); the weights come from a port
    `Bottleneck` module (random weights and frozen-BN statistics), whose own
    forward on cuDNN (f32 with TF32 off) is the library yardstick, and
    against which f32 is held too.  Then both again, device time queued
    behind a spin kernel, at the frame counts of `K5_FRAMES`: where
    `resnet.takes_k5` draws its line."""
    n = STAGE3_IMAGES
    # relative to max|ref|.  f32: summation order only.  bf16: the plain
    # version rounds the conv1 and conv3 products to bf16 where the kernel
    # keeps them in f32, and a1, a2 and the output round on both sides
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = [(stage, dtype) for dtype in (torch.float32, torch.bfloat16)
             for stage in RESNET_STAGES]
    report = {}
    with torch.no_grad():
        for stage, dtype in cases:
            hw, c, f = RESNET_STAGES[stage]
            tol = tolerance[dtype]
            g = torch.Generator(dev).manual_seed(11)
            x2 = torch.relu(torch.randn(n * hw * hw, c, device=dev, generator=g)).to(dtype)
            block = resnet.Bottleneck(c, f, compute_dtype=dtype, device=dev)
            layers.init_weights(block, torch.Generator(dev).manual_seed(12))
            random_bn_(block, torch.Generator(dev).manual_seed(13))
            args = resnet.block_args(block)
            cast = [t.to(dtype) if i in (0, 3, 6) else t for i, t in enumerate(args)]
            cuda_lib.reset_launch_counts()
            got = fr.fused_bottleneck(x2, *args, n, hw, hw)
            variant = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            if dict(cuda_lib.launch_counts) != {"fused_bottleneck": 1,
                                                f"fused_bottleneck.{variant}": 1}:
                raise AssertionError(f"K5 stage {stage} {dtype}: launches "
                                     f"{dict(cuda_lib.launch_counts)}, not one of {variant}")
            want = fr.bottleneck_reference(x2, *cast, n, hw, hw)
            x4 = x2.reshape(n, hw, hw, c).permute(0, 3, 1, 2)
            module_out = block(x4)
            torch.cuda.synchronize()
            err, rel = (got.float() - want.float()).abs().max().item(), rel_err(got, want)
            if not rel <= tol:
                raise AssertionError(f"K5 stage {stage} {dtype}: error {rel} of max|ref| > {tol}")
            module_rel = rel_err(got, module_out.permute(0, 2, 3, 1).reshape(-1, c))
            if dtype == torch.float32 and not module_rel <= tol:
                raise AssertionError(f"K5 f32 vs the Bottleneck module: {module_rel}")
            del got, want, module_out
            iters = 10 if dtype == torch.bfloat16 else 3
            ms = cuda_ms(lambda: fr.fused_bottleneck(x2, *args, n, hw, hw), iters=iters, warmup=1)
            plain_ms = cuda_ms(lambda: fr.bottleneck_reference(x2, *cast, n, hw, hw), iters=3,
                               warmup=1)
            module_ms = cuda_ms(lambda: block(x4), iters=iters, warmup=1)
            bd = kernel_bound({"flop": 2.0 * n * hw * hw * (2 * c * f + 9 * f * f),
                               "bytes": 2 * nbytes(x2) + sum(nbytes(t) for t in cast)}, dtype)
            planes = {}
            if dtype == torch.float32:  # the weights' TF32 planes, once a call before the block
                weights = [cast[i].contiguous() for i in (0, 3, 6)]
                got_planes = fr.tf32x3_weight_planes(*weights).cpu().view(torch.int32)
                want_planes = fr.tf32x3_weight_planes_reference(*(t.cpu() for t in weights))
                if not torch.equal(got_planes, want_planes.view(torch.int32)):
                    raise AssertionError(f"K5 stage {stage}: the weight planes differ from the "
                                         "plain version's")
                planes = {"planes_ms": queued_ms(lambda: fr.tf32x3_weight_planes(*weights),
                                                 iters=20)[0]}
                del got_planes, want_planes
            by_frames = {}
            for frames in K5_FRAMES:
                xf, xf4 = x2[:frames * hw * hw], x4[:frames]
                k5_q = queued_ms(lambda: fr.fused_bottleneck(xf, *args, frames, hw, hw), iters=20)
                module_q = queued_ms(lambda: block(xf4), iters=20)
                by_frames[frames] = {"ms": k5_q[0], "library_ms": module_q[0],
                                     "queued": k5_q[1] and module_q[1],
                                     "bound_ms": bd["bound_ms"] * frames / n}
            report[(stage, dtype)] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                      "library_ms": module_ms, "variant": variant,
                                      "shape": [n * hw * hw, c, f], "by_frames": by_frames,
                                      **planes, **bd}
            print(f"phase k5 {str(dtype)[6:]} stage {stage} [{n * hw * hw},{c}] F={f} n={n} "
                  f"{hw}x{hw} ({variant}): max_abs_err={err:.3g} rel {rel:.3g} (tol {tol} of "
                  f"max|ref|), vs the Bottleneck module rel {module_rel:.3g}; kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={module_ms:.4f} (the module, cuDNN "
                  f"convs{', TF32 off' if dtype == torch.float32 else ''}) {bound_text(bd)}"
                  + (f"; its weight planes alone {planes['planes_ms']:.4f} ms queued (bit for bit "
                     "the plain version's)" if planes else ""))
            for frames, t in by_frames.items():
                print(f"phase k5 {str(dtype)[6:]} stage {stage} over {frames} frames, device "
                      f"ms queued: K5 {t['ms']:.4f}, the module {t['library_ms']:.4f} "
                      f"(K5 / module {t['ms'] / t['library_ms']:.3f}; bound {t['bound_ms']:.4f}; "
                      f"{'queued' if t['queued'] else 'NOT all queued'})")
            del x2, x4, block, args, cast
            torch.cuda.empty_cache()
    cuda_lib.reset_launch_counts()
    return report


def phase_k45_simt_f32(dev, cuda_lib, fr) -> dict:
    """The CUDA-core K4 and K5 ("simt", `csrc/fused_resnet.cu`) in f32,
    which no ResNet width reaches since f32 went to the tensor cores, held
    against their plain versions at one shape each outside "tf32x3" (K4
    [777, 100] -> 130 with a residual and ReLU; K5 over 3 images of 8 x 8,
    C 32, F 8) with the f32 tolerances of phases k4 and k5, so that no
    kernel the library builds goes unchecked; each timed beside its plain
    version.  -> {"k4": report, "k5": report}."""
    g = torch.Generator(dev).manual_seed(38)
    m, k, n = 777, 100, 130
    x = torch.randn(m, k, device=dev, generator=g)
    w = torch.randn(k, n, device=dev, generator=g) / math.sqrt(k)
    k4_args = (x, w, *bn_affine(g, n, dev), torch.randn(m, n, device=dev, generator=g), True)
    images, hw, c, f = 3, 8, 32, 8
    x2 = torch.relu(torch.randn(images * hw * hw, c, device=dev, generator=g))
    w1, w2, w3 = (torch.randn(*shape, device=dev, generator=g) / math.sqrt(fan_in)
                  for shape, fan_in in (((c, f), c), ((9, f, f), 9 * f), ((f, c), f)))
    k5_args = (x2, w1, *bn_affine(g, f, dev), w2, *bn_affine(g, f, dev), w3,
               *bn_affine(g, c, dev), images, hw, hw)
    cases = {"k4": ("fused_matmul_bn_act", fr.fused_matmul_bn_act,
                    fr.fused_matmul_bn_act_reference, k4_args, 1e-5, [m, k, n]),
             "k5": ("fused_bottleneck", fr.fused_bottleneck, fr.bottleneck_reference, k5_args,
                    1e-4, [images * hw * hw, c, f])}
    report = {}
    for key, (name, kernel, plain, args, tol, shape) in cases.items():
        cuda_lib.reset_launch_counts()
        got = kernel(*args)
        torch.cuda.synchronize()
        expect_counts(cuda_lib, {name: 1, f"{name}.simt": 1}, f"{name} f32 {shape}")
        want = plain(*args)
        err, rel = (got - want).abs().max().item(), rel_err(got, want)
        if not rel <= tol:
            raise AssertionError(f"{name} simt f32 {shape}: error {rel} of max|ref| > {tol}")
        ms = cuda_ms(lambda: kernel(*args), iters=20)
        plain_ms = cuda_ms(lambda: plain(*args), iters=20)
        report[key] = {"shape": shape, "variant": "simt",
                       "source": "macsa_tpu_torch/csrc/fused_resnet.cu", "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms}
        print(f"phase k45_simt_f32 {name} (on no ResNet width) f32 {shape}: max_abs_err={err:.3g} "
              f"rel {rel:.3g} (tol {tol} of max|ref|) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    cuda_lib.reset_launch_counts()
    return report


def serving_batch(dev, cfg):
    """Loader-shaped batch of 8 samples, made on the card from a seed."""
    g = torch.Generator(dev).manual_seed(2)
    size, wpf = 224, 1 + 224 * 224 * 3 // 4
    l, a = cfg.max_text_len, NUM_ASPECTS

    def frames(lead, p_valid):
        pixels = torch.randint(0, 256, lead + (size * size * 3,), dtype=torch.uint8,
                               device=dev, generator=g)
        valid = torch.rand(lead, device=dev, generator=g) < p_valid
        return torch.cat([valid.to(torch.int32)[..., None], pixels.view(torch.int32)], -1)

    lens = torch.randint(24, l + 1, (BATCH, a), device=dev, generator=g)
    pad = torch.arange(l, device=dev) >= lens[..., None]
    ids = torch.randint(2, cfg.text.vocab_size, (BATCH, a, l), device=dev, generator=g)
    batch = {
        "images": frames((BATCH, cfg.num_imgs), 0.9),
        "roi_images": frames((BATCH, cfg.num_imgs, cfg.num_roi), 0.75),
        "roi_coors": torch.rand(BATCH, cfg.num_imgs, cfg.num_roi, 4, device=dev,
                                generator=g),
        "input_ids": ids.masked_fill(pad, cfg.text.pad_token_id).to(torch.int32),
        "token_type_ids": torch.zeros(BATCH, a, l, dtype=torch.int32, device=dev),
        "attention_mask": (~pad).to(torch.int32),
        "added_mask": torch.ones(BATCH, a, l + cfg.num_patches, dtype=torch.int32,
                                 device=dev),
    }
    assert batch["images"].shape[-1] == wpf
    return batch


def kda_backward_work(forward: dict, tokens: int, d: int) -> dict:
    """The KDA core's backward: the gradient's own work, twice the forward's
    products (each product's two gradient products); q, k, v and do read in
    bf16, g and beta in f32, dq, dk, dv written in bf16, dg and dbeta in f32,
    each once (`tokens` rows of a head, head width `d`).  `KDACore.backward`
    also computes the forward's chunk products again: `flop_with_recompute`."""
    return {"flop": 2 * forward["flop"], "flop_with_recompute": 3 * forward["flop"],
            "bytes": tokens * d * (4 * 2 + 4 + 3 * 2 + 4) + tokens * 4 * 2}


def phase_kda(dev, cuda_lib) -> dict:
    """The chunked KDA core's kernels (`csrc/kda_core.cu`, through
    `ops/kda.py` `forward_kernels` and `backward_kernels`) at the
    Kimi-Linear cell's shape, [48, 170, 32, 128] (q, k, v, o, do bf16; g,
    beta f32): o, dq, dk, dv, dg, dbeta held against the plain versions
    (`subchunk_kda`, `chunk_kda_backward`) on the same inputs, each as its
    largest gap over its largest value (bf16 outputs within 1e-2, f32 ones
    within 1e-4, the card tests' tolerances); the forward and the backward
    against their bounds (`flops/kimi_linear.kda_core`, `kda_backward_work`;
    f32 products on the CUDA cores, as the kernels take them) and the plain
    `chunk_kda` (autograd through it for the backward: the mixer's
    recomputation and autograd's pass, as the plain path runs it)."""
    from macsa_tpu_torch.ops import kda
    from port_bench.flops import kimi_linear as kimi_flops

    with open(os.path.join(REPO, "port_bench", "configs", "fcmf_kimi_linear_48b_a3b.json")) as f:
        cfg = json.load(f)
    b, l, h, d = 48, 170, 32, 128
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v, do = (torch.randn(b, l, h, d, device=dev, generator=gen).bfloat16()
                   for _ in range(4))
    g = -11 * torch.rand(b, l, h, d, device=dev, generator=gen)
    beta = torch.rand(b, l, h, device=dev, generator=gen)
    cuda_lib.reset_launch_counts()
    o = kda.forward_kernels(q, k, v, g, beta, torch.bfloat16)
    grads = kda.backward_kernels(q, k, v, g, beta, do)
    assert dict(cuda_lib.launch_counts) == {"kda_fwd": 1, "kda_bwd": 1}, cuda_lib.launch_counts
    wants = [kda.subchunk_kda(q, k, v, g, beta, torch.bfloat16),
             *kda.chunk_kda_backward(q, k, v, g, beta, do)]
    gaps, tols, errs = {}, {}, {}
    for name, got, want in zip(("o", "dq", "dk", "dv", "dg", "dbeta"), (o, *grads), wants):
        assert got.dtype == want.dtype and torch.isfinite(got).all(), name
        want = want.float()
        errs[name] = float((got.float() - want).abs().max())
        gaps[name] = errs[name] / float(want.abs().max())
        tols[name] = 1e-2 if got.dtype == torch.bfloat16 else 1e-4
    del o, grads, wants
    bad = {n: gaps[n] for n in gaps if not gaps[n] < tols[n]}
    assert not bad, f"KDA kernels off the plain versions: {bad} (tolerances {tols})"
    fwd_work = kimi_flops.kda_core(b, l, cfg, 2)
    bwd_work = kda_backward_work(fwd_work, b * l * h, d)
    fwd_ms = cuda_ms(lambda: kda.forward_kernels(q, k, v, g, beta, torch.bfloat16))
    bwd_ms = cuda_ms(lambda: kda.backward_kernels(q, k, v, g, beta, do))

    def plain_both():
        leaves = [t.clone().requires_grad_() for t in (q, k, v, g, beta)]
        kda.chunk_kda(*leaves, torch.bfloat16).backward(do)

    plain_fwd = cuda_ms(lambda: kda.chunk_kda(q, k, v, g, beta, torch.bfloat16), 5, 1)
    plain_both_ms = cuda_ms(plain_both, 5, 1)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    kda.backward_kernels(q, k, v, g, beta, do)
    torch.cuda.synchronize(dev)
    out = {"shape": [b, l, h, d], "max_abs_err": max(errs.values()), "gaps": gaps,
           "forward": {"ms": fwd_ms, "plain_ms": plain_fwd, **bound(fwd_work, torch.float32)},
           "backward": {"ms": bwd_ms, "plain_ms": plain_both_ms - plain_fwd,
                        "scratch_peak_mb": (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20,
                        **bound(bwd_work, torch.float32),
                        "bound_ms_with_recompute": bound({**bwd_work, "flop": bwd_work[
                            "flop_with_recompute"]}, torch.float32)["bound_ms"]}}
    print("kda: " + json.dumps(out))
    return out


def phase_slice(dev, cuda_lib, config, layers, fcmf, resnet, steps, image_prep):
    """The serving forward at full width through the kernels (K1, K2, K5),
    once in f32 and once in bf16, against the plain path.  Its speed is
    `serve.f32`'s to read."""
    def build(dtype: str, fused: bool):
        cfg = config.FCMFConfig(model=config.ModelConfig(dtype=dtype, fused_attention=fused),
                                text=config.TextEncoderConfig(dtype=dtype,
                                                              fused_attention=fused))
        return (cfg, fcmf.FCMF(cfg, device=dev),
                resnet.VisualFeatures(config.ResNetConfig(dtype=dtype), device=dev))

    cfg, model32, visual32 = build("float32", True)
    layers.init_weights(model32, torch.Generator(dev).manual_seed(3),
                        cfg.model.initializer_range)
    layers.init_weights(visual32, torch.Generator(dev).manual_seed(4))
    _, model16, visual16 = build("bfloat16", True)
    _, plain32, _ = build("float32", False)
    for m, src in ((model16, model32), (visual16, visual32), (plain32, model32)):
        m.load_state_dict(src.state_dict(), strict=True)
    batch = serving_batch(dev, cfg)

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    preds32, logits32 = steps.make_finetune_eval_step(model32, visual32)(batch)
    preds16, logits16 = steps.make_finetune_eval_step(model16, visual16)(batch)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    # one forward in bf16 (K1 in bf16 on the tensor cores), one in f32
    # (3xTF32); K5 on the identity blocks of stages 1-3 of a forward's two
    # ResNet passes
    k1 = cfg.text.num_hidden_layers
    want = {"fused_self_attention": 2 * k1, "fused_self_attention.wgmma": k1,
            "fused_self_attention.tf32x3": k1, "device_normalize": 4,
            **k5_counts({"float32": 2, "bfloat16": 2})}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for name, logits in (("f32", logits32), ("bf16", logits16)):
        if logits.shape != (BATCH, NUM_ASPECTS, cfg.num_labels) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{name} logits {tuple(logits.shape)} not finite/shaped")

    # the same weights on the plain path: attention without K1, pixels
    # normalized by K2's plain version (a float batch only casts), the
    # ResNet on its modules
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(
            batch[key], torch.float32)
    with resnet_modules_only():
        preds_p, logits_p = steps.make_finetune_eval_step(plain32, visual32)(plain_batch)
    torch.cuda.synchronize()
    if cuda_lib.launch_counts != launches:
        raise AssertionError("the plain path launched a kernel")
    err = (logits32 - logits_p).abs().max().item()
    if not err <= 1e-3 or not torch.equal(preds32, preds_p):
        raise AssertionError(f"kernel vs plain path: logits max abs err {err} "
                             f"(atol 1e-3), preds equal: {torch.equal(preds32, preds_p)}")
    bf16_gap = (logits16 - logits32).abs().max().item()
    agree = (preds16 == preds32).float().mean().item()
    print(f"phase slice f32: logits {tuple(logits32.shape)} finite; kernel vs plain path "
          f"max_abs_err={err:.3g} (atol 1e-3, TF32 off), preds equal")
    print(f"phase slice bf16: logits finite; max |bf16 - f32| = {bf16_gap:.3g}, "
          f"pred agreement {agree:.3f}")
    print(f"phase slice launches over 2 forwards: {launches} (12 K1 and 88 K5 per forward: "
          f"wgmma variant in bf16, tf32x3 in f32)")
    return launches


def phase_fused(dev, cuda_lib, config, layers, fcmf, resnet, steps, image_prep, fused_backbone):
    """The serving forward at full width through the fused backbone runner
    (stage 3's identity blocks through K5) and the FCMF forward with
    `use_pallas_box_attention=True` (K3), once in f32 and once in bf16,
    against the plain path; the runner's features against the modules'."""
    def build(dtype: str, kernels: bool):
        cfg = config.FCMFConfig(
            model=config.ModelConfig(dtype=dtype, fused_attention=kernels),
            text=config.TextEncoderConfig(dtype=dtype, fused_attention=kernels),
            use_pallas_box_attention=kernels)
        return (cfg, fcmf.FCMF(cfg, device=dev),
                resnet.VisualFeatures(config.ResNetConfig(dtype=dtype), device=dev))

    cfg, model32, visual32 = build("float32", True)
    layers.init_weights(model32, torch.Generator(dev).manual_seed(14),
                        cfg.model.initializer_range)
    layers.init_weights(visual32, torch.Generator(dev).manual_seed(15))
    random_bn_(visual32, torch.Generator(dev).manual_seed(16))
    _, model16, visual16 = build("bfloat16", True)
    _, plain32, _ = build("float32", False)
    for m, src in ((model16, model32), (visual16, visual32), (plain32, model32)):
        m.load_state_dict(src.state_dict(), strict=True)
    batch = serving_batch(dev, cfg)
    visuals = {"f32": visual32, "bf16": visual16}

    def fused_step(model, visual):
        """pixels -> K2 -> extract_features (K5) -> the eval step on the
        cached-features input (K1, K3)."""
        eval_step = steps.make_finetune_eval_step(model, visual)
        dt = visual.config.torch_dtype

        def step(b):
            with torch.inference_mode():
                grid, roi = fused_backbone.extract_features(
                    visual, image_prep.device_normalize(b["images"], dt),
                    image_prep.device_normalize(b["roi_images"], dt), stages=(3,))
            return eval_step({**b, "grid": grid, "roi": roi})
        return step

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    preds32, logits32 = fused_step(model32, visual32)(batch)
    preds16, logits16 = fused_step(model16, visual16)(batch)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    identity_blocks = visual32.config.stage_sizes[2] - 1
    k1 = cfg.text.num_hidden_layers
    # one forward in bf16 (K5 "wgmma"), one in f32 (K5 "tf32x3"): all on
    # the tensor cores
    want = {"fused_bottleneck": 2 * identity_blocks, "fused_bottleneck.wgmma": identity_blocks,
            "fused_bottleneck.tf32x3": identity_blocks, "box_attention": 2,
            "fused_self_attention": 2 * k1, "fused_self_attention.wgmma": k1,
            "fused_self_attention.tf32x3": k1, "device_normalize": 4}
    if launches != want:
        raise AssertionError(f"fused launch counts {launches} != {want}")
    for name, logits in (("f32", logits32), ("bf16", logits16)):
        if logits.shape != (BATCH, NUM_ASPECTS, cfg.num_labels) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"fused {name} logits {tuple(logits.shape)} not finite/shaped")

    # the plain path: plain backbone, attention without K1 or K3, pixels
    # normalized by K2's plain version
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(batch[key],
                                                                        torch.float32)
    with resnet_modules_only():
        preds_p, logits_p = steps.make_finetune_eval_step(plain32, visual32)(plain_batch)
    torch.cuda.synchronize()
    if cuda_lib.launch_counts != launches:
        raise AssertionError("the plain path launched a kernel")
    err = (logits32 - logits_p).abs().max().item()
    if not err <= 1e-3 or not torch.equal(preds32, preds_p):
        raise AssertionError(f"fused vs plain path: logits max abs err {err} (atol 1e-3), "
                             f"preds equal: {torch.equal(preds32, preds_p)}")
    bf16_gap = (logits16 - logits32).abs().max().item()
    agree = (preds16 == preds32).float().mean().item()

    # the runner's features against the modules' (`stages=()`)
    feats = {}
    with torch.inference_mode():
        for name, visual in visuals.items():
            dt = visual.config.torch_dtype
            imgs = image_prep.device_normalize(batch["images"], dt)
            rois = image_prep.device_normalize(batch["roi_images"], dt)
            feats[name] = fused_backbone.extract_features(visual, imgs, rois)
            feats["plain_" + name] = fused_backbone.extract_features(visual, imgs, rois,
                                                                     stages=())
            del imgs, rois
    torch.cuda.synchronize()
    # f32: summation order only, relative to max|ref|.  bf16: the plain
    # blocks round each conv output and the BN factors to bf16 where K5
    # keeps f32, so both bf16 paths are held against the f32 plain
    # features, and K5's may be at most twice as far as the plain one's
    errs = {}
    for i, head in enumerate(("grid", "roi")):
        ref = feats["plain_f32"][i]
        errs[head] = tuple(rel_err(feats[k][i], ref) for k in ("f32", "bf16", "plain_bf16"))
        f32_err, bf16_err, plain_bf16_err = errs[head]
        if feats["f32"][i].shape != ref.shape or not f32_err <= 1e-4:
            raise AssertionError(f"fused f32 {head} features: {f32_err} of max|ref| > 1e-4")
        if not bf16_err <= 2 * plain_bf16_err:
            raise AssertionError(f"fused bf16 {head} features {bf16_err} of max|f32 ref| > 2 x "
                                 f"the plain bf16 path's {plain_bf16_err}")
    print(f"phase fused f32: logits {tuple(logits32.shape)} finite; fused path vs plain path "
          f"max_abs_err={err:.3g} (atol 1e-3, TF32 off), preds equal")
    print(f"phase fused bf16: logits finite; max |bf16 - f32| = {bf16_gap:.3g}, pred agreement "
          f"{agree:.3f}")
    for head, (f32_err, bf16_err, plain_bf16_err) in errs.items():
        print(f"phase fused {head} features vs the plain f32 heads (rel to max|ref|): fused f32 "
              f"{f32_err:.3g} (tol 1e-4), fused bf16 {bf16_err:.3g}, plain bf16 "
              f"{plain_bf16_err:.3g} (fused bf16 <= 2 x plain bf16)")
    print(f"phase fused launches over 2 forwards: {launches} ({identity_blocks} K5 and {k1} K1 "
          f"(both tf32x3 in f32, wgmma in bf16), 1 K3, 2 K2 per forward)")
    return launches


def phase_train(dev, cuda_lib, config, layers, fcmf, resnet, steps, image_prep, optim,
                train_state):
    """The fine-tune train step at full width: a gradient check at dropout
    0 (kernels vs plain path, f32), then 1 + TRAIN_STEPS steps on one batch
    in f32 and in bf16 through the kernels, whose losses must fall.  Their
    speed is the training cells' to read."""
    def build(dtype: str, fused: bool, dropout: float):
        kw = dict(dtype=dtype, fused_attention=fused, hidden_dropout_prob=dropout,
                  attention_probs_dropout_prob=dropout)
        cfg = config.FCMFConfig(model=config.ModelConfig(**kw),
                                text=config.TextEncoderConfig(**kw),
                                use_pallas_box_attention=fused)
        return (cfg, fcmf.FCMF(cfg, device=dev),
                resnet.VisualFeatures(config.ResNetConfig(dtype=dtype), device=dev))

    cfg, model, visual = build("float32", True, 0.0)
    layers.init_weights(model, torch.Generator(dev).manual_seed(6),
                        cfg.model.initializer_range)
    layers.init_weights(visual, torch.Generator(dev).manual_seed(7))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = serving_batch(dev, cfg)
    batch["labels"] = torch.randint(0, cfg.num_labels, (BATCH, NUM_ASPECTS), device=dev,
                                    generator=torch.Generator(dev).manual_seed(8))

    # one step's loss and gradients at dropout 0: kernels against the plain
    # path (attention without K1, pixels normalized by K2's plain version)
    _, plain, _ = build("float32", False, 0.0)
    plain.load_state_dict(weights, strict=True)
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(batch[key],
                                                                        torch.float32)
    model.train()
    plain.train()
    k3_before = cuda_lib.launch_counts["box_attention"]
    loss_k, _ = steps.finetune_loss(model, visual, batch)  # no rng: no dropout, so K3 runs
    loss_k.backward()
    if cuda_lib.launch_counts["box_attention"] != k3_before + 1:
        raise AssertionError("the dropout-0 train step did not run K3 once")
    loss_p, _ = steps.finetune_loss(plain, visual, plain_batch)
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item())
    if not loss_err <= 1e-5:
        raise AssertionError(f"train loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    # f32 with TF32 off: summation order through 12+3 layers and their backward
    worst = grad_gap(model, plain, "train gradients kernels vs plain", 1e-3)
    scale = worst[2]
    print(f"phase train grad check f32 dropout 0 (K1, K3 and their backward): loss "
          f"{loss_k.item():.6f} kernels vs "
          f"plain {loss_p.item():.6f} (|diff| {loss_err:.3g}, tol 1e-5); every gradient "
          f"within 1e-3 of its max + 1e-6 of the largest ({scale:.3g}); worst {worst[0]} "
          f"at {worst[1]:.3g} of its tolerance")
    del plain, plain_batch, loss_k, loss_p
    model.zero_grad(set_to_none=True)

    def trainer(dtype: str):
        _, m, v = build(dtype, True, 0.1)  # the reference's dropout rates
        m.load_state_dict(weights, strict=True)
        v.load_state_dict(visual.state_dict(), strict=True)
        # finetune.py's defaults: 7e-5 encoder / 7e-4 head, wd 0.01, clip 1.0
        opt = optim.AdamW(m, optim.linear_warmup_schedule(7e-5, 1, 1000),
                          weight_decay=0.01, max_grad_norm=1.0,
                          head_learning_rate=optim.linear_warmup_schedule(7e-4, 1, 1000))
        return steps.make_finetune_train_step(train_state.TrainState.create(m, v, opt))

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    results = {}
    for dtype in ("float32", "bfloat16"):
        step = trainer(dtype)
        losses = [step(batch, seed=0)["loss"] for _ in range(1 + TRAIN_STEPS)]
        losses = [x.item() for x in losses]
        # one batch at a rate of 7e-4 with dropout on: single steps go up
        # as well as down, so the last three are held against the first
        if not all(math.isfinite(x) for x in losses) or not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"train {dtype}: losses {losses} not finite and falling")
        results[dtype] = losses
        del step
    launches = dict(cuda_lib.launch_counts)
    n_steps = 2 * (TRAIN_STEPS + 1)
    # no K3: with dropout active the box head takes its plain path, as in JAX;
    # the frozen ResNet's two passes a step without autograd: K5
    k1 = cfg.text.num_hidden_layers * n_steps
    want = {"device_normalize": 2 * n_steps,
            **k5_counts({"float32": n_steps, "bfloat16": n_steps})}
    for name in ("fused_self_attention", "fused_self_attention_bwd"):
        want.update({name: k1, f"{name}.wgmma": k1 // 2, f"{name}.tf32x3": k1 // 2})
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    for dtype, losses in results.items():
        print(f"phase train {dtype}: losses over {len(losses)} steps on one batch "
              + " ".join(f"{x:.4f}" for x in losses))
    print(f"phase train launches over {n_steps} steps: {launches} (12 K1 forward, "
          f"12 K1 backward (wgmma variants in bf16, tf32x3 in f32), 2 K2, 88 K5, 0 K3 per "
          f"step: dropout 0.1 takes the box head's plain path)")
    return launches


FINETUNE_ARTIFACTS = ("best.pt", "last.pt", "train.log", "metrics.jsonl",
                      "test_results_fcmf.txt", "test_predictions_formatted.txt")


def phase_finetune(card, cuda_lib, synth, finetune):
    """The fine-tune driver from files at full width: a synthetic dataset
    written to a temporary directory, `finetune.main` with its defaults
    (ResNet-152, L = 170, 7 images, 4 ROIs, batch 8, bf16, the card) for
    two epochs with eval and test, then a second `main` that resumes from
    `last` for one more epoch.  (The steps' speed is the training cells' to
    read; the driver's `--profile_dir` is not driven here.)"""
    n_train, n_dev, n_test, epochs, log_every = 64, 16, 16, 2, 4
    layers_per_pass = 12
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        t0 = time.perf_counter()
        synth.write_dataset(data, n_train=n_train, n_layers=layers_per_pass, image_size=256,
                            seed=0, n_dev=n_dev, n_test=n_test)
        written_s = time.perf_counter() - t0
        out = os.path.join(tmp, "out")
        argv = ["--data_dir", os.path.join(data, "data"), "--image_dir",
                os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
                os.path.join(data, "tok"), "--seed", "0", "--log_every", str(log_every),
                "--do_train", "--do_eval"]
        # the main path: every count from 0, read right after
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        result = finetune.main(argv + ["--do_test", "--num_train_epochs", str(epochs)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(cuda_lib.launch_counts)
        missing = [name for name in FINETUNE_ARTIFACTS
                   if not os.path.isfile(os.path.join(out, name))]
        if missing:
            raise AssertionError(f"finetune: artifacts missing: {missing}")
        with open(os.path.join(out, "test_results_fcmf.txt")) as f:
            report_lines = f.read().splitlines()
        if len(report_lines) != NUM_ASPECTS + 1 or not report_lines[-1].startswith("Average: P="):
            raise AssertionError(f"finetune: test report {report_lines}")
        steps = n_train // BATCH
        cold, warm = result["epochs"]
        for name, ep in (("cold", cold), ("warm", warm)):
            if ep["steps"] != steps or not ep["losses"] or \
                    not all(math.isfinite(x) for x in ep["losses"]):
                raise AssertionError(f"finetune {name} epoch: {ep}")
        k1 = layers_per_pass * steps
        want_cold = {"device_normalize": 2 * steps, **k5_counts({"bfloat16": 2 * steps})}
        want_warm = {}
        for name in ("fused_self_attention", "fused_self_attention_bwd"):
            for want in (want_cold, want_warm):
                want.update({name: k1, f"{name}.wgmma": k1})
        if cold["kernel_launches"] != want_cold or warm["kernel_launches"] != want_warm:
            raise AssertionError(f"finetune launches: cold {cold['kernel_launches']} (want "
                                 f"{want_cold}), warm {warm['kernel_launches']} (want "
                                 f"{want_warm}: no K2, the cache skipped the ResNet)")
        f1 = result["test"]["average"]["f1"]
        if not (math.isfinite(f1) and 0.0 <= f1 <= 1.0 and 0.0 < result["best_dev_f1"] <= 1.0):
            raise AssertionError(f"finetune scores: test {f1}, dev {result['best_dev_f1']}")
        for name, ep in (("cold", cold), ("warm", warm)):
            wall_ms = ep["seconds"] * 1e3 / ep["steps"]
            print(f"phase finetune {name} epoch: {ep['samples'] / ep['seconds']:.2f} samples/s, "
                  f"{wall_ms:.2f} ms/step wall, the host waited "
                  f"{ep['loader_wait_seconds'] / ep['seconds']:.3f} of the epoch for decoded "
                  f"batches; {ep['steps']} steps of batch {BATCH}, losses "
                  + " ".join(f"{x:.4f}" for x in ep["losses"]) + f", on {card}")
        print(f"phase finetune main: {main_s:.1f} s for {epochs} epochs + dev eval each + test "
              f"({n_train}/{n_dev}/{n_test} reviews, dataset written in {written_s:.1f} s); dev "
              f"macro-F1 {result['best_dev_f1']:.4f}, test macro-F1 {f1:.4f}; launches "
              f"{launches}; cold epoch {cold['kernel_launches']}, warm epoch "
              f"{warm['kernel_launches']}")

        # resume: one more epoch from `last`, starting at the saved step
        resumed = finetune.main(argv + ["--num_train_epochs", str(epochs + 1),
                                        "--resume_from_checkpoint", "last"])
        more = resumed["epochs"]
        if len(more) != 1 or more[0]["epoch"] != epochs or \
                more[0]["first_step"] != epochs * steps or more[0]["steps"] != steps or \
                not more[0]["losses"] or not all(math.isfinite(x) for x in more[0]["losses"]):
            raise AssertionError(f"finetune resume: {more}")
        print(f"phase finetune resume from last: epoch {more[0]['epoch']} only, from step "
              f"{more[0]['first_step']}, {more[0]['steps']} steps, losses "
              + " ".join(f"{x:.4f}" for x in more[0]["losses"]))
    return launches


def spread(xs) -> str:
    """median (min-max) of repeated readings."""
    xs = sorted(xs)
    return f"{xs[len(xs) // 2]:.2f} ({xs[0]:.2f}-{xs[-1]:.2f})"


def pretrain_batch(dev, cfg, dec_cfg, with_pixels: bool = True):
    """Loader-shaped IAOG batch of 16 samples, made on the card from a seed."""
    g = torch.Generator(dev).manual_seed(21)
    b, l, t = P1_BATCH, cfg.max_text_len, dec_cfg.max_decode_len

    def frames(lead, p_valid):
        pixels = torch.randint(0, 256, lead + (224 * 224 * 3,), dtype=torch.uint8, device=dev,
                               generator=g)
        valid = torch.rand(lead, device=dev, generator=g) < p_valid
        return torch.cat([valid.to(torch.int32)[..., None], pixels.view(torch.int32)], -1)

    lens = torch.randint(24, l + 1, (b,), device=dev, generator=g)
    pad = torch.arange(l, device=dev) >= lens[:, None]
    ids = torch.randint(3, dec_cfg.vocab_size, (b, l), device=dev, generator=g)
    dec_lens = torch.randint(4, t + 1, (b,), device=dev, generator=g)
    dec_pad = torch.arange(t, device=dev) >= dec_lens[:, None]
    dec_ids = torch.randint(3, dec_cfg.vocab_size, (b, t), device=dev, generator=g)
    dec_ids = dec_ids.masked_fill(dec_pad, cfg.text.pad_token_id)
    labels = torch.roll(dec_ids, -1, dims=1)
    labels[:, -1] = -100
    labels = labels.masked_fill(labels == cfg.text.pad_token_id, -100)
    batch = {
        "enc_input_ids": ids.masked_fill(pad, cfg.text.pad_token_id).to(torch.int32),
        "token_type_ids": torch.zeros(b, l, dtype=torch.int32, device=dev),
        "attention_mask": (~pad).to(torch.int32),
        "added_mask": torch.ones(b, l + cfg.num_patches, dtype=torch.int32, device=dev),
        "dec_input_ids": dec_ids.to(torch.int32), "labels": labels.to(torch.int32),
        "roi_coors": torch.rand(b, cfg.num_imgs, cfg.num_roi, 4, device=dev, generator=g)}
    if with_pixels:
        batch["images"] = frames((b, cfg.num_imgs), 0.9)
        batch["roi_images"] = frames((b, cfg.num_imgs, cfg.num_roi), 0.75)
    return batch


def build_seq2seq(dev, config, seq2seq, resnet, dtype: str, fused: bool, dropout: float):
    kw = dict(dtype=dtype, fused_attention=fused, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    cfg = config.FCMFConfig(model=config.ModelConfig(**kw), text=config.TextEncoderConfig(**kw))
    dec_cfg = config.DecoderConfig(dtype=dtype, dropout=dropout)
    return (cfg, dec_cfg, seq2seq.FCMFSeq2Seq(cfg, dec_cfg, device=dev),
            resnet.VisualFeatures(config.ResNetConfig(dtype=dtype), device=dev))


def grad_gap(model, plain, what: str, rel: float) -> tuple:
    """Every gradient of `model` within `rel` of its parameter's largest in
    `plain`, plus 1e-6 of the largest gradient of the model (the attention
    key biases' exact gradient is 0: theirs is rounding noise).
    -> (worst parameter, its share of its tolerance, the largest gradient)."""
    plain_grads = dict(plain.named_parameters())
    scale = max(p.grad.abs().max().item() for p in plain_grads.values() if p.grad is not None)
    worst = ("", 0.0)
    for name, p in model.named_parameters():
        gp = plain_grads[name].grad
        if p.grad is None or gp is None:
            if (p.grad is None) != (gp is None):
                raise AssertionError(f"{what}: {name}: a gradient on one path only")
            continue
        tol = rel * gp.abs().max().item() + 1e-6 * scale
        worst = max(worst, (name, (p.grad - gp).abs().max().item() / tol), key=lambda t: t[1])
    if not worst[1] <= 1.0:
        raise AssertionError(f"{what}: {worst[0]} at {worst[1]} of its tolerance")
    return worst[0], worst[1], scale


def phase_pretrain_step(dev, cuda_lib, config, layers, seq2seq, resnet, steps, image_prep, optim,
                        train_state):
    """The Phase-1 train step at full width, batch 16: a gradient check at
    dropout 0 in f32 (kernels vs plain path; chunked vs full loss), then
    1 + P1_STEPS steps in f32 and in bf16 on cached features and as many
    cold, whose launches are counted and whose losses must fall.  Their
    speed is `pretrain.cached`'s to read."""
    build = functools.partial(build_seq2seq, dev, config, seq2seq, resnet)
    cfg, dec_cfg, model, visual = build("float32", True, 0.0)
    layers.init_weights(model, torch.Generator(dev).manual_seed(22), cfg.model.initializer_range)
    layers.init_weights(visual, torch.Generator(dev).manual_seed(23))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = pretrain_batch(dev, cfg, dec_cfg)

    # one step's loss and gradients at dropout 0: kernels against the plain
    # path (attention without K1, pixels normalized by K2's plain version)
    *_, plain, _ = build("float32", False, 0.0)
    plain.load_state_dict(weights, strict=True)
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(batch[key],
                                                                        torch.float32)
    model.train()
    plain.train()
    cuda_lib.reset_launch_counts()
    loss_k, _ = steps.pretrain_loss(model, visual, batch)
    loss_k.backward()
    k1 = cfg.text.num_hidden_layers
    expect_counts(cuda_lib, {"device_normalize": 2, "fused_self_attention": k1,
                             "fused_self_attention.tf32x3": k1, "fused_self_attention_bwd": k1,
                             "fused_self_attention_bwd.tf32x3": k1, **k5_counts({"float32": 2})},
                  "pretrain grad check")
    loss_p, _ = steps.pretrain_loss(plain, visual, plain_batch)
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item())
    if not loss_err <= 1e-5:
        raise AssertionError(f"pretrain loss kernels {loss_k.item()} vs plain {loss_p.item()}")
    name, ratio, scale = grad_gap(model, plain, "pretrain gradients kernels vs plain", 1e-3)
    print(f"phase pretrain_step grad check f32 dropout 0 batch {P1_BATCH} (K1, K1's backward, "
          f"K2): loss {loss_k.item():.6f} kernels vs plain {loss_p.item():.6f} (|diff| "
          f"{loss_err:.3g}, tol 1e-5); every gradient within 1e-3 of its max + 1e-6 of the "
          f"largest ({scale:.3g}); worst {name} at {ratio:.3g} of its tolerance")
    # the chunked loss (two chunks of 8192 over 15004 rows) against the full
    # logits, on the kernel path with the features both would extract
    grid, roi = steps.visual_features(model, visual, batch)
    cached = {k: v for k, v in batch.items() if k not in ("images", "roi_images")}
    cached.update(grid=grid, roi=roi)
    chunked = seq2seq.FCMFSeq2Seq(cfg, dec_cfg, device=dev)
    chunked.load_state_dict(weights, strict=True)
    chunked.train()
    model.zero_grad(set_to_none=True)
    loss_f, acc_f = steps.pretrain_loss(model, visual, cached)
    loss_f.backward()
    loss_c, acc_c = steps.pretrain_loss(chunked, visual, cached, vocab_chunk=8192)
    loss_c.backward()
    torch.cuda.synchronize()
    chunk_err = abs(loss_c.item() - loss_f.item()) / abs(loss_f.item())
    if not chunk_err <= 1e-5 or acc_f.item() != acc_c.item():
        raise AssertionError(f"chunked loss {loss_c.item()} vs full {loss_f.item()}; accuracy "
                             f"{acc_c.item()} vs {acc_f.item()}")
    name, ratio, _ = grad_gap(chunked, model, "chunked vs full-logits gradients", 1e-5)
    print(f"phase pretrain_step vocab_chunk 8192 vs 0 (f32, cached features): loss "
          f"{loss_c.item():.6f} vs {loss_f.item():.6f} (rel diff {chunk_err:.3g}, tol 1e-5), "
          f"token accuracy equal; every gradient within 1e-5 of its max + 1e-6 of the largest; "
          f"worst {name} at {ratio:.3g} of its tolerance")
    del plain, plain_batch, chunked, loss_k, loss_p, loss_f, loss_c
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()

    def trainer(dtype: str):
        *_, m, v = build(dtype, True, 0.1)  # the reference's dropout rates
        m.load_state_dict(weights, strict=True)
        v.load_state_dict(visual.state_dict(), strict=True)
        # pretrain.py's defaults: 5e-5, wd 1e-5, clip 1.0
        opt = optim.AdamW(m, optim.linear_warmup_schedule(5e-5, 1, 1000), weight_decay=1e-5,
                          max_grad_norm=1.0)
        return m, v, steps.make_pretrain_train_step(train_state.TrainState.create(m, v, opt))

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    results = {}
    per_feed = 1 + P1_STEPS
    for dtype in ("float32", "bfloat16"):
        m, v, step = trainer(dtype)
        feeds = {"cached": {**cached, "grid": grid.to(m.config.model.torch_dtype),
                            "roi": roi.to(m.config.model.torch_dtype)}, "cold": batch}
        all_losses = []
        for feed, b in feeds.items():
            before = dict(cuda_lib.launch_counts)
            all_losses += [step(b, seed=0)["loss"] for _ in range(per_feed)]
            got = {k: n - before.get(k, 0) for k, n in cuda_lib.launch_counts.items()
                   if n != before.get(k, 0)}
            variant = K1_VARIANT[m.config.model.torch_dtype]
            want = {} if feed == "cached" else {
                "device_normalize": 2 * per_feed, **k5_counts({dtype: 2 * per_feed})}
            for name in ("fused_self_attention", "fused_self_attention_bwd"):
                want.update({name: k1 * per_feed, f"{name}.{variant}": k1 * per_feed})
            if got != want:
                raise AssertionError(f"pretrain_step {dtype} {feed}: launches {got} != {want}")
        all_losses = [x.item() for x in all_losses]
        # one batch with dropout on: single steps go up as well as down, so
        # the last three are held against the first (the rule of phase train)
        if not all(math.isfinite(x) for x in all_losses) or \
                not sum(all_losses[-3:]) / 3 < all_losses[0]:
            raise AssertionError(f"pretrain_step {dtype}: losses {all_losses} not finite and "
                                 f"falling")
        results[dtype] = all_losses
        del m, v, step, feeds
        torch.cuda.empty_cache()
    launches = dict(cuda_lib.launch_counts)
    for dtype in ("float32", "bfloat16"):
        print(f"phase pretrain_step {dtype} losses over {len(results[dtype])} steps on one "
              f"batch ({per_feed} on cached features, then {per_feed} cold; dropout 0.1): "
              + " ".join(f"{x:.4f}" for x in results[dtype]))
    n_steps = sum(len(results[dtype]) for dtype in ("float32", "bfloat16"))
    print(f"phase pretrain_step launches over {n_steps} steps: {launches} (a step: 12 K1 "
          f"forward, 12 K1 backward (wgmma variants in bf16, tf32x3 in f32), 2 K2 cold "
          f"and 0 on cached features, 0 K3)")
    return launches


def phase_decode(dev, card, cuda_lib, config, layers, seq2seq, resnet, steps):
    """Greedy and beam-3 decode at full width, batch 16, 20 steps, on cached
    features: the kernel path's tokens against the plain path's in f32,
    greedy against beam 1, the incremental logits against teacher forcing on
    the greedy tokens; then the bf16 calls (the drivers' default) timed:
    wall around a synchronize, the kernels' device time from `torch.profiler`."""
    build = functools.partial(build_seq2seq, dev, config, seq2seq, resnet)
    cfg, dec_cfg, model32, visual = build("float32", True, 0.1)
    # a wider table than the init's 0.02, so that the logits' leaders stand
    # apart by more than the two paths' rounding (f32, no exact ties)
    layers.init_weights(model32, torch.Generator(dev).manual_seed(24), 0.05)
    layers.init_weights(visual, torch.Generator(dev).manual_seed(25))
    *_, plain32, _ = build("float32", False, 0.1)
    *_, model16, _ = build("bfloat16", True, 0.1)
    for m in (plain32, model16):
        m.load_state_dict(model32.state_dict(), strict=True)
    batch = pretrain_batch(dev, cfg, dec_cfg)
    with torch.inference_mode():
        grid, roi = steps.extract_visual(visual, batch["images"], batch["roi_images"])
    bos, eos, t = 0, 2, dec_cfg.max_decode_len
    kw = dict(attention_mask=batch["attention_mask"], added_attention_mask=batch["added_mask"],
              max_len=t)

    def args(model, rows=slice(None)):
        dt = model.config.model.torch_dtype
        return (batch["enc_input_ids"][rows], grid[rows].to(dt), roi[rows].to(dt),
                batch["roi_coors"][rows], bos, eos)

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    greedy = model32.greedy_decode(*args(model32), **kw)
    beam, beam_scores = model32.beam_decode(*args(model32), beam_size=3, **kw)
    one, _ = model32.beam_decode(*args(model32), beam_size=1, **kw)
    greedy16 = model16.greedy_decode(*args(model16), **kw)
    beam16, _ = model16.beam_decode(*args(model16), beam_size=3, **kw)
    two = {k: v[:2] for k, v in kw.items() if k != "max_len"}
    debug = model16.greedy_decode(*args(model16, slice(0, 2)), max_len=t, **two)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    k1 = cfg.text.num_hidden_layers  # the encoder runs once a call, the decoder has no K1
    want = {"fused_self_attention": 6 * k1, "fused_self_attention.tf32x3": 3 * k1,
            "fused_self_attention.wgmma": 3 * k1}
    if launches != want:
        raise AssertionError(f"decode launch counts {launches} != {want}")
    greedy_p = plain32.greedy_decode(*args(plain32), **kw)
    beam_p, beam_scores_p = plain32.beam_decode(*args(plain32), beam_size=3, **kw)
    torch.cuda.synchronize()
    if cuda_lib.launch_counts != launches:
        raise AssertionError("the plain decode launched a kernel")
    for name, got, ref in (("greedy", greedy, greedy_p), ("beam 3", beam, beam_p),
                           ("beam 1 vs greedy", one, greedy)):
        if got.shape != (P1_BATCH, t) or not torch.equal(got, ref):
            raise AssertionError(f"decode {name}: tokens differ in "
                                 f"{(got != ref).sum().item()} of {got.numel()} places")
    score_err = (beam_scores - beam_scores_p).abs().max().item()
    if not score_err <= 1e-3 or not torch.isfinite(beam_scores).all():
        raise AssertionError(f"beam scores kernels vs plain: {score_err}")
    for name, seqs in (("bf16 greedy", greedy16), ("bf16 beam", beam16), ("debug", debug)):
        if seqs.shape[1] != t or seqs.min() < 0 or seqs.max() >= dec_cfg.vocab_size:
            raise AssertionError(f"decode {name}: tokens {tuple(seqs.shape)} out of range")
    # the incremental branch against teacher forcing, on the greedy tokens
    with torch.inference_mode():
        dec_in = torch.cat([torch.full((P1_BATCH, 1), bos, dtype=torch.int32, device=dev),
                            greedy[:, :-1]], dim=1)
        full = model32(batch["enc_input_ids"], dec_in, grid, roi, batch["roi_coors"], None,
                       batch["attention_mask"], batch["added_mask"])
        enc, mask = model32.encode(batch["enc_input_ids"], grid, roi, batch["roi_coors"], None,
                                   batch["attention_mask"], batch["added_mask"])
        cache = model32.decoder.init_cache(P1_BATCH, dev)
        inc = torch.cat([model32.decode_step(dec_in[:, i:i + 1], enc, mask, cache, i)
                         for i in range(t)], dim=1)
    inc_err = (inc - full).abs().max().item()
    live = ~(dec_in == eos).cumsum(1).bool()  # a row's steps up to its first eos
    if not inc_err <= 1e-3 or not torch.equal(full.argmax(-1)[live], greedy[live].long()):
        raise AssertionError(f"incremental vs teacher-forcing logits: max abs err {inc_err} "
                             f"(atol 1e-3), or their argmax is not the greedy token")
    distinct = len(torch.unique(greedy))
    ended = (greedy == eos).any(1).float().mean().item()
    print(f"phase decode f32 batch {P1_BATCH}, {t} steps: greedy and beam-3 tokens equal the "
          f"plain path's, beam 1 equals greedy, beam scores within {score_err:.3g} (atol 1e-3); "
          f"incremental vs teacher-forcing logits max_abs_err={inc_err:.3g} (atol 1e-3); "
          f"{distinct} distinct tokens, {ended:.2f} of the rows reach eos")
    print(f"phase decode launches over 6 calls (greedy, beam 3, beam 1 in f32; greedy, beam 3, "
          f"a debug decode of 2 rows in bf16): {launches} (12 K1 a call: the encoder runs once)")

    def wall_ms(fn):
        fn()
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    calls = {("bfloat16", "greedy"): functools.partial(model16.greedy_decode, *args(model16),
                                                       **kw),
             ("bfloat16", "beam 3"): functools.partial(model16.beam_decode, *args(model16),
                                                       beam_size=3, **kw)}
    walls = {key: wall_ms(fn) for key, fn in calls.items()}
    # the card's share, after every wall time was taken
    for key, fn in calls.items():
        rows = device_profile(fn, iters=1, warmup=0, host_too=False)
        dev_ms, n = sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows)
        mid = sorted(walls[key])[1]
        print(f"phase decode {key[0]} {key[1]}: wall {spread(walls[key])} ms a call (median "
              f"(min-max) of 3), {dev_ms:.2f} ms of device time in {n} kernels "
              f"(torch.profiler, 1 call): the card is busy {dev_ms / mid:.2f} of a call, "
              f"on {card}")
        if key == ("bfloat16", "beam 3"):
            print("phase decode bfloat16 beam 3 profile, ms/call x calls/call, largest first:")
            for us, count, kernel in rows[:12]:
                print(f"  {us / 1e3:8.3f} x{count:5d}  {kernel[:100]}")
    return launches


PRETRAIN_ARTIFACTS = ("best.pt", "last.pt", "train.log", "metrics.jsonl")


def phase_pretrain(card, cuda_lib, synth, pretrain, finetune):
    """The two-phase pipeline from files at full width: a synthetic dataset,
    `pretrain.main` with its defaults (ResNet-152, L = 170, T = 20, 7
    images, 4 ROIs, batch 16, bf16, the card) for two epochs with the
    generation eval, a second `main` that resumes from `last` for one more,
    then `finetune.main --pretrained_iaog_path <that output>` for one epoch
    on the same `--feature_cache_dir`."""
    n_train, n_dev, n_test, epochs, layers_per_pass, debug_every = 64, 16, 16, 2, 12, 4
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        synth.write_dataset(data, n_train=n_train, n_layers=layers_per_pass, image_size=256,
                            seed=0, n_dev=n_dev, n_test=n_test)
        out, features = os.path.join(tmp, "phase1"), os.path.join(tmp, "features")
        argv = ["--pretrained_data_dir", os.path.join(data, "data"), "--image_dir",
                os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
                os.path.join(data, "tok"), "--seed", "0", "--log_every", "4",
                "--debug_decode_every", str(debug_every), "--feature_cache_dir", features,
                "--do_train"]
        # the main path: every count from 0, read right after
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        result = pretrain.main(argv + ["--do_eval", "--num_train_epochs", str(epochs)])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(cuda_lib.launch_counts)
        missing = [n for n in PRETRAIN_ARTIFACTS if not os.path.isfile(os.path.join(out, n))]
        if missing:
            raise AssertionError(f"pretrain: artifacts missing: {missing}")
        cold, warm = result["epochs"]
        n_steps = cold["steps"]
        for name, ep in (("cold", cold), ("warm", warm)):
            if ep["steps"] != n_steps or n_steps < 4 or not ep["losses"] or \
                    not all(math.isfinite(x) for x in ep["losses"] + [ep["mean_loss"]]):
                raise AssertionError(f"pretrain {name} epoch: {ep}")
        if not warm["mean_loss"] < cold["mean_loss"] or \
                result["best_train_loss"] != warm["mean_loss"]:
            raise AssertionError(f"pretrain: mean loss {cold['mean_loss']} -> "
                                 f"{warm['mean_loss']}, best {result['best_train_loss']}")
        k1, debugs = layers_per_pass * n_steps, n_steps // debug_every
        forward = k1 + layers_per_pass * debugs  # a debug decode runs the encoder once
        want_warm = {"fused_self_attention": forward, "fused_self_attention.wgmma": forward,
                     "fused_self_attention_bwd": k1, "fused_self_attention_bwd.wgmma": k1}
        # a review's features are extracted by the first step that meets it;
        # an extracting pass over K5_MIN_FRAMES frames or more runs K5
        cold_k2 = cold["kernel_launches"].get("device_normalize", 0)
        cold_k5 = {k: v for k, v in cold["kernel_launches"].items()
                   if k.startswith("fused_bottleneck")}
        per_pass = k5_counts({"bfloat16": 1})
        k5_passes = cold_k5.get("fused_bottleneck", 0) // per_pass["fused_bottleneck"]
        if {k: v for k, v in cold["kernel_launches"].items()
                if k != "device_normalize" and k not in cold_k5} != want_warm or \
                not 2 <= cold_k2 <= 2 * n_steps or cold_k2 % 2 or \
                cold_k5 != k5_counts({"bfloat16": k5_passes}) or k5_passes > cold_k2 or \
                warm["kernel_launches"] != want_warm:
            raise AssertionError(f"pretrain launches: cold {cold['kernel_launches']}, warm "
                                 f"{warm['kernel_launches']} (want {want_warm}: no K2, every "
                                 f"review's features were cached in the first epoch)")
        gen = result["generation"]
        if set(gen) != {"rouge1", "rougeL", "bertscore_f1"} or \
                not all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in gen.values()):
            raise AssertionError(f"pretrain generation eval: {gen}")
        for name, ep in (("cold", cold), ("warm", warm)):
            print(f"phase pretrain {name} epoch: {ep['samples'] / ep['seconds']:.2f} samples/s, "
                  f"{ep['seconds'] * 1e3 / ep['steps']:.2f} ms/step wall ({debugs} debug "
                  f"decodes of 2 rows and the epoch's one read of its losses included), the "
                  f"host waited {ep['loader_wait_seconds'] / ep['seconds']:.3f} of the epoch "
                  f"for decoded batches; {ep['steps']} steps of batch {P1_BATCH}, mean loss "
                  f"{ep['mean_loss']:.4f}, launches {ep['kernel_launches']}, on {card}")
        print(f"phase pretrain main: {main_s:.1f} s for {epochs} epochs + checkpoints + the "
              f"generation eval (beam 3 over the dev samples, BERTScore on the model's own "
              f"backbone): {gen}; launches {launches}")

        resumed = pretrain.main(argv + ["--num_train_epochs", str(epochs + 1),
                                        "--resume_from_checkpoint", "last"])
        more = resumed["epochs"]
        if len(more) != 1 or more[0]["epoch"] != epochs or \
                more[0]["first_step"] != epochs * n_steps or more[0]["steps"] != n_steps or \
                more[0]["kernel_launches"] != want_warm or \
                not math.isfinite(more[0]["mean_loss"]):
            # a new process state starts with an empty device cache and
            # fills it from the disk cache: still no pixels, no K2
            raise AssertionError(f"pretrain resume: {more}")
        print(f"phase pretrain resume from last: epoch {more[0]['epoch']} only, from step "
              f"{more[0]['first_step']}, {more[0]['steps']} steps on features prefilled from "
              f"the disk cache (K2 0), {more[0]['samples'] / more[0]['seconds']:.2f} samples/s, "
              f"mean loss {more[0]['mean_loss']:.4f}")

        # Phase 2 on Phase 1's encoder and on its disk features
        phase1 = torch.load(os.path.join(out, "best.pt"), map_location="cpu",
                            weights_only=True)["model"]
        taken = {}
        ft_out = os.path.join(tmp, "phase2")
        before = dict(cuda_lib.launch_counts)
        ft = finetune.main(
            ["--data_dir", os.path.join(data, "data"), "--image_dir",
             os.path.join(data, "images"), "--output_dir", ft_out, "--pretrained_hf_model",
             os.path.join(data, "tok"), "--seed", "0", "--log_every", "4", "--do_train",
             "--num_train_epochs", "1", "--pretrained_iaog_path", out, "--feature_cache_dir",
             features],
            model_hook=lambda model, visual: taken.update(
                {k: v.detach().cpu() for k, v in model.state_dict().items()}))
        ft_launches = {k: v - before.get(k, 0) for k, v in cuda_lib.launch_counts.items()
                       if v != before.get(k, 0)}
        encoder = [k for k in taken if k.startswith("encoder.")]
        wrong = [k for k in encoder if not torch.equal(taken[k], phase1[k])]
        if wrong or len(encoder) < 200 or not torch.equal(
                taken["encoder.bert.cell.embeddings.word_embeddings.weight"],
                phase1["decoder.embedding.weight"]):
            raise AssertionError(f"transfer: {len(wrong)} of {len(encoder)} encoder tensors "
                                 f"differ from the Phase-1 checkpoint's: {wrong[:5]}")
        with open(os.path.join(ft_out, "train.log")) as f:
            log = f.read()
        ep = ft["epochs"][0]
        if "Transferring IAOG encoder from" not in log or \
                f"prefilled {n_train}/{n_train} rows from disk" not in log or \
                ft_launches.get("device_normalize", 0) != 0 or ep["steps"] != n_train // BATCH \
                or not all(math.isfinite(x) for x in ep["losses"]):
            raise AssertionError(f"phase 2 on phase 1: launches {ft_launches}, epoch {ep}")
        print(f"phase pretrain -> finetune: {len(encoder)} encoder tensors and the token table "
              f"equal the Phase-1 checkpoint's; all {n_train} train reviews' features prefilled "
              f"from Phase 1's disk cache (K2 0); {ep['steps']} steps, "
              f"{ep['samples'] / ep['seconds']:.2f} samples/s, losses "
              + " ".join(f"{x:.4f}" for x in ep["losses"]) + f"; launches {ft_launches}")
        for name, n in ft_launches.items():
            launches[name] = launches.get(name, 0) + n
        for name, n in more[0]["kernel_launches"].items():
            launches[name] = launches.get(name, 0) + n
    return launches


FT_CNN_BATCHES = (8, 4, 2)  # --fine_tune_cnn: the largest of these that fits the card
FT_CNN_STEPS = 3  # timed bf16 steps after one untimed


def fine_tune_cnn_step(dev, config, layers, fcmf, resnet, optim, train_state, steps, batch,
                       b: int) -> dict:
    """Timed bf16 `--fine_tune_cnn` steps (dropout 0.1, finetune.py's AdamW)
    at batch `b`: -> {ms, losses, peak_bytes}.  Raises OutOfMemoryError
    where `b` does not fit; its tensors are then gone with this frame."""
    kw = dict(dtype="bfloat16", fused_attention=True)
    cfg = config.FCMFConfig(model=config.ModelConfig(**kw), text=config.TextEncoderConfig(**kw))
    model, visual = fcmf.FCMF(cfg, device=dev), resnet.VisualFeatures(config.ResNetConfig(),
                                                                      device=dev)
    layers.init_weights(model, torch.Generator(dev).manual_seed(33), cfg.model.initializer_range)
    layers.init_weights(visual, torch.Generator(dev).manual_seed(34))
    opt = optim.AdamW(model, optim.linear_warmup_schedule(7e-5, 1, 1000), weight_decay=0.01,
                      max_grad_norm=1.0,
                      head_learning_rate=optim.linear_warmup_schedule(7e-4, 1, 1000))
    step = steps.make_finetune_train_step(
        train_state.TrainState.create(model, visual, opt, fine_tune_cnn=True))
    batch = {k: v[:b] for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch, seed=0)["loss"]]  # untimed: first launch of everything
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FT_CNN_STEPS):
        losses.append(step(batch, seed=0)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FT_CNN_STEPS
    peak = torch.cuda.max_memory_allocated()
    # one more step under torch.profiler, the card's activity only
    rows = device_profile(lambda: losses.append(step(batch, seed=0)["loss"]), iters=1, warmup=0,
                          host_too=False)
    return {"ms": ms, "losses": [x.item() for x in losses], "peak_bytes": peak,
            "device_ms": sum(r[0] for r in rows) / 1e3, "kernels": sum(r[1] for r in rows)}


def phase_fine_tune_cnn(dev, card, cuda_lib, config, layers, fcmf, resnet, steps, image_prep,
                        optim, train_state, finetune, data, work):
    """`--fine_tune_cnn` at full width, the ResNet-152 training beside the
    model: (1) one step's loss and gradients through the kernels (K2, K1,
    K1b) against the plain path, f32 with TF32 off, dropout 0, at batch 1
    (35 frames: f32 autograd through the ResNet at 8 would not fit), every
    ResNet tensor's gradient (convolutions and all four tensors of each
    FrozenBatchNorm) within 1e-3 of its largest; (2) timed bf16 steps at
    the largest batch of 8, 4, 2 that fits, with peak memory; (3)
    `finetune.main --fine_tune_cnn` for one epoch from the synthetic files
    at that batch (gradient accumulation keeps the effective batch at 8):
    K2 2, K1 12 and K1b 12 launches a step.  -> (launches, batch, the
    driver's output directory)."""
    def build(dtype: str, fused: bool):
        kw = dict(dtype=dtype, fused_attention=fused, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
        cfg = config.FCMFConfig(model=config.ModelConfig(**kw),
                                text=config.TextEncoderConfig(**kw))
        return cfg, fcmf.FCMF(cfg, device=dev)

    cfg, model = build("float32", True)
    _, plain = build("float32", False)
    layers.init_weights(model, torch.Generator(dev).manual_seed(31), cfg.model.initializer_range)
    plain.load_state_dict(model.state_dict(), strict=True)
    visual = resnet.VisualFeatures(config.ResNetConfig(dtype="float32"), device=dev)
    layers.init_weights(visual, torch.Generator(dev).manual_seed(32))
    random_bn_(visual, torch.Generator(dev).manual_seed(35))
    resnet.trainable_batchnorm_(visual).requires_grad_(True)
    full = serving_batch(dev, cfg)
    full["labels"] = torch.randint(0, cfg.num_labels, (BATCH, NUM_ASPECTS), device=dev,
                                   generator=torch.Generator(dev).manual_seed(36))
    batch = {k: v[:1] for k, v in full.items()}
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(batch[key],
                                                                        torch.float32)
    model.train()
    plain.train()
    loss_k, _ = steps.finetune_loss(model, visual, batch, fine_tune_cnn=True)
    loss_k.backward()
    kernel_grads = {n: p.grad.clone() for n, p in visual.named_parameters()}
    visual.zero_grad(set_to_none=True)
    loss_p, _ = steps.finetune_loss(plain, visual, plain_batch, fine_tune_cnn=True)
    loss_p.backward()
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item())
    if not loss_err <= 1e-5:
        raise AssertionError(f"fine_tune_cnn loss kernels {loss_k.item()} vs plain "
                             f"{loss_p.item()}")
    bn = [m for m in visual.modules() if isinstance(m, resnet.FrozenBatchNorm)]
    if len(kernel_grads) != len(bn) * 5:  # each BN follows one conv
        raise AssertionError(f"{len(kernel_grads)} ResNet parameters for {len(bn)} BatchNorms")
    worst = ("", 0.0)
    for name, p in visual.named_parameters():
        tol = 1e-3 * p.grad.abs().max().item()
        gap = (kernel_grads[name] - p.grad).abs().max().item()
        if not tol > 0:
            raise AssertionError(f"fine_tune_cnn: {name} got no gradient")
        worst = max(worst, (name, gap / tol), key=lambda t: t[1])
    if not worst[1] <= 1.0:
        raise AssertionError(f"fine_tune_cnn ResNet gradients: {worst[0]} at {worst[1]} of "
                             f"its tolerance")
    model_worst = grad_gap(model, plain, "fine_tune_cnn model gradients kernels vs plain", 1e-3)
    print(f"phase fine_tune_cnn grad check f32 dropout 0 batch 1 (K2, K1, K1b): loss "
          f"{loss_k.item():.6f} kernels vs plain {loss_p.item():.6f} (|diff| {loss_err:.3g}, "
          f"tol 1e-5); all {len(kernel_grads)} ResNet tensors ({len(bn)} BatchNorms x 4 "
          f"and their convs) within 1e-3 of each one's largest, worst {worst[0]} at "
          f"{worst[1]:.3g}; model gradients worst {model_worst[0]} at {model_worst[1]:.3g}")
    del model, plain, visual, kernel_grads, loss_k, loss_p, batch, plain_batch
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    tried = []
    for b in FT_CNN_BATCHES:
        try:
            timed = fine_tune_cnn_step(dev, config, layers, fcmf, resnet, optim, train_state,
                                       steps, full, b)
            break
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
        # out of the handler, the failed attempt's frame and tensors are gone
        gc.collect()
        torch.cuda.empty_cache()
        cuda_lib.reset_launch_counts()
    else:
        raise AssertionError(f"fine_tune_cnn: no batch of {FT_CNN_BATCHES} fits")
    launches = dict(cuda_lib.launch_counts)
    n = FT_CNN_STEPS + 2  # the untimed, the timed and the profiled steps
    want = {"device_normalize": 2 * n}
    for name in ("fused_self_attention", "fused_self_attention_bwd"):
        want.update({name: 12 * n, f"{name}.wgmma": 12 * n})
    if launches != want or not all(math.isfinite(x) for x in timed["losses"]):
        raise AssertionError(f"fine_tune_cnn steps: launches {launches} (want {want}), "
                             f"losses {timed['losses']}")
    del full
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase fine_tune_cnn bf16 batch {b} (did not fit: {tried or 'none'}): "
          f"{timed['ms']:.2f} ms/step over {FT_CNN_STEPS} steps after one untimed, "
          f"{b * 7 * 1e3 / timed['ms']:.1f} pairs/s; one more step under torch.profiler: "
          f"{timed['device_ms']:.2f} ms of device time in {timed['kernels']} kernels; peak memory "
          f"{timed['peak_bytes'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f} GiB; losses "
          + " ".join(f"{x:.4f}" for x in timed["losses"]) + f"; on {card}")

    out = os.path.join(work, "fine_tune_cnn")
    n_train = 16
    before = dict(cuda_lib.launch_counts)
    t0 = time.perf_counter()
    result = finetune.main(
        ["--data_dir", os.path.join(data, "data"), "--image_dir", os.path.join(data, "images"),
         "--output_dir", out, "--pretrained_hf_model", os.path.join(data, "tok"), "--seed", "0",
         "--log_every", "1", "--do_train", "--fine_tune_cnn", "--num_train_epochs", "1",
         "--train_batch_size", str(b), "--eval_batch_size", str(b),
         "--gradient_accumulation_steps", str(BATCH // b)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    (epoch,) = result["epochs"]
    k = n_train // b
    want = {"device_normalize": 2 * k}
    for name in ("fused_self_attention", "fused_self_attention_bwd"):
        want.update({name: 12 * k, f"{name}.wgmma": 12 * k})
    if epoch["steps"] != k or epoch["kernel_launches"] != want or \
            not all(math.isfinite(x) for x in epoch["losses"]) or \
            not os.path.isfile(os.path.join(out, "last.pt")):
        raise AssertionError(f"fine_tune_cnn driver: epoch {epoch} (want launches {want})")
    for name, count in cuda_lib.launch_counts.items():
        launches[name] = launches.get(name, 0) + count - before.get(name, 0)
    print(f"phase fine_tune_cnn driver: finetune.main --fine_tune_cnn, 1 epoch of {k} steps "
          f"at batch {b} x {BATCH // b} accumulated, {main_s:.1f} s with the checkpoint; "
          f"{epoch['samples'] / epoch['seconds']:.2f} samples/s, losses "
          + " ".join(f"{x:.4f}" for x in epoch["losses"])
          + f"; launches {epoch['kernel_launches']} (no feature cache: K2 every step)")
    return launches, b, out


def phase_labelers(card, data, image_categories, roi_categories, work):
    """Both offline labelers from the synthetic files at their defaults
    (ResNet-152 in bf16, plain Adam over every parameter, the card):
    `--do_train` for one epoch, then `--get_cate`; the ROI tool on a label
    CSV written from `roi_data.csv` with labels drawn from a seed.  Each
    output JSON must name every image.  -> the two classifier files."""
    images = os.path.join(data, "images")
    names = sorted(os.listdir(images))
    out = os.path.join(work, "labelers")
    classes = image_categories.DEFAULT_CLASSES
    g = torch.Generator().manual_seed(37)
    roi_csv = os.path.join(work, "roi_labels.csv")
    with open(os.path.join(data, "data", "roi_data.csv")) as f:
        lines = f.read().splitlines()
    with open(roi_csv, "w") as f:
        f.write(lines[0] + ",label\n")
        for line in lines[1:]:
            f.write(f"{line},{classes[int(torch.randint(0, len(classes), (1,), generator=g))]}\n")
    common = ["--image_dir", images, "--output_dir", out, "--batch_size", "4",
              "--num_train_epochs", "1", "--seed", "0", "--do_train", "--get_cate"]
    runs = {}
    for name, tool, extra in (
            ("image", image_categories,
             ["--image_label_path", os.path.join(data, "data", "resnet152_image_label.json")]),
            ("roi", roi_categories, ["--roi_label_path", roi_csv])):
        t0 = time.perf_counter()
        result = tool.main(common + extra)
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0, result)
        if sorted(result["labels"]) != names or \
                not all(set(v) <= set(classes) for v in result["labels"].values()):
            raise AssertionError(f"labelers {name}: labels {result['labels']}")
    files = tuple(os.path.join(out, f"{n}_classifier_best") for n in ("image", "roi"))
    with open(os.path.join(out, "resnet152_image_label.json")) as f:
        if json.load(f) != runs["image"][1]["labels"] or not all(map(os.path.isfile, files)):
            raise AssertionError("labelers: outputs missing")
    for name, (sec, result) in runs.items():
        tags = sum(len(v) for v in result["labels"].values())
        print(f"phase labelers {name}: --do_train 1 epoch + --get_cate in {sec:.1f} s "
              f"(ResNet-152 bf16, Adam over every parameter, the BatchNorms' four tensors "
              f"included); dev acc {result['best_dev_acc']:.3f}; {len(result['labels'])} "
              f"images labelled, {tags} tags; on {card}")
    return files


def phase_mde(dev, card, cuda_lib, config, layers, fcmf, resnet, steps, image_prep):
    """The FCMF with the Multimodal Denoising Encoder (`use_mde`, alpha
    0.7: 34 of 49 patches) at full width, batch 8: the serving forward and
    one train step's loss and gradients (dropout 0) in f32 and bf16 through
    the kernels, against the plain path.  f32 (TF32 off): logits within
    1e-3, the same predictions, the loss within 1e-5, every gradient within
    1e-3 of its largest.  bf16, where the guidance scores tie and the
    top-k picks may differ from f32's: its logits, loss and gradients as
    close to the plain f32 path as the plain bf16 path is, twice over."""
    def build(dtype: str, fused: bool):
        kw = dict(dtype=dtype, fused_attention=fused, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
        cfg = config.FCMFConfig(model=config.ModelConfig(**kw),
                                text=config.TextEncoderConfig(**kw), use_mde=True, alpha=0.7)
        return cfg, fcmf.FCMF(cfg, device=dev)

    cfg, m32 = build("float32", True)
    layers.init_weights(m32, torch.Generator(dev).manual_seed(41), cfg.model.initializer_range)
    models = {("f32", "kernels"): m32, ("bf16", "kernels"): build("bfloat16", True)[1],
              ("f32", "plain"): build("float32", False)[1],
              ("bf16", "plain"): build("bfloat16", False)[1]}
    for m in models.values():
        m.load_state_dict(m32.state_dict(), strict=True)
        m.train()
    visuals = {"f32": resnet.VisualFeatures(config.ResNetConfig(dtype="float32"), device=dev)}
    layers.init_weights(visuals["f32"], torch.Generator(dev).manual_seed(42))
    visuals["bf16"] = resnet.VisualFeatures(config.ResNetConfig(), device=dev)
    visuals["bf16"].load_state_dict(visuals["f32"].state_dict(), strict=True)
    batch = serving_batch(dev, cfg)
    batch["labels"] = torch.randint(0, cfg.num_labels, (BATCH, NUM_ASPECTS), device=dev,
                                    generator=torch.Generator(dev).manual_seed(43))
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    plain_batches = {}
    for name, dt in dts.items():
        plain_batches[name] = dict(batch)
        for key in ("images", "roi_images"):
            plain_batches[name][key] = image_prep.unpack_normalize_pixels_reference(batch[key],
                                                                                    dt)
        # the frozen ResNet's features as the kernel path computes them (K5
        # on stages 1-3 by `resnet.takes_k5`), given to the plain path: the
        # comparison holds K1 and the MDE alone, and the box head's gate
        # gradients, which carry 1/g (PERF.md section 2), see one input
        with torch.no_grad():
            grid, roi = steps.extract_visual(visuals[name], plain_batches[name]["images"],
                                             plain_batches[name]["roi_images"], out_dtype=dt)
        plain_batches[name].update(grid=grid, roi=roi)

    def run(dtype: str, path: str) -> dict:
        model, visual = models[(dtype, path)], visuals[dtype]
        b = batch if path == "kernels" else plain_batches[dtype]
        preds, logits = steps.make_finetune_eval_step(model, visual)(b)
        loss, _ = steps.finetune_loss(model, visual, b)
        loss.backward()
        return {"preds": preds, "logits": logits.float(), "loss": loss.item(),
                "grads": {n: p.grad.float() for n, p in model.named_parameters()
                          if p.grad is not None}}

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    got = {(dt, "kernels"): run(dt, "kernels") for dt in dts}
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    want = {"device_normalize": 8, "fused_self_attention": 48, "fused_self_attention.wgmma": 24,
            "fused_self_attention.tf32x3": 24, "fused_self_attention_bwd": 24,
            "fused_self_attention_bwd.wgmma": 12, "fused_self_attention_bwd.tf32x3": 12,
            **k5_counts({"float32": 4, "bfloat16": 4})}
    if launches != want:
        raise AssertionError(f"mde launch counts {launches} != {want}")
    got.update({(dt, "plain"): run(dt, "plain") for dt in dts})
    torch.cuda.synchronize()
    if cuda_lib.launch_counts != launches:
        raise AssertionError("the mde plain path launched a kernel")

    k32, p32 = got[("f32", "kernels")], got[("f32", "plain")]
    err = (k32["logits"] - p32["logits"]).abs().max().item()
    loss_err = abs(k32["loss"] - p32["loss"])
    if not (err <= 1e-3 and torch.equal(k32["preds"], p32["preds"]) and loss_err <= 1e-5):
        raise AssertionError(f"mde f32: logits err {err}, loss err {loss_err}, preds equal "
                             f"{torch.equal(k32['preds'], p32['preds'])}")
    worst = grad_gap(models[("f32", "kernels")], models[("f32", "plain")],
                     "mde f32 gradients kernels vs plain", 1e-3)
    if "encoder.mde.guidance_attention.w_kx" in k32["grads"]:
        raise AssertionError("the MDE's guidance attention got a gradient")

    def gaps(a: dict) -> tuple:
        flat = lambda d: torch.cat([d["grads"][n].flatten() for n in sorted(p32["grads"])])
        return ((a["logits"] - p32["logits"]).abs().max().item(), abs(a["loss"] - p32["loss"]),
                (flat(a) - flat(p32)).norm().item() / flat(p32).norm().item())

    k16, pl16 = gaps(got[("bf16", "kernels")]), gaps(got[("bf16", "plain")])
    if not all(k <= 2 * p + 1e-3 for k, p in zip(k16, pl16)):
        raise AssertionError(f"mde bf16 kernels {k16} vs the plain bf16 path's {pl16} "
                             f"(logits, loss, relative gradient gap to plain f32)")
    print(f"phase mde f32 (alpha 0.7, 34 of 49 patches kept): kernels vs plain logits "
          f"max_abs_err={err:.3g} (atol 1e-3, TF32 off), preds equal, loss |diff| "
          f"{loss_err:.3g} (tol 1e-5), gradients worst {worst[0]} at {worst[1]:.3g} of "
          f"1e-3 of its largest; the guidance attention gets no gradient (as in JAX)")
    print(f"phase mde bf16 against plain f32 (logits max err, loss err, relative gradient "
          f"gap): kernels {tuple(f'{x:.3g}' for x in k16)}, plain bf16 "
          f"{tuple(f'{x:.3g}' for x in pl16)} (kernels <= 2 x plain + 1e-3); forward + loss "
          f"+ backward of both dtypes through the kernels {kernel_s:.2f} s; launches "
          f"{launches}; on {card}")
    return launches


SERVE_RECORDS, SERVE_BATCH = 16, 8


def phase_serve(card, cuda_lib, cli, fcmf, steps, data, ft_out, taggers, work):
    """The inference CLI (`python -m macsa_tpu_torch.inference.cli`) at
    full width in f32 on the card: batch mode over 16 synthetic records at
    `--batch_size 8`, then single-sample mode, serving the `--fine_tune_cnn`
    run's checkpoint (its trained ResNet), tagging images with the
    labelers' classifiers, ROIs from `--roi_csv`.  Its predictions must
    equal the argmax of `make_finetune_eval_step` through the plain path on
    the tensors the CLI builds (`cli.Server`).  -> launches."""
    with open(os.path.join(data, "data", "train.json")) as f:
        records = [{"text": r["comment"],
                    "image_list": [os.path.join(data, "images", n) for n in r["list_img"]]}
                   for r in json.load(f)[:SERVE_RECORDS]]
    records_json = os.path.join(work, "records.json")
    with open(records_json, "w") as f:
        json.dump(records, f, ensure_ascii=False)
    argv = ["--checkpoint", ft_out, "--pretrained_hf_model", os.path.join(data, "tok"),
            "--image_model_checkpoint", taggers[0], "--roi_model_checkpoint", taggers[1],
            "--roi_csv", os.path.join(data, "data", "roi_data.csv")]
    out_jsonl, out_json = os.path.join(work, "served.jsonl"), os.path.join(work, "one.json")

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    summary = cli.main(argv + ["--input_json", records_json, "--batch_size", str(SERVE_BATCH),
                               "--output_file", out_jsonl])
    t0 = time.perf_counter()
    single = cli.main(argv + ["--text", records[0]["text"], "--image_list",
                              *records[0]["image_list"], "--output_file", out_json])
    single_s = time.perf_counter() - t0
    launches = dict(cuda_lib.launch_counts)
    forwards = SERVE_RECORDS // SERVE_BATCH + 1
    # K5: both passes of a batch forward; of the single record's, its 28 ROI
    # crops and not its 7 images; none in the taggers' one-image calls
    k5 = collections.Counter(k5_counts({"float32": 2 * (forwards - 1)}))
    k5.update(k5_counts({"float32": 1}, frames=28))
    k5.update(k5_counts({"float32": 1}, frames=7))
    want = {"fused_self_attention": 12 * forwards, "fused_self_attention.tf32x3": 12 * forwards,
            **k5}
    if launches != want:
        raise AssertionError(f"serve launches {launches} != {want} (f32: K1's 3xTF32 "
                             f"variant; host-normalized pixels: no K2)")
    with open(out_jsonl) as f:
        rows = [json.loads(line) for line in f]

    # the same tensors through the plain path
    server = cli.Server(cli.build_argparser().parse_args(argv + ["--text", "-"]))
    cfg = server.config
    plain_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, fused_attention=False),
        text=dataclasses.replace(cfg.text, fused_attention=False))
    plain = fcmf.FCMF(plain_cfg, device=server.device)
    plain.load_state_dict(server.model.state_dict(), strict=True)
    plain_step = steps.make_finetune_eval_step(plain, server.visual)
    recs = [server.prep_record(r["text"], r["image_list"]) for r in records]
    with resnet_modules_only():
        preds = torch.cat([plain_step(server.batch(recs[i:i + SERVE_BATCH]))[0]
                           for i in range(0, len(recs), SERVE_BATCH)]).cpu().tolist()
        single_plain = cli.report(plain_step(server.batch(recs[:1]))[0][0].cpu().tolist())
    torch.cuda.synchronize()
    if cuda_lib.launch_counts != launches:
        raise AssertionError("the serve plain path launched a kernel")
    want_rows = [{"image_tags": rec["img_tags"], "roi_tags": rec["roi_tags"],
                  "prediction": cli.report(p)} for rec, p in zip(recs, preds)]
    got_rows = [{k: r[k] for k in ("image_tags", "roi_tags", "prediction")} for r in rows]
    if got_rows != want_rows or single != single_plain:
        raise AssertionError(f"serve: the CLI's {got_rows[:2]}... vs the plain path's "
                             f"{want_rows[:2]}...; single {single}")
    print(f"phase serve batch: {summary['records']} records at --batch_size "
          f"{summary['batch_size']}, records_per_s {summary['records_per_s']} (host "
          f"preparation {summary['host_prep_share']:.3f} of the time: decode, resize, the two "
          f"taggers, tokenize; the forward {summary['forward_share']:.3f}); predictions equal "
          f"the plain path's argmax; single-sample call {single_s:.2f} s with its model load; "
          f"{sum(len(r['image_tags']) for r in rows)} image tags, "
          f"{sum(len(r['roi_tags']) for r in rows)} ROI tags; launches {launches}; on {card}")
    return launches


def phase_k1_baseline_shapes(dev, cuda_lib, fa) -> dict:
    """K1's forward and backward against their plain versions at the
    baselines' shapes: EF-CapTrRoBERTa's [48, 256, 768] (`--max_cap_length
    256`: bf16 on the tensor cores both ways, past 192 rows the forward's
    ring passes and the backward's two streaming launches) (`k1_at_shape`)."""
    return k1_at_shape(dev, cuda_lib, fa, 256, 12, "EF-CapTr shape", 29, 11)


def phase_k1_tp_shapes(dev, cuda_lib, fa) -> dict:
    """K1's forward and backward against their plain versions at one mp
    rank's share of the text encoder under tensor parallelism at mp 2 (phase
    tp): [48, 170, 384], 6 heads of 64 (bf16 on the tensor cores both ways,
    f32 as three TF32 products on them) (`k1_at_shape`)."""
    return k1_at_shape(dev, cuda_lib, fa, 170, 6, "mp 2 rank's shape", 31, 13)


def k1_at_shape(dev, cuda_lib, fa, l: int, h: int, label: str, data_seed: int,
                seed: int) -> dict:
    """K1's forward and backward against their plain versions at [48, l,
    h * 64], f32 and bf16, rates 0 and 0.1, with the tolerances of phases k1
    and k1_bwd, both ways on the `K1_VARIANT` of each dtype; each
    timed beside its bound, its plain version and SDPA (the forward) or
    SDPA's backward through autograd (rate 0).
    -> {"out", "grad": worst absolute errors, (dtype, rate): times}."""
    b, d = BATCH * NUM_ASPECTS, 64
    fwd_tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    bwd_tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of max|ref|
    g = torch.Generator(dev).manual_seed(data_seed)
    lens = torch.randint(24, l + 1, (b,), device=dev, generator=g)
    lens[:8] = l
    mask = torch.zeros(b, l, device=dev).masked_fill(
        torch.arange(l, device=dev)[None, :] >= lens[:, None], torch.finfo(torch.float32).min)
    q, k, v, gout = (torch.randn(b, l, h * d, device=dev, generator=g) for _ in range(4))
    report = {"out": 0.0, "grad": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        qc, kc, vc, gc = (x.to(dtype) for x in (q, k, v, gout))
        fwd_v, bwd_v = fa.attention_variant(dtype, d, l), fa.attention_variant(dtype, d, l, True)
        if (fwd_v, bwd_v) != (K1_VARIANT[dtype], K1_VARIANT[dtype]):
            raise AssertionError(f"K1 [{b},{l},{h * d}] {dtype}: variants {fwd_v}, {bwd_v}")
        for rate in (0.0, 0.1):
            leaves = [x.clone().requires_grad_(True) for x in (qc, kc, vc)]
            cuda_lib.reset_launch_counts()
            out = fa.fused_self_attention(*leaves, mask, h, rate, seed)
            grads = torch.autograd.grad(out, leaves, gc)
            expect_counts(cuda_lib, {"fused_self_attention": 1,
                                     f"fused_self_attention.{fwd_v}": 1,
                                     "fused_self_attention_bwd": 1,
                                     f"fused_self_attention_bwd.{bwd_v}": 1},
                          f"K1 [{b},{l},{h * d}] {dtype} rate {rate}")
            wants = (fa.attention_reference(qc, kc, vc, mask, h, rate, seed),
                     *fa.attention_backward_reference(qc, kc, vc, mask, gc, h, rate, seed))
            errs = {}
            for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), wants):
                err = (got.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                tol_ok = (err <= fwd_tol[dtype] if (name, rate) == ("out", 0.0)
                          else rel <= bwd_tol[dtype])
                if not tol_ok:
                    raise AssertionError(f"K1 {name} [{b},{l},{h * d}] {dtype} rate {rate}: "
                                         f"error {err} ({rel} of max|ref|)")
                errs[name] = err if (name, rate) == ("out", 0.0) else rel
                key = "out" if name == "out" else "grad"
                report[key] = max(report[key], err)
            fwd = functools.partial(fa._launch_fwd, qc, kc, vc, mask, h, rate, seed, False)
            lse = fa._launch_fwd(qc, kc, vc, mask, h, rate, seed, with_lse=True)[1]
            bwd = functools.partial(fa._launch_bwd, qc, kc, vc, mask, lse, gc, h, rate, seed)
            times = {"fwd_ms": cuda_ms(fwd, iters=50), "bwd_ms": cuda_ms(bwd, iters=50, warmup=5),
                     "fwd_plain_ms": cuda_ms(lambda: fa.attention_reference(
                         qc, kc, vc, mask, h, rate, seed), iters=5),
                     "bwd_plain_ms": cuda_ms(lambda: fa.attention_backward_reference(
                         qc, kc, vc, mask, gc, h, rate, seed), iters=5),
                     "fwd_variant": fwd_v, "bwd_variant": bwd_v,
                     "fwd_bound": attention_bound(b, l, h, d, dtype, backward=False),
                     "bwd_bound": attention_bound(b, l, h, d, dtype, backward=True),
                     "fwd_library_ms": None, "bwd_library_ms": None}
            if rate == 0.0:  # SDPA's own dropout draws another mask
                q4, k4, v4, m4 = sdpa_inputs(qc, kc, vc, mask, h)
                times["fwd_library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4), iters=50)
                q4, k4, v4, m4 = sdpa_inputs(*leaves, mask, h)
                lib = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)
                g4 = sdpa_inputs(gc, gc, gc, mask, h)[0]
                lib_bwd = functools.partial(torch.autograd.grad, lib, leaves, g4,
                                            retain_graph=True)
                times["bwd_library_ms"] = cuda_ms(lib_bwd, iters=50, warmup=5)
                # both backwards again with the host out of the way: through
                # autograd SDPA's calls time the host
                times["bwd_queued"] = queued_ms(bwd)
                times["bwd_library_queued"] = queued_ms(lib_bwd)
            report[(dtype, rate)] = times
            lib_text = lambda key: ("none" if times[key] is None else f"{times[key]:.4f}")
            queued = ("" if rate != 0.0 else
                      f"; queued behind a spin kernel (host out of the way; host ahead: "
                      f"{times['bwd_queued'][1]}, {times['bwd_library_queued'][1]}): bwd "
                      f"{times['bwd_queued'][0]:.4f}, SDPA backward "
                      f"{times['bwd_library_queued'][0]:.4f}")
            print(f"phase k1 {str(dtype)[6:]} {label} [{b},{l},{h * d}] h={h} mask "
                  f"finfo.min rate {rate}: errors "
                  + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
                  + f" (out at rate 0 absolute, atol {fwd_tol[dtype]}; else of max|ref|, tol "
                  f"{bwd_tol[dtype]}); fwd ({fwd_v}) kernel_ms={times['fwd_ms']:.4f} "
                  f"plain_ms={times['fwd_plain_ms']:.4f} library_ms={lib_text('fwd_library_ms')}"
                  f" (SDPA) {bound_text(times['fwd_bound'])}; bwd ({bwd_v}) "
                  f"kernel_ms={times['bwd_ms']:.4f} plain_ms={times['bwd_plain_ms']:.4f} "
                  f"library_ms={lib_text('bwd_library_ms')} (SDPA backward through autograd) "
                  f"{bound_text(times['bwd_bound'])}" + queued)
            del leaves, out, grads, wants, lse
    cuda_lib.reset_launch_counts()
    return report


# the baselines' text rows (train_baselines.py: --max_seq_length, --max_cap_length)
BASELINE_ROWS = {"mroberta": 170, "tomroberta": 170, "efcap": 256}
BASELINE_TARGET, BASELINE_ROIS, BASELINE_STEPS = 16, 7, 3  # TomBERT's target; 7 x 7 ROIs


def baseline_batch(dev, name: str, b: int) -> dict:
    """Loader-shaped batch of `b` reviews x 6 aspects for baseline `name`,
    made on the card from a seed: token views at the model's rows (TomBERT's
    16-token targets beside), and for mRoBERTa and TomBERT host-normalized
    f32 frames of 7 images and 7 x 7 ROI crops, as their datasets ship them."""
    g = torch.Generator(dev).manual_seed(43)
    a = NUM_ASPECTS

    def views(l, shortest):
        lens = torch.randint(shortest, l + 1, (b, a), device=dev, generator=g)
        lens[0] = l
        pad = torch.arange(l, device=dev) >= lens[..., None]
        ids = torch.randint(3, 15004, (b, a, l), device=dev, generator=g)
        return ids.masked_fill(pad, 1).to(torch.int32), (~pad).to(torch.int32)

    batch = dict(zip(("input_ids", "attention_mask"), views(BASELINE_ROWS[name], 24)))
    batch["labels"] = torch.randint(0, 4, (b, a), device=dev, generator=g)
    if name != "efcap":
        batch["images"] = torch.randn(b, 7, 224, 224, 3, device=dev, generator=g)
        batch["roi_images"] = torch.randn(b, 7, BASELINE_ROIS, 224, 224, 3, device=dev,
                                          generator=g)
    if name == "tomroberta":
        batch["target_ids"], batch["target_mask"] = views(BASELINE_TARGET, 2)
    return batch


def build_baseline(dev, name: str, dtype: str, fused: bool, dropout: float):
    """(model, ResNet-152 or None) of baseline `name` at ViSoBERT's geometry
    (12 layers x 768, vocab 15004), random weights from a seed."""
    from macsa_tpu_torch import config
    from macsa_tpu_torch.models import baselines, layers, resnet
    kw = dict(dtype=dtype, fused_attention=fused, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    model = baselines.build_baseline(name, config.TextEncoderConfig(**kw), device=dev)
    layers.init_weights(model, torch.Generator(dev).manual_seed(44), 0.02)
    visual = None
    if name != "efcap":
        visual = resnet.VisualFeatures(config.ResNetConfig(dtype=dtype), device=dev)
        layers.init_weights(visual, torch.Generator(dev).manual_seed(45))
    return model, visual


def phase_baselines(dev, card, cuda_lib, data, captions, work) -> dict:
    """The paper's three baselines at full width (ViSoBERT geometry, 12 x
    768; L = 170, TomBERT's target 16, EF-CapTr 256; ResNet-152 over 7
    images and 49 ROI crops a review; random weights from a seed).  For
    each of mroberta, tomroberta and efcap: (1) one step's loss and
    gradients at dropout 0, f32 with TF32 off, batch 2, through the kernels
    against the plain path; (2) eval logits at batch 8, f32, kernels against
    plain (atol 1e-3, predictions equal); (3) 1 + 3 timed bf16 train steps
    at batch 8 (dropout 0.1, the driver's AdamW 2e-5, wd 0.01, clip 1.0):
    wall, host issue and CUDA-event time, peak memory, then one step under
    `torch.profiler` (the card's activity only), K1 12 and K1b 12 launches
    asserted a step (EF-CapTr's K1b in two launches a call), no K2; (4)
    `train_baselines.main` for one epoch with dev and test on the synthetic
    files (`efcap` with the captions of phase captions).  -> launches."""
    from macsa_tpu_torch.train import baseline_steps, optim, state as train_state
    from macsa_tpu_torch.train import train_baselines
    from macsa_tpu_torch.train.steps import aspect_loss
    launches = {}
    for name in ("mroberta", "tomroberta", "efcap"):
        # (1) gradients and (2) eval logits: kernels against the plain path, f32
        model, visual = build_baseline(dev, name, "float32", True, 0.0)
        plain, _ = build_baseline(dev, name, "float32", False, 0.0)
        plain.load_state_dict(model.state_dict(), strict=True)
        batch = baseline_batch(dev, name, BATCH)
        small = {k: v[:2] for k, v in batch.items()}
        model.train()
        plain.train()
        losses = []
        for m in (model, plain):
            loss, _ = aspect_loss(baseline_steps.baseline_forward(m, visual, small),
                                  small["labels"])
            loss.backward()
            losses.append(loss.item())
        loss_err = abs(losses[0] - losses[1])
        if not loss_err <= 1e-5:
            raise AssertionError(f"baseline {name} f32 loss kernels {losses[0]} vs plain "
                                 f"{losses[1]}")
        worst = grad_gap(model, plain, f"baseline {name} gradients kernels vs plain", 1e-3)
        preds, logits = baseline_steps.make_baseline_eval_step(model, visual)(batch)
        want_preds, want = baseline_steps.make_baseline_eval_step(plain, visual)(batch)
        torch.cuda.synchronize()
        logit_err = (logits - want).abs().max().item()
        if not logit_err <= 1e-3 or not torch.equal(preds, want_preds):
            raise AssertionError(f"baseline {name} eval f32: logits {logit_err} from the plain "
                                 f"path's, predictions equal {torch.equal(preds, want_preds)}")
        print(f"phase baselines {name} f32 dropout 0: batch-2 step loss kernels "
              f"{losses[0]:.6f} vs plain {losses[1]:.6f} (|diff| {loss_err:.3g}, tol 1e-5), "
              f"gradients within 1e-3 of each one's largest, worst {worst[0]} at "
              f"{worst[1]:.3g}; batch-8 eval logits max |diff| {logit_err:.3g} (atol 1e-3), "
              f"predictions equal")
        weights = model.state_dict()
        del model, plain, visual, preds, logits, want_preds, want, small
        gc.collect()
        torch.cuda.empty_cache()

        # (3) the main path: every count from 0, read right after
        model, visual = build_baseline(dev, name, "bfloat16", True, 0.1)
        model.load_state_dict(weights, strict=True)
        opt = optim.AdamW(model, optim.linear_warmup_schedule(2e-5, 1, 1000),
                          weight_decay=0.01, max_grad_norm=1.0)
        state = train_state.TrainState.create(
            model, visual if visual is not None else torch.nn.Module(), opt)
        step = baseline_steps.make_baseline_train_step(state)
        cuda_lib.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(batch, seed=0)["loss"]]  # untimed: first launch of everything
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(BASELINE_STEPS):
            losses.append(step(batch, seed=0)["loss"])
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3 / BASELINE_STEPS
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / BASELINE_STEPS
        event_ms = start.elapsed_time(end) / BASELINE_STEPS
        peak = torch.cuda.max_memory_allocated()
        rows = device_profile(lambda: losses.append(step(batch, seed=0)["loss"]), iters=1,
                              warmup=0, host_too=False)
        got = dict(cuda_lib.launch_counts)
        n = BASELINE_STEPS + 2  # the untimed, the timed and the profiled steps
        want = {"fused_self_attention": 12 * n, "fused_self_attention.wgmma": 12 * n,
                "fused_self_attention_bwd": 12 * n, "fused_self_attention_bwd.wgmma": 12 * n,
                **(k5_counts({"bfloat16": 2 * n}) if visual is not None else {})}
        losses = [x.item() for x in losses]
        if got != want or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"baseline {name} bf16 steps: launches {got} (want {want}; "
                                 f"no K2: host-normalized frames), losses {losses}")
        k1b = [(us, calls) for us, calls, kname in rows if "attention_bwd" in kname]
        k1 = [(us, calls) for us, calls, kname in rows if "attention_fwd" in kname]
        device = sum(r[0] for r in rows) / 1e3
        rows_text = ", ".join(f"{us / 1e3:.3f} x{calls} {kname[:60]}"
                              for us, calls, kname in rows[:6])
        print(f"phase baselines {name} bf16 batch {BATCH} (L {BASELINE_ROWS[name]}, "
              f"{BATCH * (7 + 7 * BASELINE_ROIS) if visual is not None else 0} frames through "
              f"ResNet-152): {wall_ms:.2f} ms/step wall, host issue {issue_ms:.2f}, CUDA events "
              f"{event_ms:.2f} over {BASELINE_STEPS} steps after one untimed; peak "
              f"{peak / 2**30:.2f} GiB; one step under torch.profiler: {device:.2f} ms of device "
              f"time in {sum(r[1] for r in rows)} kernels, K1 forward {sum(u for u, _ in k1) / 1e3:.3f}"
              f" ms, K1 backward (wgmma) {sum(u for u, _ in k1b) / 1e3:.3f} ms in "
              f"{sum(c for _, c in k1b)} kernels ({sum(u for u, _ in k1b) / 12e3:.3f} ms a call); "
              f"largest: {rows_text}; launches {got}; losses "
              + " ".join(f"{x:.4f}" for x in losses) + f"; on {card}")
        for key, count in got.items():
            launches[key] = launches.get(key, 0) + count
        del model, visual, opt, state, step, batch, weights
        gc.collect()
        torch.cuda.empty_cache()

        # (4) the driver from files, its defaults (bf16, batch 8, 7 images, 7 ROIs)
        out = os.path.join(work, f"baseline_{name}")
        before = dict(cuda_lib.launch_counts)
        t0 = time.perf_counter()
        result = train_baselines.main(
            ["--model", name, "--data_dir", os.path.join(data, "data"), "--image_dir",
             os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
             os.path.join(data, "tok"), "--seed", "0", "--log_every", "1", "--do_train",
             "--do_eval", "--do_test", "--num_train_epochs", "1"]
            + (["--caption_file", captions] if name == "efcap" else []))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        (epoch,) = result["epochs"]
        k = SERVE_RECORDS // BATCH
        want = {"fused_self_attention": 12 * k, "fused_self_attention.wgmma": 12 * k,
                "fused_self_attention_bwd": 12 * k, "fused_self_attention_bwd.wgmma": 12 * k,
                **(k5_counts({"bfloat16": 2 * k}) if name != "efcap" else {})}
        files = ("last.pt", "train.log", "metrics.jsonl", f"test_results_{name}.txt",
                 "test_predictions_formatted.txt")
        missing = [f for f in files if not os.path.isfile(os.path.join(out, f))]
        if epoch["steps"] != k or epoch["kernel_launches"] != want or missing or \
                not all(math.isfinite(x) for x in epoch["losses"]):
            raise AssertionError(f"baseline {name} driver: epoch {epoch} (want launches "
                                 f"{want}), missing {missing}")
        for key, count in cuda_lib.launch_counts.items():
            launches[key] = launches.get(key, 0) + count - before.get(key, 0)
        print(f"phase baselines {name} driver: train_baselines.main, 1 epoch of {k} steps at "
              f"batch {BATCH}, dev and test, {main_s:.1f} s with model build and checkpoints; "
              f"{epoch['samples'] / epoch['seconds']:.2f} samples/s, loader wait "
              f"{epoch['loader_wait_seconds'] / epoch['seconds']:.3f} of the epoch; losses "
              + " ".join(f"{x:.4f}" for x in epoch["losses"])
              + f"; test macro-F1 {result['test']['average']['f1']:.4f}; launches "
              f"{epoch['kernel_launches']}")
        shutil.rmtree(out)  # ~3 GB of checkpoints at full width
    return launches


def phase_captions(dev, card, data, work) -> str:
    """The CATR captioner behind `tools/generate_captions.py` at v3's full
    architecture (ResNet-101 in f32, d 256, 8 heads, 6 + 6 layers, FFN 2048,
    vocab 30522, 128 positions), a seeded random state dict under the
    torch-hub checkpoint's names and a generated 30522-entry `vocab.txt`
    ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103): the tool over
    the synthetic dataset's 12 images at batch 8, then teacher-forced logits
    of 2 images on the card against the port on the CPU (within 1e-3 of
    max|ref|).  -> the captions JSON, for the efcap driver."""
    from macsa_tpu_torch.models import catr
    from macsa_tpu_torch.tools import generate_captions
    cfg = catr.CATRConfig()
    checkpoint = os.path.join(work, "catr.pth")
    sd = catr.random_state_dict(cfg, torch.Generator(dev).manual_seed(51))
    torch.save({k: v.cpu() for k, v in sd.items()}, checkpoint)
    del sd
    vocab_dir = os.path.join(work, "bert")
    os.makedirs(vocab_dir, exist_ok=True)
    words = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    words += [f"##p{i}" if i % 3 == 2 else f"w{i}" for i in range(cfg.vocab_size - len(words))]
    with open(os.path.join(vocab_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    images = os.path.join(data, "images")
    out = os.path.join(work, "captions.json")
    t0 = time.perf_counter()
    result = generate_captions.main(["--image_dir", images, "--output_file", out,
                                     "--catr_checkpoint", checkpoint, "--bert_tokenizer",
                                     vocab_dir, "--batch_size", str(BATCH)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(images))
    if list(result) != names or not all(isinstance(c, str) for c in result.values()):
        raise AssertionError(f"captions: {len(result)} for {len(names)} images")

    # teacher forcing on 2 images: the card against the CPU, the same tokens
    pixels = torch.from_numpy(np.stack([generate_captions.square_pad_resize(
        os.path.join(images, n)) for n in names[:2]]))
    model = generate_captions.load_catr(checkpoint, dev)
    t1 = time.perf_counter()
    tokens = catr.greedy_decode(model, pixels.to(dev))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    with torch.inference_mode():
        got = model(pixels.to(dev), tokens).cpu()
    del model
    cpu_model = generate_captions.load_catr(checkpoint, torch.device("cpu"))
    with torch.inference_mode():
        want = cpu_model(pixels, tokens.cpu())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= 1e-3:
        raise AssertionError(f"CATR teacher-forced logits card vs CPU: {rel} of max|ref|")
    lengths = [len(c.split()) for c in result.values()]
    print(f"phase captions: generate_captions.main --catr_checkpoint (v3 architecture, "
          f"random weights) over {len(result)} images at batch {BATCH}: {seconds:.2f} s, "
          f"model load included; a greedy decode of 2 images {decode_s:.2f} s ({tokens.shape[1]} "
          f"positions); caption words {min(lengths)}-{max(lengths)}, e.g. "
          f"{next(iter(result.values()))[:60]!r}; teacher-forced logits card vs CPU "
          f"{rel:.3g} of max|ref| (tol 1e-3); on {card}")
    return out


BUNDLE_TIMED = 5  # predict calls timed in each dtype


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of `fn` costs: the calls issued back to back,
    the card drained before and after, and the issue loop alone timed."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issue * 1e6 / calls


def phase_bundle(dev, card, cuda_lib, cli, export, config, fa, ba, data, ft_out, taggers,
                 work):
    """The serving bundle (`inference/export.py`) at full width: the
    `--fine_tune_cnn` run's checkpoint (12 x 768, L = 170, ResNet-152 at
    224^2, 7 images, 4 ROIs) exported at batch 8 with
    `use_pallas_box_attention`, in f32 (TF32 off) and bf16, loaded, and
    `predict` run on the first 8 of the serve phase's records: 12 K1
    launches a call (tf32x3 in f32, wgmma in bf16) and one K3.  The f32
    bundle's logits against the live `make_finetune_eval_step` (atol 1e-5,
    argmax equal), the bf16 bundle's against the f32 one (the JAX test's
    atol 0.15, rtol 0.2); export and load in seconds, `predict` in ms (wall
    and CUDA events) beside the live forward's; the host microseconds of a
    call of each registered op beside its wrapper's launch; then the CLI
    with `--bundle` over the serve phase's 16 records, whose predictions
    must equal the `--checkpoint` CLI's.  -> launches on the bundle path."""
    from macsa_tpu_torch.train import common
    tok = os.path.join(data, "tok")
    cfg = config.FCMFConfig(model=config.ModelConfig(dtype="float32"),
                            text=common.build_text_config(tok, "float32"),
                            use_pallas_box_attention=True)
    bundles, dirs, export_s, load_s = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        dirs[dtype] = export.export_bundle(ft_out, os.path.join(work, f"bundle_{dtype}"),
                                           batch_size=SERVE_BATCH, device="cuda",
                                           fcmf_config=cfg, dtype=dtype)
        export_s[dtype] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bundles[dtype] = export.load_bundle(dirs[dtype], dev)
        load_s[dtype] = time.perf_counter() - t0

    with open(os.path.join(work, "records.json")) as f:
        records = json.load(f)
    args = ["--pretrained_hf_model", tok, "--image_model_checkpoint", taggers[0],
            "--roi_model_checkpoint", taggers[1],
            "--roi_csv", os.path.join(data, "data", "roi_data.csv")]
    # the live eval step on the same weights, in the bundle's configuration
    server = cli.Server(cli.build_argparser().parse_args(
        args + ["--checkpoint", ft_out, "--text", "-"]),
        lambda c, r: (dataclasses.replace(c, use_pallas_box_attention=True), r))
    batch = server.arrays([server.prep_record(r["text"], r["image_list"])
                           for r in records[:SERVE_BATCH]])

    # the main path: every count from 0, read right after each predict
    logits, launches = {}, collections.Counter()
    for dtype, variant in (("float32", "tf32x3"), ("bfloat16", "wgmma")):
        cuda_lib.reset_launch_counts()
        logits[dtype] = bundles[dtype].predict(batch)
        torch.cuda.synchronize()
        expect_counts(cuda_lib, {"fused_self_attention": 12,
                                 f"fused_self_attention.{variant}": 12, "box_attention": 1,
                                 **k5_counts({dtype: 2})},
                      f"bundle {dtype} predict")
        launches.update(cuda_lib.launch_counts)

    live_step = server.eval_step
    sent = common.to_device(batch, dev)
    live = live_step(sent)[1].cpu().numpy()
    err32 = float(np.abs(logits["float32"] - live).max())
    if not err32 <= 1e-5 or not (logits["float32"].argmax(-1) == live.argmax(-1)).all():
        raise AssertionError(f"bundle f32 vs the live eval step: max abs err {err32}")
    err16 = float(np.abs(logits["bfloat16"] - logits["float32"]).max())
    if not np.allclose(logits["bfloat16"], logits["float32"], atol=0.15, rtol=0.2):
        raise AssertionError(f"bundle bf16 vs f32: max abs err {err16}")

    times = {}
    for dtype, served in bundles.items():
        walls = []
        for _ in range(BUNDLE_TIMED):
            t0 = time.perf_counter()
            served.predict(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
        inputs = [sent[k] for k in export.INPUTS]

        def program(served=served, inputs=inputs):
            with torch.inference_mode():
                served._call(*inputs)
        times[dtype] = {"predict_wall_ms": float(np.median(walls)),
                        "program_ms": cuda_ms(program, BUNDLE_TIMED, 1)}
    times["float32"]["live_ms"] = cuda_ms(lambda: live_step(sent), BUNDLE_TIMED, 1)
    wall = []
    for _ in range(BUNDLE_TIMED):
        t0 = time.perf_counter()
        live_step(sent)[0].cpu()
        wall.append((time.perf_counter() - t0) * 1e3)
    times["float32"]["live_wall_ms"] = float(np.median(wall))
    del server, live_step, bundles

    # host cost of a registered op's call beside its wrapper's launch
    g = torch.Generator(dev).manual_seed(41)
    q, k, v = (torch.randn(BATCH * NUM_ASPECTS, 170, 768, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    mask = torch.zeros(BATCH * NUM_ASPECTS, 170, device=dev)
    bq, bk, bv = (torch.randn(BATCH * 7 * 8, 4, 96, device=dev, generator=g) for _ in range(3))
    gates = torch.rand(BATCH * 7 * 8, 4, 4, device=dev, generator=g)
    from macsa_tpu_torch.ops import fused_resnet as fr
    hw, c, f = RESNET_STAGES[3]  # one identity block of stage 3 over a batch's 56 images
    x2 = torch.randn(BATCH * 7 * hw * hw, c, device=dev, generator=g)
    k5_args = (x2, torch.randn(c, f, device=dev, generator=g), *bn_affine(g, f, dev),
               torch.randn(9, f, f, device=dev, generator=g), *bn_affine(g, f, dev),
               torch.randn(f, c, device=dev, generator=g), *bn_affine(g, c, dev),
               BATCH * 7, hw, hw)
    ops_us = {
        "fused_self_attention": (
            host_us(lambda: fa.attention_op(q, k, v, mask, 12, 0.0, 0)),
            host_us(lambda: fa._launch_fwd(q, k, v, mask, 12, 0.0, 0, False))),
        "box_attention": (host_us(lambda: ba.box_attention_op(bq, bk, bv, gates)),
                          host_us(lambda: ba._launch(bq, bk, bv, gates))),
        "fused_bottleneck": (host_us(lambda: fr.bottleneck_op(*k5_args)),
                             host_us(lambda: fr._launch_k5(*k5_args)))}

    # the CLI with --bundle against the --checkpoint CLI (phase serve's output)
    out = os.path.join(work, "served_bundle.jsonl")
    cuda_lib.reset_launch_counts()
    summary = cli.main(args + ["--bundle", dirs["float32"], "--input_json",
                               os.path.join(work, "records.json"), "--batch_size",
                               str(SERVE_BATCH), "--output_file", out])
    forwards = -(-len(records) // SERVE_BATCH)
    expect_counts(cuda_lib, {"fused_self_attention": 12 * forwards,
                             "fused_self_attention.tf32x3": 12 * forwards,
                             "box_attention": forwards, **k5_counts({"float32": 2 * forwards})},
                  "the CLI with --bundle")
    launches.update(cuda_lib.launch_counts)
    rows = []
    for name in ("served_bundle.jsonl", "served.jsonl"):
        with open(os.path.join(work, name)) as f:
            rows.append([{k: r[k] for k in ("image_tags", "roi_tags", "prediction")}
                         for r in map(json.loads, f)])
    if rows[0] != rows[1]:
        raise AssertionError(f"the CLI with --bundle {rows[0][:2]}... vs --checkpoint "
                             f"{rows[1][:2]}...")

    for dtype in ("float32", "bfloat16"):
        t = times[dtype]
        print(f"phase bundle {dtype}: export {export_s[dtype]:.1f} s, load {load_s[dtype]:.1f} "
              f"s, predict at batch {SERVE_BATCH}: {t['predict_wall_ms']:.2f} ms wall (host "
              f"copies in and out included), the program {t['program_ms']:.2f} ms (CUDA "
              f"events, inputs on the card)"
              + (f"; the live eval step {t['live_ms']:.2f} ms (events), "
                 f"{t['live_wall_ms']:.2f} ms wall; max abs err vs live {err32:.3g}"
                 if dtype == "float32" else f"; max abs err vs the f32 bundle {err16:.3g}")
              + f"; on {card}")
    for name, (op, direct) in ops_us.items():
        print(f"phase bundle host cost of one call: registered op {name} {op:.1f} us, its "
              f"wrapper's launch {direct:.1f} us")
    print(f"phase bundle CLI --bundle: {summary['records']} records at --batch_size "
          f"{summary['batch_size']}, records_per_s {summary['records_per_s']}, predictions "
          f"equal the --checkpoint CLI's; launches {dict(launches)}")
    return dict(launches), times, ops_us, export_s, load_s


DDP_WORLD = 2


def ddp_model(dev, config, fcmf, layers, seed: int, dtype: str = "float32"):
    """The full-width FCMF of phases ddp and tp: dropout 0, K1 on, random
    biases (no tensor starts at zero, so each has a scale to be held to)."""
    kw = dict(dtype=dtype, fused_attention=True, hidden_dropout_prob=0.0,
              attention_probs_dropout_prob=0.0)
    cfg = config.FCMFConfig(model=config.ModelConfig(**kw), text=config.TextEncoderConfig(**kw))
    model = fcmf.FCMF(cfg, device=dev)
    g = torch.Generator(dev).manual_seed(seed)
    layers.init_weights(model, g, cfg.model.initializer_range)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, cfg.model.initializer_range, generator=g)
    return cfg, model


def ddp_steps(dev, n_steps: int = 2, dtype: str = "float32"):
    """`n_steps` fine-tune steps at full width on cached features (dropout
    0, AdamW with the driver's defaults) on this data-parallel rank's share
    of a batch of 8 made from a seed, the model sharded over the mp ranks
    where there are several (`parallel.mesh`; one process: the whole batch,
    the whole model).  -> (global losses, the trained model)."""
    from macsa_tpu_torch import config
    from macsa_tpu_torch.models import fcmf, layers, resnet
    from macsa_tpu_torch.parallel import mesh, sharding
    from macsa_tpu_torch.train import optim, steps
    from macsa_tpu_torch.train.state import TrainState
    cfg, model = ddp_model(dev, config, fcmf, layers, 51, dtype)
    mesh.replicate(model)
    sharding.shard_model_(model)
    g = torch.Generator(dev).manual_seed(52)
    batch = serving_batch(dev, cfg)
    for key in ("images", "roi_images"):
        del batch[key]
    batch["grid"] = torch.randn(BATCH, cfg.num_imgs, 49, 2048, device=dev, generator=g)
    batch["roi"] = torch.randn(BATCH, cfg.num_imgs, cfg.num_roi, 2048, device=dev, generator=g)
    batch["labels"] = torch.randint(0, cfg.num_labels, (BATCH, NUM_ASPECTS), device=dev,
                                    generator=g)
    per, rank = BATCH // mesh.dp_size(), mesh.dp_index()
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    visual = resnet.VisualFeatures(config.ResNetConfig(stage_sizes=(1, 1, 1, 1)), device=dev)
    # the driver's two rates, constant: both updates move the model.  Adam's
    # eps is 1e-4, not 1e-8: a gradient that is zero in exact arithmetic (an
    # attention key's bias: softmax ignores a shift shared by every key) is
    # rounding noise that depends on the summation order, which eps 1e-8
    # would scale up to a step of the learning rate's size
    state = TrainState.create(model, visual, optim.AdamW(model, 7e-5, eps=1e-4,
                                                         head_learning_rate=7e-4))
    step = steps.make_finetune_train_step(state)
    losses = [float(mesh.all_mean(step(local, 0)["loss"])) for _ in range(n_steps)]
    return losses, model


def param_gap(params: dict, want: dict) -> tuple:
    """The worst parameter's largest difference over its tensor's largest
    value.  -> (gap, name)."""
    worst, worst_name = 0.0, ""
    for name, p in params.items():
        ref = want[name].to(p.device)
        rel = float((p - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    return worst, worst_name


def ddp_worker(rank: int, port: int, work: str, data: str, out: str) -> None:
    """One of phase ddp's two ranks: gloo over CUDA tensors, both on the one
    card (NCCL refuses two ranks on one device).  (b) two full-width steps
    at batch 4 a rank, held against the single-process run the parent
    saved; (c) `finetune.main` for one epoch.  Its numbers go to `out`."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.train import finetune
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=DDP_WORLD)
    try:
        cuda_lib.reset_launch_counts()
        losses, model = ddp_steps(dev)
        torch.cuda.synchronize()
        step_launches = dict(cuda_lib.launch_counts)
        ref = torch.load(os.path.join(work, "ddp_reference.pt"), map_location=dev)
        worst, worst_name = param_gap(model.state_dict(), ref["params"])
        del model, ref
        torch.cuda.empty_cache()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        result = finetune.main(ddp_driver_argv(data, os.path.join(work, "ddp_driver"),
                                               BATCH // DDP_WORLD))
        torch.cuda.synchronize()
        with open(out, "w") as f:
            json.dump({"losses": losses, "param_rel_err": worst, "worst_param": worst_name,
                       "step_launches": step_launches,
                       "driver_s": time.perf_counter() - t0,
                       "driver": {k: result["epochs"][0][k]
                                  for k in ("steps", "losses", "kernel_launches", "seconds")},
                       "driver_launches": dict(cuda_lib.launch_counts)}, f)
    finally:
        dist.destroy_process_group()


def ddp_driver_argv(data: str, out: str, batch: int, *extra) -> list:
    return ["--data_dir", os.path.join(data, "data"), "--image_dir",
            os.path.join(data, "images"), "--output_dir", out, "--pretrained_hf_model",
            os.path.join(data, "tok"), "--seed", "0", "--log_every", "1",
            "--train_batch_size", str(batch), "--num_train_epochs", "1", "--do_train", *extra]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_ddp(dev, card, cuda_lib, finetune, data, work):
    """Data parallelism (`parallel/mesh.py`) on the one card.  (a) A world
    of one over NCCL: `finetune.main` for one epoch (f32, the 16-review
    dataset) gives the losses of the same run with no group.  (b) Two ranks
    as two processes over gloo with CUDA tensors: two full-width fine-tune
    steps at batch 4 a rank (f32, TF32 off, dropout 0, cached features)
    against one process at batch 8: losses within 1e-4, every parameter
    within 1e-3 of its tensor's largest value.  (c) `finetune.main` under
    the two ranks for one epoch (bf16, batch 4 a rank): their losses agree,
    and rank 0 alone wrote the artifacts.  Multi-card NCCL is not driven
    (one card).  -> launches on the ranks' paths."""
    import torch.distributed as dist
    from macsa_tpu_torch.parallel import mesh

    # (a) a world of one over NCCL against no group
    argv_a = lambda out: ddp_driver_argv(data, os.path.join(work, out), BATCH, "--no-bf16")  # noqa: E731
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        if mesh.process_count() != 1 or dist.get_backend() != "nccl":
            raise AssertionError("phase ddp (a): not a world of one over NCCL")
        with_group = finetune.main(argv_a("ddp_nccl"))["epochs"][0]["losses"]
    finally:
        dist.destroy_process_group()
    without = finetune.main(argv_a("ddp_none"))["epochs"][0]["losses"]
    gap_a = max(abs(a - b) for a, b in zip(with_group, without))
    if len(with_group) != len(without) or not gap_a <= 1e-4:
        raise AssertionError(f"phase ddp (a): NCCL world of one {with_group} vs {without}")

    # (b) the single-process reference the ranks are held against
    ref_losses, model = ddp_steps(dev)
    torch.save({"losses": ref_losses,
                "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               os.path.join(work, "ddp_reference.pt"))
    del model
    torch.cuda.empty_cache()

    # (b) and (c) in two processes
    port = free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    outs = [os.path.join(work, f"ddp_rank{r}.json") for r in range(DDP_WORLD)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=ddp_worker, args=(r, port, work, data, outs[r]))
             for r in range(DDP_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase ddp ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    per_step = {"fused_self_attention": 12, "fused_self_attention.tf32x3": 12,
                "fused_self_attention_bwd": 12, "fused_self_attention_bwd.tf32x3": 12}
    for r, got in enumerate(ranks):
        loss_gap = max(abs(a - b) for a, b in zip(got["losses"], ref_losses))
        if not loss_gap <= 1e-4 or not got["param_rel_err"] <= 1e-3:
            raise AssertionError(f"phase ddp (b) rank {r}: losses {got['losses']} vs one "
                                 f"process {ref_losses}, parameters {got['param_rel_err']} "
                                 f"({got['worst_param']})")
        if got["step_launches"] != {k: 2 * v for k, v in per_step.items()}:
            raise AssertionError(f"phase ddp (b) rank {r} launches {got['step_launches']}")
    steps_c = 16 // BATCH
    drivers = [got["driver"] for got in ranks]
    want_c = {"device_normalize": 2 * steps_c, **k5_counts({"bfloat16": 2 * steps_c})}
    for name in ("fused_self_attention", "fused_self_attention_bwd"):
        want_c.update({name: 12 * steps_c, f"{name}.wgmma": 12 * steps_c})
    if drivers[0]["losses"] != drivers[1]["losses"] or \
            any(d["steps"] != steps_c or d["kernel_launches"] != want_c for d in drivers):
        raise AssertionError(f"phase ddp (c): ranks {drivers}")
    out_c = os.path.join(work, "ddp_driver")
    with open(os.path.join(out_c, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    if not os.path.isfile(os.path.join(out_c, "last.pt")) or len(lines) != steps_c + 1:
        raise AssertionError(f"phase ddp (c): {sorted(os.listdir(out_c))}, {len(lines)} metric "
                             f"lines (rank 0 alone writes one a step and one an epoch)")
    launches = collections.Counter()
    for got in ranks:
        launches.update(got["step_launches"])
        launches.update(got["driver_launches"])
    print(f"phase ddp (a) a world of one over NCCL: finetune.main losses "
          + " ".join(f"{x:.5f}" for x in with_group) + f", without a group the same within "
          f"{gap_a:.2g}; on {card}")
    print(f"phase ddp (b) 2 ranks over gloo on one card, batch 4 a rank: losses "
          + " ".join(f"{x:.6f}" for x in ranks[0]["losses"]) + ", one process at batch 8 "
          + " ".join(f"{x:.6f}" for x in ref_losses) + f"; parameters after 2 steps within "
          f"{max(g['param_rel_err'] for g in ranks):.3g} of each tensor's largest value")
    print(f"phase ddp (c) finetune.main under 2 ranks: {drivers[0]['steps']} steps of 4 a rank "
          f"in {drivers[0]['seconds']:.1f} s, losses "
          + " ".join(f"{x:.4f}" for x in drivers[0]["losses"])
          + f" on both ranks; rank 0 alone wrote {sorted(os.listdir(out_c))}; both rank "
          f"processes {ranks_s:.1f} s with their start; launches {dict(launches)}")
    return dict(launches)


TP_WORLD = 2


def tp_phase1_step(dev):
    """One Phase-1 step at full width (f32, dropout 0, K1 on, the tied
    table of 15004 rows: 7502 a rank at mp 2) at batch 16 on cached
    features, the model sharded over the mp ranks where there are several.
    -> (the loss, the trained model)."""
    from macsa_tpu_torch import config
    from macsa_tpu_torch.models import layers, resnet, seq2seq
    from macsa_tpu_torch.parallel import mesh, sharding
    from macsa_tpu_torch.train import optim, steps
    from macsa_tpu_torch.train.state import TrainState
    cfg, dec_cfg, model, _ = build_seq2seq(dev, config, seq2seq, resnet, "float32", True, 0.0)
    g = torch.Generator(dev).manual_seed(61)
    layers.init_weights(model, g, cfg.model.initializer_range)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, cfg.model.initializer_range, generator=g)
    mesh.replicate(model)
    sharding.shard_model_(model)
    batch = pretrain_batch(dev, cfg, dec_cfg, with_pixels=False)
    batch["grid"] = torch.randn(P1_BATCH, cfg.num_imgs, 49, 2048, device=dev, generator=g)
    batch["roi"] = torch.randn(P1_BATCH, cfg.num_imgs, cfg.num_roi, 2048, device=dev,
                               generator=g)
    visual = resnet.VisualFeatures(config.ResNetConfig(stage_sizes=(1, 1, 1, 1)), device=dev)
    state = TrainState.create(model, visual, optim.AdamW(model, 7e-5, eps=1e-4))
    loss = float(mesh.all_mean(steps.make_pretrain_train_step(state)(batch, 0)["loss"]))
    return loss, model


def tp_worker(rank: int, port: int, work: str, data: str, out: str) -> None:
    """One of phase tp's two ranks at (dp 1, mp 2): gloo over CUDA tensors,
    both on the one card.  2 full-width f32 steps, 2 bf16 steps, one
    Phase-1 step, `finetune.main --mp 2` for one bf16 epoch.  Its numbers
    go to `out`."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.parallel import mesh, sharding
    from macsa_tpu_torch.train import finetune
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=TP_WORLD)
    try:
        mesh.init_model_parallel(TP_WORLD)
        got = {"layout": [mesh.dp_size(), mesh.dp_index(), mesh.mp_size(), mesh.mp_index()]}
        ref = torch.load(os.path.join(work, "ddp_reference.pt"))
        p1_ref = torch.load(os.path.join(work, "tp_reference.pt"))
        for dtype in ("float32", "bfloat16"):
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            losses, model = ddp_steps(dev, dtype=dtype)
            torch.cuda.synchronize()
            got[dtype] = {"losses": losses, "s": time.perf_counter() - t0,
                          "launches": dict(cuda_lib.launch_counts)}
            if dtype == "float32":
                got[dtype]["param_gap"] = param_gap(sharding.whole_state_dict(model),
                                                    ref["params"])
            del model
            torch.cuda.empty_cache()
        cuda_lib.reset_launch_counts()
        loss, model = tp_phase1_step(dev)
        got["phase1"] = {"loss": loss,
                         "param_gap": param_gap(sharding.whole_state_dict(model),
                                                p1_ref["params"]),
                         "launches": dict(cuda_lib.launch_counts),
                         "table_rows": int(model.shared_embedding.shape[0])}
        del model, ref, p1_ref
        torch.cuda.empty_cache()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        result = finetune.main(ddp_driver_argv(data, os.path.join(work, "tp_driver"), BATCH,
                                               "--mp", str(TP_WORLD)))
        torch.cuda.synchronize()
        got["driver_s"] = time.perf_counter() - t0
        got["driver"] = {k: result["epochs"][0][k]
                         for k in ("steps", "losses", "kernel_launches", "seconds")}
        got["driver_launches"] = dict(cuda_lib.launch_counts)
        with open(out, "w") as f:
            json.dump(got, f)
    finally:
        dist.destroy_process_group()


def phase_tp(dev, card, cuda_lib, data, work):
    """Tensor parallelism (`parallel/sharding.py`) at (dp 1, mp 2) on the
    one card: two processes over gloo with CUDA tensors (NCCL refuses two
    ranks on one device), each holding its half of every sharded tensor
    and running K1 and K1b on 6 of the 12 heads.  Against one process: 2
    full-width f32 steps (TF32 off, dropout 0, cached features) held to
    phase ddp's saved run, losses within 1e-4 and every parameter within
    1e-3 of its tensor's largest; 2 bf16 steps against bf16 at mp 1, losses
    within 2e-2 relative, K1 and K1b on their tensor-core variant; one
    Phase-1 step at batch 16 (the tied table at 7502 rows a rank), as the
    f32 steps are held.  Then `finetune.main --mp 2` for one bf16 epoch:
    both ranks' losses, rank 0 alone writes.  The two processes share one
    card: their times are not a speed of tensor parallelism.
    -> launches on the ranks' paths."""
    bf16_ref, model = ddp_steps(dev, dtype="bfloat16")
    del model
    p1_loss, model = tp_phase1_step(dev)
    torch.save({"loss": p1_loss,
                "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               os.path.join(work, "tp_reference.pt"))
    del model
    torch.cuda.empty_cache()
    f32_ref = torch.load(os.path.join(work, "ddp_reference.pt"))["losses"]  # phase ddp's

    port = free_port()
    ctx = torch.multiprocessing.get_context("spawn")
    outs = [os.path.join(work, f"tp_rank{r}.json") for r in range(TP_WORLD)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=tp_worker, args=(r, port, work, data, outs[r]))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase tp ranks exited {[p.exitcode for p in procs]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    per_step = lambda variant: {"fused_self_attention": 12,  # noqa: E731
                                f"fused_self_attention.{variant}": 12,
                                "fused_self_attention_bwd": 12,
                                f"fused_self_attention_bwd.{variant}": 12}
    steps_c = 16 // BATCH
    want_c = {"device_normalize": 2 * steps_c, **k5_counts({"bfloat16": 2 * steps_c})}
    for name in ("fused_self_attention", "fused_self_attention_bwd"):
        want_c.update({name: 12 * steps_c, f"{name}.wgmma": 12 * steps_c})
    for r, got in enumerate(ranks):
        if got["layout"] != [1, 0, TP_WORLD, r]:
            raise AssertionError(f"phase tp rank {r} layout {got['layout']}")
        f32, bf16, p1 = got["float32"], got["bfloat16"], got["phase1"]
        gap = max(abs(a - b) for a, b in zip(f32["losses"], f32_ref))
        if not gap <= 1e-4 or not f32["param_gap"][0] <= 1e-3:
            raise AssertionError(f"phase tp f32 rank {r}: losses {f32['losses']} vs mp 1 "
                                 f"{f32_ref}, parameters {f32['param_gap']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(bf16["losses"], bf16_ref))
        if not rel <= 2e-2:
            raise AssertionError(f"phase tp bf16 rank {r}: losses {bf16['losses']} vs mp 1 "
                                 f"{bf16_ref}")
        if f32["launches"] != {k: 2 * v for k, v in per_step("tf32x3").items()} or \
                bf16["launches"] != {k: 2 * v for k, v in per_step("wgmma").items()}:
            raise AssertionError(f"phase tp rank {r} launches {f32['launches']}, "
                                 f"{bf16['launches']}")
        if not abs(p1["loss"] - p1_loss) <= 1e-4 or not p1["param_gap"][0] <= 1e-3 or \
                p1["table_rows"] != 15004 // TP_WORLD or \
                p1["launches"] != per_step("tf32x3"):
            raise AssertionError(f"phase tp Phase 1 rank {r}: {p1} vs mp 1 loss {p1_loss}")
        if got["driver"]["steps"] != steps_c or got["driver"]["kernel_launches"] != want_c:
            raise AssertionError(f"phase tp driver rank {r}: {got['driver']}")
    drivers = [got["driver"] for got in ranks]
    if drivers[0]["losses"] != drivers[1]["losses"]:
        raise AssertionError(f"phase tp driver: the mp ranks' losses differ {drivers}")
    out_c = os.path.join(work, "tp_driver")
    with open(os.path.join(out_c, "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    if not os.path.isfile(os.path.join(out_c, "last.pt")) or len(lines) != steps_c + 1:
        raise AssertionError(f"phase tp driver: {sorted(os.listdir(out_c))}, {len(lines)} "
                             f"metric lines (rank 0 alone writes one a step and one an epoch)")
    saved = torch.load(os.path.join(out_c, "last.pt"), map_location="cpu", weights_only=True)
    if saved["model"]["encoder.bert.cell.encoder.layer.0.attention.self.query.weight"].shape \
            != (768, 768):
        raise AssertionError("phase tp driver: the checkpoint does not hold whole tensors")
    del saved
    launches = collections.Counter()
    for got in ranks:
        for part in (got["float32"], got["bfloat16"], got["phase1"]):
            launches.update(part["launches"])
        launches.update(got["driver_launches"])
    r0 = ranks[0]
    print(f"phase tp (dp 1, mp 2) 2 ranks over gloo on one card ({card}): f32 losses "
          + " ".join(f"{x:.6f}" for x in r0["float32"]["losses"]) + ", mp 1 "
          + " ".join(f"{x:.6f}" for x in f32_ref) + "; parameters within "
          f"{max(g['float32']['param_gap'][0] for g in ranks):.3g} of each tensor's largest; "
          f"the model's build and 2 steps {r0['float32']['s']:.2f} s")
    print(f"phase tp bf16 losses " + " ".join(f"{x:.5f}" for x in r0["bfloat16"]["losses"])
          + ", mp 1 " + " ".join(f"{x:.5f}" for x in bf16_ref)
          + f"; K1 and K1b at 6 heads a rank on wgmma, {r0['bfloat16']['launches']}; the "
          f"model's build and 2 steps {r0['bfloat16']['s']:.2f} s (two processes share the "
          f"card: not a speed of TP)")
    print(f"phase tp Phase 1 at batch 16, table {r0['phase1']['table_rows']} rows a rank: loss "
          f"{r0['phase1']['loss']:.6f}, mp 1 {p1_loss:.6f}; parameters within "
          f"{max(g['phase1']['param_gap'][0] for g in ranks):.3g}")
    print(f"phase tp finetune.main --mp 2: {drivers[0]['steps']} steps of 8 in "
          f"{drivers[0]['seconds']:.1f} s, losses "
          + " ".join(f"{x:.4f}" for x in drivers[0]["losses"])
          + f" on both ranks; rank 0 alone wrote {sorted(os.listdir(out_c))}, whole tensors; "
          f"both rank processes {ranks_s:.1f} s with their start; launches {dict(launches)}")
    return dict(launches)


def main() -> int:
    sys.path.insert(0, REPO)
    from macsa_tpu_torch import config
    from macsa_tpu_torch.models import fcmf, fused_backbone, layers, resnet, seq2seq
    from macsa_tpu_torch.ops import box_attention as ba
    from macsa_tpu_torch.ops import cuda_lib, image_prep
    from macsa_tpu_torch.ops import fused_attention as fa
    from macsa_tpu_torch.ops import fused_resnet as fr
    from macsa_tpu_torch.data import synth
    from macsa_tpu_torch.train import finetune, optim, pretrain, steps
    from macsa_tpu_torch.train import state as train_state
    from macsa_tpu_torch.inference import cli, export
    from macsa_tpu_torch.tools import image_categories, roi_categories

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # f32 means f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"phase device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"phase build: {time.perf_counter() - t0:.1f} s ({lib._name})")

    def run(phase, *args):
        """One phase, with the seconds it took on a line of its own."""
        t0 = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the phase's models are gone
        print(f"{phase.__name__.replace('_', ' ', 1)} took {time.perf_counter() - t0:.1f} s")
        return out

    model_mods = (config, layers, fcmf, resnet, steps, image_prep)
    k2 = run(phase_k2, dev, image_prep)
    k2_phase1 = run(phase_k2_phase1_shapes, dev, image_prep)
    k1 = run(phase_k1, dev, cuda_lib, fa)
    k1_bwd = run(phase_k1_bwd, dev, cuda_lib, fa)
    k1_phase1 = run(phase_k1_phase1_shapes, dev, cuda_lib, fa)
    k1_baselines = run(phase_k1_baseline_shapes, dev, cuda_lib, fa)
    k1_tp = run(phase_k1_tp_shapes, dev, cuda_lib, fa)
    k1_simt = run(phase_k1_head_width_32, dev, cuda_lib, fa)
    k3 = run(phase_k3, dev, ba, cuda_lib)
    k4, k4_launches = run(phase_k4, dev, cuda_lib, fr)
    k5 = run(phase_k5, dev, cuda_lib, layers, resnet, fused_backbone, fr)
    k45_simt = run(phase_k45_simt_f32, dev, cuda_lib, fr)
    kda_core = run(phase_kda, dev, cuda_lib)
    launches = run(phase_slice, dev, cuda_lib, *model_mods)
    fused_launches = run(phase_fused, dev, cuda_lib, *model_mods, fused_backbone)
    train_launches = run(phase_train, dev, cuda_lib, *model_mods, optim, train_state)
    finetune_launches = run(phase_finetune, smi, cuda_lib, synth, finetune)
    step_launches = run(phase_pretrain_step, dev, cuda_lib, config, layers, seq2seq, resnet,
                        steps, image_prep, optim, train_state)
    decode_launches = run(phase_decode, dev, smi, cuda_lib, config, layers, seq2seq, resnet,
                          steps)
    pretrain_launches = run(phase_pretrain, smi, cuda_lib, synth, pretrain, finetune)
    with tempfile.TemporaryDirectory() as work:
        # the files of the last four phases: 16 train reviews, 12 images of 256^2
        data = os.path.join(work, "synth")
        synth.write_dataset(data, n_train=SERVE_RECORDS, n_layers=12, image_size=256, seed=0,
                            n_dev=4, n_test=4)
        ft_cnn_launches, _, ft_out = run(phase_fine_tune_cnn, dev, smi, cuda_lib, *model_mods,
                                         optim, train_state, finetune, data, work)
        taggers = run(phase_labelers, smi, data, image_categories, roi_categories, work)
        mde_launches = run(phase_mde, dev, smi, cuda_lib, *model_mods)
        serve_launches = run(phase_serve, smi, cuda_lib, cli, fcmf, steps, data, ft_out,
                             taggers, work)
        bundle_launches, *_ = run(phase_bundle, dev, smi, cuda_lib, cli, export, config, fa,
                                  ba, data, ft_out, taggers, work)
        ddp_launches = run(phase_ddp, dev, smi, cuda_lib, finetune, data, work)
        tp_launches = run(phase_tp, dev, smi, cuda_lib, data, work)
        captions = run(phase_captions, dev, smi, data, work)
        baseline_launches = run(phase_baselines, dev, smi, cuda_lib, data, captions, work)
    run(phase_k1_bwd_queued, k1_bwd)

    def entry(name, source, replaces, launched, err, timed):
        """One kernel of the `kernels` line: its launches on the paths, its
        worst error over its phase, and the times of its bf16 case.  Where
        `ms` and `plain_ms` are device times replayed from a CUDA graph (K2,
        K3), `call_ms` and `plain_call_ms` are the same two as back-to-back
        Python calls, the way every other kernel's `ms` is taken (K2's
        plain version cannot be captured: both of its times are calls).
        K1's `ms` is its launches back to back, its `call_ms` the wrapper's
        no-autograd calls, which go through the registered op."""
        both = {key: timed[key] for key in ("call_ms", "plain_call_ms") if key in timed}
        return {"name": name, "route": "cuda", "source": f"macsa_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launched, "max_abs_err": err,
                "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
                "bound_by": timed["bound_by"], "library_ms": timed.get("library_ms"), **both}

    bf16 = torch.bfloat16
    k1_bwd0 = k1_bwd[("-10000", bf16, 0.0)]  # rate 0: the case SDPA's backward is timed at
    k1_err = max([r["err"] for r in k1.values()] + [r["err"]["out"] for r in k1_bwd.values()]
                 + [k1_phase1["out"], k1_baselines["out"], k1_tp["out"], k1_simt["out"]])
    k1b_err = max([max(r["err"][n] for n in ("dq", "dk", "dv")) for r in k1_bwd.values()]
                  + [k1_phase1["grad"], k1_baselines["grad"], k1_tp["grad"], k1_simt["grad"]])
    phase1 = (step_launches, decode_launches, pretrain_launches)
    later = (ft_cnn_launches, mde_launches, serve_launches, bundle_launches, ddp_launches,
             tp_launches, baseline_launches)

    def later_launches(name):
        """Launches on Phase 1's paths, and on the fine_tune_cnn, mde,
        serve, bundle, ddp, tp and baselines phases'."""
        return sum(path.get(name, 0) for path in phase1 + later)

    def at_shape(which: str, report: dict, rows: int, width: int, dtype=bf16) -> dict:
        """K1's (`fwd`) or K1b's (`bwd`) times at [48, rows, width], rate 0
        (EF-CapTr's rows; an mp 2 rank's heads): the variant it ran, its
        time, plain, bound (in f32 also with f32 on the CUDA cores), SDPA's.
        The backward's `ms` and `library_ms` are each side's smaller
        reading, back to back or queued behind a spin kernel (`queued_ms`)."""
        t = report[(dtype, 0.0)]
        ms, library_ms = t[f"{which}_ms"], t[f"{which}_library_ms"]
        if which == "bwd":
            ms = min(ms, t["bwd_queued"][0])
            library_ms = min(library_ms, t["bwd_library_queued"][0])
        bd = t[f"{which}_bound"]
        return {"shape": [BATCH * NUM_ASPECTS, rows, width], "variant": t[f"{which}_variant"],
                "ms": ms, "plain_ms": t[f"{which}_plain_ms"], "bound_ms": bd["bound_ms"],
                "bound_by": bd["bound_by"], "library_ms": library_ms,
                **({"cuda_cores_bound_ms": bd["cuda_cores_bound_ms"]}
                   if "cuda_cores_bound_ms" in bd else {})}

    def f32_at_170(report: dict) -> dict:
        """K1's or K1b's f32 times at the train step's [48, 170, 768], rate
        0, mask -10000 (phases k1, k1_bwd), beside its two bounds and SDPA."""
        return {"shape": [BATCH * NUM_ASPECTS, 170, 768], "variant": K1_VARIANT[torch.float32],
                "ms": report["ms"], "plain_ms": report["plain_ms"],
                "bound_ms": report["bound_ms"], "bound_by": report["bound_by"],
                "cuda_cores_bound_ms": report["cuda_cores_bound_ms"],
                "library_ms": report["library_ms"]}

    def head_width_32(which: str) -> dict:
        """The CUDA-core variant, on no path, at [8, 170, 384] with 12 heads
        of 32, rate 0 (phase k1_head_width_32): its bf16 and f32 times."""
        return {"shape": [BATCH, 170, 384], "variant": "simt",
                "source": "macsa_tpu_torch/csrc/fused_attention.cu", "max_abs_err": k1_simt[
            "out" if which == "fwd" else "grad"],
                **{str(dt)[6:]: {"ms": k1_simt[(dt, 0.0)][f"{which}_ms"],
                                 "plain_ms": k1_simt[(dt, 0.0)][f"{which}_plain_ms"]}
                   for dt in (bf16, torch.float32)}}
    k4_conv1 = next(r for (name, dt), r in k4.items() if name.startswith("conv1") and dt == bf16)
    kernels = [
        entry("fused_self_attention", "fused_attention_wgmma.cu",
              "macsa_tpu/ops/fused_attention.py:92",
              launches["fused_self_attention"] + fused_launches["fused_self_attention"]
              + train_launches["fused_self_attention"]
              + finetune_launches["fused_self_attention"]
              + later_launches("fused_self_attention"), k1_err, k1[("-10000", bf16)]),
        entry("fused_self_attention_bwd", "fused_attention_wgmma.cu",
              "macsa_tpu/ops/fused_attention.py:118", train_launches["fused_self_attention_bwd"]
              + finetune_launches["fused_self_attention_bwd"]
              + later_launches("fused_self_attention_bwd"), k1b_err, k1_bwd0),
        entry("device_normalize", "image_prep.cu", "macsa_tpu/ops/image_prep.py:36",
              launches["device_normalize"] + fused_launches["device_normalize"]
              + train_launches["device_normalize"] + finetune_launches["device_normalize"]
              + later_launches("device_normalize"),
              max([r["err"] for r in k2.values()] + [k2_phase1]),
              k2[("packed_rois", bf16)]),
        entry("box_attention", "box_attention.cu", "macsa_tpu/ops/box_attention_kernel.py:37",
              fused_launches["box_attention"] + later_launches("box_attention"),
              max(r["err"] for r in k3.values()), k3[bf16]),
        entry("fused_matmul_bn_act", "fused_resnet_wgmma.cu",
              "tools_dev/fused_resnet_experiment.py:82", k4_launches,
              max([r["err"] for r in k4.values()] + [k45_simt["k4"]["max_abs_err"]]), k4_conv1),
        entry("fused_bottleneck", "fused_resnet_wgmma.cu",
              "tools_dev/fused_resnet_experiment.py:208",
              launches["fused_bottleneck"] + fused_launches["fused_bottleneck"]
              + train_launches["fused_bottleneck"] + finetune_launches["fused_bottleneck"]
              + later_launches("fused_bottleneck"),
              max([r["err"] for r in k5.values()] + [k45_simt["k5"]["max_abs_err"]]),
              k5[(3, bf16)]),
    ]
    for which in ("forward", "backward"):  # no phase past phase_kda runs the KDA core
        kernels.append({"name": f"kda_{which}", "route": "cuda",
                        "source": "macsa_tpu_torch/csrc/kda_core.cu", "replaces": None,
                        "launches": 1, "max_abs_err": kda_core["max_abs_err"],
                        "max_gap": max(kda_core["gaps"].values()), "shape": kda_core["shape"],
                        **{key: kda_core[which][key] for key in ("ms", "plain_ms", "bound_ms",
                                                                  "bound_by")}})
    f32_170 = (k1[("-10000", torch.float32)], k1_bwd[("-10000", torch.float32, 0.0)])
    for kernel, which, f32_report in zip(kernels[:2], ("fwd", "bwd"), f32_170):
        kernel["at_256_rows"] = at_shape(which, k1_baselines, 256, 768)
        kernel["at_mp2_rank"] = at_shape(which, k1_tp, 170, 384)
        kernel["f32"] = {"source": "macsa_tpu_torch/csrc/fused_attention_tf32.cu",
                         "at_170_rows": f32_at_170(f32_report),
                         "at_256_rows": at_shape(which, k1_baselines, 256, 768, torch.float32),
                         "at_mp2_rank": at_shape(which, k1_tp, 170, 384, torch.float32)}
        kernel["head_width_32"] = head_width_32(which)

    def resnet_cases(report: dict, dtype, label) -> list:
        """Phase k4's or k5's cases in one dtype: times, bounds (f32: also
        on the CUDA cores), the library call."""
        keys = ("variant", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "cuda_cores_bound_ms", "library_ms", "err")
        return [{"case": label(key), **{k: r[k] for k in keys if k in r}}
                for key, r in report.items() if key[1] == dtype]
    for kernel, report, label, simt in (
            (kernels[4], k4, lambda key: key[0], k45_simt["k4"]),
            (kernels[5], k5, lambda key: f"stage {key[0]}", k45_simt["k5"])):
        kernel["variants"] = {
            "wgmma": {"source": "macsa_tpu_torch/csrc/fused_resnet_wgmma.cu",
                      "cases": resnet_cases(report, bf16, label)},
            "tf32x3": {"source": "macsa_tpu_torch/csrc/fused_resnet_tf32.cu",
                       "cases": resnet_cases(report, torch.float32, label)},
            "simt": simt}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
