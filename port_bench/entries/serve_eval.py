"""Entry `serve_eval`: the serving forward of `macsa_tpu_torch` as
`inference/cli.py`'s `Server.predict` runs it live: a host batch as
`Server.arrays` shapes it (host-normalized f32 frames for the images and
the ROI crops, the 6 aspect views of each text) goes to the card through
`train/common.to_device`, through `train/steps.make_finetune_eval_step`
(ResNet-152 and the FCMF in f32 with TF32 off, K1 as "tf32x3"), and its
polarities come back to the host.  A closed loop with one batch in flight,
as the CLI's batch mode runs, over a pool of distinct host batches.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.entries.finetune_step import model_state, port_configs, resnet_state
from port_bench.flops import counts
from port_bench.lib import check, traffic, training
from port_bench.reference import model as ref_model
from port_bench.reference.train import state_for

CHECKED_BATCHES = 4


def host_batches(ctx) -> list:
    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    rng = traffic.host_rng(ctx.seed, 5)
    g = traffic.device_generator(ctx.seed, 4, dev)
    b, i, r = tr["batch"], cfg["num_imgs"], cfg["num_roi"]
    size = cfg["resnet"]["image_size"]
    pool = []
    for _ in range(tr["pool"]):
        batch = traffic.aspect_views(rng, b, cfg["aspects"], cfg["max_text_len"],
                                     cfg["num_patches"], cfg["text"]["vocab_size"],
                                     tr["text_len"])
        batch["roi_coors"] = traffic.boxes(rng, (b, i, r))
        batch["images"] = traffic.frames(g, (b, i), tr["images_valid"], "normalized", dev, size)
        batch["roi_images"] = traffic.frames(g, (b, i, r), tr["rois_valid"], "normalized", dev,
                                             size)
        pool.append(batch)
    return pool


def build_program(ctx):
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.resnet import VisualFeatures
    from macsa_tpu_torch.train.steps import make_finetune_eval_step

    cfg, dev = ctx.config, ctx.device
    fc, rc = port_configs(cfg, cfg["compute_dtype"]["serve"])
    model = FCMF(fc, device=dev)
    model.load_state_dict(model_state(cfg, ctx.seed, dev))
    visual = VisualFeatures(rc, device=dev)
    visual.load_state_dict(resnet_state(cfg, ctx.seed, dev))
    return make_finetune_eval_step(model, visual)


def reference_logits(ctx, pool: list, which: list, tf32: bool = False) -> dict:
    """{pool index: the plain model's logits [B, A, labels]}."""
    cfg, dev = ctx.config, ctx.device
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    r = cfg["resnet"]
    with torch.device(dev):
        ref = ref_model.FCMF(cfg).eval()
        net = ref_model.ResNet(tuple(r["stage_sizes"]), r["num_filters"])
    ref.load_state_dict(state_for(ref, model_state(cfg, ctx.seed, dev)))
    net.load_state_dict(resnet_state(cfg, ctx.seed, dev))
    out = {}
    with torch.no_grad():
        for j in sorted(set(which)):
            bt = {k: torch.as_tensor(v, device=dev) for k, v in pool[j].items()}
            grid = net.features(bt["images"], False)
            roi = net.features(bt["roi_images"], True)
            out[j] = ref_model.fcmf_all_aspects(ref, bt, grid, roi).cpu()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return out


def readers(ctx) -> dict:
    cfg, tr = ctx.config, ctx.workload["traffic"]
    t, b = cfg["text"], tr["batch"] * cfg["aspects"]
    frames = tr["batch"] * cfg["num_imgs"] * (1 + cfg["num_roi"])
    r = cfg["resnet"]
    elt = 4 if cfg["compute_dtype"]["serve"] == "float32" else 2
    peak = counts.PEAK_TF32 if elt == 4 else counts.PEAK_BF16
    return {"flop_per_step": counts.serve_batch(cfg, tr["batch"], cfg["aspects"],
                                                cfg["max_text_len"], frames, r["image_size"],
                                                tuple(r["stage_sizes"])),
            "peak_flops": peak,
            "k1_fwd_bound_s": counts.bound_s(counts.k1_forward(
                b, cfg["max_text_len"], t["hidden_size"], t["num_attention_heads"], elt, False),
                peak)}


def run(ctx) -> dict:
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.train.common import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, tr = ctx.device, ctx.workload["traffic"]
    pool = host_batches(ctx)
    step = build_program(ctx)
    kept = []  # (pool index, logits) of every batch served in the window

    def serve(i: int):
        t = time.perf_counter()
        preds, logits = step(to_device(pool[i % len(pool)], dev))
        preds.cpu().numpy()
        return time.perf_counter() - t, logits

    for i in range(tr["warm_batches"]):
        serve(i)
    training.sync(dev)
    setup_s = time.perf_counter() - ctx.started

    lat = []
    t0 = time.perf_counter()
    while True:
        i = len(lat)
        s, logits = serve(i)
        lat.append(s)
        kept.append((i % len(pool), logits))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window = time.perf_counter() - t0
    n = len(lat)
    out = {"attempted": n, "failed": 0,
           "end_to_end": {"setup_s": setup_s,
                          "serve_reviews_per_s": n * tr["batch"] / window,
                          "serve_batch_ms_p90": float(np.percentile(lat, 90)) * 1e3}}
    if ctx.trace:
        def run_batches(count):
            for j in range(count):
                serve(n + j)

        out.update(training.traced(run_batches, [], tr["trace_steps"], dev,
                                   cuda_lib.launch_counts, readers(ctx), n, window))
    out["memory_peak_bytes"] = training.peak_bytes(dev)
    variants = {k: v for k, v in cuda_lib.launch_counts.items() if v}
    step = None
    training.free(dev)

    rng = traffic.host_rng(ctx.seed, 9)
    sample = sorted(rng.choice(n, size=min(CHECKED_BATCHES, n), replace=False).tolist())
    ref = reference_logits(ctx, pool, [kept[i][0] for i in sample])
    gap = max(check.logit_gap(kept[i][1].cpu(), ref[kept[i][0]]) for i in sample)
    correct, checked = check.verdict({"logit_gap": gap}, ctx.workload["check"])
    out.update(correct=correct, check=checked,
               notes={"variants": variants, "checked_batches": sample})
    out["device"] = training.device_info(ctx, out)
    return out


def control(ctx, kind: str) -> dict:
    """The reference in TF32 against the reference in f32, on the batches
    a run's sample draws (no program run): {"logit_gap": ...}."""
    pool = host_batches(ctx)
    which = list(range(min(CHECKED_BATCHES, len(pool))))
    if kind != "tf32":
        raise ValueError(f"serve_eval's control is tf32, not {kind}")
    ref = reference_logits(ctx, pool, which)
    low = reference_logits(ctx, pool, which, tf32=True)
    return {"logit_gap": max(check.logit_gap(low[j], ref[j]) for j in which)}
