"""Entry `finetune_step`: the Phase-2 train step of `macsa_tpu_torch`
(`train/steps.make_finetune_train_step`) driven as `train/finetune.py`
drives it: dual-rate AdamW with linear warmup and clipping, dropout drawn
from (seed, step), the loss read to the host every `log_every` steps.

Visual input by the traffic's `visual`:
* "cached": grid and ROI features from a `train/feature_cache.
  VisualFeatureCache` held on the card, one row a review, read through
  `lookup` in the epoch's shuffled order (the driver's warm epochs); no
  ResNet is built, as none runs,
* "packed": packed uint8 frames (a validity word + the RGB bytes) from a
  pool of host batches, copied to the card each step, unpacked by K2 and
  run through the frozen ResNet-152 without autograd (the first epoch).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.flops import counts
from port_bench.lib import traffic, training, weights
from port_bench.reference import model as ref_model
from port_bench.reference.train import readings as ref_readings, state_for


def port_configs(cfg: dict, dtype: str):
    from macsa_tpu_torch.config import (FCMFConfig, ModelConfig, ResNetConfig,
                                        TextEncoderConfig)
    fc = FCMFConfig(model=ModelConfig(dtype=dtype, **cfg["model"]),
                    text=TextEncoderConfig(dtype=dtype, **cfg["text"]),
                    num_imgs=cfg["num_imgs"], num_roi=cfg["num_roi"],
                    num_labels=cfg["num_labels"], num_patches=cfg["num_patches"],
                    visual_feat_dim=cfg["visual_feat_dim"], max_text_len=cfg["max_text_len"],
                    box_heads=cfg["box_heads"])
    r = cfg["resnet"]
    rc = ResNetConfig(dtype=dtype, stage_sizes=tuple(r["stage_sizes"]),
                      num_filters=r["num_filters"])
    return fc, rc


def model_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes, norms = weights.shapes_of(ref_model.FCMF(cfg))
    return weights.seeded_state(shapes, norms, traffic.derived_seed(seed, 1), device)


def resnet_state(cfg: dict, seed: int, device) -> dict:
    r = cfg["resnet"]
    with torch.device("meta"):
        shapes, norms = weights.shapes_of(ref_model.ResNet(tuple(r["stage_sizes"]),
                                                           r["num_filters"]))
    return weights.seeded_state(shapes, norms, traffic.derived_seed(seed, 2), device)


def host_pool(cfg: dict, tr: dict, seed: int) -> dict:
    """The split's host arrays, one row a review: the 6 aspect views, labels, boxes."""
    rng = traffic.host_rng(seed, 5)
    rows, a, l = tr["rows"], cfg["aspects"], cfg["max_text_len"]
    pool = traffic.aspect_views(rng, rows, a, l, cfg["num_patches"], cfg["text"]["vocab_size"],
                                tr["text_len"])
    pool["labels"] = traffic.labels(rng, rows, a, tr["label_probs"])
    pool["roi_coors"] = traffic.boxes(rng, (rows, cfg["num_imgs"], cfg["num_roi"]))
    return pool


def pixel_pool(cfg: dict, tr: dict, seed: int, device) -> list:
    """`pool` host batches of packed frames: [B, I, words], [B, I, R, words]."""
    g = traffic.device_generator(seed, 4, device)
    b, i, r = tr["batch"], cfg["num_imgs"], cfg["num_roi"]
    return [{"images": traffic.frames(g, (b, i), tr["images_valid"], "packed", device),
             "roi_images": traffic.frames(g, (b, i, r), tr["rois_valid"], "packed", device)}
            for _ in range(tr["pool"])]


def feature_shapes(cfg: dict, rows: int):
    return ((rows, cfg["num_imgs"], cfg["num_patches"], cfg["visual_feat_dim"]),
            (rows, cfg["num_imgs"], cfg["num_roi"], cfg["visual_feat_dim"]))


def build_program(ctx, pool: dict, order: np.ndarray, pixels: list) -> training.Program:
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.models.resnet import VisualFeatures
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.train.common import to_device
    from macsa_tpu_torch.train.feature_cache import VisualFeatureCache
    from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
    from macsa_tpu_torch.train.state import TrainState
    from macsa_tpu_torch.train.steps import make_finetune_train_step

    cfg, tr, st, dev = ctx.config, ctx.workload["traffic"], ctx.workload["step"], ctx.device
    fc, rc = port_configs(cfg, cfg["compute_dtype"]["train"])
    model = FCMF(fc, device=dev)
    model.load_state_dict(model_state(cfg, ctx.seed, dev))
    if tr["visual"] == "cached":
        visual = torch.nn.Module()  # the step reads the cache; no ResNet runs
        cache = VisualFeatureCache(tr["rows"], fc.num_imgs, fc.num_roi, fc.num_patches,
                                   fc.visual_feat_dim, dtype=fc.model.torch_dtype, device=dev)
        traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), cache.grid, cache.roi)
    else:
        visual = VisualFeatures(rc, device=dev)
        visual.load_state_dict(resnet_state(cfg, ctx.seed, dev))
        cache = None
    o = training.optimizer_settings(st, tr["rows"], tr["batch"])
    optimizer = AdamW(model, linear_warmup_schedule(o["lr"], o["warmup"], o["total"]),
                      weight_decay=o["weight_decay"], max_grad_norm=o["max_grad_norm"],
                      head_learning_rate=linear_warmup_schedule(o["head_lr"], o["warmup"],
                                                                o["total"]))
    state = TrainState.create(model, visual, optimizer)
    keys = ("input_ids", "token_type_ids", "attention_mask", "added_mask", "labels", "roi_coors")

    def batch(k: int) -> dict:
        rows = order[k % len(order)]
        host = {key: pool[key][rows] for key in keys}
        if cache is None:
            host.update(pixels[k % len(pixels)])
        sent = to_device(host, dev)
        if cache is not None:
            sent["grid"], sent["roi"] = cache.lookup(rows)
        return sent

    frames = 0 if cache is not None else tr["batch"] * fc.num_imgs * (1 + fc.num_roi)
    return training.Program(state, make_finetune_train_step(state, 0), batch, tr["batch"],
                            st["log_every"], readers(ctx, frames, pixels), cuda_lib.launch_counts)


def readers(ctx, frames: int, pixels: list) -> dict:
    cfg, tr = ctx.config, ctx.workload["traffic"]
    t, b = cfg["text"], tr["batch"] * cfg["aspects"]
    hd, heads, l = t["hidden_size"], t["num_attention_heads"], cfg["max_text_len"]
    elt = 2 if cfg["compute_dtype"]["train"] == "bfloat16" else 4
    peak = counts.PEAK_BF16 if elt == 2 else counts.PEAK_TF32
    out = {"flop_per_step": counts.finetune_step(cfg, tr["batch"], cfg["aspects"], l, frames,
                                                 cfg["resnet"]["image_size"],
                                                 tuple(cfg["resnet"]["stage_sizes"])),
           "peak_flops": peak,
           "k1_fwd_bound_s": counts.bound_s(counts.k1_forward(b, l, hd, heads, elt, True), peak),
           "k1_bwd_bound_s": counts.bound_s(counts.k1_backward(b, l, hd, heads, elt), peak)}
    if pixels:
        size = cfg["resnet"]["image_size"]
        # K2's two calls of each pool batch (images, ROI crops), by their valid frames
        out["k2_bound_s_by_batch"] = [
            sum(counts.bound_s(counts.k2_unpack(f[..., 0].size, int((f[..., 0] != 0).sum()),
                                                size, elt), peak)
                for f in (p["images"], p["roi_images"])) for p in pixels]
    return out


def reference_readings(ctx, pool: dict, order: np.ndarray, pixels: list, lowp=None,
                       fault=None) -> dict:
    """The plain model's three steps on the same batches, from the seed."""
    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(dev):
        ref = ref_model.FCMF(cfg, lowp)
    ref.load_state_dict(state_for(ref, model_state(cfg, ctx.seed, dev)))
    keys = ("input_ids", "token_type_ids", "attention_mask", "added_mask", "labels", "roi_coors")
    batches = [{key: torch.as_tensor(pool[key][order[k]], device=dev) for key in keys}
               for k in range(training.CHECKED_STEPS)]
    if tr["visual"] == "cached":
        dt = getattr(torch, cfg["compute_dtype"]["train"])
        grid_shape, roi_shape = feature_shapes(cfg, tr["rows"])
        grid = torch.empty(grid_shape, dtype=dt, device=dev)
        roi = torch.empty(roi_shape, dtype=dt, device=dev)
        traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), grid, roi)
        for k, bt in enumerate(batches):
            rows = torch.as_tensor(order[k], device=dev)
            bt["grid"], bt["roi"] = grid[rows].float(), roi[rows].float()
        del grid, roi
    else:
        r = cfg["resnet"]
        with torch.device(dev):
            net = ref_model.ResNet(tuple(r["stage_sizes"]), r["num_filters"], lowp)
        net.load_state_dict(resnet_state(cfg, ctx.seed, dev))
        with torch.no_grad():
            for k, bt in enumerate(batches):
                p = pixels[k % len(pixels)]
                img = ref_model.unpack_frames(torch.as_tensor(p["images"], device=dev),
                                              r["image_size"])
                rois = ref_model.unpack_frames(torch.as_tensor(p["roi_images"], device=dev),
                                               r["image_size"])
                bt["grid"], bt["roi"] = net.features(img, False), net.features(rois, True)
        del net

    def loss_fn(m, bt, rng):
        return ref_model.aspect_loss(ref_model.fcmf_all_aspects(m, bt, bt["grid"], bt["roi"], rng),
                                     bt["labels"])

    o = training.optimizer_settings(ctx.workload["step"], tr["rows"], tr["batch"])
    return ref_readings(ref, loss_fn, batches, ctx.seed, o, training.CHECKED_STEPS, fault)


def inputs(ctx):
    cfg, tr = ctx.config, ctx.workload["traffic"]
    pool = host_pool(cfg, tr, ctx.seed)
    order = traffic.epoch_order(ctx.seed, tr["rows"], tr["batch"], tr["max_steps"])
    pixels = pixel_pool(cfg, tr, ctx.seed, ctx.device) if tr["visual"] == "packed" else []
    return pool, order, pixels


def run(ctx) -> dict:
    pool, order, pixels = inputs(ctx)
    tr = ctx.workload["traffic"]
    out = training.run_training(
        ctx, build_program(ctx, pool, order, pixels),
        lambda: reference_readings(ctx, pool, order, pixels),
        tr["warm_steps"], tr["trace_steps"])
    out["device"] = training.device_info(ctx, out)
    return out


def control(ctx, lowp, fault=None) -> dict:
    """The control's readings (or a planted fault's) and the reference's,
    with no program run."""
    pool, order, pixels = inputs(ctx)
    return {"control": reference_readings(ctx, pool, order, pixels, lowp, fault),
            "reference": reference_readings(ctx, pool, order, pixels)}
