"""Entry `pretrain_step`: the Phase-1 IAOG train step of `macsa_tpu_torch`
(`train/steps.make_pretrain_train_step`, `vocab_chunk` 0: the tied f32
vocabulary head and its CE whole) driven as `train/pretrain.py` drives
it: single-rate AdamW with linear warmup and clipping, dropout drawn from
(seed, step), the loss read every `log_every` steps, grid and ROI
features from a `VisualFeatureCache` on the card read through `lookup` in
the epoch's shuffled order (one row a review, the driver's `orig_idx`).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.entries.finetune_step import feature_shapes, port_configs
from port_bench.flops import counts
from port_bench.lib import traffic, training, weights
from port_bench.reference import model as ref_model
from port_bench.reference.train import readings as ref_readings, state_for

KEYS = ("enc_input_ids", "token_type_ids", "attention_mask", "added_mask", "dec_input_ids",
        "labels", "roi_coors")


def decoder_config(cfg: dict, dtype: str):
    from macsa_tpu_torch.config import DecoderConfig
    return DecoderConfig(dtype=dtype, **cfg["decoder"])


def model_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes, norms = weights.shapes_of(ref_model.Seq2Seq(cfg, cfg["decoder"]))
    return weights.seeded_state(shapes, norms, traffic.derived_seed(seed, 1), device)


def host_pool(cfg: dict, tr: dict, seed: int) -> dict:
    rng = traffic.host_rng(seed, 5)
    rows, l = tr["rows"], cfg["max_text_len"]
    t = traffic.texts(rng, (rows,), l, cfg["text"]["vocab_size"], tr["text_len"])
    pool = {"enc_input_ids": t["ids"], "attention_mask": t["mask"],
            "token_type_ids": np.zeros_like(t["ids"]),
            "added_mask": np.ones((rows, l + cfg["num_patches"]), np.int32)}
    pool.update(traffic.decoder_targets(rng, rows, cfg["decoder"]["max_decode_len"],
                                        cfg["decoder"]["vocab_size"], tr["decoder_len"]))
    pool["roi_coors"] = traffic.boxes(rng, (rows, cfg["num_imgs"], cfg["num_roi"]))
    return pool


def build_program(ctx, pool: dict, order: np.ndarray) -> training.Program:
    from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.train.common import to_device
    from macsa_tpu_torch.train.feature_cache import VisualFeatureCache
    from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
    from macsa_tpu_torch.train.state import TrainState
    from macsa_tpu_torch.train.steps import make_pretrain_train_step

    cfg, tr, st, dev = ctx.config, ctx.workload["traffic"], ctx.workload["step"], ctx.device
    dtype = cfg["compute_dtype"]["train"]
    fc, _ = port_configs(cfg, dtype)
    model = FCMFSeq2Seq(fc, decoder_config(cfg, dtype), device=dev)
    model.load_state_dict(model_state(cfg, ctx.seed, dev))
    cache = VisualFeatureCache(tr["rows"], fc.num_imgs, fc.num_roi, fc.num_patches,
                               fc.visual_feat_dim, dtype=fc.model.torch_dtype, device=dev)
    traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), cache.grid, cache.roi)
    o = training.optimizer_settings(st, tr["rows"], tr["batch"])
    optimizer = AdamW(model, linear_warmup_schedule(o["lr"], o["warmup"], o["total"]),
                      weight_decay=o["weight_decay"], eps=o["eps"],
                      max_grad_norm=o["max_grad_norm"])
    state = TrainState.create(model, torch.nn.Module(), optimizer)

    def batch(k: int) -> dict:
        rows = order[k % len(order)]
        sent = to_device({key: pool[key][rows] for key in KEYS}, dev)
        sent["grid"], sent["roi"] = cache.lookup(rows)
        return sent

    return training.Program(state, make_pretrain_train_step(state, vocab_chunk=0, dp_index=0),
                            batch, tr["batch"], st["log_every"], readers(ctx),
                            cuda_lib.launch_counts)


def readers(ctx) -> dict:
    cfg, tr = ctx.config, ctx.workload["traffic"]
    t, l = cfg["text"], cfg["max_text_len"]
    hd, heads, b = t["hidden_size"], t["num_attention_heads"], tr["batch"]
    elt = 2 if cfg["compute_dtype"]["train"] == "bfloat16" else 4
    peak = counts.PEAK_BF16 if elt == 2 else counts.PEAK_TF32
    return {"flop_per_step": counts.pretrain_step(cfg, cfg["decoder"], b, l,
                                                  cfg["decoder"]["max_decode_len"]),
            "peak_flops": peak,
            "k1_fwd_bound_s": counts.bound_s(counts.k1_forward(b, l, hd, heads, elt, True), peak),
            "k1_bwd_bound_s": counts.bound_s(counts.k1_backward(b, l, hd, heads, elt), peak)}


def reference_readings(ctx, pool: dict, order: np.ndarray, lowp=None,
                       fault=None) -> dict:
    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(dev):
        ref = ref_model.Seq2Seq(cfg, cfg["decoder"], lowp)
    ref.load_state_dict(state_for(ref, model_state(cfg, ctx.seed, dev)))
    dt = getattr(torch, cfg["compute_dtype"]["train"])
    grid_shape, roi_shape = feature_shapes(cfg, tr["rows"])
    grid = torch.empty(grid_shape, dtype=dt, device=dev)
    roi = torch.empty(roi_shape, dtype=dt, device=dev)
    traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), grid, roi)
    batches = []
    for k in range(training.CHECKED_STEPS):
        rows = torch.as_tensor(order[k], device=dev)
        bt = {key: torch.as_tensor(pool[key][order[k]], device=dev) for key in KEYS}
        bt["grid"], bt["roi"] = grid[rows].float(), roi[rows].float()
        batches.append(bt)
    del grid, roi

    def loss_fn(m, bt, rng):
        return ref_model.seq2seq_loss(m(bt, bt["grid"], bt["roi"], rng), bt["labels"])

    o = training.optimizer_settings(ctx.workload["step"], tr["rows"], tr["batch"])
    return ref_readings(ref, loss_fn, batches, ctx.seed, o, training.CHECKED_STEPS, fault)


def inputs(ctx):
    tr = ctx.workload["traffic"]
    return (host_pool(ctx.config, tr, ctx.seed),
            traffic.epoch_order(ctx.seed, tr["rows"], tr["batch"], tr["max_steps"]))


def run(ctx) -> dict:
    pool, order = inputs(ctx)
    tr = ctx.workload["traffic"]
    out = training.run_training(ctx, build_program(ctx, pool, order),
                                lambda: reference_readings(ctx, pool, order),
                                tr["warm_steps"], tr["trace_steps"])
    out["device"] = training.device_info(ctx, out)
    return out


def control(ctx, lowp, fault=None) -> dict:
    """The control's readings (or a planted fault's) and the reference's."""
    pool, order = inputs(ctx)
    return {"control": reference_readings(ctx, pool, order, lowp, fault),
            "reference": reference_readings(ctx, pool, order)}
