"""Entry `finetune_moe_step`: the Phase-2 train step of `macsa_tpu_torch`
(`train/steps.make_finetune_train_step`, the dual-rate `AdamW`) with
DeepSeek-V2 as FCMF's text backbone (`models/deepseek_v2.py`), on cached
visual features read through `VisualFeatureCache.lookup` in the epoch's
shuffled order, as `finetune_step` drives `finetune.cached`.

The traffic, the cache and the batches are `finetune_step`'s helpers, the
ids' <s>, </s> and <pad> put in DeepSeek's places (the configuration's
`text`).  What differs from `finetune_step`:
* the program's first three steps keep the weights they start from on
  the host, not on the card: a second copy of the ~2.9 B f32 parameters
  does not fit beside the step (`program_readings`),
* the plain reference is `reference/deepseek_v2.py`,
* the notes give the share of (token, slot) routes on which the bf16
  program and the f32 reference disagree in their first forward, and the
  routes sent to the held experts there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.entries import finetune_step
from port_bench.flops import counts, deepseek_v2 as flops
from port_bench.lib import check, traffic, training, weights
from port_bench.reference import deepseek_v2 as ref_dsv2, model as ref_model
from port_bench.reference.train import readings as ref_readings, state_for

KEYS = ("input_ids", "token_type_ids", "attention_mask", "added_mask", "labels", "roi_coors")


def port_configs(cfg: dict, dtype: str):
    from macsa_tpu_torch.config import DeepseekV2Config, FCMFConfig, ModelConfig
    text = DeepseekV2Config.from_hf(cfg, n_routed_experts=flops.router_width(cfg),
                                    ep_size=cfg["ep_size"], ep_rank=cfg["ep_rank"], dtype=dtype)
    return FCMFConfig(model=ModelConfig(dtype=dtype, **cfg["model"]), text=text,
                      num_imgs=cfg["num_imgs"], num_roi=cfg["num_roi"],
                      num_labels=cfg["num_labels"], num_patches=cfg["num_patches"],
                      visual_feat_dim=cfg["visual_feat_dim"], max_text_len=cfg["max_text_len"],
                      box_heads=cfg["box_heads"])


def model_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        shapes, norms = weights.shapes_of(ref_dsv2.FCMF(cfg))
    return weights.seeded_state(shapes, norms, traffic.derived_seed(seed, 1), device)


def inputs(ctx):
    """The host pool (`finetune_step.host_pool` over DeepSeek's vocabulary,
    its special ids in place) and the epoch order."""
    cfg, tr = ctx.config, ctx.workload["traffic"]
    pool = finetune_step.host_pool(dict(cfg, text={"vocab_size": cfg["vocab_size"]}), tr,
                                   ctx.seed)
    ids, t = pool["input_ids"], cfg["text"]
    for theirs, ours in ((traffic.BOS, "bos_token_id"), (traffic.EOS, "eos_token_id"),
                         (traffic.PAD, "pad_token_id")):
        ids = np.where(pool["input_ids"] == theirs, t[ours], ids)
    pool["input_ids"] = ids.astype(np.int32)
    return pool, traffic.epoch_order(ctx.seed, tr["rows"], tr["batch"], tr["max_steps"])


def optimizer_settings(ctx) -> dict:
    tr = ctx.workload["traffic"]
    return training.optimizer_settings(ctx.workload["step"], tr["rows"], tr["batch"])


def build_program(ctx, pool: dict, order: np.ndarray) -> training.Program:
    from macsa_tpu_torch.models.fcmf import FCMF
    from macsa_tpu_torch.ops import cuda_lib
    from macsa_tpu_torch.train.common import to_device
    from macsa_tpu_torch.train.feature_cache import VisualFeatureCache
    from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
    from macsa_tpu_torch.train.state import TrainState
    from macsa_tpu_torch.train.steps import make_finetune_train_step

    cfg, tr, st, dev = ctx.config, ctx.workload["traffic"], ctx.workload["step"], ctx.device
    fc = port_configs(cfg, cfg["compute_dtype"]["train"])
    model = FCMF(fc, device=dev)
    model.load_state_dict(model_state(cfg, ctx.seed, dev))
    cache = VisualFeatureCache(tr["rows"], fc.num_imgs, fc.num_roi, fc.num_patches,
                               fc.visual_feat_dim, dtype=fc.model.torch_dtype, device=dev)
    traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), cache.grid, cache.roi)
    o = optimizer_settings(ctx)
    optimizer = AdamW(model, linear_warmup_schedule(o["lr"], o["warmup"], o["total"]),
                      weight_decay=o["weight_decay"], max_grad_norm=o["max_grad_norm"],
                      head_learning_rate=linear_warmup_schedule(o["head_lr"], o["warmup"],
                                                                o["total"]))
    state = TrainState.create(model, torch.nn.Module(), optimizer)

    def batch(k: int) -> dict:
        rows = order[k % len(order)]
        sent = to_device({key: pool[key][rows] for key in KEYS}, dev)
        sent["grid"], sent["roi"] = cache.lookup(rows)
        return sent

    return training.Program(state, make_finetune_train_step(state, 0), batch, tr["batch"],
                            st["log_every"], readers(ctx), cuda_lib.launch_counts)


def readers(ctx) -> dict:
    cfg, tr = ctx.config, ctx.workload["traffic"]
    elt = 2 if cfg["compute_dtype"]["train"] == "bfloat16" else 4
    peak = counts.PEAK_BF16 if elt == 2 else counts.PEAK_TF32
    return {"flop_per_step": flops.finetune_step(cfg, tr["batch"], cfg["aspects"],
                                                 cfg["max_text_len"]),
            "peak_flops": peak,
            "experts_bound_s": lambda rows: flops.experts_bound_s(rows, cfg, elt, peak)}


class RouteLog:
    """The experts each router picks in its first call after the log is made
    (a checkpointed layer calls its router again in the backward), until
    `remove`."""

    def __init__(self, routers):
        self.routes: dict = {}
        self.hooks = [r.register_forward_hook(self._hook(i)) for i, r in enumerate(routers)]

    def _hook(self, i):
        def hook(module, args, out):
            self.routes.setdefault(i, out[0].detach().clone())
        return hook

    def remove(self) -> list:
        for h in self.hooks:
            h.remove()
        return [self.routes[i] for i in sorted(self.routes)]


def routers(model) -> list:
    return [layer.mlp.gate for layer in model.encoder.bert.cell.layers
            if hasattr(layer.mlp, "gate")]


def route_notes(prog_routes: list, ref_routes: list, cfg: dict) -> dict:
    """Share of (token, slot) routes in which the two sides' expert sets
    differ, over every MoE layer; and the routes to the held experts a
    layer (the program's) and a held expert."""
    first, held = cfg["ep_rank"] * cfg["n_routed_experts"], cfg["n_routed_experts"]
    differ, total, rows = 0, 0, 0
    for p, r in zip(prog_routes, ref_routes):
        r = r.to(p.device)
        same = (p[:, :, None] == r[:, None, :]).any(-1).sum()
        differ += int(p.numel() - same)
        total += p.numel()
        rows += int(((p >= first) & (p < first + held)).sum())
    n = max(len(prog_routes), 1)
    return {"route_disagreement": differ / max(total, 1),
            "held_rows_per_layer": rows / n, "rows_per_held_expert": rows / n / held}


def program_readings(prog: training.Program, seed: int) -> tuple:
    """Steps 1..3 through the window's own call and feed -> (readings, k,
    routes of the first forward), as `training._program_readings` takes
    them, the starting weights kept on the host."""
    named = [(n, p) for n, p in prog.state.model.named_parameters() if p.requires_grad]
    start = [p.detach().to("cpu", copy=True) for _, p in named]
    log = RouteLog(routers(prog.state.model))
    losses, grad, routes = [], {}, []
    for k in range(training.CHECKED_STEPS):
        losses.append(prog.step(prog.batch(k), seed)["loss"])
        if k == 0:
            routes = log.remove()
            moments = prog.state.optimizer.optimizer.state
            norms = torch.stack(torch._foreach_norm(
                [moments.get(p, {}).get("exp_avg", torch.zeros_like(p)) for _, p in named]
            )).cpu() / (1 - training.BETA1)
            grad = {n: float(v) for (n, _), v in zip(named, norms)}
    change = {n: float(torch.linalg.vector_norm(p.detach() - s.to(p.device)))
              for (n, p), s in zip(named, start)}
    del start
    return ({"loss": [float(x) for x in losses], "grad": grad, "change": change},
            training.CHECKED_STEPS, routes)


def reference_readings(ctx, pool: dict, order: np.ndarray, lowp=None, fault=None) -> dict:
    """The plain model's three steps on the same batches, from the seed;
    its first forward's routes under "routes"."""
    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    with torch.device(dev):
        ref = ref_dsv2.FCMF(cfg, lowp)
    ref.load_state_dict(state_for(ref, model_state(cfg, ctx.seed, dev)))
    batches = [{key: torch.as_tensor(pool[key][order[k]], device=dev) for key in KEYS}
               for k in range(training.CHECKED_STEPS)]
    dt = getattr(torch, cfg["compute_dtype"]["train"])
    grid_shape, roi_shape = finetune_step.feature_shapes(cfg, tr["rows"])
    grid = torch.empty(grid_shape, dtype=dt, device=dev)
    roi = torch.empty(roi_shape, dtype=dt, device=dev)
    traffic.fill_features_(traffic.device_generator(ctx.seed, 3, dev), grid, roi)
    for k, bt in enumerate(batches):
        rows = torch.as_tensor(order[k], device=dev)
        bt["grid"], bt["roi"] = grid[rows].float(), roi[rows].float()
    del grid, roi
    log = RouteLog(routers(ref))

    def loss_fn(m, bt, rng):
        return ref_model.aspect_loss(ref_model.fcmf_all_aspects(m, bt, bt["grid"], bt["roi"], rng),
                                     bt["labels"])

    out = ref_readings(ref, loss_fn, batches, ctx.seed, optimizer_settings(ctx),
                       training.CHECKED_STEPS, fault)
    out["routes"] = log.remove()
    return out


def run_training(ctx, prog: training.Program, reference, warm_steps: int,
                 trace_steps: int) -> dict:
    """`training.run_training` with `program_readings` and the route notes."""
    dev = ctx.device
    readings, k, prog_routes = program_readings(prog, ctx.seed)
    for _ in range(warm_steps):
        prog.step(prog.batch(k), ctx.seed)
        k += 1
    training.sync(dev)
    setup_s = time.perf_counter() - ctx.started

    t0, n = time.perf_counter(), 0
    while True:
        metrics = prog.step(prog.batch(k), ctx.seed)
        k, n = k + 1, n + 1
        if n % prog.log_every == 0:
            float(metrics["loss"])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    training.sync(dev)
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
        out.update(training.traced(run_steps, ks, trace_steps, dev, prog.launch_counts,
                                   prog.readers, n, window))
    out["memory_peak_bytes"] = training.peak_bytes(dev)
    variants = {key: v for key, v in prog.launch_counts.items() if v}
    prog.state = prog.step = prog.batch = None
    training.free(dev)

    ref = reference()
    numbers, worst = check.training_numbers(readings, ref)
    correct, checked = check.verdict(numbers, ctx.workload["check"])
    out.update(correct=correct, check=checked,
               notes={"variants": variants, "worst_leaf": worst,
                      "program_loss": readings["loss"], "reference_loss": ref["loss"],
                      **route_notes(prog_routes, ref["routes"], ctx.config)})
    return out


def run(ctx) -> dict:
    # a program without the DeepSeek-V2 backbone stops here, before any work
    from macsa_tpu_torch.config import DeepseekV2Config  # noqa: F401

    pool, order = inputs(ctx)
    tr = ctx.workload["traffic"]
    out = run_training(ctx, build_program(ctx, pool, order),
                       lambda: reference_readings(ctx, pool, order),
                       tr["warm_steps"], tr["trace_steps"])
    out["device"] = training.device_info(ctx, out)
    return out


def control(ctx, lowp, fault=None) -> dict:
    """The control's readings (or a planted fault's) and the reference's,
    with no program run."""
    pool, order = inputs(ctx)
    low = reference_readings(ctx, pool, order, lowp, fault)
    training.free(ctx.device)
    return {"control": low, "reference": reference_readings(ctx, pool, order)}
