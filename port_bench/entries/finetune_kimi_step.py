"""Entry `finetune_kimi_step`: the Phase-2 train step of `macsa_tpu_torch`
(`train/steps.make_finetune_train_step`, the dual-rate `AdamW`) with Kimi
Linear as FCMF's text backbone (`models/kimi_linear.py`), on cached visual
features, as `finetune_moe_step` drives DeepSeek-V2's cell.

The traffic, the pool, the batches, the route notes and the run itself
(`finetune_moe_step.run_training`: the first three steps' readings with
the starting weights on the host, the window, the traced stretch, the
reference after the program is freed) are `finetune_moe_step`'s.  What
this entry adds:
* Kimi's configuration (`KimiLinearConfig.from_hf`, the router over every
  expert of the 32-way deployment) and its reference
  (`reference/kimi_linear.py`),
* the weights: the benchmark's rule (`lib/weights.py`) but for KDA's
  `A_log`, log U(1, 16) a head from the seed (flash-linear-attention's
  draw, which gives the decays their published range),
* the reference's AdamW leaves `A_log` and `dt_bias` undecayed, as the
  program's does (`reference/train.no_decay` knows biases and norms only),
* the readers' FLOP and bounds at Kimi's widths (`flops/kimi_linear.py`):
  the step's FLOP, the held experts' bound and the KDA core's.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from port_bench.entries import finetune_moe_step as moe_step
from port_bench.entries import finetune_step
from port_bench.flops import counts, kimi_linear as flops
from port_bench.lib import traffic, training, weights
from port_bench.reference import kimi_linear as ref_kimi, model as ref_model
from port_bench.reference import train as ref_train
from port_bench.reference.train import state_for

KEYS = moe_step.KEYS


def port_configs(cfg: dict, dtype: str):
    from macsa_tpu_torch.config import FCMFConfig, KimiLinearConfig, ModelConfig
    text = KimiLinearConfig.from_hf(cfg, num_experts=flops.router_width(cfg),
                                    ep_size=cfg["ep_size"], ep_rank=cfg["ep_rank"], dtype=dtype)
    return FCMFConfig(model=ModelConfig(dtype=dtype, **cfg["model"]), text=text,
                      num_imgs=cfg["num_imgs"], num_roi=cfg["num_roi"],
                      num_labels=cfg["num_labels"], num_patches=cfg["num_patches"],
                      visual_feat_dim=cfg["visual_feat_dim"], max_text_len=cfg["max_text_len"],
                      box_heads=cfg["box_heads"])


def seeded_state(module: torch.nn.Module, seed: int, device, std: float = 0.02) -> dict:
    """`weights.seeded_state` of the module's leaves, then every `A_log`
    drawn again as log U(1, 16) (one generator, the leaves in order)."""
    shapes, norms = weights.shapes_of(module)
    state = weights.seeded_state(shapes, norms, seed, device, std=std)
    g = traffic.device_generator(seed, 6, device)
    for name in (n for n in state if n.endswith(".A_log")):
        state[name] = torch.empty_like(state[name]).uniform_(1.0, 16.0, generator=g).log_()
    return state


def model_state(cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        module = ref_kimi.FCMF(cfg)
    return seeded_state(module, traffic.derived_seed(seed, 1), device)


def readers(ctx) -> dict:
    cfg, tr = ctx.config, ctx.workload["traffic"]
    elt = 2 if cfg["compute_dtype"]["train"] == "bfloat16" else 4
    peak = counts.PEAK_BF16 if elt == 2 else counts.PEAK_TF32
    return {"flop_per_step": flops.finetune_step(cfg, tr["batch"], cfg["aspects"],
                                                 cfg["max_text_len"]),
            "peak_flops": peak,
            "experts_bound_s": lambda rows: flops.experts_bound_s(rows, cfg, elt, peak),
            "kda_core_bound_s": lambda seqs, length: flops.kda_core_bound_s(seqs, length, cfg,
                                                                            elt, peak)}


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
    o = moe_step.optimizer_settings(ctx)
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


@contextlib.contextmanager
def _undecayed(leaves):
    """`reference/train.readings` with `leaves` (by leaf name) added to its
    no-decay set."""
    plain = ref_train.no_decay

    def no_decay(model):
        return plain(model) | {n for n, _ in model.named_parameters()
                               if n.rsplit(".", 1)[-1] in leaves}

    ref_train.no_decay = no_decay
    try:
        yield
    finally:
        ref_train.no_decay = plain


def reference_readings(ctx, pool: dict, order: np.ndarray, lowp=None, fault=None) -> dict:
    """The plain model's three steps on the same batches, from the seed;
    its first forward's routes under "routes"."""
    cfg, tr, dev = ctx.config, ctx.workload["traffic"], ctx.device
    with torch.device(dev):
        ref = ref_kimi.FCMF(cfg, lowp)
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
    log = moe_step.RouteLog(moe_step.routers(ref))

    def loss_fn(m, bt, rng):
        return ref_model.aspect_loss(ref_model.fcmf_all_aspects(m, bt, bt["grid"], bt["roi"], rng),
                                     bt["labels"])

    with _undecayed(ref_kimi.NO_DECAY_LEAVES):
        out = ref_train.readings(ref, loss_fn, batches, ctx.seed,
                                 moe_step.optimizer_settings(ctx), training.CHECKED_STEPS, fault)
    out["routes"] = log.remove()
    return out


def _route_ctx(ctx):
    """The ctx `finetune_moe_step`'s route notes read: the held experts
    under DeepSeek's key name."""
    return dataclasses.replace(ctx, config=dict(ctx.config,
                                                n_routed_experts=ctx.config["num_experts"]))


def run(ctx) -> dict:
    # a program without the Kimi Linear backbone stops here, before any work
    from macsa_tpu_torch.config import KimiLinearConfig  # noqa: F401

    pool, order = moe_step.inputs(ctx)
    tr = ctx.workload["traffic"]
    out = moe_step.run_training(_route_ctx(ctx), build_program(ctx, pool, order),
                                lambda: reference_readings(ctx, pool, order),
                                tr["warm_steps"], tr["trace_steps"])
    out["device"] = training.device_info(ctx, out)
    return out


def control(ctx, lowp, fault=None) -> dict:
    """The control's readings (or a planted fault's) and the reference's,
    with no program run."""
    pool, order = moe_step.inputs(ctx)
    low = reference_readings(ctx, pool, order, lowp, fault)
    training.free(ctx.device)
    return {"control": low, "reference": reference_readings(ctx, pool, order)}
