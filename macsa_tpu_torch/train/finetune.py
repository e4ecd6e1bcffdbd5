"""Phase-2 MACSA fine-tune driver (FCMF classifier), on PyTorch.

Counterpart of `macsa_tpu/train/finetune.py` (reference driver:
run_multimodal_fcmf.py): the same flag surface (argparse), the same data
prerequisites, dual-LR AdamW + linear warmup, optional encoder freeze,
per-epoch dev macro-F1 with best/last checkpoints, and the test harness
writing `test_results_fcmf.txt` + the human-auditable
`test_predictions_formatted.txt`, in the byte formats `macsa_tpu` pins.

What differs from the JAX driver:
* `--device` (default `cuda`): the card the run is on.  Without a CUDA
  device the default raises; only `--device cpu` runs on the CPU.
* `--fused_attention auto|on` means the hand-written attention kernel (on
  the card), `off` the plain path; `on` with `--device cpu` raises.
* checkpoints are torch files (`best.pt`, `last.pt`), not orbax directories.
* `--prng` is accepted and ignored (it picks a JAX PRNG); dropout is drawn
  from (seed, step) by explicit torch generators.
* `--pretrained_iaog_path` takes a Phase-1 output directory of
  `macsa_tpu_torch.train.pretrain` (its `best.pt`, else `last.pt`) or a
  checkpoint file.
* data parallelism is the reference's DDP over processes (`parallel/mesh.py`):
  `torchrun --nproc_per_node N -m macsa_tpu_torch.train.finetune ...`, one
  card a rank; `--train_batch_size` is per data-parallel rank (the global
  batch is dp times it, as in JAX); the ranks' gradients are averaged once
  an update; dev eval runs on lockstep stripes, gathered to every rank;
  only rank 0 writes logs, metrics, checkpoints and reports.  Each
  data-parallel rank draws its own dropout masks (`DropoutRng` keyed by
  its index), so with dropout on N ranks draw other masks than one process.
* `--mp M` is tensor parallelism (`parallel/sharding.py`, JAX's Megatron
  rules): N processes make dp = N / M data-parallel ranks of M model
  shards each; the checkpoints hold whole tensors.
* `--fine_tune_cnn` trains the ResNet beside the model (convolutions and
  all four tensors of every FrozenBatchNorm, in the one AdamW); the feature
  cache is then off unless `--cache_visual_features on`, as in JAX.

One train step covers ResNet feature extraction + all 6 aspect views, as
there; nothing on the step's path waits on the device: the loss is read
only every `--log_every` steps.

Run: python -m macsa_tpu_torch.train.finetune --do_train --do_eval ...
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from macsa_tpu_torch.config import ASPECTS, FCMFConfig, ModelConfig, ResNetConfig
from macsa_tpu_torch.data.loader import DataLoader, pad_batch
from macsa_tpu_torch.data.tokenizer import load_tokenizer
from macsa_tpu_torch.data.vimacsa import MACSADataset
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.parallel import mesh, sharding
from macsa_tpu_torch.train import common
from macsa_tpu_torch.train.checkpoints import (CheckpointManager, load_model_state_dict,
                                               resolve_iaog_checkpoint,
                                               transfer_encoder_params)
from macsa_tpu_torch.train.common import resolve_device, resolve_fused_attention, to_device
from macsa_tpu_torch.train.feature_cache import FeatureCacheFeeder
from macsa_tpu_torch.train.metrics import aspect_report, write_test_reports
from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_finetune_eval_step, make_finetune_train_step
from macsa_tpu_torch.utils.logging import (MetricWriter, NullWriter, device_kernel_seconds,
                                           maybe_profile, setup_logging)


def build_argparser() -> argparse.ArgumentParser:
    """Flag surface mirroring run_multimodal_fcmf.py:65-118 and
    `macsa_tpu.train.finetune.build_argparser`, plus `--device`."""
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pretrained_hf_model", type=str, default="uitnlp/visobert",
                   help="local model directory: its config.json picks the text backbone "
                        "(RoBERTa; DeepSeek-V2 where model_type is deepseek_v2: this "
                        "process then holds rank 0's 8 of every MoE layer's routed experts, "
                        "as in an 8-way expert-parallel deployment; Kimi Linear where it is "
                        "kimi_linear: rank 0's 8 of 256, 32-way), its tokenizer and "
                        "pytorch_model.bin its vocabulary and weights.  The MoE models' "
                        "published weights (safetensors) and tokenizers are not read yet: "
                        "the backbone keeps its random init")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="torchvision resnet152 state-dict file")
    p.add_argument("--num_imgs", type=int, default=7)
    p.add_argument("--num_rois", type=int, default=4)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--max_seq_length", type=int, default=170)
    p.add_argument("--train_batch_size", type=int, default=8,
                   help="per process; the global batch is the world size times it")
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--encoder_learning_rate", type=float, default=7e-5)
    p.add_argument("--classifier_head_learning_rate", type=float, default=7e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--num_train_epochs", type=int, default=12)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--prng", type=str, default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="accepted for the JAX driver's command lines and "
                        "ignored: dropout is drawn by torch generators")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 activations (replaces the reference --fp16); "
                        "--no-bf16 computes in float32")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--pretrained_iaog_path", type=str, default=None,
                   help="Phase-1 output directory (its best.pt, else last.pt) or "
                        "checkpoint file for the encoder transfer")
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--fine_tune_cnn", action="store_true",
                   help="train the ResNet too: its convolutions and all four "
                        "BatchNorm tensors join the model's parameters in AdamW")
    p.add_argument("--cross_mask_mode", type=str, default="causal_quirk",
                   choices=["causal_quirk", "padding"])
    p.add_argument("--use_mde", action="store_true", default=False,
                   help="enable the Multimodal Denoising Encoder on the "
                        "patch branch when alpha < 1 (with alpha >= 1 the "
                        "flag changes nothing)")
    p.add_argument("--pixel_transfer", type=str, default="packed",
                   choices=["packed", "f32"],
                   help="host->device pixel encoding. packed (default): "
                        "int32 words, 1 byte/pixel, normalize fused into "
                        "the on-device unpack; f32: the reference's "
                        "host-normalized float32 shape "
                        "(vimacsa_dataset.py:25-30).  Same math either way "
                        "(ops/image_prep.py)")
    p.add_argument("--fused_attention", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="hand-written fused softmax+dropout+PV attention "
                        "kernel for the text-encoder blocks; auto = on for "
                        "a CUDA device")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of each epoch's "
                        "train steps under this directory")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--resnet_stages", type=str, default="3,8,36,3",
                   help="ResNet stage sizes (default: ResNet-152); smaller "
                        "values for smoke tests, e.g. '1,1,1,1'")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel size: the model is Megatron-sharded over "
                        "mp ranks (parallel.sharding), dp = processes // mp")
    p.add_argument("--cache_visual_features", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="cache the frozen-CNN visual features in device "
                        "memory after the first pass over each split (exact: "
                        "eval-mode BN; skips the ResNet stack and the "
                        "raw-pixel host->device transfer). auto = on unless "
                        "--fine_tune_cnn")
    p.add_argument("--feature_cache_dir", type=str, default=None,
                   help="cross-stage on-disk feature cache "
                        "(train/disk_feature_cache.py): content-addressed "
                        "(image bytes + ROI boxes + ResNet weights), so "
                        "processes sharing the dir reuse each other's "
                        "frozen-CNN extraction instead of re-decoding.  "
                        "Requires the device feature cache")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run.  The default raises "
                        "without a CUDA device; say cpu to run on the CPU")
    return p


def main(argv: Optional[list] = None, *,
         config_hook: Optional[Callable] = None,
         model_hook: Optional[Callable] = None) -> dict:
    """Run the driver.  The two hooks are for tests only (the parity tests
    against the JAX package; the command line cannot reach them):
    `config_hook(cfg, rcfg) -> (cfg, rcfg)` edits the model configs built
    from the flags, `model_hook(model, visual)` runs after the weight
    import (to load carried-over parameters)."""
    args = build_argparser().parse_args(argv)
    device = mesh.maybe_initialize_distributed(resolve_device(args.device))
    mesh.init_model_parallel(args.mp)
    # the loaders' shards and stripes are the data-parallel ranks'
    n_hosts, host_id = mesh.dp_size(), mesh.dp_index()
    is_main = mesh.process_index() == 0
    logger = setup_logging(args.output_dir if is_main else None, is_main=is_main)
    writer = MetricWriter(args.output_dir) if is_main else NullWriter()
    np.random.seed(args.seed)
    logger.info(f"--prng {args.prng}: ignored (a JAX PRNG choice; dropout is drawn from "
                f"(seed, step) by torch generators)")

    dtype = "bfloat16" if args.bf16 else "float32"
    fused = resolve_fused_attention(args.fused_attention, device)
    text_cfg = common.build_text_config(args.pretrained_hf_model, dtype, fused_attention=fused)
    cfg = FCMFConfig(model=ModelConfig(dtype=dtype, fused_attention=fused),
                     text=text_cfg,
                     num_imgs=args.num_imgs, num_roi=args.num_rois,
                     alpha=args.alpha, max_text_len=args.max_seq_length,
                     decoder_cross_mask_mode=args.cross_mask_mode,
                     use_mde=args.use_mde)
    rcfg = ResNetConfig(dtype=dtype, stage_sizes=tuple(
        int(s) for s in args.resnet_stages.split(",")))
    if config_hook is not None:
        cfg, rcfg = config_hook(cfg, rcfg)

    tokenizer = load_tokenizer(args.pretrained_hf_model)
    roi_boxes, dict_img, dict_roi = common.load_metadata(args.data_dir)

    def make_dataset(split: str) -> MACSADataset:
        records = common.load_records(os.path.join(args.data_dir, f"{split}.json"))
        return MACSADataset(records, tokenizer, args.image_dir, roi_boxes,
                            dict_img, dict_roi, num_img=args.num_imgs,
                            num_roi=args.num_rois,
                            max_text_len=args.max_seq_length,
                            num_patches=cfg.num_patches,
                            pixel_mode=args.pixel_transfer)

    # --- model & params -------------------------------------------------
    model = FCMF(cfg, device=device)
    visual = VisualFeatures(rcfg, device=device)
    init_weights(model, torch.Generator(device).manual_seed(args.seed),
                 cfg.model.initializer_range)
    init_weights(visual, torch.Generator(device).manual_seed(args.seed + 1))
    common.import_text_params(model, args.pretrained_hf_model, logger)
    common.import_resnet_params(visual, args.resnet_weights, logger)

    # --- IAOG encoder transfer (run_multimodal_fcmf.py:382-412) ----------
    if args.pretrained_iaog_path:
        ckpt_path = resolve_iaog_checkpoint(args.pretrained_iaog_path)
        if ckpt_path is not None:
            logger.info(f"Transferring IAOG encoder from {ckpt_path}")
            model.load_state_dict(transfer_encoder_params(
                load_model_state_dict(ckpt_path), model.state_dict()), strict=True)
        else:
            logger.warning(f"no IAOG checkpoint under {args.pretrained_iaog_path}; "
                           "training from scratch")
    if model_hook is not None:
        model_hook(model, visual)
    mesh.replicate(model)  # every rank starts from rank 0's weights
    mesh.replicate(visual)
    sharding.shard_model_(model)  # --mp > 1: each rank keeps its slices

    # --- optimizer (dual LR, run_multimodal_fcmf.py:247-289) -------------
    train_ds = make_dataset("train") if args.do_train else None
    steps_per_epoch = (len(train_ds) // args.train_batch_size) if train_ds else 0
    num_train_steps = int(steps_per_epoch / args.gradient_accumulation_steps
                          * args.num_train_epochs)
    warmup = int(num_train_steps * args.warmup_proportion)
    if args.freeze_encoder:
        # the encoder gets no gradient, so AdamW leaves it out: neither
        # updated nor decayed (run_multimodal_fcmf.py:230-236)
        model.encoder.requires_grad_(False)
    optimizer = AdamW(
        model,
        linear_warmup_schedule(args.encoder_learning_rate, warmup, num_train_steps),
        weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        head_learning_rate=linear_warmup_schedule(
            args.classifier_head_learning_rate, warmup, num_train_steps),
        accumulate_steps=args.gradient_accumulation_steps)
    state = TrainState.create(model, visual, optimizer, fine_tune_cnn=args.fine_tune_cnn)

    ckpt = CheckpointManager(args.output_dir)
    start_epoch, best_f1 = 0, 0.0
    if args.resume_from_checkpoint and ckpt.exists(args.resume_from_checkpoint):
        state, start_epoch, best_f1 = ckpt.restore(args.resume_from_checkpoint, state)
        logger.info(f"resumed from epoch {start_epoch} (step {state.step}), "
                    f"best F1 {best_f1:.4f}")

    train_step = make_finetune_train_step(state, host_id)
    eval_step = make_finetune_eval_step(model, visual)

    # --- frozen-CNN visual feature cache (device memory) -----------------
    # Exact across epochs (eval-mode BN, no autograd); the first pass over a
    # split computes + stores, later passes gather and skip the ResNet
    # stack AND the raw-pixel host->device transfer.
    use_feature_cache = (args.cache_visual_features == "on" or
                         (args.cache_visual_features == "auto"
                          and not args.fine_tune_cnn))
    feeders: dict = {}  # split -> FeatureCacheFeeder

    # --- cross-stage on-disk feature cache (disk_feature_cache.py) -------
    disk_cache, cache_fp = None, None
    if use_feature_cache and args.feature_cache_dir:
        from macsa_tpu_torch.train.disk_feature_cache import DiskFeatureCache, record_key
        disk_cache = DiskFeatureCache(args.feature_cache_dir)
        cache_fp = common.resnet_fingerprint(args.resnet_weights, rcfg, args.seed)

    def ensure_cache(split: str, dataset) -> None:
        """Create the split's feeder (its device cache, prefilled from disk)
        BEFORE the loader starts."""
        if not use_feature_cache or split in feeders:
            return
        keys = None
        if disk_cache is not None:
            keys = [record_key(rec.get("list_img") or [], args.image_dir,
                               roi_boxes, args.num_imgs, args.num_rois, cache_fp)
                    for rec in dataset.records]
        feeders[split] = FeatureCacheFeeder(visual, cfg, len(dataset), device, "_idx",
                                            disk_cache=disk_cache, keys=keys, logger=logger,
                                            name=f"[{split}]")

    def featurize(split: str, batch: dict) -> dict:
        """Loader batch (numpy) -> device batch, raw pixels replaced with
        (possibly cached) visual features."""
        if not use_feature_cache:
            return to_device(batch, device)
        return feeders[split](batch)

    def pixels_needed(split: str):
        """Per-sample gate for the loader: pixels are required only until the
        device feature cache owns that row (None => always carry pixels).
        Under several processes the train loader's gate is off (JAX's rule:
        each rank shuffles its own shard, so it cannot answer for its
        peers' rows); the eval stripes gate on the global step's rows."""
        return feeders[split].needs_pixels if use_feature_cache else None

    def run_eval(dataset, split: str = "dev") -> dict:
        """Dev eval over the ranks in lockstep: global step s covers rows
        [s*G, (s+1)*G), G = ranks x eval_batch_size, each rank its stripe;
        every row is computed once, the trailing clone rows (marked -1)
        dropped, and `fetch_global` brings the predictions and labels to
        every rank, so every rank returns the full report."""
        n = len(dataset)
        g = n_hosts * args.eval_batch_size
        ensure_cache(split, dataset)
        loader = DataLoader(dataset, args.eval_batch_size, num_workers=8,
                            cache=use_feature_cache,
                            needs_pixels=pixels_needed(split),
                            num_hosts=n_hosts, host_id=host_id,
                            eval_stripe=True)
        trues = np.zeros((n, len(ASPECTS)), np.int32)
        preds = np.zeros((n, len(ASPECTS)), np.int32)
        for s, batch in enumerate(loader):
            labels = batch["labels"]
            p, _ = eval_step(featurize(split, batch))
            m = min(g, n - s * g)  # trailing rows are -1-marked clone pads
            preds[s * g:s * g + m] = mesh.fetch_global(p)[:m]
            trues[s * g:s * g + m] = mesh.fetch_global(labels)[:m]
        return aspect_report(trues, preds)

    result: dict = {}
    if args.do_train:
        dev_ds = make_dataset("dev") if args.do_eval else None
        ensure_cache("train", train_ds)
        # this rank's contiguous shard of the train split
        loader = DataLoader(train_ds, args.train_batch_size, shuffle=True,
                            seed=args.seed, drop_last=True, num_workers=8,
                            cache=True, num_hosts=n_hosts, host_id=host_id,
                            needs_pixels=pixels_needed("train") if n_hosts == 1 else None)
        result["epochs"] = []
        for epoch in range(start_epoch, args.num_train_epochs):
            loader.set_epoch(epoch)
            meter, losses = common.EpochMeter(epoch, int(state.step)), []
            # with --profile_dir: one trace an epoch, of its train steps only
            with maybe_profile(args.profile_dir if is_main else None,
                               tag=f"epoch{epoch}") as prof:
                for batch in meter.batches(loader):
                    metrics = train_step(featurize("train", batch), args.seed)
                    meter.count(args.train_batch_size)
                    if meter.steps % args.log_every == 0:
                        # the global batch's loss: the mean of the ranks' equal batches
                        loss, rate = float(mesh.all_mean(metrics["loss"])), meter.rate()
                        losses.append(loss)
                        logger.info(f"epoch {epoch} step {meter.steps}: "
                                    f"loss {loss:.4f}  {rate:.2f} samples/s")
                        writer.write(int(state.step), loss=loss,
                                     samples_per_s=rate, epoch=epoch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # the epoch's last step has ended
            record = meter.stop(losses=losses)
            kernel_s = device_kernel_seconds(prof) if prof is not None else None
            # the card's kernels and copies alone, from the profiler
            # (--profile_dir only; None otherwise and on the CPU)
            record["device_kernel_ms_per_step"] = (
                kernel_s * 1e3 / meter.steps if kernel_s and meter.steps else None)
            result["epochs"].append(record)
            meter.write(writer, int(state.step))
            if args.do_eval and dev_ds is not None:
                report = run_eval(dev_ds)
                f1 = report["average"]["f1"]
                logger.info(f"epoch {epoch} dev macro-F1 {f1:.4f}")
                writer.write(int(state.step), dev_f1=f1, epoch=epoch)
                if f1 > best_f1:
                    best_f1 = f1
                    logger.info(f"new best F1 {best_f1:.4f}; saving best")
                    if host_id == 0:  # rank 0 writes; its mp peers send their shards
                        ckpt.save("best", state, epoch + 1, best_f1)
                    if is_main:
                        ckpt.copy("best", "last")  # identical payload
                    mesh.barrier()
                    continue
            if host_id == 0:
                ckpt.save("last", state, epoch + 1, best_f1)
            mesh.barrier()
        ckpt.finalize()
        result["best_dev_f1"] = best_f1

    if args.do_test:
        if ckpt.exists("best"):
            state = ckpt.restore_params_only("best", state)
        test_ds = make_dataset("test")
        ensure_cache("test", test_ds)
        loader = DataLoader(test_ds, args.eval_batch_size, num_workers=8,
                            cache=use_feature_cache,
                            needs_pixels=pixels_needed("test"))
        trues, preds, texts = [], [], []
        for batch in loader:
            texts.extend(batch.pop("text"))
            b = batch["labels"].shape[0]
            padded = pad_batch(batch, args.eval_batch_size)
            p, _ = eval_step(featurize("test", padded))
            preds.append(p.cpu().numpy()[:b])
            trues.append(batch["labels"])
        trues, preds = np.concatenate(trues), np.concatenate(preds)
        report = aspect_report(trues, preds)
        result["test"] = report

        # artifact files matching the reference (:660-694), in the byte
        # format `macsa_tpu.train.metrics` pins; every rank ran the whole
        # test split, rank 0 writes
        if is_main:
            write_test_reports(args.output_dir, report, texts, trues, preds)
        mesh.barrier()
        logger.info(f"test macro-F1 {report['average']['f1']:.4f}")

    if disk_cache is not None:
        disk_cache.flush()  # queued feature writes land before exit
    return result


if __name__ == "__main__":
    main()
