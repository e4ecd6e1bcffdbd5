"""Baseline trainer: mRoBERTa / TomBERT / EF-CapTrRoBERTa, on PyTorch.

Counterpart of `macsa_tpu/train/train_baselines.py` (reference:
mROBERTa/train_mroberta_vimacsa_full.py, tomROBERTa/
train_tomroberta_vimacsa_full.py, EF-CapTrRoBERTa/train_ef_captr_roberta.py):
one driver, `--model` picks the architecture and its dataset; the FCMF
driver's loop (one AdamW with linear warmup, weight decay and clipping, no
head learning rate; a dev macro-F1 each epoch; best/last checkpoints; the
test report `test_results_{model}.txt` and the formatted prediction dump).
ROI boxes come from the metadata where the label JSONs exist, else from
`roi_data.csv`; `efcap` reads its captions from `--caption_file`
(`macsa_tpu_torch.tools.generate_captions` writes one).

What differs from the JAX driver, as in `train/finetune.py`:
* `--device` (default `cuda`) raises without a CUDA device; only `--device
  cpu` runs on the CPU.  `--fused_attention auto|on` is the hand-written
  attention kernel (on the card), `off` the plain path; `on` with `--device
  cpu` raises.
* checkpoints are torch files (`best.pt`, `last.pt`); `--bf16` is
  `--bf16/--no-bf16`; `--prng` is accepted and ignored.
* data parallelism is the reference's DDP over processes (`parallel/mesh.py`,
  `torchrun --nproc_per_node N -m macsa_tpu_torch.train.train_baselines ...`):
  `--train_batch_size` is per process, each rank trains on its shard, the
  gradients are averaged once an update, every rank evaluates the whole
  dev and test splits (as every JAX host does), and only rank 0 logs,
  writes metrics, checkpoints and reports.

Run: python -m macsa_tpu_torch.train.train_baselines --model mroberta --do_train ...
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.data.baselines import EFCapDataset, MRoBERTaDataset, TomBERTDataset
from macsa_tpu_torch.data.images import roi_boxes_from_csv
from macsa_tpu_torch.data.loader import DataLoader, pad_batch
from macsa_tpu_torch.data.tokenizer import load_tokenizer
from macsa_tpu_torch.models.baselines import BASELINE_NAMES, build_baseline
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.parallel import mesh
from macsa_tpu_torch.train import common
from macsa_tpu_torch.train.baseline_steps import make_baseline_eval_step, make_baseline_train_step
from macsa_tpu_torch.train.checkpoints import CheckpointManager
from macsa_tpu_torch.train.common import resolve_device, resolve_fused_attention, to_device
from macsa_tpu_torch.train.metrics import aspect_report, write_test_reports
from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.utils.logging import MetricWriter, NullWriter, setup_logging


def build_argparser() -> argparse.ArgumentParser:
    """The flags of `macsa_tpu.train.train_baselines.build_argparser`, plus
    `--device`."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True, choices=list(BASELINE_NAMES))
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--caption_file", type=str, default=None,
                   help="visual captions JSON (efcap)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pretrained_hf_model", type=str, default="uitnlp/visobert")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="torchvision resnet152 state-dict file")
    p.add_argument("--num_imgs", type=int, default=7)
    p.add_argument("--num_rois", type=int, default=7)
    p.add_argument("--max_seq_length", type=int, default=170)
    p.add_argument("--max_cap_length", type=int, default=256)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=2e-5)
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
    p.add_argument("--fused_attention", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="hand-written fused attention kernel for the text "
                        "encoder's blocks; auto = on for a CUDA device")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 activations; --no-bf16 computes in float32")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run.  The default raises "
                        "without a CUDA device; say cpu to run on the CPU")
    return p


def main(argv: Optional[list] = None, *,
         config_hook: Optional[Callable] = None,
         model_hook: Optional[Callable] = None) -> dict:
    """Run the driver.  The two hooks are for tests only:
    `config_hook(text_cfg, rcfg) -> (text_cfg, rcfg)` edits the configs
    built from the flags, `model_hook(model, visual)` runs after the weight
    import (`visual` is None for efcap)."""
    args = build_argparser().parse_args(argv)
    device = mesh.maybe_initialize_distributed(resolve_device(args.device))
    n_hosts, host_id = mesh.dp_size(), mesh.dp_index()
    is_main = host_id == 0
    logger = setup_logging(args.output_dir if is_main else None, is_main=is_main)
    writer = MetricWriter(args.output_dir) if is_main else NullWriter()
    np.random.seed(args.seed)
    logger.info(f"--prng {args.prng}: ignored (a JAX PRNG choice; dropout is drawn from "
                f"(seed, step) by torch generators)")

    dtype = "bfloat16" if args.bf16 else "float32"
    text_cfg = common.build_text_config(
        args.pretrained_hf_model, dtype,
        fused_attention=resolve_fused_attention(args.fused_attention, device))
    rcfg = ResNetConfig(dtype=dtype)
    if config_hook is not None:
        text_cfg, rcfg = config_hook(text_cfg, rcfg)
    tokenizer = load_tokenizer(args.pretrained_hf_model)

    uses_visual = args.model in ("mroberta", "tomroberta")
    roi_boxes = None
    if uses_visual:
        if os.path.exists(os.path.join(args.data_dir, "resnet152_image_label.json")):
            roi_boxes = common.load_metadata(args.data_dir)[0]
        else:
            roi_boxes = roi_boxes_from_csv(os.path.join(args.data_dir, "roi_data.csv"))
    caption_dict = {}
    if args.model == "efcap" and args.caption_file:
        with open(args.caption_file) as f:
            caption_dict = json.load(f)
        logger.info(f"{len(caption_dict)} captions from {args.caption_file}")

    def make_dataset(split: str):
        records = common.load_records(os.path.join(args.data_dir, f"{split}.json"))
        if args.model == "mroberta":
            return MRoBERTaDataset(records, tokenizer, args.image_dir, roi_boxes,
                                   num_img=args.num_imgs, num_roi=args.num_rois,
                                   max_len=args.max_seq_length)
        if args.model == "tomroberta":
            return TomBERTDataset(records, tokenizer, args.image_dir, roi_boxes,
                                  num_img=args.num_imgs, num_roi=args.num_rois,
                                  sentence_len=args.max_seq_length)
        return EFCapDataset(records, tokenizer, caption_dict, num_img=args.num_imgs,
                            max_len=args.max_cap_length)

    # --- model & params -------------------------------------------------
    # the ResNet's channels: 2048 at ResNet-152's 64 filters
    feat_dim = rcfg.num_filters * 2 ** (len(rcfg.stage_sizes) - 1) * 4
    model = build_baseline(args.model, text_cfg, feat_dim, device=device)
    init_weights(model, torch.Generator(device).manual_seed(args.seed),
                 text_cfg.initializer_range)
    common.import_text_params(model, args.pretrained_hf_model, logger, cell=model.roberta)
    visual = None
    if uses_visual:
        visual = VisualFeatures(rcfg, device=device)
        init_weights(visual, torch.Generator(device).manual_seed(args.seed + 1))
        common.import_resnet_params(visual, args.resnet_weights, logger)
    if model_hook is not None:
        model_hook(model, visual)
    for module in (model, visual):  # every rank starts from rank 0's weights
        if module is not None:
            mesh.replicate(module)

    # --- optimizer: one AdamW, no head rate ------------------------------
    train_ds = make_dataset("train") if args.do_train else None
    steps_per_epoch = (len(train_ds) // args.train_batch_size) if train_ds else 0
    num_train_steps = int(steps_per_epoch / args.gradient_accumulation_steps
                          * args.num_train_epochs)
    optimizer = AdamW(
        model,
        linear_warmup_schedule(args.learning_rate, int(num_train_steps * args.warmup_proportion),
                               num_train_steps),
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        accumulate_steps=args.gradient_accumulation_steps)
    # efcap has no CNN: an empty module stands in, so checkpoints keep one layout
    state = TrainState.create(model, visual if visual is not None else nn.Module(), optimizer)

    ckpt = CheckpointManager(args.output_dir)
    start_epoch, best_f1 = 0, 0.0
    if args.resume_from_checkpoint and ckpt.exists(args.resume_from_checkpoint):
        state, start_epoch, best_f1 = ckpt.restore(args.resume_from_checkpoint, state)
        logger.info(f"resumed from epoch {start_epoch} (step {state.step}), "
                    f"best F1 {best_f1:.4f}")

    train_step = make_baseline_train_step(state, host_id)
    eval_step = make_baseline_eval_step(model, visual)

    def run_eval(dataset):
        loader = DataLoader(dataset, args.eval_batch_size, num_workers=8)
        trues, preds, texts = [], [], []
        for batch in loader:
            texts.extend(batch.pop("text", []))
            b = batch["labels"].shape[0]
            p, _ = eval_step(to_device(pad_batch(batch, args.eval_batch_size), device))
            preds.append(p.cpu().numpy()[:b])
            trues.append(batch["labels"])
        return np.concatenate(trues), np.concatenate(preds), texts

    result: dict = {}
    if args.do_train:
        dev_ds = make_dataset("dev") if args.do_eval else None
        loader = DataLoader(train_ds, args.train_batch_size, shuffle=True, seed=args.seed,
                            drop_last=True, num_workers=8, cache=True,
                            num_hosts=n_hosts, host_id=host_id)
        result["epochs"] = []
        for epoch in range(start_epoch, args.num_train_epochs):
            loader.set_epoch(epoch)
            meter, losses = common.EpochMeter(epoch, int(state.step)), []
            for batch in meter.batches(loader):
                metrics = train_step(to_device(batch, device), args.seed)
                meter.count(args.train_batch_size)
                if meter.steps % args.log_every == 0:
                    loss, rate = float(mesh.all_mean(metrics["loss"])), meter.rate()
                    losses.append(loss)
                    logger.info(f"epoch {epoch} step {meter.steps}: loss {loss:.4f}  "
                                f"{rate:.2f} samples/s")
                    writer.write(int(state.step), loss=loss, samples_per_s=rate, epoch=epoch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # the epoch's last step has ended
            result["epochs"].append(meter.stop(losses=losses))
            meter.write(writer, int(state.step))
            if args.do_eval and dev_ds is not None:
                trues, preds, _ = run_eval(dev_ds)
                f1 = aspect_report(trues, preds)["average"]["f1"]
                logger.info(f"epoch {epoch} dev macro-F1 {f1:.4f}")
                writer.write(int(state.step), dev_f1=f1, epoch=epoch)
                if f1 > best_f1:
                    best_f1 = f1
                    if is_main:
                        ckpt.save("best", state, epoch + 1, best_f1)
                        ckpt.copy("best", "last")  # identical payload
                    mesh.barrier()
                    continue
            if is_main:
                ckpt.save("last", state, epoch + 1, best_f1)
            mesh.barrier()
        ckpt.finalize()
        result["best_dev_f1"] = best_f1

    if args.do_test:
        if ckpt.exists("best"):
            state = ckpt.restore_params_only("best", state)
        trues, preds, texts = run_eval(make_dataset("test"))
        report = aspect_report(trues, preds)
        result["test"] = report
        if is_main:
            write_test_reports(args.output_dir, report, texts, trues, preds,
                               results_filename=f"test_results_{args.model}.txt")
        mesh.barrier()
        logger.info(f"test macro-F1 {report['average']['f1']:.4f}")
    return result


if __name__ == "__main__":
    main()
