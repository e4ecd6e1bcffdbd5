"""Phase-1 IAOG pretraining driver (FCMF seq2seq), on PyTorch.

Counterpart of `macsa_tpu/train/pretrain.py` (reference driver:
run_pretraining_fcmf.py): the same flags, IAOG label preprocessing
(normalize sentiment words, :139-168), AdamW (weight decay 1e-5) + linear
warmup, CE(ignore -100) over decoder logits, periodic debug decoding
(:340-372), `best` by mean epoch loss and `last` checkpoints, and an eval
harness with greedy/beam generation (the reference's is commented out,
:376-452 — here it is live).

What differs from the JAX driver:
* `--device` (default `cuda`): the card the run is on.  Without a CUDA
  device the default raises; only `--device cpu` runs on the CPU.
* `--fused_attention auto|on` means the hand-written attention kernel (on
  the card), `off` the plain path; `on` with `--device cpu` raises.
* checkpoints are torch files (`best.pt`, `last.pt`), which
  `finetune.py --pretrained_iaog_path <output_dir>` reads for the encoder
  transfer.
* `--prng` and `--scan_decoder` are accepted and ignored: the first picks a
  JAX PRNG (dropout here is drawn from (seed, step) by torch generators),
  the second a layout of the JAX program (the blocks run unrolled here).
* nothing on a step's path waits on the device: the loss is read every
  `--log_every` steps and at the epoch's end.
* one process on one card: `--mp > 1` is refused, and so is `--use_mde`
  with `alpha < 1`, with the ROADMAP item that will lift each.

Run: python -m macsa_tpu_torch.train.pretrain --do_train --do_eval ...
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional

import numpy as np
import torch

from macsa_tpu_torch.config import DecoderConfig, FCMFConfig, ModelConfig, ResNetConfig
from macsa_tpu_torch.data.iaog import IAOGDataset
from macsa_tpu_torch.data.loader import DataLoader
from macsa_tpu_torch.data.text_preprocess import TextNormalize
from macsa_tpu_torch.data.tokenizer import load_tokenizer
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.models.seq2seq import FCMFSeq2Seq
from macsa_tpu_torch.train import common
from macsa_tpu_torch.train.checkpoints import CheckpointManager
from macsa_tpu_torch.train.common import resolve_device, resolve_fused_attention, to_device
from macsa_tpu_torch.train.feature_cache import FeatureCacheFeeder
from macsa_tpu_torch.train.generation import (decode_text, evaluate_generation,
                                              special_token_ids)
from macsa_tpu_torch.train.optim import AdamW, linear_warmup_schedule
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import make_pretrain_train_step, visual_features
from macsa_tpu_torch.utils.logging import MetricWriter, setup_logging


def build_argparser() -> argparse.ArgumentParser:
    """Flag surface mirroring run_pretraining_fcmf.py:45-84 and
    `macsa_tpu.train.pretrain.build_argparser`, plus `--device`."""
    p = argparse.ArgumentParser()
    p.add_argument("--pretrained_data_dir", type=str, required=True,
                   help="dir with train_with_iaog.json / dev_with_iaog.json")
    p.add_argument("--data_dir", type=str, default=None,
                   help="dir with roi_data.csv + label JSONs (defaults to "
                        "pretrained_data_dir)")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--pretrained_hf_model", type=str, default="uitnlp/visobert")
    p.add_argument("--resnet_weights", type=str, default=None,
                   help="torchvision resnet152 state-dict file")
    p.add_argument("--num_imgs", type=int, default=7)
    p.add_argument("--num_rois", type=int, default=4)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--max_seq_length", type=int, default=170)
    p.add_argument("--max_len_decoder", type=int, default=20)
    p.add_argument("--train_batch_size", type=int, default=16,
                   help="batch (default 16, the reference's); a training "
                        "hyperparameter, so raising it is the user's call")
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--num_train_epochs", type=int, default=20)
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
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bf16 activations; --no-bf16 computes in float32")
    p.add_argument("--fine_tune_cnn", action="store_true",
                   help="Phase 1 never trains the ResNet; as in the JAX driver "
                        "the flag only turns the feature cache off under "
                        "--cache_visual_features auto")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--checkpoint_every", type=int, default=1,
                   help="epochs between non-best `last` saves (best "
                        "improvements always checkpoint).  1 = the "
                        "reference's per-epoch cadence "
                        "(run_pretraining_fcmf.py:454-460); the final epoch "
                        "always saves.")
    p.add_argument("--cross_mask_mode", type=str, default="causal_quirk",
                   choices=["causal_quirk", "padding"])
    p.add_argument("--pixel_transfer", type=str, default="packed",
                   choices=["packed", "f32"],
                   help="host->device pixel encoding (see finetune.py): "
                        "packed int32 words (default) or the reference's "
                        "host-normalized float32")
    p.add_argument("--scan_decoder", type=str, default="on",
                   choices=["on", "off"],
                   help="accepted for the JAX driver's command lines and "
                        "ignored: it picks a layout of the JAX program; the "
                        "decoder blocks run unrolled here")
    p.add_argument("--vocab_chunk", type=int, default=0,
                   help="chunked-vocab CE: >0 goes over the weight-tied "
                        "output head in chunks of this many vocab rows "
                        "(online logsumexp; the [B,T,V] f32 logits are never "
                        "held; gradient-exact).  0 (default) keeps the "
                        "full-logits loss")
    p.add_argument("--use_mde", action="store_true", default=False,
                   help="Multimodal Denoising Encoder when alpha < 1 (not "
                        "ported yet; with alpha >= 1 the flag changes nothing)")
    p.add_argument("--resnet_stages", type=str, default="3,8,36,3")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel size (not ported yet; must be 1)")
    p.add_argument("--cache_visual_features", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="cache frozen-CNN visual features in device memory, "
                        "keyed by the ORIGINAL review index (IAOG samples from "
                        "the same review share images). auto = on unless "
                        "--fine_tune_cnn")
    p.add_argument("--feature_cache_dir", type=str, default=None,
                   help="cross-stage on-disk feature cache shared with the "
                        "finetune driver (train/disk_feature_cache.py; "
                        "content-addressed by image bytes + ROI boxes + "
                        "ResNet weights)")
    p.add_argument("--fused_attention", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="hand-written fused softmax+dropout+PV attention "
                        "kernel for the text-encoder blocks; auto = on for "
                        "a CUDA device")
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--debug_decode_every", type=int, default=10,
                   help="decode 2 samples every N steps (reference :340-372)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run.  The default raises "
                        "without a CUDA device; say cpu to run on the CPU")
    return p


def preprocess_iaog_records(records, normalizer=None):
    """Normalize the sentiment-word part of each 'word#Aspect' label
    (run_pretraining_fcmf.py:139-158)."""
    tn = normalizer or TextNormalize()
    for rec in records:
        labels = rec.get("iaog_labels")
        if not isinstance(labels, list):
            continue
        out = []
        for label in labels:
            if "#" not in label:
                out.append(label)
                continue
            word, aspect = label.split("#", 1)
            out.append(f"{common.normalize_comment(word.strip(), tn)}#{aspect.strip()}")
        rec["iaog_labels"] = out
    return records


def refuse_unported(args) -> None:
    """Flags of the JAX driver whose path is not ported yet."""
    if args.use_mde and args.alpha < 1.0:
        raise NotImplementedError(
            "--use_mde with alpha < 1: the Multimodal Denoising Encoder is not ported "
            "(ROADMAP queue 1, the rest of the surface)")
    if args.mp != 1:
        raise NotImplementedError(
            f"--mp {args.mp}: tensor parallelism is not ported (ROADMAP queue 1, tensor "
            "parallelism); the driver is one process on one card until data parallelism "
            "is ported too (ROADMAP queue 1, DDP)")


def main(argv: Optional[list] = None, *,
         config_hook: Optional[Callable] = None,
         model_hook: Optional[Callable] = None) -> dict:
    """Run the driver.  The two hooks are for tests only (the parity tests
    against the JAX package; the command line cannot reach them):
    `config_hook(cfg, dec_cfg, rcfg) -> (cfg, dec_cfg, rcfg)` edits the model
    configs built from the flags, `model_hook(model, visual)` runs after the
    weight import (to load carried-over parameters)."""
    args = build_argparser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    data_dir = args.data_dir or args.pretrained_data_dir
    logger = setup_logging(args.output_dir)
    writer = MetricWriter(args.output_dir)
    np.random.seed(args.seed)
    logger.info(f"--prng {args.prng}, --scan_decoder {args.scan_decoder}: ignored (choices of "
                "the JAX program; dropout is drawn from (seed, step) by torch generators, the "
                "decoder blocks run unrolled)")

    dtype = "bfloat16" if args.bf16 else "float32"
    fused = resolve_fused_attention(args.fused_attention, device)
    text_cfg = common.build_text_config(args.pretrained_hf_model, dtype, fused_attention=fused)
    tokenizer = load_tokenizer(args.pretrained_hf_model)
    vocab_size = len(tokenizer)
    cfg = FCMFConfig(model=ModelConfig(dtype=dtype, fused_attention=fused),
                     text=text_cfg,
                     num_imgs=args.num_imgs, num_roi=args.num_rois,
                     alpha=args.alpha, max_text_len=args.max_seq_length,
                     decoder_cross_mask_mode=args.cross_mask_mode,
                     use_mde=args.use_mde)
    dec_cfg = DecoderConfig(vocab_size=vocab_size,
                            hidden_size=cfg.model.hidden_size,
                            num_blocks=cfg.model.num_hidden_layers,
                            num_heads=cfg.model.num_attention_heads,
                            max_decode_len=args.max_len_decoder, dtype=dtype)
    rcfg = ResNetConfig(dtype=dtype, stage_sizes=tuple(
        int(s) for s in args.resnet_stages.split(",")))
    if config_hook is not None:
        cfg, dec_cfg, rcfg = config_hook(cfg, dec_cfg, rcfg)

    roi_boxes, dict_img, dict_roi = common.load_metadata(data_dir)

    def make_dataset(split: str) -> IAOGDataset:
        records = common.load_records(
            os.path.join(args.pretrained_data_dir, f"{split}_with_iaog.json"))
        records = preprocess_iaog_records(records)
        return IAOGDataset(records, tokenizer, args.image_dir, roi_boxes,
                           dict_img, dict_roi, num_img=args.num_imgs,
                           num_roi=args.num_rois,
                           max_text_len=args.max_seq_length,
                           num_patches=cfg.num_patches,
                           max_len_decoder=args.max_len_decoder,
                           pixel_mode=args.pixel_transfer)

    # --- model & params -------------------------------------------------
    model = FCMFSeq2Seq(cfg, dec_cfg, device=device)
    visual = VisualFeatures(rcfg, device=device)
    init_weights(model, torch.Generator(device).manual_seed(args.seed),
                 cfg.model.initializer_range)
    # the seed the fine-tune driver gives its ResNet: with one --seed and no
    # weight file both phases extract the same features (one disk cache)
    init_weights(visual, torch.Generator(device).manual_seed(args.seed + 1))
    # the HF backbone; the shared (tied) token table also comes from it,
    # resized to the tokenizer
    if common.import_text_params(model, args.pretrained_hf_model, logger,
                                 resize_vocab_to=vocab_size):
        logger.info(f"imported HF backbone weights (tied token table resized to {vocab_size})")
    common.import_resnet_params(visual, args.resnet_weights, logger)
    if model_hook is not None:
        model_hook(model, visual)

    # --- optimizer: single-rate AdamW (run_pretraining_fcmf.py:254-270) ---
    train_ds = make_dataset("train") if args.do_train else None
    steps_per_epoch = (len(train_ds) // args.train_batch_size) if train_ds else 0
    num_train_steps = int(steps_per_epoch / args.gradient_accumulation_steps
                          * args.num_train_epochs)
    optimizer = AdamW(
        model,
        linear_warmup_schedule(args.learning_rate,
                               int(num_train_steps * args.warmup_proportion),
                               num_train_steps),
        weight_decay=args.weight_decay, eps=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm,
        accumulate_steps=args.gradient_accumulation_steps)
    state = TrainState.create(model, visual, optimizer)

    ckpt = CheckpointManager(args.output_dir)
    start_epoch, best_loss = 0, float("inf")
    if args.resume_from_checkpoint and ckpt.exists(args.resume_from_checkpoint):
        state, start_epoch, neg_best = ckpt.restore(args.resume_from_checkpoint, state)
        best_loss = -neg_best
        logger.info(f"resumed from epoch {start_epoch} (step {state.step}), "
                    f"best loss {best_loss:.4f}")

    train_step = make_pretrain_train_step(state, vocab_chunk=args.vocab_chunk)

    # --- frozen-CNN visual feature cache, keyed by ORIGINAL review index
    # (IAOG expands each review into one sample per aspect — all of them
    # share the same images, so the cache dedupes across aspects too).
    use_feature_cache = (args.cache_visual_features == "on" or
                         (args.cache_visual_features == "auto"
                          and not args.fine_tune_cnn))
    feeder = None
    if use_feature_cache and train_ds is not None:
        # cross-stage on-disk feature cache (shared with finetune: the same
        # content-addressed keys, so Phase 2 reuses Phase 1's extraction)
        disk_cache, keys = None, None
        if args.feature_cache_dir:
            from macsa_tpu_torch.train.disk_feature_cache import DiskFeatureCache, record_key
            disk_cache = DiskFeatureCache(args.feature_cache_dir)
            cache_fp = common.resnet_fingerprint(args.resnet_weights, rcfg, args.seed)
            keys = [record_key(rec.get("list_img") or [], args.image_dir,
                               roi_boxes, args.num_imgs, args.num_rois, cache_fp)
                    for rec in train_ds.records]
        # built BEFORE the loader starts, so already-extracted reviews skip
        # host decoding from step 0
        feeder = FeatureCacheFeeder(visual, cfg, len(train_ds.records), device, "orig_idx",
                                    disk_cache=disk_cache, keys=keys, logger=logger,
                                    unit="reviews")

    # In-training debug decoding (run_pretraining_fcmf.py:340-372): every N
    # steps, greedy-decode 2 samples and log prediction vs label.
    bos_id, eos_id = special_token_ids(tokenizer)

    def debug_decode(sent: dict, texts) -> None:
        two = {k: v[:2] for k, v in sent.items()}
        with torch.inference_mode():
            grid, roi = visual_features(model, visual, two)
        seqs = model.greedy_decode(
            two["enc_input_ids"], grid, roi, two["roi_coors"], bos_id, eos_id,
            attention_mask=two["attention_mask"], added_attention_mask=two["added_mask"],
            max_len=args.max_len_decoder).cpu().numpy()
        dec_ids = two["dec_input_ids"].cpu().numpy()
        for j in range(seqs.shape[0]):
            pred = decode_text(tokenizer, seqs[j], eos_id)
            label = decode_text(tokenizer, dec_ids[j], tokenizer.pad_token_id)
            src = texts[j][:60] if texts else ""
            logger.info(f"  [debug] src='{src}' pred='{pred}' label='{label}'")

    result: dict = {}
    if args.do_train:
        # pixels required only until the feature cache owns the sample's
        # ORIGINAL review row (aspect-expanded samples share images)
        needs_pixels = None
        if feeder is not None:
            needs_pixels = lambda i: (  # noqa: E731
                feeder.needs_pixels(train_ds.samples[i]["original_idx"]))
        loader = DataLoader(train_ds, args.train_batch_size, shuffle=True,
                            seed=args.seed, drop_last=True, num_workers=8,
                            cache=True, needs_pixels=needs_pixels)
        result["epochs"] = []
        for epoch in range(start_epoch, args.num_train_epochs):
            loader.set_epoch(epoch)
            meter = common.EpochMeter(epoch, int(state.step))
            losses, step_losses = [], []
            for batch in meter.batches(loader):
                texts = batch.pop("text", None)
                batch.pop("target_aspect", None)
                sent = feeder(batch) if feeder is not None else to_device(batch, device)
                metrics = train_step(sent, args.seed)
                step_losses.append(metrics["loss"])
                meter.count(args.train_batch_size)
                i = meter.steps
                if i % args.log_every == 0:
                    loss, acc = float(metrics["loss"]), float(metrics["token_accuracy"])
                    losses.append(loss)
                    rate = meter.rate()
                    logger.info(f"epoch {epoch} step {i}: loss {loss:.4f} "
                                f"tok-acc {acc:.3f} {rate:.2f} samples/s")
                    writer.write(int(state.step), loss=loss, token_accuracy=acc,
                                 samples_per_s=rate, epoch=epoch)
                if args.debug_decode_every and i % args.debug_decode_every == 0:
                    debug_decode(sent, texts)
            # the epoch's one wait for the device: its steps' losses
            mean_loss = (float(torch.stack(step_losses).double().mean())
                         if step_losses else 0.0)
            result["epochs"].append(meter.stop(mean_loss=mean_loss, losses=losses))
            i = meter.steps
            logger.info(f"epoch {epoch} mean loss {mean_loss:.4f} ({i} steps)")
            meter.write(writer, int(state.step), epoch_mean_loss=mean_loss)
            if i > 0 and mean_loss < best_loss:
                best_loss = mean_loss
                ckpt.save("best", state, epoch + 1, -best_loss)
                ckpt.copy("best", "last")  # identical payload
            elif ((epoch + 1 - start_epoch) % max(args.checkpoint_every, 1) == 0
                  or epoch == int(args.num_train_epochs) - 1):
                ckpt.save("last", state, epoch + 1, -best_loss)
        ckpt.finalize()
        result["best_train_loss"] = best_loss

    if args.do_eval:
        dev_ds = make_dataset("dev")
        gen = evaluate_generation(model, visual, dev_ds, tokenizer, args.eval_batch_size,
                                  device, beam_size=args.beam_size,
                                  max_len=args.max_len_decoder, logger=logger)
        result["generation"] = gen
        logger.info(f"dev generation: {gen}")

    if feeder is not None and feeder.disk_cache is not None:
        feeder.disk_cache.flush()  # queued feature writes land before exit
    return result


if __name__ == "__main__":
    main()
