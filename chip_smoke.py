#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and fine-tune train step on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit (`nvcc`).  It builds the port's kernels from `macsa_tpu_torch/csrc`,
holds each kernel against its plain PyTorch version at the shapes of the
paths below (K2; K1's forward and backward with dropout on and off; K3,
the box attention, at the serving shape; K4, the 1x1 conv with its
frozen-BN epilogue, and K5, the whole identity bottleneck, at ResNet-152
stage 3 over 280 images), then, at the full width of the FCMF model
(ViSoBERT-sized 12-layer text encoder at L=170, ResNet-152 over 7 images
and 28 ROI crops per sample, batch 8, random weights from a seed):
* runs `make_finetune_eval_step` (the serving forward),
* runs the serving forward with the fused backbone runner
  (`models/fused_backbone.extract_features`, stage 3 through K5) feeding
  the FCMF forward with `use_pallas_box_attention=True` (K3), and holds
  its features and logits against the plain path's,
* runs `make_finetune_train_step` (dropout 0.1, AdamW with the defaults
  of `finetune.py`) for a few steps on one batch in f32 and bf16, after
  holding one step's loss and gradients through the kernels (K3's
  included) against the plain path's at dropout 0,
and checks that each path went through its kernels.  Each phase prints
its lines; any failure raises and the exit code is not 0.  The
second-to-last line lists the kernels as JSON; the last line is the run's
JSON verdict.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH, NUM_ASPECTS, ITERS, TRAIN_STEPS = 8, 6, 5, 10
# ResNet-152 stage 3 over one serving batch: 8 x (7 images + 28 ROI crops)
STAGE3_IMAGES, STAGE3_HW, STAGE3_C, STAGE3_F = BATCH * (7 + 28), 14, 1024, 256


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


def f32_ulp_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Every element of `got` within one float32 ulp of `want`."""
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=want.device)) - want.abs()
    return bool(((got - want).abs() <= ulp).all())


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
            ms = cuda_ms(lambda: kernel(x, dtype))
            plain_ms = cuda_ms(lambda: plain(x, dtype))
            report[(name, dtype)] = (err, ms, plain_ms)
            print(f"phase k2 {name} {str(dtype)[6:]} {tuple(x.shape)}: max_abs_err={err:.3g} "
                  f"(f32 <= 1 ulp, bf16 equal) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return report


def phase_k1(dev, fa):
    """K1 against its plain version at the text encoder's serving shape."""
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
            got = fa.fused_self_attention(qc, kc, vc, mask, h)
            want = fa.attention_reference(qc, kc, vc, mask, h)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= atol:
                raise AssertionError(f"K1 {dtype} mask {neg_name}: max abs err {err} > {atol}")
            ms = cuda_ms(lambda: fa.fused_self_attention(qc, kc, vc, mask, h))
            plain_ms = cuda_ms(lambda: fa.attention_reference(qc, kc, vc, mask, h))
            report[(neg_name, dtype)] = (err, ms, plain_ms)
            print(f"phase k1 {str(dtype)[6:]} mask {neg_name} [{b},{l},{h * d}] h={h}: "
                  f"max_abs_err={err:.3g} (atol {atol}) kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f}")
    return report


def phase_k1_bwd(dev, fa):
    """K1 forward with dropout and K1's backward against their plain
    versions (same seed, so the same mask) at the train step's shape."""
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
                out = fa.fused_self_attention(*leaves, mask, h, rate, seed)
                grads = torch.autograd.grad(out, leaves, gc, retain_graph=True)
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
                fwd_ms = cuda_ms(lambda: fa.fused_self_attention(qc, kc, vc, mask, h, rate,
                                                                 seed))
                fwd_plain = cuda_ms(lambda: fa.attention_reference(qc, kc, vc, mask, h, rate,
                                                                   seed))
                bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, gc,
                                                             retain_graph=True))
                bwd_plain = cuda_ms(lambda: fa.attention_backward_reference(
                    qc, kc, vc, mask, gc, h, rate, seed))
                report[(neg_name, dtype, rate)] = (abs_err, fwd_ms, fwd_plain, bwd_ms,
                                                   bwd_plain)
                print(f"phase k1_bwd {str(dtype)[6:]} rate {rate} mask {neg_name} "
                      f"[{b},{l},{h * d}] h={h}: rel_err "
                      + " ".join(f"{n}={e:.3g}" for n, e in rel_err.items())
                      + f" (tol {tol} of max|ref|); fwd kernel_ms={fwd_ms:.4f} "
                      f"plain_ms={fwd_plain:.4f}; bwd kernel_ms={bwd_ms:.4f} "
                      f"plain_ms={bwd_plain:.4f}")
    return report


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_k3(dev, ba):
    """K3 against its plain version at the serving shape, forward and
    backward (the backward is the plain analytic function itself)."""
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
        ms = cuda_ms(lambda: ba.fused_box_attention(qc, kc, vc, gc))
        plain_ms = cuda_ms(lambda: ba.box_attention_reference(qc, kc, vc, gc))
        report[dtype] = (err, ms, plain_ms)
        print(f"phase k3 {str(dtype)[6:]} [{bh},{n},{d}] gates {gc.eq(0).float().mean():.3f} "
              f"zero: max_abs_err={err:.3g} (atol {atol} + rtol {rtol}); backward rel err "
              f"{grad_err:.3g}, zero dgates at zero gates; kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}")
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
    after, then the comparisons and the timing."""
    g = torch.Generator(dev).manual_seed(10)
    m = STAGE3_IMAGES * STAGE3_HW * STAGE3_HW
    c, f = STAGE3_C, STAGE3_F
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
        report[(name, dtype)] = (err, ms, plain_ms)
        print(f"phase k4 {str(dtype)[6:]} {name}: max_abs_err={err:.3g} rel {rel:.3g} "
              f"(tol {tol} of max|ref|) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    print(f"phase k4 launches driving the {len(calls)} cases: {launches}")
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


def phase_k5(dev, layers, resnet, fused_backbone, fr):
    """K5 against its plain version on one identity bottleneck of ResNet-152
    stage 3 over 280 images, its weights taken from a port `Bottleneck`
    module (random weights and frozen-BN statistics), which also runs."""
    n, hw, c, f = STAGE3_IMAGES, STAGE3_HW, STAGE3_C, STAGE3_F
    g = torch.Generator(dev).manual_seed(11)
    x = torch.relu(torch.randn(n, hw, hw, c, device=dev, generator=g))  # NHWC
    # relative to max|ref|.  f32: summation order only.  bf16: the plain
    # version rounds the conv1 and conv3 products to bf16 where the kernel
    # keeps them in f32, and a1, a2 and the output round on both sides
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    report = {}
    with torch.no_grad():
        for dtype, tol in tolerance.items():
            block = resnet.Bottleneck(c, f, compute_dtype=dtype, device=dev)
            layers.init_weights(block, torch.Generator(dev).manual_seed(12))
            random_bn_(block, torch.Generator(dev).manual_seed(13))
            args = fused_backbone.block_args(block)
            x2 = x.to(dtype).reshape(-1, c)
            cast = [t.to(dtype) if i in (0, 3, 6) else t for i, t in enumerate(args)]
            got = fr.fused_bottleneck(x2, *args, n, hw, hw)
            want = fr.bottleneck_reference(x2, *cast, n, hw, hw)
            module_out = block(x2.reshape(n, hw, hw, c).permute(0, 3, 1, 2))
            torch.cuda.synchronize()
            err, rel = (got.float() - want.float()).abs().max().item(), rel_err(got, want)
            if not rel <= tol:
                raise AssertionError(f"K5 {dtype}: error {rel} of max|ref| > {tol}")
            module_rel = rel_err(got, module_out.permute(0, 2, 3, 1).reshape(-1, c))
            if dtype == torch.float32 and not module_rel <= tol:
                raise AssertionError(f"K5 f32 vs the Bottleneck module: {module_rel}")
            ms = cuda_ms(lambda: fr.fused_bottleneck(x2, *args, n, hw, hw), iters=3, warmup=1)
            plain_ms = cuda_ms(lambda: fr.bottleneck_reference(x2, *cast, n, hw, hw), iters=3,
                               warmup=1)
            x4 = x2.reshape(n, hw, hw, c).permute(0, 3, 1, 2)
            module_ms = cuda_ms(lambda: block(x4), iters=3, warmup=1)
            report[dtype] = (err, ms, plain_ms)
            print(f"phase k5 {str(dtype)[6:]} [{n * hw * hw},{c}] F={f} n={n} {hw}x{hw}: "
                  f"max_abs_err={err:.3g} rel {rel:.3g} (tol {tol} of max|ref|), vs the "
                  f"Bottleneck module rel {module_rel:.3g}; kernel_ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} module_ms={module_ms:.4f} (cuDNN convs)")
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


def phase_slice(dev, card, cuda_lib, config, layers, fcmf, resnet, steps, image_prep):
    """The serving forward at full width, through both kernels."""
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
    pairs = BATCH * cfg.num_imgs

    def drive(step):
        preds, logits = step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            preds, logits = step(batch)
        torch.cuda.synchronize()
        return preds, logits, (time.perf_counter() - t0) * 1e3 / ITERS

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    preds32, logits32, ms32 = drive(steps.make_finetune_eval_step(model32, visual32))
    preds16, logits16, ms16 = drive(steps.make_finetune_eval_step(model16, visual16))
    launches = dict(cuda_lib.launch_counts)
    forwards = 2 * (ITERS + 1)
    want = {"fused_self_attention": cfg.text.num_hidden_layers * forwards,
            "device_normalize": 2 * forwards}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for name, logits in (("f32", logits32), ("bf16", logits16)):
        if logits.shape != (BATCH, NUM_ASPECTS, cfg.num_labels) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{name} logits {tuple(logits.shape)} not finite/shaped")

    # the same weights on the plain path: attention without K1, pixels
    # normalized by K2's plain version (a float batch only casts)
    plain_batch = dict(batch)
    for key in ("images", "roi_images"):
        plain_batch[key] = image_prep.unpack_normalize_pixels_reference(
            batch[key], torch.float32)
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
          f"max_abs_err={err:.3g} (atol 1e-3, TF32 off), preds equal; "
          f"{ms32:.2f} ms/forward, {pairs * 1e3 / ms32:.1f} pairs/s on {card}")
    print(f"phase slice bf16: logits finite; max |bf16 - f32| = {bf16_gap:.3g}, "
          f"pred agreement {agree:.3f}; {ms16:.2f} ms/forward, "
          f"{pairs * 1e3 / ms16:.1f} pairs/s on {card}")
    print(f"phase slice launches over {forwards} forwards: {launches}")
    return launches


def phase_fused(dev, card, cuda_lib, config, layers, fcmf, resnet, steps, image_prep,
                fused_backbone):
    """The serving forward at full width through the fused backbone runner
    (stage 3's identity blocks through K5) and the FCMF forward with
    `use_pallas_box_attention=True` (K3), against the plain path."""
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
    pairs = BATCH * cfg.num_imgs
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

    def drive(step):
        preds, logits = step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            preds, logits = step(batch)
        torch.cuda.synchronize()
        return preds, logits, (time.perf_counter() - t0) * 1e3 / ITERS

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    preds32, logits32, ms32 = drive(fused_step(model32, visual32))
    preds16, logits16, ms16 = drive(fused_step(model16, visual16))
    launches = dict(cuda_lib.launch_counts)
    forwards = 2 * (ITERS + 1)
    identity_blocks = visual32.config.stage_sizes[2] - 1
    want = {"fused_bottleneck": identity_blocks * forwards, "box_attention": forwards,
            "fused_self_attention": cfg.text.num_hidden_layers * forwards,
            "device_normalize": 2 * forwards}
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

    # the features against the module's own grid/pooled heads, and the
    # backbone's time per pass over the 280 images, fused and plain
    feats, times = {}, {}
    with torch.inference_mode():
        for name, visual in visuals.items():
            dt = visual.config.torch_dtype
            imgs = image_prep.device_normalize(batch["images"], dt)
            rois = image_prep.device_normalize(batch["roi_images"], dt)
            feats[name] = fused_backbone.extract_features(visual, imgs, rois)
            feats["plain_" + name] = (visual.grid_features(imgs), visual.pooled_features(rois))
            times[name] = (
                cuda_ms(lambda: fused_backbone.extract_features(visual, imgs, rois),
                        iters=3, warmup=1),
                cuda_ms(lambda: (visual.grid_features(imgs), visual.pooled_features(rois)),
                        iters=3, warmup=1))
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
          f"max_abs_err={err:.3g} (atol 1e-3, TF32 off), preds equal; {ms32:.2f} ms/forward, "
          f"{pairs * 1e3 / ms32:.1f} pairs/s on {card}")
    print(f"phase fused bf16: logits finite; max |bf16 - f32| = {bf16_gap:.3g}, pred agreement "
          f"{agree:.3f}; {ms16:.2f} ms/forward, {pairs * 1e3 / ms16:.1f} pairs/s on {card}")
    for head, (f32_err, bf16_err, plain_bf16_err) in errs.items():
        print(f"phase fused {head} features vs the plain f32 heads (rel to max|ref|): fused f32 "
              f"{f32_err:.3g} (tol 1e-4), fused bf16 {bf16_err:.3g}, plain bf16 "
              f"{plain_bf16_err:.3g} (fused bf16 <= 2 x plain bf16)")
    for name, (fused_ms, plain_ms) in times.items():
        print(f"phase fused backbone {name} over {STAGE3_IMAGES} images at 224^2: fused "
              f"(stage 3 through K5) {fused_ms:.2f} ms/pass, plain {plain_ms:.2f} ms/pass on "
              f"{card}")
    print(f"phase fused launches over {forwards} forwards: {launches} ({identity_blocks} K5, "
          f"1 K3, {cfg.text.num_hidden_layers} K1, 2 K2 per forward)")
    return launches, times


def phase_train(dev, card, cuda_lib, config, layers, fcmf, resnet, steps, image_prep,
                optim, train_state):
    """The fine-tune train step at full width: a gradient check at dropout
    0 (kernels vs plain path, f32), then TRAIN_STEPS timed steps on one
    batch in f32 and in bf16 through the kernels."""
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
    pairs = BATCH * cfg.num_imgs

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
    # f32 with TF32 off: summation order through 12+3 layers and their
    # backward.  Each parameter within 1e-3 of its largest gradient, plus
    # 1e-6 of the largest gradient of the model: the key biases' exact
    # gradient is 0 (softmax is shift-invariant), so theirs is rounding
    # noise of the gradients around them on both paths
    plain_grads = dict(plain.named_parameters())
    scale = max(p.grad.abs().max().item() for p in plain_grads.values()
                if p.grad is not None)
    worst = ("", 0.0)
    for name, p in model.named_parameters():
        gp = plain_grads[name].grad
        if p.grad is None or gp is None:
            if (p.grad is None) != (gp is None):
                raise AssertionError(f"{name}: a gradient on one path only")
            continue
        tol = 1e-3 * gp.abs().max().item() + 1e-6 * scale
        ratio = (p.grad - gp).abs().max().item() / tol
        worst = max(worst, (name, ratio), key=lambda t: t[1])
    if not worst[1] <= 1.0:
        raise AssertionError(f"train gradients kernels vs plain: {worst[0]} at {worst[1]} "
                             f"of its tolerance")
    print(f"phase train grad check f32 dropout 0 (K1, K3 and their backward): loss "
          f"{loss_k.item():.6f} kernels vs "
          f"plain {loss_p.item():.6f} (|diff| {loss_err:.3g}, tol 1e-5); every gradient "
          f"within 1e-3 of its max + 1e-6 of the largest ({scale:.3g}); worst {worst[0]} "
          f"at {worst[1]:.3g} of its tolerance")
    del plain, plain_batch, loss_k, loss_p, plain_grads
    model.zero_grad(set_to_none=True)

    def trainer(dtype: str):
        _, m, v = build(dtype, True, 0.1)  # the reference's dropout rates
        m.load_state_dict(weights, strict=True)
        v.load_state_dict(visual.state_dict(), strict=True)
        # finetune.py's defaults: 7e-5 encoder / 7e-4 head, wd 0.01, clip 1.0
        opt = optim.AdamW(m.named_parameters(), optim.linear_warmup_schedule(7e-5, 1, 1000),
                          weight_decay=0.01, max_grad_norm=1.0,
                          head_learning_rate=optim.linear_warmup_schedule(7e-4, 1, 1000))
        return steps.make_finetune_train_step(train_state.TrainState.create(m, v, opt))

    # the main path: every count from 0, read right after
    cuda_lib.reset_launch_counts()
    results = {}
    for dtype in ("float32", "bfloat16"):
        step = trainer(dtype)
        losses = [step(batch, seed=0)["loss"]]  # untimed: first launch of everything
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(step(batch, seed=0)["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        losses = [x.item() for x in losses]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {dtype}: losses {losses} not finite and falling")
        results[dtype] = (ms, losses)
        del step
        torch.cuda.empty_cache()
    launches = dict(cuda_lib.launch_counts)
    n_steps = 2 * (TRAIN_STEPS + 1)
    # no K3: with dropout active the box head takes its plain path, as in JAX
    want = {"fused_self_attention": cfg.text.num_hidden_layers * n_steps,
            "fused_self_attention_bwd": cfg.text.num_hidden_layers * n_steps,
            "device_normalize": 2 * n_steps}
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    for dtype, (ms, losses) in results.items():
        print(f"phase train {dtype}: {ms:.2f} ms/step, {pairs * 1e3 / ms:.1f} pairs/s over "
              f"{TRAIN_STEPS} steps after one untimed, on {card}; losses "
              + " ".join(f"{x:.4f}" for x in losses))
    print(f"phase train launches over {n_steps} steps: {launches} (12 K1 forward, "
          f"12 K1 backward, 2 K2, 0 K3 per step: dropout 0.1 takes the box head's plain "
          f"path)")
    return launches


def main() -> int:
    sys.path.insert(0, REPO)
    from macsa_tpu_torch import config
    from macsa_tpu_torch.models import fcmf, fused_backbone, layers, resnet
    from macsa_tpu_torch.ops import box_attention as ba
    from macsa_tpu_torch.ops import cuda_lib, image_prep
    from macsa_tpu_torch.ops import fused_attention as fa
    from macsa_tpu_torch.ops import fused_resnet as fr
    from macsa_tpu_torch.train import optim, steps
    from macsa_tpu_torch.train import state as train_state

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

    k2 = phase_k2(dev, image_prep)
    k1 = phase_k1(dev, fa)
    k1_bwd = phase_k1_bwd(dev, fa)
    k3 = phase_k3(dev, ba)
    k4, k4_launches = phase_k4(dev, cuda_lib, fr)
    torch.cuda.empty_cache()
    k5 = phase_k5(dev, layers, resnet, fused_backbone, fr)
    torch.cuda.empty_cache()
    launches = phase_slice(dev, smi, cuda_lib, config, layers, fcmf, resnet, steps,
                           image_prep)
    torch.cuda.empty_cache()  # the serving models are gone
    fused_launches, _ = phase_fused(dev, smi, cuda_lib, config, layers, fcmf, resnet, steps,
                                    image_prep, fused_backbone)
    torch.cuda.empty_cache()
    train_launches = phase_train(dev, smi, cuda_lib, config, layers, fcmf, resnet, steps,
                                 image_prep, optim, train_state)

    k1_err = max([e for e, _, _ in k1.values()]
                 + [errs["out"] for errs, *_ in k1_bwd.values()])
    k1b_err = max(max(errs[n] for n in ("dq", "dk", "dv")) for errs, *_ in k1_bwd.values())
    k2_err = max(e for e, _, _ in k2.values())
    _, k1_ms, k1_plain, k1b_ms, k1b_plain = k1_bwd[("-10000", torch.bfloat16, 0.1)]
    _, k2_ms, k2_plain = k2[("packed_rois", torch.bfloat16)]
    _, k3_ms, k3_plain = k3[torch.bfloat16]
    k4_err = max(e for e, _, _ in k4.values())
    _, k4_ms, k4_plain = next(v for (name, dt), v in k4.items()
                              if name.startswith("conv1") and dt == torch.bfloat16)
    _, k5_ms, k5_plain = k5[torch.bfloat16]
    source = "macsa_tpu_torch/csrc/fused_attention.cu"
    resnet_source = "macsa_tpu_torch/csrc/fused_resnet.cu"
    kernels = [
        {"name": "fused_self_attention", "route": "cuda", "source": source,
         "replaces": "macsa_tpu/ops/fused_attention.py:92",
         "launches": launches["fused_self_attention"]
         + fused_launches["fused_self_attention"] + train_launches["fused_self_attention"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "fused_self_attention_bwd", "route": "cuda", "source": source,
         "replaces": "macsa_tpu/ops/fused_attention.py:118",
         "launches": train_launches["fused_self_attention_bwd"],
         "max_abs_err": k1b_err, "ms": k1b_ms, "plain_ms": k1b_plain},
        {"name": "device_normalize", "route": "cuda",
         "source": "macsa_tpu_torch/csrc/image_prep.cu",
         "replaces": "macsa_tpu/ops/image_prep.py:36",
         "launches": launches["device_normalize"] + fused_launches["device_normalize"]
         + train_launches["device_normalize"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "box_attention", "route": "cuda",
         "source": "macsa_tpu_torch/csrc/box_attention.cu",
         "replaces": "macsa_tpu/ops/box_attention_kernel.py:37",
         "launches": fused_launches["box_attention"],
         "max_abs_err": max(e for e, _, _ in k3.values()), "ms": k3_ms, "plain_ms": k3_plain},
        {"name": "fused_matmul_bn_act", "route": "cuda", "source": resnet_source,
         "replaces": "tools_dev/fused_resnet_experiment.py:82",
         "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain},
        {"name": "fused_bottleneck", "route": "cuda", "source": resnet_source,
         "replaces": "tools_dev/fused_resnet_experiment.py:208",
         "launches": fused_launches["fused_bottleneck"],
         "max_abs_err": max(e for e, _, _ in k5.values()), "ms": k5_ms, "plain_ms": k5_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
