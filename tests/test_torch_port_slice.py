"""The port's serving slice against the JAX package's, end to end.

JAX `make_finetune_eval_step` (with its Pallas attention kernel in
interpret mode) and the port's `make_finetune_eval_step` run the same
loader-shaped batch: packed pixel frames with empty slots, padded token
views, all six aspects.  Also: the port's package imports no JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.ops.image_prep import pack_pixels_u8 as jax_pack
from macsa_tpu.train.steps import make_finetune_eval_step as jax_eval_step
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.ops.image_prep import pack_pixels_u8
from macsa_tpu_torch.train import jax_import
from macsa_tpu_torch.train.steps import make_finetune_eval_step
from test_torch_port_models import jinit, randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, A, L, IMG, VOCAB = 2, 6, 40, 64, 64
# L >= 32 so the text encoder's attention takes the kernel path on both sides
KW = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=128,
          max_text_len=L, box_heads=8)
RESNET_KW = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="float32")
SLICE_MODULES = ("config", "ops.cuda_lib", "ops.image_prep", "ops.fused_attention",
                 "ops.box_attention", "ops.fused_resnet", "models.layers",
                 "models.text_encoder", "models.box_attention", "models.resnet",
                 "models.fused_backbone", "models.fcmf", "train.optim", "train.state",
                 "train.steps", "train.jax_import", "native", "utils.logging",
                 "data.text_preprocess", "data.png", "data.images", "data.tokenizer",
                 "data.vimacsa", "data.loader", "data.synth", "train.metrics", "train.common",
                 "train.feature_cache", "train.disk_feature_cache", "train.checkpoints",
                 "train.finetune", "models.attention", "models.decoder", "models.seq2seq",
                 "data.iaog", "tools.iaog_labels", "train.generation", "train.pretrain")


MODEL_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, fused_attention=True)
TEXT_KW = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=64, fused_attention=True)


def serving_batch(rng, num_imgs=2, num_roi=2, num_patches=4):
    """Loader-shaped numpy batch: pixels as uint8 frames + validity."""
    images = rng.integers(0, 256, size=(B, num_imgs, IMG, IMG, 3), dtype=np.uint8)
    rois = rng.integers(0, 256, size=(B, num_imgs, num_roi, IMG, IMG, 3), dtype=np.uint8)
    img_valid = np.ones((B, num_imgs), bool)
    roi_valid = np.ones((B, num_imgs, num_roi), bool)
    img_valid[1, 1] = False  # an unreadable image
    roi_valid[0, 1, 1] = False  # an empty ROI slot
    coors = rng.uniform(0, 1, size=(B, num_imgs, num_roi, 4)).astype(np.float32)
    coors[~roi_valid] = 0.0
    ids = rng.integers(2, VOCAB, size=(B, A, L)).astype(np.int32)
    attn = np.ones((B, A, L), np.int32)
    for b in range(B):
        for a in range(A):
            n = rng.integers(8, L + 1)
            ids[b, a, n:], attn[b, a, n:] = 1, 0  # pad id 1
    added = np.ones((B, A, L + num_patches), np.int32)
    added[1, :, 2] = 0  # a masked patch
    text = {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
            "attention_mask": attn, "added_mask": added, "roi_coors": coors}
    return images, img_valid, rois, roi_valid, text


def _torch_batch(images, img_valid, rois, roi_valid, text):
    batch = {k: torch.from_numpy(v) for k, v in text.items()}
    batch["images"] = torch.from_numpy(pack_pixels_u8(images, img_valid))
    batch["roi_images"] = torch.from_numpy(pack_pixels_u8(rois, roi_valid))
    return batch


def test_eval_step_matches_jax(rng):
    jcfg_ = jcfg.FCMFConfig(
        model=jcfg.ModelConfig(fused_attention_interpret=True, **MODEL_KW),
        text=jcfg.TextEncoderConfig(fused_attention_interpret=True, **TEXT_KW), **KW)
    model, visual = JFCMF(jcfg_), JVisual(jcfg.ResNetConfig(**RESNET_KW))
    images, img_valid, rois, roi_valid, text = serving_batch(rng)
    params = randomize(jinit(
        model, text["input_ids"][:, 0], np.zeros((B, 2, 4, 128), np.float32),
        np.zeros((B, 2, 2, 128), np.float32), text["roi_coors"], None,
        text["attention_mask"][:, 0], text["added_mask"][:, 0])["params"], rng)
    visual_params = randomize(jinit(visual, np.zeros((1, IMG, IMG, 3), np.float32)), rng)
    jbatch = {k: jnp.asarray(v) for k, v in text.items()}
    jbatch["images"] = jnp.asarray(jax_pack(images, img_valid))
    jbatch["roi_images"] = jnp.asarray(jax_pack(rois, roi_valid))
    want_preds, want_logits = jax_eval_step(model, visual)(params, visual_params, jbatch)

    port = TFCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                                 text=tcfg.TextEncoderConfig(**TEXT_KW), **KW))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    port_visual = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    port_visual.load_state_dict(
        jax_import.visual_state_dict_from_jax(visual_params["params"]), strict=True)
    preds, logits = make_finetune_eval_step(port, port_visual)(
        _torch_batch(images, img_valid, rois, roi_valid, text))

    assert logits.shape == (B, A, 4) and preds.shape == (B, A)
    assert np.ptp(np.asarray(want_logits), axis=(0, 1)).min() > 1e-3  # views differ
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))


def test_port_imports_no_jax():
    code = ("import sys\nimport macsa_tpu_torch\n"
            + "".join(f"import macsa_tpu_torch.{m}\n" for m in SLICE_MODULES)
            + "bad = sorted(m for m in sys.modules\n"
              "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'macsa_tpu'))\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

