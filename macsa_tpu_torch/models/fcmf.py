"""FCMF — Fine-grained Cross-Modal Fusion encoder and classifier, in PyTorch.

Counterpart of `macsa_tpu/models/fcmf.py` (reference:
fcmf_framework/fcmf_pretraining.py:14-141, fcmf_multimodal.py:12-51), with
the same restructuring as the JAX model:

* the image axis is folded into the batch (`repeat_interleave`), so one
  batched attention covers all images,
* the text->image cross-attention and the text+ROI `mm_attention` pass
  compute only the CLS query row, the only row their poolers read (exact:
  query rows never interact inside one layer),
* the ROI-branch mask reuses the text-position slice
  `added_attention_mask[:, :L+num_roi]`, a reference quirk kept as is,
* one `mm_attention` module serves both the text+ROI pass and the final
  [CLS | h_1..h_I | r_1..r_I] fusion, as in the reference,
* with `use_mde` and `alpha < 1` the Multimodal Denoising Encoder
  (`models/mde.py`) keeps `int(49 * alpha)` denoised patches of each image
  for the text->image cross-attention, unmasked, as in JAX,
* the classifier runs in f32.

Module names are the reference checkpoint's, so `state_dict()` keys are
the ones `macsa_tpu.train.torch_import.import_fcmf_classifier` reads.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from macsa_tpu_torch.config import (DeepseekV2Config, FCMFConfig, KimiLinearConfig,
                                    TextEncoderConfig)
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.models.box_attention import BoxMultiHeadedAttention
from macsa_tpu_torch.models.deepseek_v2 import DeepseekV2Encoder
from macsa_tpu_torch.models.kimi_linear import KimiLinearEncoder
from macsa_tpu_torch.models.mde import MultimodalDenoisingEncoder
from macsa_tpu_torch.models.text_encoder import TextEncoder
from macsa_tpu_torch.utils.logging import span


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[B, I, ...] -> [B*I, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


class FeatureExtractor(nn.Module):
    """The reference's text-backbone wrapper (mm_modeling.py:433-446), which
    holds the HF model as `cell`: hence the `encoder.bert.cell.*` keys.
    The backbone follows the config's type: RoBERTa (`TextEncoder`),
    DeepSeek-V2 (`DeepseekV2Encoder`) or Kimi Linear (`KimiLinearEncoder`),
    the last two with their projection into the fusion's width `out_dim`."""

    def __init__(self, config: Union[TextEncoderConfig, DeepseekV2Config, KimiLinearConfig],
                 device=None, embedding_table: Optional[nn.Parameter] = None,
                 out_dim: int = 768):
        super().__init__()
        llm = {DeepseekV2Config: DeepseekV2Encoder, KimiLinearConfig: KimiLinearEncoder}
        if type(config) in llm:
            if embedding_table is not None:
                raise ValueError(f"a {type(config).__name__} backbone shares no token table")
            self.cell = llm[type(config)](config, out_dim, device=device)
        else:
            self.cell = TextEncoder(config, device=device, embedding_table=embedding_table)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, rng=None):
        return self.cell(input_ids, token_type_ids, attention_mask, rng)


class FCMFEncoder(nn.Module):
    """`embedding_table`: the token table shared with the Phase-1 decoder
    (`models/seq2seq.py`); the classifier keeps a table of its own."""

    def __init__(self, config: FCMFConfig, device=None,
                 embedding_table: Optional[nn.Parameter] = None):
        super().__init__()
        self.config = config
        mc = config.model
        h, dt = mc.hidden_size, mc.torch_dtype
        self.bert = FeatureExtractor(config.text, device=device,
                                     embedding_table=embedding_table, out_dim=h)
        self.vismap2text = layers.Dense(config.visual_feat_dim, h, dt, device=device)
        self.roimap2text = layers.Dense(config.visual_feat_dim, h, dt, device=device)
        self.box_head = BoxMultiHeadedAttention(config.box_heads, h, dt,
                                                mc.attention_probs_dropout_prob,
                                                config.use_pallas_box_attention,
                                                device=device)
        self.text2img_attention = layers.BertCrossEncoder(mc, device=device)
        self.text2img_pooler = layers.TokenPooler(mc, device=device)
        self.text2roi_pooler = layers.TokenPooler(mc, device=device)
        self.mm_attention = layers.MultimodalEncoder(mc, device=device)
        # text-guided patch denoising, built only where the JAX model builds
        # it (fcmf_pretraining.py:267-287)
        self.mde = (MultimodalDenoisingEncoder(mc, config.alpha, device=device)
                    if config.use_mde and config.alpha < 1.0 else None)

    def forward(self,
                input_ids: torch.Tensor,          # [B, L]
                visual_embeds_att: torch.Tensor,  # [B, I, 49, 2048] grid features
                roi_embeds_att: torch.Tensor,     # [B, I, R, 2048] pooled ROI features
                roi_coors: torch.Tensor,          # [B, I, R, 4]
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                added_attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[layers.DropoutRng] = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.model.torch_dtype
        b, num_imgs = visual_embeds_att.shape[:2]

        # 1. text encoding
        with span("text_encoder"):
            sequence_output, _ = self.bert(input_ids, token_type_ids, attention_mask, rng)
        with span("fusion"):
            seq_len = sequence_output.shape[1]
            if added_attention_mask is None:
                added_attention_mask = torch.ones(b, seq_len + cfg.num_patches,
                                                  dtype=torch.int32, device=input_ids.device)
            text_rep = sequence_output.repeat_interleave(num_imgs, dim=0)  # [B*I, L, H]

            # A. image-guided cross attention, CLS query only (fcmf_pretraining.py:48-93)
            converted_img = self.vismap2text(_fold(visual_embeds_att).to(dt))  # [B*I, 49, H]
            if self.mde is not None:
                # K = int(49 * alpha) strong patches, all valid (fcmf_pretraining.py:272-287)
                converted_img = self.mde(text_rep, converted_img)
                img_mask = torch.ones(converted_img.shape[:2], dtype=torch.int32,
                                      device=converted_img.device)
            else:
                img_mask = added_attention_mask[:, :cfg.num_patches].repeat_interleave(num_imgs, 0)
            ext_img_mask = layers.extend_attention_mask(img_mask, dtype=dt)
            text2img = self.text2img_attention(text_rep[:, :1], converted_img, ext_img_mask, rng)
            all_h = self.text2img_pooler(text2img).reshape(b, num_imgs, -1)

            # B. geometric ROI-aware attention (fcmf_pretraining.py:95-124); the
            # mask slices text positions [:L+num_roi] (reference quirk)
            t2r_mask = added_attention_mask[:, :seq_len + cfg.num_roi]
            ext_t2r_mask = layers.extend_attention_mask(
                t2r_mask.repeat_interleave(num_imgs, 0), dtype=dt)
            converted_roi = self.roimap2text(_fold(roi_embeds_att).to(dt))  # [B*I, R, H]
            relative_roi = self.box_head(converted_roi, converted_roi, converted_roi,
                                         _fold(roi_coors), rng)
            text_roi = torch.cat([text_rep, relative_roi], dim=1)
            roi_encoded = self.mm_attention(text_roi, ext_t2r_mask, num_query_tokens=1, rng=rng)
            all_r = self.text2roi_pooler(roi_encoded).reshape(b, num_imgs, -1)

            # C. fusion [CLS | h_1..h_I | r_1..r_I] (fcmf_pretraining.py:126-141)
            fusion = torch.cat([sequence_output[:, :1], all_h, all_r], dim=1)
            comb_mask = added_attention_mask[:, :1 + 2 * num_imgs]
            ext_comb_mask = layers.extend_attention_mask(comb_mask, dtype=dt)
            return self.mm_attention(fusion, ext_comb_mask, rng=rng)


class FCMF(nn.Module):
    """Phase-2 classifier: FCMFEncoder -> first-token pool -> dropout ->
    Dense in f32 (fcmf_framework/fcmf_multimodal.py:39-51)."""

    def __init__(self, config: FCMFConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = FCMFEncoder(config, device=device)
        self.text_pooler = layers.TokenPooler(config.model, device=device)
        self.classifier = layers.Dense(config.model.hidden_size, config.num_labels,
                                       torch.float32, device=device)

    def forward(self, input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
                token_type_ids=None, attention_mask=None,
                added_attention_mask=None,
                rng: Optional[layers.DropoutRng] = None) -> torch.Tensor:
        """Logits [B, num_labels]; dropout is on when the module is in
        training mode and `rng` is given."""
        fused = self.encoder(input_ids, visual_embeds_att, roi_embeds_att, roi_coors,
                             token_type_ids, attention_mask, added_attention_mask, rng)
        cls = layers.dropout(self.text_pooler(fused), self.config.model.hidden_dropout_prob,
                             rng if self.training else None)
        return self.classifier(cls.float())
