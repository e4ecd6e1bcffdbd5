"""Configuration dataclasses of the PyTorch port.

Field for field the counterparts of `macsa_tpu/config.py`, with the same
defaults, minus the fields that only steered the JAX programs (`scan_*`,
`remat_*`, `fused_attention_interpret`, the decoder's `scan_blocks` and
`scan_unroll`).  `fused_attention` selects the
hand-written attention kernel (`macsa_tpu_torch/ops/fused_attention.py`)
and is on by default here.
"""

from __future__ import annotations

import dataclasses

import torch

# Task constants (reference: vimacsa_dataset.py:16-23, run_multimodal_fcmf.py:89-90)
ASPECTS = ("Location", "Food", "Room", "Facilities", "Service", "Public_area")
POLARITIES = ("None", "Negative", "Neutral", "Positive")
NUM_POLARITIES = len(POLARITIES)


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Fusion-model architecture constants (fcmf_framework/mm_modeling.py:21-30)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    # compute dtype for activations; params are always float32
    dtype: str = "float32"
    # run text-encoder self-attention through the hand-written kernel
    fused_attention: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """XLM-R / ViSoBERT-compatible RoBERTa encoder configuration."""

    vocab_size: int = 15004  # uitnlp/visobert vocab
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    dtype: str = "float32"
    fused_attention: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class FCMFConfig:
    """FCMF encoder / classifier configuration
    (fcmf_framework/fcmf_pretraining.py:14-19, fcmf_multimodal.py:12-18)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    text: TextEncoderConfig = dataclasses.field(default_factory=TextEncoderConfig)
    num_imgs: int = 7
    num_roi: int = 4
    alpha: float = 0.7
    num_labels: int = NUM_POLARITIES
    num_patches: int = 49  # 7x7 ResNet grid (fcmf_framework/resnet_utils.py:24)
    visual_feat_dim: int = 2048  # ResNet-152 channel dim
    max_text_len: int = 170  # vimacsa_dataset.py:101
    box_heads: int = 8  # roi_modeling.py BoxMultiHeadedAttention(8, 768)
    # Reproduce the reference decoder's cross-attention mask semantics: a 2-D
    # mask passed as `memory_len` triggers a *causal tril* over (dec_len,
    # enc_len) regardless of its values (mm_modeling.py:115-118,607-610).
    # "causal_quirk" = faithful; "padding" = use the mask as a padding mask.
    decoder_cross_mask_mode: str = "causal_quirk"
    # run the box head's attention core through kernel K3
    # (ops/box_attention.py) when its dropout is not active; off by default
    # as in the JAX package
    use_pallas_box_attention: bool = False
    # Multimodal Denoising Encoder on the patch branch when alpha < 1
    # (models/mde.py); with alpha >= 1 the flag changes nothing, as in JAX
    use_mde: bool = False


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """IAOG transformer decoder configuration (mm_modeling.py:634-666).
    The blocks always run unrolled (`block{i}` modules)."""

    vocab_size: int = 15004
    hidden_size: int = 768
    num_blocks: int = 12
    num_heads: int = 12
    ffn_hidden: int = 768  # PositionWiseFFN(HIDDEN_SIZE, HIDDEN_SIZE) — mm_modeling.py:583
    dropout: float = 0.1
    max_position_embeddings: int = 512
    max_decode_len: int = 20  # --max_len_decoder default (run_pretraining_fcmf.py:61)
    dtype: str = "float32"
    # emulate the reference Attention's batch-size-dependent head<->weight
    # pairing (models/attention.py) — parity testing only
    emulate_reference_heads: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """ResNet-152 (torchvision-compatible) feature extractor config."""

    stage_sizes: tuple = (3, 8, 36, 3)  # ResNet-152
    num_filters: int = 64
    grid_size: int = 7  # att_size for grid features (resnet_utils.py:13)
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)
