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
from typing import Union

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
class DeepseekV2Config:
    """DeepSeek-V2 decoder used as FCMF's text backbone (`models/deepseek_v2.py`).

    The shape fields of deepseek-ai/DeepSeek-V2-Lite's `config.json` (its
    `rope_scaling` group spelled out as `rope_*` fields), plus the
    expert-parallel share this process holds: `ep_size` processes share
    each MoE layer's `n_routed_experts` experts, and rank `ep_rank` holds
    `experts_held` of them, `[ep_rank * n / ep_size, (ep_rank + 1) * n / ep_size)`.
    The router keeps its published width (all `n_routed_experts`).  What
    V2-Lite fixes (no q-LoRA, the softmax router's greedy top-k with its
    weights as they are, every layer after the dense ones a MoE layer)
    `from_hf` checks; the sigmoid router, renormalization, scaling and
    NoPE fields are `KimiLinearConfig.deepseek()`'s."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944  # the dense layers' SwiGLU width
    moe_intermediate_size: int = 1408  # one expert's width
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1  # leading dense layers; the rest are MoE
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    ep_size: int = 8
    ep_rank: int = 0
    dtype: str = "float32"
    # the router: "softmax" (DeepSeek-V2) or "sigmoid" (with a fixed
    # per-expert bias that only the choice reads); the weights of the
    # chosen experts renormalized to sum 1 or not, then times the scaling
    scoring_func: str = "softmax"
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    # latent attention without rotary positions (the 64-wide parts kept)
    mla_use_nope: bool = False

    def __post_init__(self):
        if self.n_routed_experts % self.ep_size or not 0 <= self.ep_rank < self.ep_size:
            raise ValueError(f"{self.n_routed_experts} experts over ep_size {self.ep_size}, "
                             f"rank {self.ep_rank}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> int:
        return self.n_routed_experts // self.ep_size

    @property
    def first_expert(self) -> int:
        return self.ep_rank * self.experts_held

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @classmethod
    def from_hf(cls, hf: dict, **overrides) -> "DeepseekV2Config":
        """From a `config.json` of `model_type` deepseek_v2; raises where it
        asks for what the module does not build."""
        built = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
                 "norm_topk_prob": False, "routed_scaling_factor": 1, "moe_layer_freq": 1,
                 "attention_bias": False, "hidden_act": "silu"}
        other = {k: hf[k] for k, v in built.items() if k in hf and hf[k] != v}
        rope = hf.get("rope_scaling") or {}
        if rope.get("type", "yarn") != "yarn":
            other["rope_scaling"] = rope
        if other:
            raise ValueError(f"not built: {other}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in hf.items() if k in fields}
        for key, field in (("factor", "rope_factor"),
                           ("original_max_position_embeddings", "rope_original_max_position"),
                           ("beta_fast", "rope_beta_fast"), ("beta_slow", "rope_beta_slow"),
                           ("mscale", "rope_mscale"), ("mscale_all_dim", "rope_mscale_all_dim")):
            if key in rope:
                kw[field] = rope[key]
        if not rope:
            kw["rope_factor"] = 1.0
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    """Kimi Linear used as FCMF's text backbone (`models/kimi_linear.py`).

    The shape fields of moonshotai/Kimi-Linear-48B-A3B-Instruct's
    `config.json` (its `linear_attn_config` group spelled out as `kda_*`
    fields), plus the expert-parallel share this process holds, as
    `DeepseekV2Config` has it: `ep_size` processes share each MoE layer's
    `num_experts`, and rank `ep_rank` holds `num_experts / ep_size` of them.
    Layer i (1-based, the config's numbering) is a KDA layer where it is in
    `kda_layers`, else a latent-attention layer without rotary positions.
    The latent attention and the MoE layers are `models/deepseek_v2.py`'s,
    built from `deepseek()`.  What the modules build (no q-LoRA, one expert
    group, the sigmoid router) `from_hf` checks."""

    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216  # the dense layer's SwiGLU width
    moe_intermediate_size: int = 1024  # one expert's width
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 32
    num_experts: int = 256
    num_shared_experts: int = 1
    num_experts_per_token: int = 8
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    kda_layers: tuple = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23,
                         25, 26)
    kda_num_heads: int = 32
    kda_head_dim: int = 128
    short_conv_kernel_size: int = 4
    ep_size: int = 32
    ep_rank: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        self.deepseek()  # the share's checks

    def is_kda(self, index: int) -> bool:
        """Layer `index` (0-based) is a KDA layer."""
        return index + 1 in self.kda_layers

    @property
    def torch_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    def deepseek(self) -> DeepseekV2Config:
        """The shapes `models/deepseek_v2.py`'s latent attention, MLPs and
        MoE layer read: NoPE attention at the softmax scale qk_head_dim^-1/2,
        the sigmoid router renormalized (or not) and scaled."""
        return DeepseekV2Config(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            moe_intermediate_size=self.moe_intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            first_k_dense_replace=self.first_k_dense_replace,
            num_attention_heads=self.num_attention_heads, n_routed_experts=self.num_experts,
            n_shared_experts=self.num_shared_experts,
            num_experts_per_tok=self.num_experts_per_token, kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim, qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim, rope_factor=1.0, rms_norm_eps=self.rms_norm_eps,
            ep_size=self.ep_size, ep_rank=self.ep_rank, dtype=self.dtype,
            scoring_func="sigmoid", norm_topk_prob=self.moe_renormalize,
            routed_scaling_factor=self.routed_scaling_factor, mla_use_nope=True)

    @classmethod
    def from_hf(cls, hf: dict, **overrides) -> "KimiLinearConfig":
        """From a `config.json` of `model_type` kimi_linear; raises where it
        asks for what the modules do not build."""
        built = {"q_lora_rank": None, "num_expert_group": 1, "topk_group": 1,
                 "moe_router_activation_func": "sigmoid", "moe_layer_freq": 1,
                 "mla_use_nope": True, "rope_scaling": None, "hidden_act": "silu",
                 "num_nextn_predict_layers": 0}
        other = {k: hf[k] for k, v in built.items() if k in hf and hf[k] != v}
        lin = hf.get("linear_attn_config") or {}
        kda = tuple(lin.get("kda_layers", ()))
        full = tuple(lin.get("full_attn_layers", ()))
        if sorted(kda + full) != list(range(1, hf["num_hidden_layers"] + 1)):
            other["linear_attn_config"] = lin
        if hf.get("num_key_value_heads", hf["num_attention_heads"]) != hf["num_attention_heads"]:
            other["num_key_value_heads"] = hf["num_key_value_heads"]
        if other:
            raise ValueError(f"not built: {other}")
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in hf.items() if k in fields}
        kw.update(kda_layers=kda, kda_num_heads=lin["num_heads"], kda_head_dim=lin["head_dim"],
                  short_conv_kernel_size=lin["short_conv_kernel_size"])
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class FCMFConfig:
    """FCMF encoder / classifier configuration
    (fcmf_framework/fcmf_pretraining.py:14-19, fcmf_multimodal.py:12-18)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    # the text backbone: RoBERTa (ViSoBERT, XLM-R), DeepSeek-V2 or Kimi Linear
    text: Union[TextEncoderConfig, DeepseekV2Config, KimiLinearConfig] = dataclasses.field(
        default_factory=TextEncoderConfig)
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
