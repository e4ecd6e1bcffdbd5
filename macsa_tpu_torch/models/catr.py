"""CATR image captioner in PyTorch.

Counterpart of `macsa_tpu/models/catr.py` (reference:
EF-CapTrRoBERTa/Caption_Generation/generate_captions_vi.py:129-130 loads the
torch-hub `saahiluppal/catr` v3; :50-71 decode greedily).  CATR is a
DETR-style captioner: ResNet backbone -> 1x1 projection to d = 256 -> sine
2-D position embedding -> transformer encoder over the flattened feature
grid -> transformer decoder over BERT-tokenized caption prefixes -> 3-layer
MLP head to the BERT vocabulary (30522).

The module carries the hub checkpoint's own state-dict names, so a hub
`.pth` loads with `load_state_dict(strict=True)`: the backbone under
`backbone.0.body.*` in torchvision layout (the port's `ResNet`, in f32),
`input_proj` as the 1x1 conv it is there, `transformer.{encoder,decoder}.
layers.N.*` with torch `nn.MultiheadAttention`'s packed projections,
`transformer.embeddings.*`, `mlp.layers.N.*`.  `infer_catr_config` reads
the architecture off those names and shapes.

As in JAX, `greedy_decode` encodes the images once and then runs
decoder-only steps over a static [B, max_len] token buffer, each over the
whole prefix (no cache, as the JAX program has none), until every row has
emitted SEP: one host read a step.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.config import ResNetConfig
from macsa_tpu_torch.models.resnet import ResNet


@dataclasses.dataclass(frozen=True)
class CATRConfig:
    """CATR v3 architecture constants (torch-hub `saahiluppal/catr`)."""

    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    vocab_size: int = 30522          # bert-base-uncased
    max_position_embeddings: int = 128
    layer_norm_eps: float = 1e-12    # DecoderEmbeddings LN
    pre_norm: bool = True            # DETR normalize_before
    mlp_hidden: int = 512
    backbone_stages: Tuple[int, ...] = (3, 4, 23, 3)  # ResNet-101
    backbone_channels: int = 2048
    start_token: int = 101           # [CLS]
    end_token: int = 102             # [SEP]
    pad_token: int = 0


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 128,
                            temperature: float = 10000.0, device=None) -> torch.Tensor:
    """DETR PositionEmbeddingSine (normalize=True, scale=2*pi), no padding:
    [h*w, 2*num_pos_feats], the y part then the x part."""
    eps, scale = 1e-6, 2 * math.pi
    f32 = dict(dtype=torch.float32, device=device)
    y = (torch.arange(1, h + 1, **f32)[:, None] / (h + eps) * scale).expand(h, w)
    x = (torch.arange(1, w + 1, **f32)[None, :] / (w + eps) * scale).expand(h, w)
    dim_t = temperature ** (2 * torch.div(torch.arange(num_pos_feats, **f32), 2,
                                          rounding_mode="floor") / num_pos_feats)

    def interleave(p):  # sin of the even features, cos of the odd, pairwise
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).reshape(h, w, num_pos_feats)

    return torch.cat([interleave(y[..., None] / dim_t), interleave(x[..., None] / dim_t)],
                     dim=-1).reshape(h * w, -1)


class TorchMHA(nn.Module):
    """torch `nn.MultiheadAttention`'s parameters (packed `in_proj_weight`
    / `in_proj_bias`, `out_proj`) with the JAX model's rounding points: the
    score divided by sqrt(hd) after the product, an additive mask, softmax
    in f32."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q [B, Tq, D], k/v [B, Tk, D], mask additive [*, Tq, Tk] or None."""
        d, hd = self.dim, self.dim // self.heads
        w, b = self.in_proj_weight, self.in_proj_bias

        def proj(x, i):
            y = F.linear(x, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
            return y.reshape(x.shape[:-1] + (self.heads, hd))

        scores = torch.einsum("bqhd,bkhd->bhqk", proj(q, 0), proj(k, 1)) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask.to(scores.dtype)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", attn, proj(v, 2)).reshape(q.shape[:-1] + (d,))
        return self.out_proj(ctx)


class EncoderLayer(nn.Module):
    """DETR TransformerEncoderLayer (ReLU FFN; pre- or post-norm)."""

    def __init__(self, cfg: CATRConfig, device=None):
        super().__init__()
        self.pre_norm = cfg.pre_norm
        self.self_attn = TorchMHA(cfg.hidden_dim, cfg.nheads, device=device)
        self.linear1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward, device=device)
        self.linear2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim, device=device)
        self.norm1 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(cfg.hidden_dim, eps=1e-5, device=device)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        ffn = lambda x: self.linear2(F.relu(self.linear1(x)))
        if self.pre_norm:
            s2 = self.norm1(src)
            src = src + self.self_attn(s2 + pos, s2 + pos, s2)
            return src + ffn(self.norm2(src))
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + ffn(src))


class DecoderLayer(nn.Module):
    """DETR TransformerDecoderLayer: causal self-attention, cross-attention
    onto the image memory, FFN."""

    def __init__(self, cfg: CATRConfig, device=None):
        super().__init__()
        self.pre_norm = cfg.pre_norm
        self.self_attn = TorchMHA(cfg.hidden_dim, cfg.nheads, device=device)
        self.multihead_attn = TorchMHA(cfg.hidden_dim, cfg.nheads, device=device)
        self.linear1 = nn.Linear(cfg.hidden_dim, cfg.dim_feedforward, device=device)
        self.linear2 = nn.Linear(cfg.dim_feedforward, cfg.hidden_dim, device=device)
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", nn.LayerNorm(cfg.hidden_dim, eps=1e-5, device=device))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, query_pos: torch.Tensor,
                pos: torch.Tensor, tgt_mask: torch.Tensor) -> torch.Tensor:
        ffn = lambda x: self.linear2(F.relu(self.linear1(x)))
        if self.pre_norm:
            t2 = self.norm1(tgt)
            tgt = tgt + self.self_attn(t2 + query_pos, t2 + query_pos, t2, tgt_mask)
            t2 = self.norm2(tgt)
            tgt = tgt + self.multihead_attn(t2 + query_pos, memory + pos, memory)
            return tgt + ffn(self.norm3(tgt))
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt, tgt_mask))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + ffn(tgt))


class _Stack(nn.Module):
    """`transformer.encoder` / `transformer.decoder`: `layers.N` and a final
    `norm` where the checkpoint has one."""

    def __init__(self, layers: list, norm: Optional[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class CATR(nn.Module):
    """The captioner.  `encode(images)` -> (memory, pos);
    `decode_logits(memory, pos, tokens)` -> [B, T, V].  Images: [B, H, W, 3]
    float, ImageNet-normalized, any (H, W)."""

    def __init__(self, cfg: CATRConfig = CATRConfig(), device=None):
        super().__init__()
        self.cfg = c = cfg
        body = ResNet(ResNetConfig(stage_sizes=tuple(c.backbone_stages), dtype="float32"),
                      device=device)
        self.backbone = nn.ModuleList([nn.ModuleDict({"body": body})])
        self.input_proj = nn.Conv2d(c.backbone_channels, c.hidden_dim, 1, device=device)
        self.transformer = nn.Module()
        self.transformer.encoder = _Stack(
            [EncoderLayer(c, device=device) for _ in range(c.enc_layers)],
            nn.LayerNorm(c.hidden_dim, eps=1e-5, device=device) if c.pre_norm else None)
        self.transformer.decoder = _Stack(
            [DecoderLayer(c, device=device) for _ in range(c.dec_layers)],
            nn.LayerNorm(c.hidden_dim, eps=1e-5, device=device))
        self.transformer.embeddings = nn.Module()
        emb = self.transformer.embeddings
        emb.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_dim, device=device)
        emb.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_dim,
                                               device=device)
        emb.LayerNorm = nn.LayerNorm(c.hidden_dim, eps=c.layer_norm_eps, device=device)
        self.mlp = nn.Module()
        self.mlp.layers = nn.ModuleList(
            nn.Linear(i, o, device=device) for i, o in
            ((c.hidden_dim, c.mlp_hidden), (c.mlp_hidden, c.mlp_hidden),
             (c.mlp_hidden, c.vocab_size)))

    def encode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, 3] -> (memory [B, hw, D], pos [hw, D])."""
        feat = self.backbone[0]["body"](images.permute(0, 3, 1, 2))  # [B, 2048, h, w]
        b, _, h, w = feat.shape
        src = self.input_proj(feat.float()).flatten(2).transpose(1, 2)  # (h, w) row-major
        pos = sine_position_embedding(h, w, self.cfg.hidden_dim // 2, device=images.device)
        x = src
        for layer in self.transformer.encoder.layers:
            x = layer(x, pos)
        if self.transformer.encoder.norm is not None:
            x = self.transformer.encoder.norm(x)
        return x, pos

    def decode_hidden(self, memory: torch.Tensor, pos: torch.Tensor, tokens: torch.Tensor,
                      pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T] -> the decoder's normalized output [B, T, D]; the
        causal mask always, `pad_mask` [B, T] (True = masked) as the
        reference's tgt_key_padding_mask."""
        emb = self.transformer.embeddings
        t = tokens.shape[1]
        qpos = emb.position_embeddings(torch.arange(t, device=tokens.device))
        x = emb.LayerNorm(emb.word_embeddings(tokens) + qpos[None])
        causal = torch.zeros(t, t, device=tokens.device).masked_fill(
            ~torch.ones(t, t, dtype=torch.bool, device=tokens.device).tril(), -1e9)[None, None]
        if pad_mask is not None:
            causal = causal + torch.where(pad_mask, -1e9, 0.0)[:, None, None, :]
        for layer in self.transformer.decoder.layers:
            x = layer(x, memory, qpos[None], pos, causal)
        return self.transformer.decoder.norm(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP head to the vocabulary, position by position."""
        first, second, last = self.mlp.layers
        return last(F.relu(second(F.relu(first(x)))))

    def decode_logits(self, memory: torch.Tensor, pos: torch.Tensor, tokens: torch.Tensor,
                      pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, T] int -> logits [B, T, V] (teacher forcing / prefix)."""
        return self.head(self.decode_hidden(memory, pos, tokens, pad_mask))

    def forward(self, images: torch.Tensor, tokens: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        memory, pos = self.encode(images)
        return self.decode_logits(memory, pos, tokens, pad_mask)


@torch.inference_mode()
def greedy_decode(model: CATR, images: torch.Tensor, max_len: Optional[int] = None
                  ) -> torch.Tensor:
    """Batched greedy captioning -> token ids [B, max_len], starting with
    CLS; everything after a row's first SEP is PAD.  Encodes once; each
    step runs the decoder over the whole prefix and the head on the step's
    position alone; the loop ends when every row has emitted SEP."""
    c = model.cfg
    max_len = max_len or c.max_position_embeddings
    memory, pos = model.encode(images)
    b = images.shape[0]
    tokens = torch.full((b, max_len), c.pad_token, dtype=torch.long, device=images.device)
    tokens[:, 0] = c.start_token
    finished = torch.zeros(b, dtype=torch.bool, device=images.device)
    for i in range(max_len - 1):
        if bool(finished.all()):  # the step's one read on the host
            break
        hidden = model.decode_hidden(memory, pos, tokens)[:, i]
        nxt = model.head(hidden).argmax(-1)
        nxt = torch.where(finished, c.pad_token, nxt)
        tokens[:, i + 1] = nxt
        finished |= nxt == c.end_token
    return tokens


def infer_catr_config(sd: Dict[str, Any], nheads: int = 8) -> CATRConfig:
    """The architecture of a CATR state dict, read off its keys and shapes.
    `nheads` cannot be read (the packed in_proj is [3d, d] for any count):
    CATR's 8 by default."""
    d = sd["input_proj.weight"].shape[0]
    vocab = sd["transformer.embeddings.word_embeddings.weight"].shape[0]
    maxpos = sd["transformer.embeddings.position_embeddings.weight"].shape[0]
    ffn = sd["transformer.encoder.layers.0.linear1.weight"].shape[0]
    mlp_hidden = sd["mlp.layers.0.weight"].shape[0]

    def count(pattern: str) -> int:
        return 1 + max(int(m.group(1)) for k in sd if (m := re.match(pattern, k)))

    stages = tuple(count(rf"backbone\.0\.body\.layer{s}\.(\d+)\.") for s in range(1, 5))
    return CATRConfig(hidden_dim=d, nheads=nheads, vocab_size=vocab,
                      max_position_embeddings=maxpos, dim_feedforward=ffn,
                      mlp_hidden=mlp_hidden,
                      enc_layers=count(r"transformer\.encoder\.layers\.(\d+)\."),
                      dec_layers=count(r"transformer\.decoder\.layers\.(\d+)\."),
                      pre_norm="transformer.encoder.norm.weight" in sd,
                      backbone_stages=stages)


@torch.no_grad()
def random_state_dict(cfg: CATRConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A seeded CATR state dict under the hub's names, on the generator's
    device: weights at 1/sqrt(fan_in), embeddings at 1, biases around 0,
    norm scales and BatchNorm statistics around 1 (a captioner that
    computes something, for tests and the card's smoke run)."""
    sd = {}
    dev = generator.device
    for name, t in CATR(cfg, device="meta").state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("running_var",)) or (name.endswith("weight") and len(shape) == 1):
            v = torch.rand(shape, generator=generator, device=dev) + 0.5
        elif name.endswith(("bias", "running_mean", "in_proj_bias")):
            v = torch.randn(shape, generator=generator, device=dev) * 0.1
        elif "embeddings" in name:
            v = torch.randn(shape, generator=generator, device=dev)
        else:
            fan_in = math.prod(shape[1:])
            v = torch.randn(shape, generator=generator, device=dev) / math.sqrt(fan_in)
        sd[name] = v
    return sd
