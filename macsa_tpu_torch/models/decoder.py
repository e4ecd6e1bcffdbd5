"""IAOG transformer decoder with a preallocated KV cache, in PyTorch.

Counterpart of `macsa_tpu/models/decoder.py` (reference:
fcmf_framework/mm_modeling.py:558-666): position-wise FFN, AddNorm,
TransformerDecoderBlock (causal self-attention + cross-attention to the
fused encoder sequence), sinusoidal positional encoding, and the
`IAOGDecoder` whose output head is weight-tied to the token embedding
(mm_modeling.py:644-645).  Module names are the reference checkpoint's
(`embedding`, `dense`, `blks.block{i}.{attention1,addnorm1,attention2,
addnorm2,ffn,add_norm3}`), so `macsa_tpu.train.torch_import.
import_fcmf_seq2seq` reads a `state_dict()` of it.

Decode: the reference caches each block's *input* states by list concat
(`state[2][i]`, mm_modeling.py:588-591).  Here, as in the JAX package, the
cache is a preallocated [B, max_decode_len, H] buffer per block, written at
`step` and read under `lengths = step + 1`, so the shapes never change.
`step` is a Python int: a decode loop never reads a value back from the
device.

Cross-attention mask semantics (`cross_mask_mode`):
* "causal_quirk" (faithful default): the reference passes the 0/1 combined
  encoder mask as `memory_len`; being 2-D it triggers a causal tril over
  (dec_len, enc_len) regardless of values (mm_modeling.py:115-118,607-610),
  so decoder step t attends encoder tokens 0..t only.  Incremental decode
  keeps the train-consistent rule (`lengths = min(step + 1, enc_len)`).
* "padding": the combined mask is used as an encoder padding mask.

The blocks run unrolled; the JAX package's scanned layout is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from macsa_tpu_torch.config import DecoderConfig
from macsa_tpu_torch.models import layers
from macsa_tpu_torch.models.attention import PerHeadAttention

Cache = Dict[str, torch.Tensor]


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """P[pos, 2i] = sin(pos / 10000^(2i/dim)), P[pos, 2i+1] = cos(...)
    (mm_modeling.py:615-627), in f32."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    inv = torch.pow(10000.0, torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    x = pos / inv  # [max_len, dim/2]
    p = torch.zeros(max_len, dim, dtype=torch.float32, device=device)
    p[:, 0::2] = torch.sin(x)
    p[:, 1::2] = torch.cos(x)
    return p


class PositionWiseFFN(nn.Module):
    """dense1 -> gelu -> dense2 (mm_modeling.py:558-565)."""

    def __init__(self, hidden_size: int, ffn_hidden: int,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dense1 = layers.Dense(hidden_size, ffn_hidden, compute_dtype, device=device)
        self.dense2 = layers.Dense(ffn_hidden, hidden_size, compute_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense2(layers.gelu_erf(self.dense1(x)))


class AddNorm(nn.Module):
    """LN(dropout(Y) + X) (mm_modeling.py:566-573)."""

    def __init__(self, hidden_size: int, dropout_rate: float,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln = layers.LayerNormTF(hidden_size, 1e-12, compute_dtype, device=device)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                rng: Optional[layers.DropoutRng] = None) -> torch.Tensor:
        y = layers.dropout(y, self.dropout_rate, rng if self.training else None)
        return self.ln(y + x)


class TransformerDecoderBlock(nn.Module):
    """Causal self-attn + encoder cross-attn + FFN (mm_modeling.py:574-613)."""

    def __init__(self, config: DecoderConfig, cross_mask_mode: str = "causal_quirk",
                 device=None):
        super().__init__()
        if cross_mask_mode not in ("causal_quirk", "padding"):
            raise ValueError(f"invalid cross_mask_mode: {cross_mask_mode}")
        self.cross_mask_mode = cross_mask_mode
        h, dt = config.hidden_size, config.torch_dtype

        def attention():
            return PerHeadAttention(h, config.head_dim, config.num_heads, compute_dtype=dt,
                                    emulate_reference_heads=config.emulate_reference_heads,
                                    device=device)

        self.attention1 = attention()
        self.addnorm1 = AddNorm(h, config.dropout, dt, device=device)
        self.attention2 = attention()
        self.addnorm2 = AddNorm(h, config.dropout, dt, device=device)
        self.ffn = PositionWiseFFN(h, config.ffn_hidden, dt, device=device)
        self.add_norm3 = AddNorm(h, config.dropout, dt, device=device)

    def _cross(self, y: torch.Tensor, enc_outputs: torch.Tensor,
               enc_mask: Optional[torch.Tensor], step: Optional[int]) -> torch.Tensor:
        """Cross-attention with the configured mask semantics."""
        if self.cross_mask_mode == "causal_quirk":
            if step is None:  # teacher forcing: tril(q_len, enc_len)
                return self.attention2(enc_outputs, y, causal=True)
            # incremental: step t sees encoder tokens 0..t
            lengths = torch.full((y.shape[0],), min(step + 1, enc_outputs.shape[1]),
                                 dtype=torch.int32, device=y.device)
            return self.attention2(enc_outputs, y, lengths=lengths)
        if enc_mask is None:
            return self.attention2(enc_outputs, y)
        return self.attention2(enc_outputs, y, key_mask=enc_mask)

    def forward(self, x: torch.Tensor, enc_outputs: torch.Tensor,
                enc_mask: Optional[torch.Tensor],
                rng: Optional[layers.DropoutRng] = None,
                kv: Optional[torch.Tensor] = None,
                step: Optional[int] = None) -> torch.Tensor:
        """Teacher forcing when `kv` is None (x is [B, T, H]); otherwise one
        decode step: x is [B, 1, H] and is written into `kv`
        ([B, max_decode_len, H], this block's inputs so far) at `step`."""
        if kv is None:
            x2 = self.attention1(x, x, causal=True)
        else:
            kv[:, step] = x[:, 0].to(kv.dtype)
            lengths = torch.full((x.shape[0],), step + 1, dtype=torch.int32, device=x.device)
            x2 = self.attention1(kv, x, lengths=lengths)
        y = self.addnorm1(x, x2, rng)
        z = self.addnorm2(y, self._cross(y, enc_outputs, enc_mask, step), rng)
        return self.add_norm3(z, self.ffn(z), rng)


class TiedHead(nn.Module):
    """The vocabulary head `dense`: its weight is the token table (the same
    `nn.Parameter` object as the embedding's), its bias its own.  Runs in
    f32 whatever the decoder's compute dtype."""

    def __init__(self, table: nn.Parameter, device=None):
        super().__init__()
        self.weight = table
        self.bias = nn.Parameter(torch.empty(table.shape[0], device=device))

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.weight.float().T + self.bias


class IAOGDecoder(nn.Module):
    """`num_blocks` decoder blocks; embedding scaled by sqrt(H) + sinusoidal
    positions; output head weight-tied to the embedding
    (mm_modeling.py:634-666).

    `embedding_table` is the token table shared with the text backbone
    (fcmf_pretraining.py:162-166); without one the decoder allocates its own."""

    def __init__(self, config: DecoderConfig, cross_mask_mode: str = "causal_quirk",
                 embedding_table: Optional[nn.Parameter] = None, device=None):
        super().__init__()
        self.config = config
        h, dt = config.hidden_size, config.torch_dtype
        self.embedding = layers.Embed(config.vocab_size, h, dt, device=device,
                                      weight=embedding_table)
        self.blks = nn.ModuleDict({
            f"block{i}": TransformerDecoderBlock(config, cross_mask_mode, device=device)
            for i in range(config.num_blocks)})
        self.dense = TiedHead(self.embedding.weight, device=device)
        self.register_buffer(
            "positions", sinusoidal_positions(config.max_position_embeddings, h, device),
            persistent=False)

    def init_cache(self, batch_size: int, device=None) -> Cache:
        cfg = self.config
        return {name: torch.zeros(batch_size, cfg.max_decode_len, cfg.hidden_size,
                                  dtype=cfg.torch_dtype, device=device)
                for name in self.blks}

    def _embed(self, token_ids: torch.Tensor, position_offset: int,
               rng: Optional[layers.DropoutRng]) -> torch.Tensor:
        cfg = self.config
        x = self.embedding(token_ids) * math.sqrt(cfg.hidden_size)
        pe = self.positions[position_offset:position_offset + token_ids.shape[1]]
        x = x + pe.to(cfg.torch_dtype)[None]
        return layers.dropout(x, cfg.dropout, rng if self.training else None)

    def forward(self, token_ids: torch.Tensor, enc_outputs: torch.Tensor,
                enc_mask: Optional[torch.Tensor],
                rng: Optional[layers.DropoutRng] = None,
                cache: Optional[Cache] = None, step: Optional[int] = None,
                return_hidden: bool = False) -> torch.Tensor:
        """Teacher forcing when `cache` is None ([B, T] ids -> [B, T, V] f32
        logits); otherwise one decode step ([B, 1] ids -> [B, 1, V] logits,
        `cache` updated in place).  `return_hidden` skips the head and
        returns the final hidden states [B, T, H], for the chunked loss."""
        x = self._embed(token_ids, 0 if cache is None else step, rng)
        for name, blk in self.blks.items():
            x = blk(x, enc_outputs, enc_mask, rng,
                    kv=None if cache is None else cache[name], step=step)
        if return_hidden:
            return x
        return self.dense(x)
