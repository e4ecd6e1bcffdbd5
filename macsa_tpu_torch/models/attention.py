"""Per-head-parameter attention (the decoder's attention), in PyTorch.

Counterpart of `macsa_tpu/models/attention.py` (reference:
fcmf_framework/mm_modeling.py:35-132): per-head projection tensors
`w_kx`/`w_qx` of shape [n_head, embed, hidden], three score functions
(scaled_dot_product / mlp / bi_linear), and the quirk that the *value*
stream is the key projection `kx` (there is no separate W_v,
mm_modeling.py:129).

Masking (mm_modeling.py:105-124): the score is cast to f32 and *filled*
with -1e4 where masked (not added to), in the order `causal` (a
tril(q_len, k_len)) > `lengths` (valid key length per batch row) >
`key_mask` (a [B, Lk] 0/1 keep mask); the softmax runs in f32 and is cast
back to the compute dtype.

Head slot c uses weight head c, whatever the batch size.  With
`emulate_reference_heads` slot c of batch element b reads weight head
(c*B + b) % n_head instead, the reference's repeat/view pairing
(mm_modeling.py:79-85), which depends on the batch size the module is
called with (a beam decode calls it at B*k).

The products here are plain einsums in the JAX package too (no kernel of
its own); `scaled_dot_product_attention` is not used: its rounding points
differ from the ones above.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from macsa_tpu_torch.models.layers import Dense

MASK_FILL = -1e4  # mm_modeling.py:124
SCORE_FUNCTIONS = ("scaled_dot_product", "mlp", "bi_linear")


def _xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax's `xavier_uniform` on a [..., in, out] tensor: the leading axes
    count into the receptive field of both fans."""
    receptive = math.prod(t.shape[:-2])
    bound = math.sqrt(6.0 / ((t.shape[-2] + t.shape[-1]) * receptive))
    t.uniform_(-bound, bound, generator=generator)


class PerHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, hidden_dim: int, n_head: int = 1,
                 score_function: str = "scaled_dot_product",
                 compute_dtype: torch.dtype = torch.float32,
                 emulate_reference_heads: bool = False, device=None):
        super().__init__()
        if score_function not in SCORE_FUNCTIONS:
            raise ValueError(f"invalid score_function: {score_function}")
        self.embed_dim, self.hidden_dim, self.n_head = embed_dim, hidden_dim, n_head
        self.score_function = score_function
        self.compute_dtype = compute_dtype
        self.emulate_reference_heads = emulate_reference_heads
        self.w_kx = nn.Parameter(torch.empty(n_head, embed_dim, hidden_dim, device=device))
        self.w_qx = nn.Parameter(torch.empty(n_head, embed_dim, hidden_dim, device=device))
        if score_function == "mlp":
            self.weight = nn.Parameter(torch.empty(2 * hidden_dim, 1, device=device))
        elif score_function == "bi_linear":
            self.weight = nn.Parameter(torch.empty(hidden_dim, hidden_dim, device=device))
        self.proj = Dense(n_head * hidden_dim, embed_dim, compute_dtype, device=device)

    def init_weights_(self, generator: torch.Generator, std: float) -> None:
        for name in ("w_kx", "w_qx", "weight"):
            if hasattr(self, name):
                _xavier_uniform_(getattr(self, name), generator)

    def forward(self, k: torch.Tensor, q: torch.Tensor, *,
                lengths: Optional[torch.Tensor] = None,
                causal: bool = False,
                key_mask: Optional[torch.Tensor] = None,
                return_probs: bool = False):
        """k [B, Lk, E] (also the value stream once projected), q [B, Lq, E]
        -> [B, Lq, E]."""
        if k.dim() == 2:
            k = k[:, None, :]
        if q.dim() == 2:
            q = q[:, None, :]
        dt, d, nh = self.compute_dtype, self.hidden_dim, self.n_head
        kx = torch.einsum("ble,hed->bhld", k.to(dt), self.w_kx.to(dt))
        qx = torch.einsum("ble,hed->bhld", q.to(dt), self.w_qx.to(dt))

        if self.emulate_reference_heads:
            bsz = kx.shape[0]
            idx = (torch.arange(nh, device=kx.device)[None, :] * bsz
                   + torch.arange(bsz, device=kx.device)[:, None]) % nh  # [B, nh]
            rows = torch.arange(bsz, device=kx.device)[:, None]
            kx, qx = kx[rows, idx], qx[rows, idx]

        if self.score_function == "scaled_dot_product":
            score = torch.einsum("bhqd,bhkd->bhqk", qx, kx) / math.sqrt(d)
        elif self.score_function == "mlp":
            lq, lk = qx.shape[2], kx.shape[2]
            kxx = kx[:, :, None, :, :].expand(-1, -1, lq, -1, -1)
            qxx = qx[:, :, :, None, :].expand(-1, -1, -1, lk, -1)
            kq = torch.cat([kxx, qxx], dim=-1)  # [B, nh, Lq, Lk, 2d]
            score = torch.tanh((kq @ self.weight.to(dt)).squeeze(-1))
        else:
            score = torch.tanh(torch.einsum("bhqd,de,bhke->bhqk", qx, self.weight.to(dt), kx))

        lq, lk = score.shape[2], score.shape[3]
        score = score.float()
        if causal:
            tri = torch.ones(lq, lk, dtype=torch.bool, device=score.device).tril()
            score = torch.where(tri, score, MASK_FILL)
        elif lengths is not None:
            keep = torch.arange(lk, device=score.device)[None, :] < lengths[:, None]  # [B, Lk]
            score = torch.where(keep[:, None, None, :], score, MASK_FILL)
        elif key_mask is not None:
            score = torch.where(key_mask[:, None, None, :].bool(), score, MASK_FILL)

        probs = torch.softmax(score, dim=-1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, kx)  # value stream = kx
        out = self.proj(out.transpose(1, 2).reshape(out.shape[0], lq, nh * d))
        if return_probs:
            return out, probs
        return out
