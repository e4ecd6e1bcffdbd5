"""Geometric (box-relational) ROI self-attention in PyTorch.

Counterpart of `macsa_tpu/models/box_attention.py` (reference:
fcmf_framework/roi_modeling.py): pairwise box displacement log-ratios ->
64-d sinusoidal embedding -> per-head ReLU gates, and log(max(gate, 1e-6))
added to the scaled-dot scores before the softmax, and dropout on the
probabilities in training.  FCMF runs it with no mask and the
trigonometric embedding.  With `use_pallas_kernel` (the JAX option's name)
the scores, log-gates, softmax and P @ V run as kernel K3
(`ops/box_attention.py`) whenever dropout is not active, as in the JAX
module; otherwise the plain path below runs.
Parameter names are the reference's: `linears.{0..3}` (q/k/v/out) and
`WGs.{0..h-1}`, the per-head gates, run as one stacked matmul.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.models.layers import Dense, DropoutRng, dropout
from macsa_tpu_torch.ops.box_attention import fused_box_attention

GEO_CLAMP_MIN = 1e-6  # roi_modeling.py:40
DIM_G = 64  # geometric embedding width
WAVE_LEN = 1000.0


def box_relational_embedding(boxes: torch.Tensor) -> torch.Tensor:
    """boxes [B, N, 4] as (x_min, x_max, y_min, y_max) -> [B, N, N, 64]
    (roi_modeling.py:79-138)."""
    boxes = boxes.float()
    x_min, x_max, y_min, y_max = boxes.split(1, dim=-1)  # each [B, N, 1]
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0
    # delta[b, i, j] = f(box_i, box_j); normalizers use box_i
    delta_x = torch.log(torch.clamp(torch.abs((cx - cx.transpose(1, 2)) / w), min=1e-3))
    delta_y = torch.log(torch.clamp(torch.abs((cy - cy.transpose(1, 2)) / h), min=1e-3))
    delta_w = torch.log(w / w.transpose(1, 2))
    delta_h = torch.log(h / h.transpose(1, 2))
    position_mat = torch.stack([delta_x, delta_y, delta_w, delta_h], dim=-1)

    n_freq = DIM_G // 8
    feat_range = torch.arange(n_freq, dtype=torch.float32, device=boxes.device)
    dim_mat = 1.0 / torch.pow(WAVE_LEN, feat_range / n_freq)
    mul = (100.0 * position_mat)[..., None] * dim_mat  # [B, N, N, 4, n_freq]
    mul = mul.reshape(*mul.shape[:3], 4 * n_freq)
    return torch.cat([torch.sin(mul), torch.cos(mul)], dim=-1)


class BoxMultiHeadedAttention(nn.Module):
    """Multi-head self-attention with box-relational gates
    (roi_modeling.py:49-180)."""

    def __init__(self, num_heads: int, d_model: int,
                 compute_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.1,
                 use_pallas_kernel: bool = False, device=None):
        super().__init__()
        self.num_heads, self.d_model = num_heads, d_model
        self.compute_dtype = compute_dtype
        self.dropout_rate = dropout_rate
        self.use_pallas_kernel = use_pallas_kernel
        self.linears = nn.ModuleList(Dense(d_model, d_model, compute_dtype, device=device)
                                     for _ in range(4))
        self.WGs = nn.ModuleList(Dense(DIM_G, 1, compute_dtype, device=device)
                                 for _ in range(num_heads))

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                boxes: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        h, dt = self.num_heads, self.compute_dtype
        d_k = self.d_model // h
        geo = box_relational_embedding(boxes).to(dt)  # [B, N, N, 64]

        def heads(x):
            b, n, _ = x.shape
            return x.reshape(b, n, h, d_k).transpose(1, 2)

        q = heads(self.linears[0](query))
        k = heads(self.linears[1](key))
        v = heads(self.linears[2](value))
        # the h per-head gates Linear(64, 1) as one [64 -> h] matmul
        wg_weight = torch.cat([g.weight for g in self.WGs]).to(dt)
        wg_bias = torch.cat([g.bias for g in self.WGs]).to(dt)
        w_g = F.relu(F.linear(geo, wg_weight, wg_bias)).permute(0, 3, 1, 2)
        b, _, n, _ = q.shape

        drop_active = self.training and rng is not None and self.dropout_rate > 0.0
        if self.use_pallas_kernel and not drop_active:
            def fold(x):  # [B, h, ...] -> [B*h, ...], the JAX module's fold order
                return x.reshape((b * h,) + tuple(x.shape[2:])).contiguous()

            out = fused_box_attention(fold(q), fold(k), fold(v), fold(w_g))
            out = out.reshape(b, h, n, d_k).transpose(1, 2).reshape(b, n, self.d_model)
            return self.linears[3](out)

        scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(d_k)
        scores = scores + torch.log(torch.clamp(w_g.float(), min=GEO_CLAMP_MIN))
        probs = dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                        rng if self.training else None)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), v)
        return self.linears[3](out.transpose(1, 2).reshape(b, n, self.d_model))
