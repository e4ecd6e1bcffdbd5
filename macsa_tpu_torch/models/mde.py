"""Multimodal Denoising Encoder (MDE), in PyTorch.

Counterpart of `macsa_tpu/models/mde.py` (reference:
fcmf_framework/mm_modeling.py:448-555): the text CLS scores the image
patches through a `PerHeadAttention`, the top `int(n * alpha)` patches are
the strong set and the bottom `n - k` the weak set, each weak patch is
assigned to its most cosine-similar strong patch, and a theta-gated
max-pool folds the weak patches into the strong ones.

Ties are ordered as `jax.lax.top_k` orders them, lower index first: the
strong set is a stable descending sort of the scores, the weak set a
separate stable descending sort of their negation, as JAX calls
`top_k(-scores, m)`.  With tied scores (common in bf16) the two sets may
overlap, as they do in JAX; `torch.topk` gives no order for ties on CUDA
and is not used.  `k = max(1, int(n * alpha))` truncates (34 of 49 at 0.7).
Maxima pass their gradient evenly to tied elements (`amax`), as JAX's
`max` does; `argmax` takes the first maximum in both packages.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from macsa_tpu_torch.config import ModelConfig
from macsa_tpu_torch.models.attention import PerHeadAttention

POOL_FILL = -1e4  # mm_modeling.py:526-550


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, largest first, equal
    values lower index first (`jax.lax.top_k`'s order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _unit(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| in f32 with a finite value and gradient at x = 0 (a
    zero-padded missing image gives exactly-zero patches)."""
    x = x.float()
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-12)


class MultimodalDenoisingEncoder(nn.Module):
    def __init__(self, config: ModelConfig, alpha: float = 0.7, device=None):
        super().__init__()
        self.alpha = alpha
        heads = config.num_attention_heads
        self.guidance_attention = PerHeadAttention(
            config.hidden_size, config.hidden_size // heads, heads, "scaled_dot_product",
            compute_dtype=config.torch_dtype, device=device)

    def forward(self, text_hidden: torch.Tensor, image_hidden: torch.Tensor) -> torch.Tensor:
        """text_hidden [B, L, H], image_hidden [B, N, H] -> [B, K, H]."""
        b, n, h = image_hidden.shape
        k_strong = max(1, int(n * self.alpha))
        m_weak = n - k_strong

        # 1. scoring: the text CLS queries the patches (mm_modeling.py:480-488)
        lengths = torch.full((b,), n, dtype=torch.int32, device=image_hidden.device)
        _, probs = self.guidance_attention(image_hidden, text_hidden[:, 0:1], lengths=lengths,
                                           return_probs=True)
        scores = probs.reshape(b, -1, 1, n).mean(dim=1)[:, 0, :]  # [B, N]

        # 2. strong / weak split (mm_modeling.py:492-506)
        def gather(idx):
            return image_hidden.gather(1, idx[..., None].expand(-1, -1, h))

        v_strong = gather(top_k_indices(scores, k_strong))
        if m_weak == 0:
            return v_strong
        v_weak = gather(top_k_indices(-scores, m_weak))

        # 3. cosine similarity weak -> strong (mm_modeling.py:509-513)
        sim = torch.einsum("bmh,bkh->bmk", _unit(v_weak), _unit(v_strong))

        # 4. theta gate and assignment (mm_modeling.py:516-523)
        max_sim = sim.amax(dim=-1)                             # [B, M]
        assign = sim.argmax(dim=-1)                            # [B, M]
        theta_weak = torch.exp(max_sim) / (torch.exp(max_sim) + math.e)

        # 5. masked max-pool fusion (mm_modeling.py:526-550)
        mask = F.one_hot(assign, k_strong).float()             # [B, M, K]
        pool_in = torch.where(mask[..., None] == 0, POOL_FILL, v_weak[:, :, None, :].float())
        attended = pool_in.amax(dim=1)                         # [B, K, H]
        has_child = mask.sum(dim=1) > 0                        # [B, K]
        attended = torch.where(has_child[..., None], attended, 0.0)

        theta_map = torch.where(mask == 0, POOL_FILL, theta_weak[..., None] * mask)
        theta_strong = theta_map.amax(dim=1)                   # [B, K]
        theta_strong = torch.where(theta_strong == POOL_FILL, 0.0, theta_strong)[..., None]

        updated = (1.0 - theta_strong) * v_strong.float() + theta_strong * attended
        return updated.to(image_hidden.dtype)
