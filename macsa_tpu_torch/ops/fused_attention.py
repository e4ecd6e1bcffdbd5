"""Fused multi-head self-attention forward (kernel K1).

Counterpart of `macsa_tpu/ops/fused_attention.py` (`fused_self_attention`),
forward only and deterministic: softmax(QK^T/sqrt(d) + mask row) in f32,
then @V, with q/k/v in the projections' native `[B, L, H*d]` layout and
the heads sliced inside the kernel, so no transpose runs around it.

On a CUDA tensor `fused_self_attention` launches the hand-written kernel
(`macsa_tpu_torch/csrc/fused_attention.cu`); on a CPU tensor it runs
`attention_reference`, the plain PyTorch version of the same math.
Dropout (rate > 0) and the backward belong to training and are not
ported yet: a rate above 0 raises.
"""

from __future__ import annotations

import math

import torch

from macsa_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64)  # head widths the kernel is instantiated for


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H] -> [B, num_heads, L, H/num_heads]."""
    b, l, h = x.shape
    return x.reshape(b, l, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, n, L, d] -> [B, L, n*d]."""
    b, n, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, n * d)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   additive_mask: torch.Tensor | None) -> torch.Tensor:
    """Deterministic scaled-dot-product attention over split heads
    (`macsa_tpu.models.layers.attention_core`): q/k/v [B, n, L, d], mask
    broadcastable to [B, n, Lq, Lk].  Scores leave the matmul in the
    operand dtype and the softmax runs in f32; the probs are cast back to
    the operand dtype before @V."""
    scores = torch.einsum("bnqd,bnkd->bnqk", q, k).float() / math.sqrt(q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnqk,bnkd->bnqd", probs, v)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K1: q/k/v [B, L, H*d], mask [B, L] additive f32."""
    ctx = attention_core(split_heads(q, num_heads), split_heads(k, num_heads),
                         split_heads(v, num_heads), mask[:, None, None, :])
    return merge_heads(ctx)


def _check_cuda_args(q, k, v, mask, num_heads):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {_DTYPES}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be one [B, L, H*d] shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, hd = q.shape
    if hd % num_heads or hd // num_heads not in HEAD_DIMS:
        raise ValueError(f"width {hd} over {num_heads} heads: head dim must be "
                         f"one of {HEAD_DIMS}")
    if mask.dtype != torch.float32 or tuple(mask.shape) != (b, l):
        raise ValueError(f"mask must be float32 [{b}, {l}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, num_heads: int,
                         rate: float = 0.0) -> torch.Tensor:
    """Multi-head softmax(QK^T/sqrt(d) + mask) @ V.

    q/k/v: [B, L, H*d] projection outputs (not head-split); mask: [B, L]
    additive f32 row (0 keep, large negative drop).  Returns [B, L, H*d]
    in the input dtype, merged heads, ready for the output projection."""
    if rate != 0.0:
        raise NotImplementedError("attention dropout (rate > 0) is not ported yet")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, k, v, mask, num_heads)
    b, l, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library()
    status = lib.macsa_fused_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, l, num_heads, hd // num_heads, int(q.dtype == torch.bfloat16),
        cuda_lib.stream_handle(q.device))
    cuda_lib.check(status, "macsa_fused_attention_fwd")
    cuda_lib.launch_counts["fused_self_attention"] += 1
    return out
