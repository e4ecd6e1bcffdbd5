"""Fused geometric (box-bias) attention (K3).

Counterpart of `macsa_tpu/ops/box_attention_kernel.py`: per (batch*head)
slice, softmax(QK^T/sqrt(d) + log(max(gates, 1e-6))) V, with q/k/v
[B*h, N, d] and the post-ReLU geometric gates [B*h, N, N] (the fold order
of `macsa_tpu/models/box_attention.py:123-127`).  Scores are taken in f32;
the probabilities are cast to q's dtype before the P @ V product.

On a CUDA tensor `fused_box_attention` launches the hand-written kernel
(`macsa_tpu_torch/csrc/box_attention.cu`); under autograd its gradient is
`box_attention_backward_reference`, the analytic backward that the JAX
package's custom VJP runs as plain XLA.  On a CPU tensor it runs
`box_attention_reference`, the plain version, and autograd differentiates
that.  Without autograd the forward is the registered op
`torch.ops.macsa_tpu_torch.box_attention` on both devices (the kernel's
launch on CUDA, the plain version on the CPU, a fake implementation for
`torch.export`), as K1's is.  The kernel launches under the tensors'
device, whatever device is current.  The TPU kernel's padding of N to 8
rows and d to 128 lanes, and its -inf mask of the padded keys, exist only
for the TPU tile and have no counterpart here.
"""

from __future__ import annotations

import math

import torch

from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops.fused_attention import OPS

GEO_CLAMP_MIN = 1e-6  # roi_modeling.py:40
MAX_ROIS = 8  # the kernel keeps the N x N scores of a slice in registers
_DTYPES = (torch.float32, torch.bfloat16)


def _probs(q: torch.Tensor, k: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """f32 softmax(QK^T/sqrt(d) + log(max(gates, 1e-6))) over the keys
    (`_xla_probs`), with the scores taken from f32 operands."""
    scores = torch.einsum("bnd,bmd->bnm", q.float(), k.float()) / math.sqrt(q.shape[-1])
    scores = scores + torch.log(torch.clamp(gates.float(), min=GEO_CLAMP_MIN))
    return torch.softmax(scores, dim=-1)


def box_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            gates: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 (`box_attention_reference`): [BH, N, d] in q's dtype."""
    return torch.einsum("bnm,bmd->bnd", _probs(q, k, gates).to(q.dtype), v)


def box_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     gates: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv, dgates) for the cotangent g [BH, N, d]: the JAX
    package's `_bwd`, in f32, each cast to its input's dtype.
    d log(max(gates, 1e-6)) is 1/gates above the clamp and 0 at or below it,
    so dgates is exactly 0 where a gate is 0."""
    scale = math.sqrt(q.shape[-1])
    probs = _probs(q, k, gates)
    g32 = g.float()
    dv = torch.einsum("bnm,bnd->bmd", probs, g32)
    dp = torch.einsum("bnd,bmd->bnm", g32, v.float())
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq = torch.einsum("bnm,bmd->bnd", ds, k.float()) / scale
    dk = torch.einsum("bnm,bnd->bmd", ds, q.float()) / scale
    g_f = gates.float()
    dgates = torch.where(g_f > GEO_CLAMP_MIN, ds / torch.clamp(g_f, min=GEO_CLAMP_MIN), 0.0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dgates.to(gates.dtype)


def _check_cuda_args(q, k, v, gates) -> None:
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, gates)):
        raise TypeError(f"q/k/v/gates must share one of {_DTYPES}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {gates.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be one [BH, N, d] shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, _ = q.shape
    if not 1 <= n <= MAX_ROIS:
        raise ValueError(f"N = {n} ROIs: the kernel takes 1 to {MAX_ROIS}")
    if tuple(gates.shape) != (bh, n, n):
        raise ValueError(f"gates must be [{bh}, {n}, {n}], got {tuple(gates.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("gates", gates)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@cuda_lib.on_tensor_device
def _launch(q, k, v, gates) -> torch.Tensor:
    bh, n, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    status = cuda_lib.library().macsa_box_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), gates.data_ptr(), out.data_ptr(),
        bh, n, d, int(q.dtype == torch.bfloat16), cuda_lib.stream_handle(q.device))
    cuda_lib.check(status, "macsa_box_attention_fwd")
    cuda_lib.launch_counts["box_attention"] += 1
    return out


class _FusedBoxAttention(torch.autograd.Function):
    """K3's kernel forward; the plain analytic backward as its gradient
    (the custom VJP of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, gates):
        ctx.save_for_backward(q, k, v, gates)
        return _launch(q, k, v, gates)

    @staticmethod
    def backward(ctx, g):
        return box_attention_backward_reference(*ctx.saved_tensors, g)


# K3's forward without autograd as a registered op (the library object
# and the reason for it: `ops/fused_attention.py`)
OPS.define("box_attention(Tensor q, Tensor k, Tensor v, Tensor gates) -> Tensor")
OPS.impl("box_attention", box_attention_reference, "CPU")


def _box_attention_op_cuda(q, k, v, gates):
    _check_cuda_args(q, k, v, gates)
    return _launch(q, k, v, gates)


OPS.impl("box_attention", _box_attention_op_cuda, "CUDA")


@torch.library.register_fake("macsa_tpu_torch::box_attention")
def _box_attention_op_fake(q, k, v, gates):
    return torch.empty_like(q)


box_attention_op = torch.ops.macsa_tpu_torch.box_attention.default


def fused_box_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gates: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(d) + log(max(gates, 1e-6))) V per (batch*head).

    q/k/v: [BH, N, d]; gates: [BH, N, N] post-ReLU geometric weights, in
    q's dtype.  Returns [BH, N, d] in q's dtype.  Gradients flow to all
    four inputs; without autograd the call is the registered op
    `box_attention_op`."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, gates)):
        if q.device.type == "cpu":
            return box_attention_reference(q, k, v, gates)
        _check_cuda_args(q, k, v, gates)
        return _FusedBoxAttention.apply(q, k, v, gates)
    return box_attention_op(q, k, v, gates)
