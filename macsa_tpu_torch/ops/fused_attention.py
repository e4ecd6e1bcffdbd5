"""Fused multi-head self-attention with dropout, forward and backward (K1).

Counterpart of `macsa_tpu/ops/fused_attention.py` (`fused_self_attention`
and its custom VJP): softmax(QK^T/sqrt(d) + mask row) in f32, dropout on the
probabilities, then @V, with q/k/v in the projections' native `[B, L, H*d]`
layout and the heads sliced inside the kernels, so no transpose runs
around them.  The backward recomputes the probabilities and regenerates the
dropout mask; only q/k/v, the mask row, the seed and a per-row f32
logsumexp are kept from the forward.

The dropout mask is a keyed 32-bit hash of (seed, b, h, i, j) alone
(`dropout_keep`), so a kernel draws the same bits whatever block or thread
computes an element, and the plain PyTorch versions reproduce them exactly.
It is not the TPU's PRNG stream: only the keep rate and independence carry
over, as between the TPU kernel and `jax.random` in the JAX package.

On a CUDA tensor `fused_self_attention` launches the hand-written kernels:
the forward, and under autograd the backward, each under the tensors'
device, whatever device is current.  Each has three variants,
picked by `attention_variant` from the dtype and the head width alone:
"wgmma" (`macsa_tpu_torch/csrc/fused_attention_wgmma.cu`: bf16 at head
width 64, any length, every product on the tensor cores; past
`WGMMA_BWD_ONE_LAUNCH_LEN` rows the forward streams its key passes and the
backward runs two launches that stream tiles instead of one that holds a
head), "tf32x3" (`macsa_tpu_torch/csrc/fused_attention_tf32.cu`: f32 at
head width 64, any length, every f32 product as three TF32 products on the
tensor cores, `mma.sync`; the backward is two launches) and "simt"
(`macsa_tpu_torch/csrc/fused_attention.cu`: f32 sums on the CUDA cores,
f32 or bf16 at head width 32, any length).
`cuda_lib.launch_counts` counts each call under the kernel's name and
under "<name>.<variant>", once whatever its launches.
On a CPU tensor it runs `attention_reference`, the plain version, and
autograd differentiates that.

Without autograd the forward is the registered op
`torch.ops.macsa_tpu_torch.fused_self_attention` on both devices: its CUDA
implementation is the kernel's launch, its CPU implementation the plain
version (a dispatch by device, not a fallback), and a fake implementation
gives its output's shape, so `torch.export` keeps the op in an exported
program (`inference/export.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from macsa_tpu_torch.ops import cuda_lib

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64)  # head widths the kernels are instantiated for
WGMMA_HEAD_DIM = 64   # the tensor-core kernels: one head row is one 128-byte tile row
# up to this length the tensor-core backward keeps a head's q, k, v, g in
# one block's shared memory (one launch); past it, two launches stream tiles
# and need a row-term scratch
WGMMA_BWD_ONE_LAUNCH_LEN = 192
# the f32 tensor-core kernels: query rows a block owns, and the keys (or
# queries) of each tile it walks (`kTile` of csrc/fused_attention_tf32.cu)
TF32X3_TILE = 64

_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x7FEB352D, 0x846CA68B  # the 32-bit finalizer of csrc/fused_attention.cu


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H] -> [B, num_heads, L, H/num_heads]."""
    b, l, h = x.shape
    return x.reshape(b, l, num_heads, h // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, n, L, d] -> [B, L, n*d]."""
    b, n, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, n * d)


# ---------------------------------------------------------------------------
# the dropout mask
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32): the product is taken from
    c's 16-bit halves, so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (xorshift-multiply finalizer)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def _as_u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def keep_threshold(rate: float) -> int:
    """Bits below this value drop an element (the TPU kernel's
    `round(rate * 2^32)`, `_keep_mask`)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_bits(seed: int, b, h, i, j) -> torch.Tensor:
    """uint32 random bits (held in int64) for the probability element
    (b, h, i, j), broadcast over the coordinate tensors:
    mix(mix(mix(mix(mix(seed) ^ b) ^ h) ^ i) ^ j)."""
    row = _mix32(_as_u32(seed))
    for coord in (b, h, i):
        row = _mix32(row ^ _as_u32(coord))
    return _mix32(row ^ _as_u32(j))


def dropout_keep(seed: int, b, h, i, j, rate: float) -> torch.Tensor:
    """Keep mask of element (b, h, i, j): a function of those coordinates
    and the seed only, so every tiling of the tensor draws the same bits."""
    return dropout_bits(seed, b, h, i, j) >= keep_threshold(rate)


def _keep_mask(seed: int, b: int, n: int, l: int, rate: float, device) -> torch.Tensor:
    """The [B, n, L, L] keep mask of one attention call."""
    ar = lambda m: torch.arange(m, device=device)
    return dropout_keep(seed, ar(b)[:, None, None, None], ar(n)[None, :, None, None],
                        ar(l)[:, None], ar(l), rate)


def _inv_keep(rate: float) -> float:
    """1/(1-rate) rounded to f32, the factor the kernels apply."""
    return float(np.float32(1.0 / (1.0 - rate)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   additive_mask: torch.Tensor | None,
                   keep: torch.Tensor | None = None, rate: float = 0.0) -> torch.Tensor:
    """Scaled-dot-product attention over split heads
    (`macsa_tpu.models.layers.attention_core`): q/k/v [B, n, L, d], mask
    broadcastable to [B, n, Lq, Lk].  Scores leave the matmul in the
    operand dtype and the softmax runs in f32; with a `keep` mask the
    kept probs are scaled by 1/(1-rate) and the others zeroed; the probs
    are cast back to the operand dtype before @V."""
    scores = torch.einsum("bnqd,bnkd->bnqk", q, k).float() / math.sqrt(q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = torch.where(keep, probs * _inv_keep(rate), 0.0)
    return torch.einsum("bnqk,bnkd->bnqd", probs.to(q.dtype), v)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, num_heads: int, rate: float = 0.0,
                        seed: int = 0) -> torch.Tensor:
    """Plain version of K1: q/k/v [B, L, H*d], mask [B, L] additive f32;
    dropout at `rate` with the kernels' hashed mask."""
    b, l, _ = q.shape
    keep = _keep_mask(seed, b, num_heads, l, rate, q.device) if rate > 0.0 else None
    ctx = attention_core(split_heads(q, num_heads), split_heads(k, num_heads),
                         split_heads(v, num_heads), mask[:, None, None, :], keep, rate)
    return merge_heads(ctx)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: torch.Tensor, g: torch.Tensor, num_heads: int,
                                 rate: float = 0.0, seed: int = 0):
    """Plain version of K1's backward: (dq, dk, dv) for the cotangent g
    [B, L, H*d], with the TPU kernel's rounding points (`_bwd_kernel`):
    probs in f32 from f32-accumulated scores, the dropped probs cast to the
    operand dtype before dV, ds cast to the operand dtype before dQ/dK,
    f32 accumulation, outputs in the operand dtype."""
    dt = q.dtype
    b, l, _ = q.shape
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh, gh = (split_heads(t, num_heads).float() for t in (q, k, v, g))
    s = torch.einsum("bnqd,bnkd->bnqk", qh, kh) * scale + mask.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    dpd = torch.einsum("bnqd,bnkd->bnqk", gh, vh)
    if rate > 0.0:
        keep = _keep_mask(seed, b, num_heads, l, rate, q.device)
        inv = _inv_keep(rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dpd * inv, 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.einsum("bnqk,bnqd->bnkd", pd.to(dt).float(), gh)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.einsum("bnqk,bnkd->bnqd", ds, kh) * scale
    dk = torch.einsum("bnqk,bnqd->bnkd", ds, qh) * scale
    return tuple(merge_heads(x).to(dt) for x in (dq, dk, dv))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")


def _check_cuda_args(q, k, v, mask, num_heads, *extra):
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
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask), *extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # rows are fetched and written 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned")


def attention_variant(dtype: torch.dtype, head_dim: int, length: int,
                      backward: bool = False) -> str:
    """Which K1 kernel takes [B, length, H*head_dim] on a CUDA tensor,
    forward or `backward`: at head width 64, "wgmma" for bf16 (the kernels
    pick their own tiling from the length) and "tf32x3" for f32 (three TF32
    products for each f32 product hold the f32 tolerances, where one would
    not); at head width 32 (half a swizzled tile row), "simt" for both.
    The length and the direction do not decide: every variant takes every
    length, both ways."""
    if head_dim != WGMMA_HEAD_DIM:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _count(name: str, variant: str) -> None:
    cuda_lib.launch_counts[name] += 1
    cuda_lib.launch_counts[f"{name}.{variant}"] += 1


def _dropout_args(rate: float, seed: int):
    """(dropout on, keep threshold, 1/(1-rate), seed as uint32) for the C calls."""
    if rate == 0.0:
        return 0, 0, 1.0, 0
    return 1, keep_threshold(rate), _inv_keep(rate), int(seed) & _M32


@cuda_lib.on_tensor_device
def _launch_fwd(q, k, v, mask, num_heads, rate, seed, with_lse):
    """Forward kernel -> (out [B, L, H*d], lse [B, H, L] f32 or None)."""
    b, l, hd = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, num_heads, l, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    variant = attention_variant(q.dtype, hd // num_heads, l)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                lse.data_ptr() if with_lse else None)
    tail = (*_dropout_args(rate, seed), cuda_lib.stream_handle(q.device))
    if variant == "wgmma":
        status = cuda_lib.library().macsa_fused_attention_fwd_wgmma(
            *pointers, b, l, num_heads, *tail)
    elif variant == "tf32x3":
        status = cuda_lib.library().macsa_fused_attention_fwd_tf32x3(
            *pointers, b, l, num_heads, *tail)
    else:
        status = cuda_lib.library().macsa_fused_attention_fwd(
            *pointers, b, l, num_heads, hd // num_heads, int(q.dtype == torch.bfloat16), *tail)
    cuda_lib.check(status, f"macsa_fused_attention_fwd ({variant})")
    _count("fused_self_attention", variant)
    return out, lse


@cuda_lib.on_tensor_device
def _launch_bwd(q, k, v, mask, lse, g, num_heads, rate, seed):
    """Backward kernel (one count whatever its launches) -> (dq, dk, dv)."""
    _check_cuda_args(q, k, v, mask, num_heads, ("g", g), ("lse", lse))
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must be {q.dtype} {tuple(q.shape)}, "
                         f"got {g.dtype} {tuple(g.shape)}")
    b, l, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if q.numel() == 0:
        return dq, dk, dv
    variant = attention_variant(q.dtype, hd // num_heads, l, backward=True)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), g.data_ptr(),
              lse.data_ptr())
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (*_dropout_args(rate, seed), cuda_lib.stream_handle(q.device))
    # rowsum(dp * p), written by a dq launch for the dk/dv launch; the
    # one-launch bf16 tensor-core kernel keeps it in the block
    two_launches = variant != "wgmma" or l > WGMMA_BWD_ONE_LAUNCH_LEN
    row_term = torch.empty_like(lse) if two_launches else None
    term_ptr = row_term.data_ptr() if two_launches else None
    if variant == "wgmma":
        status = cuda_lib.library().macsa_fused_attention_bwd_wgmma(
            *inputs, term_ptr, *grads, b, l, num_heads, *tail)
    elif variant == "tf32x3":
        status = cuda_lib.library().macsa_fused_attention_bwd_tf32x3(
            *inputs, term_ptr, *grads, b, l, num_heads, *tail)
    else:
        status = cuda_lib.library().macsa_fused_attention_bwd(
            *inputs, term_ptr, *grads, b, l, num_heads, hd // num_heads,
            int(q.dtype == torch.bfloat16), *tail)
    cuda_lib.check(status, f"macsa_fused_attention_bwd ({variant})")
    _count("fused_self_attention_bwd", variant)
    return dq, dk, dv


@cuda_lib.on_tensor_device
def _launch_bwd_streamed(q, k, v, mask, lse, g, num_heads, rate, seed):
    """The tensor-core backward's two streaming launches at any length ->
    (dq, dk, dv).  `_launch_bwd` takes them only past
    `WGMMA_BWD_ONE_LAUNCH_LEN` rows; this lets a measurement read them at
    shorter rows beside the one-launch kernel.  Counted nowhere: no path
    calls it."""
    _check_cuda_args(q, k, v, mask, num_heads, ("g", g), ("lse", lse))
    b, l, hd = q.shape
    if attention_variant(q.dtype, hd // num_heads, l, backward=True) != "wgmma" \
            or g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError("the streaming backward takes bf16 q, k, v, g at head width "
                         f"{WGMMA_HEAD_DIM}: {q.dtype} {tuple(q.shape)}, g {g.dtype}")
    grads = [torch.empty_like(q) for _ in range(3)]
    row_term = torch.empty_like(lse)
    status = cuda_lib.library().macsa_fused_attention_bwd_wgmma_streamed(
        *(x.data_ptr() for x in (q, k, v, mask, g, lse, row_term, *grads)), b, l, num_heads,
        *_dropout_args(rate, seed), cuda_lib.stream_handle(q.device))
    cuda_lib.check(status, "macsa_fused_attention_bwd_wgmma_streamed")
    return tuple(grads)


class _FusedAttention(torch.autograd.Function):
    """K1 forward kernel, and K1's backward kernel as its gradient (the
    custom VJP of the JAX package).  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, rate, seed):
        out, lse = _launch_fwd(q, k, v, mask, num_heads, rate, seed, with_lse=True)
        ctx.save_for_backward(q, k, v, mask, lse)
        ctx.num_heads, ctx.rate, ctx.seed = num_heads, rate, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, mask, lse, g.contiguous(), ctx.num_heads,
                                 ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None, None


# K1's forward without autograd as a registered op.  Defined with
# `torch.library.Library` rather than `torch.library.custom_op`: the same
# dispatch by device for a fraction of the host time a call costs (no
# alias checks or autograd wrapper around the implementation).
OPS = torch.library.Library("macsa_tpu_torch", "FRAGMENT")
OPS.define("fused_self_attention(Tensor q, Tensor k, Tensor v, Tensor mask, int num_heads, "
           "float rate, int seed) -> Tensor")
OPS.impl("fused_self_attention", attention_reference, "CPU")


def _attention_op_cuda(q, k, v, mask, num_heads, rate, seed):
    _check_cuda_args(q, k, v, mask, num_heads)
    return _launch_fwd(q, k, v, mask, num_heads, rate, seed, with_lse=False)[0]


OPS.impl("fused_self_attention", _attention_op_cuda, "CUDA")


@torch.library.register_fake("macsa_tpu_torch::fused_self_attention")
def _attention_op_fake(q, k, v, mask, num_heads, rate, seed):
    return torch.empty_like(q)


attention_op = torch.ops.macsa_tpu_torch.fused_self_attention.default


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor, num_heads: int,
                         rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Multi-head softmax(QK^T/sqrt(d) + mask) -> dropout -> @V.

    q/k/v: [B, L, H*d] projection outputs (not head-split); mask: [B, L]
    additive f32 row (0 keep, large negative drop); `seed` keys the dropout
    mask (ignored at rate 0).  Returns [B, L, H*d] in the input dtype,
    merged heads, ready for the output projection.  Gradients flow to
    q/k/v, through K1's backward kernel on CUDA tensors; without autograd
    the call is the registered op `attention_op`."""
    _check_rate(rate)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.device.type == "cpu":
            return attention_reference(q, k, v, mask, num_heads, rate, seed)
        _check_cuda_args(q, k, v, mask, num_heads)
        return _FusedAttention.apply(q, k, v, mask, num_heads, rate, seed)
    return attention_op(q, k, v, mask, num_heads, rate, int(seed))
