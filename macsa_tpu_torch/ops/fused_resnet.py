"""A 1x1 conv with its frozen-BN epilogue (K4) and the whole stride-1
identity ResNet bottleneck (K5).

Counterpart of the kernel half of `tools_dev/fused_resnet_experiment.py`
(`fused_matmul_bn_act`, `fused_bottleneck` and their custom VJPs).
Activations are NHWC rows: x2 is [n*h*w, C], the row view of a
channels-last tensor (`permute(0, 2, 3, 1).reshape(-1, C)` copies
nothing).  Weights are [in, out] matrices: w [K, N] for K4; w1 [C, F],
w2 [9, F, F] (the 3x3 taps in dy*3+dx order) and w3 [F, C] for K5.  Each
(mul, add) is the f32 frozen-BatchNorm affine of one conv.

On a CUDA tensor the wrappers launch the hand-written kernels, K5 as one
launch per bottleneck with its intermediates kept on chip.  Each kernel
has three variants, picked by `matmul_variant` / `bottleneck_variant` from
the dtype and the shape alone: "wgmma"
(`macsa_tpu_torch/csrc/fused_resnet_wgmma.cu`: bf16 products on the
tensor cores, operands through an asynchronous ring in shared memory),
"tf32x3" (`macsa_tpu_torch/csrc/fused_resnet_tf32.cu`: f32 at the same
shapes on the tensor cores, every f32 product as three TF32 products of
split operands: K4 on `mma.sync`, split in registers; K5 on `wgmma`, its
weights split once a call into K-major TF32 planes, `tf32x3_weight_planes`)
and "simt"
(`macsa_tpu_torch/csrc/fused_resnet.cu`: f32 sums on the CUDA cores, any
other shape, f32 or bf16).  `cuda_lib.launch_counts` counts each
launch under the kernel's name and under "<name>.<variant>".  Under autograd K4's
gradient is `fused_matmul_bn_act_backward_reference` (the JAX `_bwd`) and
K5's is PyTorch autograd through `bottleneck_reference` (the JAX `_bneck_bwd`
takes `jax.vjp` of `_bottleneck_ref`).  On a CPU tensor they run the
plain versions, and autograd differentiates those.  Without autograd K5
is the registered op `torch.ops.macsa_tpu_torch.fused_bottleneck`
(`bottleneck_op`), which an exported program holds; its CPU
implementation is `bottleneck_reference`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops.fused_attention import OPS

_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def fused_matmul_bn_act_reference(x2: torch.Tensor, w: torch.Tensor, mul: torch.Tensor,
                                  add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                                  relu: bool = True) -> torch.Tensor:
    """Plain version of K4: relu?((x2 @ w) * mul + add [+ residual]) with an
    f32 product and epilogue, returned in x2's dtype."""
    y = (x2.float() @ w.float()) * mul.float() + add.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype)


def fused_matmul_bn_act_backward_reference(x2: torch.Tensor, w: torch.Tensor,
                                           mul: torch.Tensor, add: torch.Tensor,
                                           y: torch.Tensor, g: torch.Tensor,
                                           has_residual: bool, relu: bool):
    """(dx2, dw, dmul, dadd, dresidual or None) for the cotangent g of K4's
    output y (the JAX `_bwd`): the ReLU mask from the saved output, the
    BN-affine gradients from a recomputed f32 product."""
    g = g.float()
    if relu:
        g = torch.where(y > 0, g, 0.0)
    dres = g.to(x2.dtype) if has_residual else None
    gm = (g * mul.float()).to(x2.dtype)
    dx = (gm.float() @ w.float().t()).to(x2.dtype)
    dw = (x2.float().t() @ gm.float()).to(w.dtype)
    acc = x2.float() @ w.float()
    dmul = (g * acc).sum(0).to(mul.dtype)
    dadd = g.sum(0).to(add.dtype)
    return dx, dw, dmul, dadd, dres


def bottleneck_reference(x2: torch.Tensor, w1: torch.Tensor, mul1: torch.Tensor,
                         add1: torch.Tensor, w2: torch.Tensor, mul2: torch.Tensor,
                         add2: torch.Tensor, w3: torch.Tensor, mul3: torch.Tensor,
                         add3: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """Plain version of K5 (`_bottleneck_ref`) with its rounding points, the
    weights cast to x2's dtype as `_bneck_fwd` casts them: the conv1 and
    conv3 products leave their matmuls in x2's dtype before the f32
    epilogues, conv2 sums in f32, a1 and a2 are cast to x2's dtype, the
    residual is added in f32.  [n*h*w, C] -> [n*h*w, C]."""
    dt = x2.dtype
    f = w1.shape[1]
    a1 = torch.clamp_min((x2 @ w1.to(dt)).float() * mul1 + add1, 0.0).to(dt)
    a1 = a1.reshape(n, h, w, f).permute(0, 3, 1, 2)
    k2 = w2.to(dt).reshape(3, 3, f, f).permute(3, 2, 0, 1)  # [out, in, dy, dx]
    conv = F.conv2d(a1.float(), k2.float(), padding=1).permute(0, 2, 3, 1).reshape(-1, f)
    a2 = torch.clamp_min(conv * mul2 + add2, 0.0).to(dt)
    y = (a2 @ w3.to(dt)).float() * mul3 + add3 + x2.float()
    return torch.clamp_min(y, 0.0).to(dt)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check_tensors(dtype, named) -> None:
    """Each (name, tensor, dtype or None = `dtype`, shape) in `named` is
    contiguous, on the device of the first, with its dtype and shape."""
    device = named[0][1].device
    for name, t, want_dtype, shape in named:
        want_dtype = want_dtype or dtype
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dtype(x2: torch.Tensor) -> None:
    if x2.dtype not in _DTYPES:
        raise TypeError(f"x2 must be one of {_DTYPES}, got {x2.dtype}")
    if x2.dim() != 2:
        raise ValueError(f"x2 must be [rows, channels], got {tuple(x2.shape)}")


WGMMA_F = (64, 128, 256, 512)  # bottleneck widths the tensor-core K5 is built for
SMEM_PER_BLOCK = 232448        # bytes of shared memory one block can have on sm_90
_WGMMA_RING = 1024 + 4 * 128 * 64 * 2  # alignment slack + the ring of weight tiles
_WGMMA_X_RING = 4 * 128 * 64 * 2       # conv1's ring of x tiles, in a2's space
_WGMMA_OUT_STAGE = 128 * (128 + 8) * 4  # conv3's f32 output staging tile, in a1's space


# f32 tensor-core K5 ("tf32x3", csrc/fused_resnet_tf32.cu): a ring of three
# weight tiles (256 columns by 16 k, its big and small TF32 planes), each of
# the 8 warps' rings of three slots of 16 x rows by 16 k, two barriers a
# stage, the alignment slack; in bytes
_TF32X3_FIXED = 1024 + 3 * (256 * 16 * 4 * 2) + 8 * 3 * (16 * 16 * 4) + 3 * 2 * 8


def matmul_variant(dtype: torch.dtype, m: int, n: int, k: int) -> str:
    """Which K4 kernel takes x2 [m, k] @ w [k, n] on a CUDA tensor: for k and
    n multiples of 64 (any m) "wgmma" in bf16 and "tf32x3" in f32, else
    "simt"."""
    if m >= 1 and n >= 64 and k >= 64 and n % 64 == 0 and k % 64 == 0:
        return "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    return "simt"


def wgmma_bottleneck_smem(tile_rows: int, w: int, f: int) -> int:
    """Bytes of shared memory of one block of the tensor-core K5 with
    `tile_rows` output image rows: the weight ring, a2 [tile_rows * (w + 1),
    F] (no smaller than conv1's ring of x tiles, which shares its space)
    and a1 [(tile_rows + 2) * (w + 1) + 2, F] (no smaller than conv3's
    output staging tile, which shares its space), rows padded by 16 bytes."""
    row = 2 * f + 16
    a2 = max(tile_rows * (w + 1) * row, _WGMMA_X_RING)
    a1 = max(((tile_rows + 2) * (w + 1) + 2) * row, _WGMMA_OUT_STAGE)
    return _WGMMA_RING + a2 + a1


def _evened_tile_rows(h: int, w: int, f: int, smem, limit: int) -> int:
    """The most output image rows whose `smem(rows, w, f)` is within
    `limit`, evened over the image's h rows; 0 if not even one fits."""
    most = 0
    while most < h and smem(most + 1, w, f) <= limit:
        most += 1
    if most == 0:
        return 0
    tiles = -(-h // most)
    return -(-h // tiles)


@functools.lru_cache(maxsize=None)
def wgmma_tile_rows(h: int, w: int, f: int, limit: int = SMEM_PER_BLOCK) -> int:
    """Output image rows per block of the tensor-core K5: the most that fit
    in `limit` bytes of shared memory, evened over the image's h rows
    (h = 14: 9 fit, two tiles, so 7 each).  0 if not even one row fits."""
    return _evened_tile_rows(h, w, f, wgmma_bottleneck_smem, limit)


def tf32x3_bottleneck_smem(tile_rows: int, w: int, f: int) -> int:
    """Bytes of shared memory of one block of the f32 tensor-core K5 with
    `tile_rows` rows of x: the weight ring, the warps' rings of x rows, the
    barriers and the alignment slack, and a1 [tile_rows + 2w + 2 + 1, F]
    (the tile, a halo of w + 1 rows each side and the zero row; a2 takes its
    first rows, or at F > 256, where conv2 takes two column passes,
    tile_rows rows of its own) in f32 rows padded by 64 bytes."""
    rows = tile_rows + 2 * w + 3 + (tile_rows if f > 256 else 0)
    return _TF32X3_FIXED + rows * (4 * f + 64)


@functools.lru_cache(maxsize=None)
def tf32x3_tile_rows(h: int, w: int, f: int, limit: int = SMEM_PER_BLOCK) -> int:
    """Rows of x [n*h*w, C] a block of the f32 tensor-core K5 takes (output
    pixels, running across image rows and images, so h does not bound
    them): the most multiples of 64 (the `wgmma` tile) whose shared memory
    fits in `limit` bytes, else the most multiples of 8 (stage 3: 64; stage
    4: 16).  0 if not even 8 fit."""
    most = 0
    while tf32x3_bottleneck_smem(most + 8, w, f) <= limit:
        most += 8
    return most - most % 64 if most >= 64 else most


def tf32x3_plane_floats(c: int, f: int) -> int:
    """f32 of K5's TF32 weight planes at C, F: big and small of w1, w2, w3."""
    return 2 * (2 * c * f + 9 * f * f)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value, ties away from zero (the
    kernels' integer add and mask)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _planes_of(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] as the kernel's tiles of nb = min(N, 256) columns by 16 k:
    column tile by column tile, k by k within one, each the big plane then
    the small one, [nb][16] K-major with the 64-byte swizzle (16-byte chunk
    c of row j at chunk c ^ ((j >> 1) & 3)), place 4c + e of a row holding k
    c + 4e of the tile's 16."""
    k, n = w.shape
    nb = min(n, 256)
    big = _tf32(w)
    small = _tf32(w - big)
    j = torch.arange(nb)[:, None]
    at = torch.arange(4)[None, :] ^ ((j >> 1) & 3)  # where chunk c of row j is stored
    tiles = []
    for plane in (big, small):
        # a tile row's place 4c + e holds k = c + 4e of its 16: [np, kt, j, c, e]
        t = plane.reshape(k // 16, 4, 4, n // nb, nb).permute(3, 0, 4, 2, 1)
        laid = torch.empty_like(t)
        laid[:, :, j, at] = t
        tiles.append(laid.reshape(n // nb, k // 16, nb * 16))
    return torch.cat(tiles, dim=2).reshape(-1)


def tf32x3_weight_planes_reference(w1: torch.Tensor, w2: torch.Tensor,
                                   w3: torch.Tensor) -> torch.Tensor:
    """Plain version of `tf32_weight_planes_kernel`: w1 [C, F], w2 [9, F, F]
    (as [9F, F], its own tap order) and w3 [F, C] in f32 as the planes K5
    reads, [tf32x3_plane_floats(C, F)] f32."""
    f = w1.shape[1]
    return torch.cat([_planes_of(w1.float()), _planes_of(w2.float().reshape(9 * f, f)),
                      _planes_of(w3.float())])


def tf32x3_weight_planes(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """K5's TF32 weight planes (`tf32x3_weight_planes_reference`), on a CUDA
    tensor by the kernel the f32 K5 launches before each bottleneck
    (`macsa_tf32_weight_planes`; counted as "tf32_weight_planes")."""
    if w1.device.type == "cpu":
        return tf32x3_weight_planes_reference(w1, w2, w3)
    return _launch_planes(w1, w2, w3)


@cuda_lib.on_tensor_device
def _launch_planes(w1, w2, w3) -> torch.Tensor:
    c, f = w1.shape
    _check_tensors(torch.float32, [("w1", w1, None, (c, f)), ("w2", w2, None, (9, f, f)),
                                   ("w3", w3, None, (f, c))])
    planes = torch.empty(tf32x3_plane_floats(c, f), device=w1.device)
    status = cuda_lib.library().macsa_tf32_weight_planes(
        w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), planes.data_ptr(), c, f,
        cuda_lib.stream_handle(w1.device))
    cuda_lib.check(status, "macsa_tf32_weight_planes")
    cuda_lib.launch_counts["tf32_weight_planes"] += 1
    return planes


def bottleneck_variant(dtype: torch.dtype, h: int, w: int, c: int, f: int) -> str:
    """Which K5 kernel takes an [n*h*w, c] block of width f on a CUDA
    tensor: with f one of 64, 128, 256, 512 (the ResNet widths) and c a
    multiple of 128, "wgmma" in bf16 where an image row is narrow enough
    for one output row's a1 and a2 to fit in shared memory, and "tf32x3"
    in f32 where a tile of 8 rows with its halo does; else "simt"."""
    if f in WGMMA_F and c >= 128 and c % 128 == 0:
        if dtype == torch.bfloat16 and wgmma_tile_rows(h, w, f) > 0:
            return "wgmma"
        if dtype == torch.float32 and tf32x3_tile_rows(h, w, f) > 0:
            return "tf32x3"
    return "simt"


def _check_aligned(named) -> None:
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the tensor-core kernel")


@cuda_lib.on_tensor_device
def _launch_k4(x2, w, mul, add, residual, relu) -> torch.Tensor:
    m, k = x2.shape
    n = w.shape[-1]
    f32 = torch.float32
    named = [("x2", x2, None, (m, k)), ("w", w, None, (k, n)),
             ("mul", mul, f32, (n,)), ("add", add, f32, (n,))]
    if residual is not None:
        named.append(("residual", residual, None, (m, n)))
    _check_tensors(x2.dtype, named)
    if k == 0:
        raise ValueError(f"empty product [{m}, 0] @ [0, {n}]")
    out = torch.empty(m, n, dtype=x2.dtype, device=x2.device)
    if out.numel() == 0:
        return out
    variant = matmul_variant(x2.dtype, m, n, k)
    pointers = (x2.data_ptr(), w.data_ptr(), mul.data_ptr(), add.data_ptr(),
                None if residual is None else residual.data_ptr(), out.data_ptr())
    stream = cuda_lib.stream_handle(x2.device)
    if variant in ("wgmma", "tf32x3"):
        _check_aligned([("x2", x2), ("w", w)]
                       + ([] if residual is None else [("residual", residual)]))
        entry = getattr(cuda_lib.library(), f"macsa_matmul_bn_act_{variant}")
        status = entry(*pointers, m, n, k, int(relu), stream)
    else:
        status = cuda_lib.library().macsa_matmul_bn_act(
            *pointers, m, n, k, int(relu), int(x2.dtype == torch.bfloat16), stream)
    cuda_lib.check(status, f"macsa_matmul_bn_act ({variant})")
    cuda_lib.launch_counts["fused_matmul_bn_act"] += 1
    cuda_lib.launch_counts[f"fused_matmul_bn_act.{variant}"] += 1
    return out


class _FusedMatmulBnAct(torch.autograd.Function):
    """K4's kernel forward; `fused_matmul_bn_act_backward_reference` as its
    gradient (the custom VJP of the JAX experiment)."""

    @staticmethod
    def forward(ctx, x2, w, mul, add, residual, relu):
        y = _launch_k4(x2, w, mul, add, residual, relu)
        ctx.save_for_backward(x2, w, mul, add, y)
        ctx.has_residual, ctx.relu = residual is not None, relu
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, mul, add, y = ctx.saved_tensors
        grads = fused_matmul_bn_act_backward_reference(x2, w, mul, add, y, g,
                                                       ctx.has_residual, ctx.relu)
        return (*grads, None)


def fused_matmul_bn_act(x2: torch.Tensor, w: torch.Tensor, mul: torch.Tensor,
                        add: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """relu?((x2 @ w) * mul + add [+ residual]): a 1x1 conv over NHWC rows
    with its frozen-BN epilogue.  x2 [M, K]; w [K, N] in x2's dtype;
    mul/add [N] f32; residual [M, N] in x2's dtype or None.  Returns
    [M, N] in x2's dtype, with an f32 product and epilogue.  On a CUDA
    tensor the kernel is the one `matmul_variant(dtype, M, N, K)` names:
    K and N multiples of 64 run on the tensor cores (f32 as three TF32
    products), anything else on the CUDA cores; nothing is tried and
    retried."""
    if x2.device.type == "cpu":
        return fused_matmul_bn_act_reference(x2, w, mul, add, residual, relu)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    _check_dtype(x2)
    inputs = (x2, w, mul, add) + (() if residual is None else (residual,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedMatmulBnAct.apply(x2, w, mul, add, residual, relu)
    return _launch_k4(x2, w, mul, add, residual, relu)


@cuda_lib.on_tensor_device
def _launch_k5(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w) -> torch.Tensor:
    rows, c = x2.shape
    f = w1.shape[-1]
    f32 = torch.float32
    if rows != n * h * w or rows == 0:
        raise ValueError(f"x2 has {rows} rows, not n*h*w = {n}*{h}*{w} > 0")
    _check_tensors(x2.dtype, [
        ("x2", x2, None, (rows, c)), ("w1", w1, None, (c, f)), ("mul1", mul1, f32, (f,)),
        ("add1", add1, f32, (f,)), ("w2", w2, None, (9, f, f)), ("mul2", mul2, f32, (f,)),
        ("add2", add2, f32, (f,)), ("w3", w3, None, (f, c)), ("mul3", mul3, f32, (c,)),
        ("add3", add3, f32, (c,))])
    out = torch.empty_like(x2)
    variant = bottleneck_variant(x2.dtype, h, w, c, f)
    pointers = [t.data_ptr() for t in (x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, out)]
    stream = cuda_lib.stream_handle(x2.device)
    if variant == "wgmma":
        _check_aligned([("x2", x2), ("w1", w1), ("w2", w2), ("w3", w3)])
        status = cuda_lib.library().macsa_fused_bottleneck_wgmma(
            *pointers, n, h, w, c, f, wgmma_tile_rows(h, w, f), stream)
    elif variant == "tf32x3":
        _check_aligned([("x2", x2)])
        # the weights' TF32 planes, written by the entry's first kernel
        planes = torch.empty(tf32x3_plane_floats(c, f), device=x2.device)
        status = cuda_lib.library().macsa_fused_bottleneck_tf32x3(
            *pointers, planes.data_ptr(), n, h, w, c, f, tf32x3_tile_rows(h, w, f), stream)
    else:
        status = cuda_lib.library().macsa_fused_bottleneck(
            *pointers, n, h, w, c, f, int(x2.dtype == torch.bfloat16), stream)
    cuda_lib.check(status, f"macsa_fused_bottleneck ({variant})")
    cuda_lib.launch_counts["fused_bottleneck"] += 1
    cuda_lib.launch_counts[f"fused_bottleneck.{variant}"] += 1
    return out


class _FusedBottleneck(torch.autograd.Function):
    """K5's kernel forward; autograd through `bottleneck_reference` as its
    gradient (the JAX `_bneck_bwd`)."""

    @staticmethod
    def forward(ctx, x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w):
        ctx.save_for_backward(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3)
        ctx.geometry = (n, h, w)
        return _launch_k5(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:10]
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = bottleneck_reference(*leaves, *ctx.geometry)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if need else None for need in needs), None, None, None)


# K5's forward without autograd as a registered op (the library object
# and the reason for it: `ops/fused_attention.py`)
OPS.define("fused_bottleneck(Tensor x2, Tensor w1, Tensor mul1, Tensor add1, Tensor w2, "
           "Tensor mul2, Tensor add2, Tensor w3, Tensor mul3, Tensor add3, int n, int h, "
           "int w) -> Tensor")
OPS.impl("fused_bottleneck", bottleneck_reference, "CPU")


def _bottleneck_op_cuda(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w):
    _check_dtype(x2)
    return _launch_k5(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w)


OPS.impl("fused_bottleneck", _bottleneck_op_cuda, "CUDA")


@torch.library.register_fake("macsa_tpu_torch::fused_bottleneck")
def _bottleneck_op_fake(x2, w1, mul1, add1, w2, mul2, add2, w3, mul3, add3, n, h, w):
    return torch.empty_like(x2)


bottleneck_op = torch.ops.macsa_tpu_torch.fused_bottleneck.default


def fused_bottleneck(x2: torch.Tensor, w1: torch.Tensor, mul1: torch.Tensor,
                     add1: torch.Tensor, w2: torch.Tensor, mul2: torch.Tensor,
                     add2: torch.Tensor, w3: torch.Tensor, mul3: torch.Tensor,
                     add3: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """One ResNet bottleneck (stride 1, identity shortcut) over NHWC rows:
    relu(bn3(conv3(relu(bn2(conv2(relu(bn1(conv1(x)))))))) + x).

    x2 [n*h*w, C]; w1 [C, F], w2 [9, F, F], w3 [F, C], cast to x2's dtype
    here (differentiably, as `_bneck_fwd` casts them); mul*/add* the f32 BN
    affines.  Returns [n*h*w, C] in x2's dtype.  On a CUDA tensor the
    kernel is the one `bottleneck_variant(dtype, h, w, C, F)` names: F in
    64/128/256/512 and C a multiple of 128 (every ResNet stage) run on the
    tensor cores (f32 as three TF32 products), anything else on the CUDA
    cores.  Without autograd the call is the registered op `bottleneck_op`."""
    dt = x2.dtype
    weights = (w1.to(dt).contiguous(), w2.to(dt).contiguous(), w3.to(dt).contiguous())
    affines = tuple(t.float().contiguous() for t in (mul1, add1, mul2, add2, mul3, add3))
    args = (x2, weights[0], *affines[0:2], weights[1], *affines[2:4], weights[2], *affines[4:6])
    if x2.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if x2.device.type == "cpu":
            return bottleneck_reference(*args, n, h, w)
        _check_dtype(x2)
        return _FusedBottleneck.apply(*args, n, h, w)
    return bottleneck_op(*args, n, h, w)
