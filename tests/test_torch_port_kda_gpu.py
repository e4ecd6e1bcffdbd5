"""The chunked KDA core's kernels (`csrc/kda_core.cu`, through
`ops/kda.KDACore`) on the card, against their plain versions
(`ops/kda.subchunk_kda`, `chunk_kda`, `chunk_kda_backward`).

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the card's machine has none):

    python -m pytest tests/test_torch_port_kda_gpu.py -m gpu --noconftest -q -s

Each check reads the largest gap of an output over its largest value.
Tolerances: f32 outputs 1e-4 (both sides are f32, the kernels' products
FFMA sums in another order than the plain versions', over sums of 64 to
192 terms, a triangular solve and three chunks of the state); outputs in
bf16 (o, and dq, dk, dv for bf16 inputs) 1e-2: both sides round to bf16,
whose step is 2^-8 of a value.
"""

import json

import pytest
import torch

from macsa_tpu_torch.ops import cuda_lib, kda

pytestmark = pytest.mark.gpu
F32_TOL, BF16_TOL = 1e-4, 1e-2
STEEP = (5, 6, 7, 60, 61, 62, 63, 64, 100, 101, 102)  # 3+ steps in a row, across sub-chunks and chunks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def inputs(shape, dtype, device, steep, seed=0):
    """q, k, v [B, L, H, D] in `dtype`, g (f32, -11 to 0 a step; with
    `steep`, -30 to -200 on the STEEP positions), beta [B, L, H] f32."""
    b, l, h, d = shape
    gen = torch.Generator(device).manual_seed(seed)
    q, k, v = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(3))
    g = -11 * torch.rand(shape, device=device, generator=gen)
    if steep:
        at = [t for t in STEEP if t < l]
        g[:, at] = -30 - 170 * torch.rand(b, len(at), h, d, device=device, generator=gen)
    return q, k, v, g, torch.rand(b, l, h, device=device, generator=gen)


def gap(got, want) -> float:
    """The largest gap over the largest value, read against 1e-3 where all
    values are smaller (dg at length 1, where g moves nothing: rounding
    noise on both sides)."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-3))


def run_core(q, k, v, g, beta, do, out_dtype):
    """The kernels forward and backward through `KDACore`: (o, grads)."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v, g, beta)]
    o = kda.KDACore.apply(*leaves, out_dtype)
    o.backward(do.to(o.dtype))
    return o, [t.grad for t in leaves]


def check(q, k, v, g, beta, out_dtype, steep):
    gen = torch.Generator(q.device).manual_seed(7)
    do = torch.randn(q.shape, device=q.device, generator=gen)
    cuda_lib.reset_launch_counts()
    o, grads = run_core(q, k, v, g, beta, do, out_dtype)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launch_counts) == {"kda_fwd": 1, "kda_bwd": 1}
    want = kda.subchunk_kda(q, k, v, g, beta, out_dtype)
    wgrads = kda.chunk_kda_backward(q, k, v, g, beta, do.to(out_dtype))
    plain = kda.chunk_kda(q, k, v, g, beta, out_dtype)
    gaps = {"o": gap(o, want)}
    if steep and q.shape[1] > STEEP[2]:  # outside `chunk_kda`'s envelope: it overflows
        assert not torch.isfinite(plain).all()
    else:
        gaps["o_chunk_kda"] = gap(o, plain)
    for name, a, w in zip(["dq", "dk", "dv", "dg", "dbeta"], grads, wgrads):
        assert a.dtype == w.dtype and torch.isfinite(a).all(), name
        gaps[name] = gap(a, w)
    print(json.dumps({"shape": list(q.shape), "dtype": str(q.dtype), "steep": steep,
                      "gaps": gaps}))
    low = {"o", "o_chunk_kda"} if out_dtype == torch.bfloat16 else set()
    if q.dtype == torch.bfloat16:
        low |= {"dq", "dk", "dv"}
    for name, value in gaps.items():
        assert value < (BF16_TOL if name in low else F32_TOL), (name, value)


@pytest.mark.parametrize("steep", [False, True])
@pytest.mark.parametrize("length", [1, 17, 64, 65, 170])
def test_kernels_match_the_plain_versions(cuda, length, steep):
    check(*inputs((3, length, 2, 128), torch.float32, cuda, steep), torch.float32, steep)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steep", [False, True])
def test_kernels_at_the_cells_shape(cuda, steep, out_dtype):
    """[48, 170, 32, 128] with q, k, v in bf16 and g, beta in f32, as the
    Kimi-Linear cell's 20 KDA layers run it."""
    check(*inputs((48, 170, 32, 128), torch.bfloat16, cuda, steep), out_dtype, steep)


def test_a_cuda_call_never_reaches_the_plain_core(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached the plain core")

    for name in ("chunk_kda", "chunk_kda_backward", "subchunk_kda", "_subchunk_parts"):
        monkeypatch.setattr(kda, name, refuse)
    q, k, v, g, beta = inputs((2, 40, 2, 128), torch.bfloat16, cuda, False)
    cuda_lib.reset_launch_counts()
    o, grads = run_core(q, k, v, g, beta, torch.ones_like(q), torch.bfloat16)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in [o, *grads])
    assert dict(cuda_lib.launch_counts) == {"kda_fwd": 1, "kda_bwd": 1}
