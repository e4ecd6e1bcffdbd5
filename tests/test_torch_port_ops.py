"""The port's kernel modules against the JAX package's.

Inputs are made from a seed with numpy and fed to both sides.  The JAX
side runs as the JAX tests run it on the CPU: the Pallas kernels in
interpret mode, and the XLA packed-frame path.  On the CPU the port's
wrappers run their kernels' plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card by
`tests/test_torch_port_gpu.py` and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.ops import fused_attention as jfa
from macsa_tpu.ops import image_prep as jip
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.ops import fused_attention as tfa
from macsa_tpu_torch.ops import image_prep as tip

B, L, H, D = 2, 40, 4, 8  # L is not a multiple of 16
MASKS = {"neg10000": -10000.0, "finfo_min": float(np.finfo(np.float32).min)}


def _qkv_mask(rng, b=B, l=L, h=H, d=D, neg=-10000.0, valid=(L, 23)):
    q, k, v = (rng.normal(size=(b, l, h * d)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, l), np.float32)
    for i, n in enumerate(valid):
        mask[i, n:] = neg  # padded keys
    return q, k, v, mask


def _jax_attention(q, k, v, mask, dtype):
    out = jfa.fused_self_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(mask), jnp.zeros((1,), jnp.int32), H, 0.0, True)
    return np.asarray(out.astype(jnp.float32))


def _torch_attention(q, k, v, mask, dtype):
    out = tfa.fused_self_attention(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                   torch.from_numpy(mask), H)
    assert out.dtype == dtype and out.shape == (B, L, H * D)
    return out.float().numpy()


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
def test_attention_plain_matches_jax_kernel_f32(rng, mask_kind):
    q, k, v, mask = _qkv_mask(rng, neg=MASKS[mask_kind])
    np.testing.assert_allclose(_torch_attention(q, k, v, mask, torch.float32),
                               _jax_attention(q, k, v, mask, jnp.float32),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask_kind", sorted(MASKS))
def test_attention_plain_matches_jax_kernel_bf16(rng, mask_kind):
    # atol 2e-2: the plain version rounds the scores to bf16 (they leave the
    # matmul in the operand dtype), the TPU kernel keeps them in f32
    q, k, v, mask = _qkv_mask(rng, neg=MASKS[mask_kind])
    np.testing.assert_allclose(_torch_attention(q, k, v, mask, torch.bfloat16),
                               _jax_attention(q, k, v, mask, jnp.bfloat16),
                               rtol=0, atol=2e-2)


def test_attention_padded_keys_are_dropped(rng):
    """Keys behind the mask do not reach the output: changing them changes
    nothing (finfo.min mask)."""
    q, k, v, mask = _qkv_mask(rng, neg=MASKS["finfo_min"])
    out = _torch_attention(q, k, v, mask, torch.float32)
    k2, v2 = k.copy(), v.copy()
    k2[1, 23:], v2[1, 23:] = 50.0, 1e3
    np.testing.assert_allclose(_torch_attention(q, k2, v2, mask, torch.float32), out,
                               rtol=0, atol=1e-6)


def test_attention_cpu_wrapper_launches_nothing_and_rejects_dropout(rng):
    """On the CPU the wrapper runs the plain version, with dropout too, and
    launches nothing; a rate outside [0, 1) is rejected."""
    q, k, v, mask = (torch.from_numpy(x).requires_grad_(True) for x in _qkv_mask(rng))
    cuda_lib.reset_launch_counts()
    tfa.fused_self_attention(q, k, v, mask.detach(), H)
    tfa.fused_self_attention(q, k, v, mask.detach(), H, rate=0.1, seed=3).sum().backward()
    assert not cuda_lib.launch_counts
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            tfa.fused_self_attention(q, k, v, mask.detach(), H, rate=rate)


def _frames(rng, lead=(2, 3), size=8):
    images = rng.integers(0, 256, size=lead + (size, size, 3), dtype=np.uint8)
    valid = np.ones(lead, bool)
    valid[1, 2] = False  # an empty image slot
    return images, valid


def test_pack_pixels_matches_jax_bytes(rng):
    images, valid = _frames(rng)
    np.testing.assert_array_equal(tip.pack_pixels_u8(images, valid),
                                  jip.pack_pixels_u8(images, valid).view(np.int32))
    assert tip.frame_size(tip.packed_words_per_frame(224)) == 224
    with pytest.raises(ValueError):
        tip.frame_size(100)


# f32: at most ~1 ulp (the JAX formula may be FMA-contracted by XLA);
# bf16: at most 1 bf16 ulp at |y| <= 2.7 for the same reason
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 1.6e-2)])
def test_unpack_normalize_matches_jax(rng, dtype, atol):
    images, valid = _frames(rng)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jip.unpack_normalize_pixels(jnp.asarray(jip.pack_pixels_u8(images, valid)),
                                       image_size=8, out_dtype=jdtype)
    got = tip.device_normalize(torch.from_numpy(tip.pack_pixels_u8(images, valid)), dtype)
    assert got.dtype == dtype and got.shape == images.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)), rtol=0, atol=atol)
    assert not got[1, 2].any()  # the invalid frame is exact zeros
    assert got[0, 0].any()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-6), (torch.bfloat16, 1.6e-2)])
def test_normalize_u8_matches_jax_kernel_and_reference(rng, dtype, atol):
    images, _ = _frames(rng)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = tip.device_normalize(torch.from_numpy(images), dtype)
    assert got.dtype == dtype
    got = got.float().numpy()
    for want in (jip.normalize_images_u8(jnp.asarray(images), jdtype, interpret=True),
                 jip.normalize_images_u8_reference(jnp.asarray(images), jdtype)):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=0, atol=atol)


def test_device_normalize_casts_floats_and_rejects_other_dtypes():
    x = torch.linspace(-1, 1, 24).reshape(2, 2, 2, 3)
    assert tip.device_normalize(x, torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        tip.device_normalize(x.to(torch.int64), torch.float32)


def test_build_without_nvcc_raises(tmp_path):
    with pytest.raises(RuntimeError, match="could not run"):
        cuda_lib.build_library(tmp_path, nvcc=str(tmp_path / "no-nvcc"))

