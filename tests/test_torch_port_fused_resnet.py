"""The port's fused-ResNet kernels (K4, K5) and backbone runner against the
JAX experiment (`tools_dev/fused_resnet_experiment.py`).

The JAX kernels run in interpret mode on the CPU; the port runs its plain
versions, as every CPU tensor does.  K4 on the grid of
`tests/test_fused_conv.py`, its backward reference against `jax.grad`;
K5 at tiny shapes, square and not; the runner and `extract_features`
against JAX's `run_backbone`/`extract_features` with stages (1, 2) fused,
and the parameter gradients through both runners.  Weights and frozen-BN
statistics are carried across by `jax_import.visual_state_dict_from_jax`.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.config import ResNetConfig as JResNetConfig
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu_torch.config import ResNetConfig as TResNetConfig
from macsa_tpu_torch.models import fused_backbone
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.ops import fused_resnet as tfr
from macsa_tpu_torch.train import jax_import

_spec = importlib.util.spec_from_file_location(
    "fused_resnet_experiment",
    os.path.join(os.path.dirname(__file__), os.pardir, "tools_dev",
                 "fused_resnet_experiment.py"))
jfr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jfr)

TINY_KW = dict(stage_sizes=(2, 1), num_filters=8, grid_size=1, dtype="float32")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _k4_inputs(rng, m, k, n, has_res):
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((m, k), (k, n), (n,), (n,))]
    res = rng.normal(size=(m, n)).astype(np.float32) if has_res else None
    return arrays, res


@pytest.mark.parametrize("m", [16, 300, 512])
@pytest.mark.parametrize("has_res,relu", [(True, True), (False, True), (True, False)])
def test_k4_matches_jax(rng, m, has_res, relu):
    (x2, w, mul, add), res = _k4_inputs(rng, m, 24, 40, has_res)
    want = jfr.fused_matmul_bn_act(*map(jnp.asarray, (x2, w, mul, add)),
                                   None if res is None else jnp.asarray(res), relu, True)
    got = tfr.fused_matmul_bn_act(*map(_t, (x2, w, mul, add)),
                                  None if res is None else _t(res), relu)
    assert got.shape == (m, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("has_res", [True, False])
def test_k4_backward_reference_matches_jax_grad(rng, has_res):
    (x2, w, mul, add), res = _k4_inputs(rng, 48, 16, 24, has_res)
    args = [x2, w, mul, add] + ([res] if has_res else [])

    def loss(*a):
        r = a[4] if has_res else None
        return (jfr.fused_matmul_bn_act(*a[:4], r, True, True) ** 2).sum()

    wants = jax.grad(loss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    tx2, tw, tmul, tadd = map(_t, (x2, w, mul, add))
    y = tfr.fused_matmul_bn_act_reference(tx2, tw, tmul, tadd, _t(res) if has_res else None)
    gots = tfr.fused_matmul_bn_act_backward_reference(tx2, tw, tmul, tadd, y, 2 * y,
                                                      has_res, True)
    assert (gots[4] is None) == (not has_res)
    for name, got, want in zip(("dx2", "dw", "dmul", "dadd", "dres"), gots, wants):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3,
                                   err_msg=name)
    # on the CPU the wrapper is the plain version under autograd: the same gradients
    leaves = [_t(a).requires_grad_(True) for a in args]
    out = tfr.fused_matmul_bn_act(*leaves[:4], leaves[4] if has_res else None)
    for name, got, want in zip(("dx2", "dw", "dmul", "dadd", "dres"),
                               torch.autograd.grad((out ** 2).sum(), leaves), wants):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3,
                                   err_msg=name)


def _k5_inputs(rng, n, h, w, c, f):
    x2 = np.maximum(rng.normal(size=(n * h * w, c)), 0.0).astype(np.float32)
    w1 = rng.normal(0, c ** -0.5, size=(c, f)).astype(np.float32)
    w2 = rng.normal(0, (9 * f) ** -0.5, size=(9, f, f)).astype(np.float32)
    w3 = rng.normal(0, f ** -0.5, size=(f, c)).astype(np.float32)
    affine = [(rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32),
               rng.normal(0, 0.1, size=(k,)).astype(np.float32)) for k in (f, f, c)]
    return [x2, w1, *affine[0], w2, *affine[1], w3, *affine[2]]


@pytest.mark.parametrize("n,h,w", [(2, 8, 8), (2, 6, 10)])
def test_k5_matches_jax(rng, n, h, w):
    args = _k5_inputs(rng, n, h, w, 32, 8)
    want = jfr.fused_bottleneck(*map(jnp.asarray, args), n, h, w, True)
    got = tfr.fused_bottleneck(*map(_t, args), n, h, w)
    assert got.shape == (n * h * w, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_k5_gradients_match_jax(rng):
    n, h, w = 2, 6, 10
    args = _k5_inputs(rng, n, h, w, 32, 8)
    wants = jax.grad(lambda *a: (jfr.fused_bottleneck(*a, n, h, w, True) ** 2).sum(),
                     argnums=tuple(range(10)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    gots = torch.autograd.grad((tfr.fused_bottleneck(*leaves, n, h, w) ** 2).sum(), leaves)
    for i, (got, want) in enumerate(zip(gots, wants)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3,
                                   err_msg=f"argument {i}")


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny backbone of `tests/test_fused_conv.py` (jittered
    parameters and BN statistics) and the port's module holding them."""
    cfg = JResNetConfig(**TINY_KW)
    visual = JVisual(cfg)
    variables = jax.jit(visual.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    def jitter(path, x):
        return x + 0.1 * jnp.asarray(
            np.random.default_rng(len(str(path))).normal(size=x.shape), x.dtype)

    variables = {"params": jax.tree_util.tree_map_with_path(jitter, variables["params"])}
    port = TVisual(TResNetConfig(**TINY_KW))
    port.load_state_dict(jax_import.visual_state_dict_from_jax(variables["params"]),
                         strict=True)
    return cfg, variables, port


def test_run_backbone_matches_jax(rng, tiny_pair):
    cfg, variables, port = tiny_pair
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = jfr.run_backbone(variables, jnp.asarray(x), cfg, stages=(1, 2), interpret=True)
    got = fused_backbone.run_backbone(port, _t(x), stages=(1, 2))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # with no stage fused it is the module's own forward
    plain = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(fused_backbone.run_backbone(port, _t(x), stages=()), plain)


def test_extract_features_matches_jax(rng, tiny_pair):
    cfg, variables, port = tiny_pair
    b, i, r = 2, 3, 2
    imgs = rng.normal(size=(b, i, 32, 32, 3)).astype(np.float32)
    rois = rng.normal(size=(b, i, r, 32, 32, 3)).astype(np.float32)
    want_grid, want_roi = jfr.extract_features(variables, jnp.asarray(imgs), jnp.asarray(rois),
                                               cfg, stages=(1, 2), interpret=True)
    grid, roi = fused_backbone.extract_features(port, _t(imgs), _t(rois), stages=(1, 2))
    assert tuple(grid.shape) == want_grid.shape and tuple(roi.shape) == want_roi.shape
    np.testing.assert_allclose(grid.detach().numpy(), np.asarray(want_grid), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(roi.detach().numpy(), np.asarray(want_roi), rtol=1e-4,
                               atol=1e-4)
    # and they are the port's VisualFeatures heads
    torch.testing.assert_close(grid, port.grid_features(_t(imgs)), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(roi, port.pooled_features(_t(rois)), rtol=1e-5, atol=1e-5)


def test_backbone_gradients_match_jax(rng, tiny_pair):
    """Gradients of every parameter and frozen statistic through the runner
    (the fused blocks' backward included), against JAX's runner."""
    cfg, variables, port = tiny_pair
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = jax.grad(lambda v: (jfr.run_backbone(v, jnp.asarray(x), cfg, (1, 2), True)
                               ** 2).sum())(variables)
    want = jax_import.visual_state_dict_from_jax(want["params"])
    tensors = dict(port.named_parameters())
    tensors.update(port.named_buffers())
    try:
        for t in tensors.values():
            t.requires_grad_(True)
        loss = (fused_backbone.run_backbone(port, _t(x), stages=(1, 2)) ** 2).sum()
        grads = dict(zip(tensors, torch.autograd.grad(loss, list(tensors.values()))))
    finally:
        for t in port.buffers():
            t.requires_grad_(False)
    assert grads.keys() == want.keys()
    for name, got in grads.items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=name)
