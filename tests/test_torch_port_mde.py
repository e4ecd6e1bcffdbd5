"""The port's Multimodal Denoising Encoder against the JAX package's.

Parameters are made in JAX and carried over by `jax_import`; both sides
run the same numpy inputs in f32.  Held: `top_k_indices` against
`jax.lax.top_k` on rows full of ties; the MDE's output and its gradients
at alpha 0.7 and 1.0, on random patches, on patches whose guidance scores
tie (the strong and weak sets then overlap, as in JAX), and on all-zero
patches (finite gradients, as `tests/test_mde.py` asks of JAX); the FCMF
forward and one train step's loss with the MDE; and both drivers with
`--use_mde --alpha 0.7`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.mde import MultimodalDenoisingEncoder as JMDE
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.mde import MultimodalDenoisingEncoder as TMDE
from macsa_tpu_torch.models.mde import top_k_indices
from macsa_tpu_torch.train import finetune, jax_import, pretrain
from test_torch_port_models import L, VOCAB, jinit, model_cfgs, randomize, text_cfgs

H, HEADS, N = 32, 4, 10
JCFG = jcfg.ModelConfig(hidden_size=H, num_attention_heads=HEADS)
TCFG = tcfg.ModelConfig(hidden_size=H, num_attention_heads=HEADS)


def test_top_k_indices_orders_ties_as_jax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, size=(50, 13)).astype(np.float32)  # ties everywhere
    for k in (1, 5, 9, 13):
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
        np.testing.assert_array_equal(top_k_indices(torch.from_numpy(scores), k).numpy(), want)
        want = np.asarray(jax.lax.top_k(-jnp.asarray(scores), k)[1])
        np.testing.assert_array_equal(top_k_indices(-torch.from_numpy(scores), k).numpy(), want)


def _pair(alpha, rng):
    mde = JMDE(JCFG, alpha=alpha)
    text = rng.normal(size=(2, 5, H)).astype(np.float32)
    img = rng.normal(size=(2, N, H)).astype(np.float32)
    params = randomize(jinit(mde, text, img), rng)
    port = TMDE(TCFG, alpha)
    port.load_state_dict(jax_import.mde_state_dict_from_jax(params["params"]), strict=True)
    return mde, params, port, text


def _run_both(mde, params, port, text, img, g):
    """Outputs and the gradients of <out, g> w.r.t. (text, img), both sides."""
    def f(t, x):
        return jnp.sum(mde.apply(params, t, x) * g)

    want = mde.apply(params, jnp.asarray(text), jnp.asarray(img))
    want_grads = jax.grad(f, argnums=(0, 1))(jnp.asarray(text), jnp.asarray(img))
    t, x = (torch.from_numpy(a).requires_grad_(True) for a in (text, img))
    out = port(t, x)
    (out * torch.from_numpy(g)).sum().backward()
    # the text only picks indices: no gradient reaches it (zeros in JAX)
    got_grads = [np.zeros(a.shape, np.float32) if a.grad is None else a.grad.numpy()
                 for a in (t, x)]
    return out.detach().numpy(), got_grads, np.asarray(want), [np.asarray(w) for w in want_grads]


def _patches(kind, rng):
    if kind == "random":
        return rng.normal(size=(2, N, H)).astype(np.float32)
    if kind == "tied":
        # repeated patches score equally: sample 0 has ties across the
        # strong/weak boundary, sample 1 is one patch ten times (all tie)
        base = rng.normal(size=(2, 4, H)).astype(np.float32)
        return np.stack([base[0, [0, 1, 2, 0, 1, 2, 3, 3, 1, 2]], base[1, [0] * N]])
    return np.zeros((2, N, H), np.float32)


@pytest.mark.parametrize("kind", ["random", "tied", "zeros"])
@pytest.mark.parametrize("alpha", [0.7, 1.0])
def test_mde_matches_jax(rng, alpha, kind):
    mde, params, port, text = _pair(alpha, rng)
    img = _patches(kind, rng)
    k = max(1, int(N * alpha))
    g = rng.normal(size=(2, k, H)).astype(np.float32)
    got, got_grads, want, want_grads = _run_both(mde, params, port, text, img, g)
    assert got.shape == want.shape == (2, k, H)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for name, x, w in zip(("text", "patches"), got_grads, want_grads):
        assert np.isfinite(x).all(), name
        np.testing.assert_allclose(x, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    if kind == "tied" and alpha < 1:
        # sample 1: every score ties, so the strong set is patches 0..6 and
        # the weak set 0..2, as JAX's two top_k calls pick them
        scores = torch.full((1, N), 0.1)
        assert top_k_indices(scores, k).tolist() == [list(range(k))]
        assert top_k_indices(-scores, N - k).tolist() == [list(range(N - k))]


def _fcmf_pair(rng, alpha=0.7):
    jm, tm = model_cfgs()
    jt, tt = text_cfgs()
    kw = dict(num_imgs=2, num_roi=2, num_patches=7, visual_feat_dim=64, max_text_len=L,
              box_heads=8, use_mde=True, alpha=alpha)
    model = JFCMF(jcfg.FCMFConfig(model=jm, text=jt, **kw))
    ids = rng.integers(2, VOCAB, size=(2, L)).astype(np.int32)
    grid = rng.normal(size=(2, 2, 7, 64)).astype(np.float32)
    roi = rng.normal(size=(2, 2, 2, 64)).astype(np.float32)
    coors = rng.uniform(size=(2, 2, 2, 4)).astype(np.float32)
    attn, added = np.ones_like(ids), np.ones((2, L + 7), np.int32)
    inputs = (ids, grid, roi, coors, None, attn, added)
    params = randomize(jinit(model, *inputs)["params"], rng)
    port = TFCMF(tcfg.FCMFConfig(model=tm, text=tt, **kw))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    return model, params, port, inputs


def test_fcmf_with_the_mde_matches_jax(rng):
    """The forward's logits and a CE loss's gradients w.r.t. every parameter."""
    model, params, port, inputs = _fcmf_pair(rng)
    assert port.encoder.mde is not None
    labels = np.asarray([1, 3])
    t_inputs = [None if x is None else torch.from_numpy(x) for x in inputs]

    def loss_fn(p):
        logits = model.apply({"params": p}, *[None if x is None else jnp.asarray(x)
                                              for x in inputs])
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1).mean(), logits

    (want_loss, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port.eval()
    logits = port(*t_inputs)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_sd = jax_import.fcmf_state_dict_from_jax(grads, 2)
    for name, p in port.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want_sd[name].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-2),
                                   err_msg=name)
    # the guidance attention only picks indices: no gradient on either side
    assert all(p.grad is None for p in port.encoder.mde.parameters())


def test_both_drivers_run_with_the_mde(tmp_path):
    from macsa_tpu_torch.data import synth
    from test_torch_port_finetune import _argv as ft_argv
    from test_torch_port_finetune import small_hook as ft_hook
    from test_torch_port_pretrain import _argv as pt_argv
    from test_torch_port_pretrain import small_hook as pt_hook
    data = str(tmp_path / "synth")
    synth.write_dataset(data)
    built = []

    def watch(hook):
        def wrapped(*cfgs):
            out = hook(*cfgs)
            built.append(out[0])
            return out
        return wrapped

    ft = finetune.main(ft_argv(data, tmp_path / "ft", "--do_train", "--use_mde", "--alpha",
                               "0.7", epochs=1), config_hook=watch(ft_hook()))
    pt = pretrain.main(pt_argv(data, tmp_path / "pt", "--do_train", "--use_mde", "--alpha",
                               "0.7", epochs=1), config_hook=watch(pt_hook()))
    assert [c.use_mde and c.alpha == 0.7 for c in built] == [True, True]
    assert np.isfinite(ft["epochs"][0]["losses"]).all()
    assert np.isfinite(pt["epochs"][0]["losses"]).all()
    sd = torch.load(tmp_path / "ft" / "last.pt", map_location="cpu", weights_only=True)["model"]
    assert "encoder.mde.guidance_attention.w_kx" in sd
