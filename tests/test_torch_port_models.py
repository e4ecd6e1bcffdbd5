"""The port's model modules against the JAX package's, one test per module.

Parameters are initialised in JAX (then randomised from a numpy seed so
that biases, LayerNorm scales and BatchNorm statistics are not trivial),
carried across by `macsa_tpu_torch.train.jax_import`, and both sides run
the same numpy inputs in float32 (atol 1e-4).  The bridge is held in both
directions: the JAX package's own importers read the port's state dicts
back to the same parameters.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models import layers as jlayers
from macsa_tpu.models.box_attention import BoxMultiHeadedAttention as JBox
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.models.resnet import import_torchvision_resnet
from macsa_tpu.models.text_encoder import TextEncoder as JTextEncoder
from macsa_tpu.train import torch_import
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models import layers as tlayers
from macsa_tpu_torch.models.box_attention import BoxMultiHeadedAttention as TBox
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.models.text_encoder import TextEncoder as TTextEncoder
from macsa_tpu_torch.train import jax_import

ATOL = 1e-4
HIDDEN, HEADS, FFN, VOCAB, L = 32, 4, 64, 64, 40


def model_cfgs(fused=False):
    """(JAX, port) ModelConfig pair at a small width."""
    kw = dict(hidden_size=HIDDEN, num_hidden_layers=2, num_attention_heads=HEADS,
              intermediate_size=FFN, fused_attention=fused)
    return (jcfg.ModelConfig(fused_attention_interpret=fused, **kw),
            tcfg.ModelConfig(**kw))


def text_cfgs(fused=False):
    kw = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=2,
              num_attention_heads=HEADS, intermediate_size=FFN,
              max_position_embeddings=64, fused_attention=fused)
    return (jcfg.TextEncoderConfig(fused_attention_interpret=fused, **kw),
            tcfg.TextEncoderConfig(**kw))


def randomize(params, rng):
    """Replace the deterministic initial values (zero biases and means,
    unit scales and variances) with seeded random ones, and draw dense
    kernels at unit gain (1/sqrt(fan_in)) so that every branch, the visual
    ones included, moves the outputs well above the tolerance.  Conv
    kernels and embeddings keep flax's random draws."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, size=x.shape).astype(np.float32)
        if name == "kernel" and x.ndim == 2:
            return rng.normal(0.0, x.shape[0] ** -0.5, size=x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, params)


def jinit(mod, *args):
    """Flax init under one jit (op-by-op init compiles every op apart)."""
    return jax.jit(mod.init)(jax.random.PRNGKey(0), *args)


def japply(mod, params, *args, **kw):
    return jax.jit(functools.partial(mod.apply, **kw))(params, *args)


def additive_mask(valid_lens, length, neg=-10000.0):
    m = np.zeros((len(valid_lens), 1, 1, length), np.float32)
    for i, n in enumerate(valid_lens):
        m[i, ..., n:] = neg
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_config_fields_and_defaults_match_jax():
    """Every field the port keeps has the JAX default, except
    `fused_attention`, which the port turns on."""
    for jc, tc in ((jcfg.ModelConfig, tcfg.ModelConfig),
                   (jcfg.TextEncoderConfig, tcfg.TextEncoderConfig),
                   (jcfg.FCMFConfig, tcfg.FCMFConfig),
                   (jcfg.ResNetConfig, tcfg.ResNetConfig)):
        jdefault, tdefault = jc(), tc()
        jnames = {f.name for f in dataclasses.fields(jc)}
        for f in dataclasses.fields(tc):
            assert f.name in jnames, (tc.__name__, f.name)
            if f.name in ("fused_attention", "model", "text"):
                continue
            assert getattr(tdefault, f.name) == getattr(jdefault, f.name), f.name
        assert tdefault.__class__.__name__ == jdefault.__class__.__name__
    assert tcfg.ModelConfig().fused_attention and tcfg.TextEncoderConfig().fused_attention
    assert tcfg.ASPECTS == jcfg.ASPECTS and tcfg.POLARITIES == jcfg.POLARITIES


def test_layer_norm_tf(rng):
    x = rng.normal(size=(2, 5, HIDDEN)).astype(np.float32) * 3 + 1
    mod = jlayers.LayerNormTF(epsilon=1e-12)
    params = randomize(jinit(mod, x), rng)
    want = japply(mod, params, x)
    ln = tlayers.LayerNormTF(HIDDEN, 1e-12)
    ln.load_state_dict(jax_import.layer_norm_state_dict(params["params"]))
    _close(ln(_t(x)), want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("num_query_tokens", [None, 1])
def test_bert_layer(rng, fused, num_query_tokens):
    jc, tc = model_cfgs(fused)
    x = rng.normal(size=(2, L, HIDDEN)).astype(np.float32)
    mask = additive_mask((L, 27), L)
    mod = jlayers.BertLayer(jc)
    params = randomize(jinit(mod, x, mask), rng)
    want = japply(mod, params, x, mask, num_query_tokens=num_query_tokens)
    layer = tlayers.BertLayer(tc)
    layer.load_state_dict(jax_import.bert_block_state_dict(params["params"]))
    _close(layer(_t(x), _t(mask), num_query_tokens), want)


def test_bert_cross_attention_layer(rng):
    jc, tc = model_cfgs()
    s1 = rng.normal(size=(3, 1, HIDDEN)).astype(np.float32)
    s2 = rng.normal(size=(3, 6, HIDDEN)).astype(np.float32)
    mask = additive_mask((6, 4, 1), 6)
    mod = jlayers.BertCrossAttentionLayer(jc)
    params = randomize(jinit(mod, s1, s2, mask), rng)
    want = japply(mod, params, s1, s2, mask)
    layer = tlayers.BertCrossAttentionLayer(tc)
    layer.load_state_dict(jax_import.bert_block_state_dict(params["params"]))
    _close(layer(_t(s1), _t(s2), _t(mask)), want)


@pytest.mark.parametrize("fused", [False, True])
def test_text_encoder(rng, fused):
    jc, tc = text_cfgs(fused)
    ids = rng.integers(2, VOCAB, size=(2, L)).astype(np.int32)
    attn = np.ones((2, L), np.int32)
    ids[1, 30:], attn[1, 30:] = jc.pad_token_id, 0  # a padded view
    types = np.zeros_like(ids)
    mod = JTextEncoder(jc)
    params = randomize(jinit(mod, ids, types, attn), rng)
    want_seq, want_pooled = japply(mod, params, ids, types, attn)
    enc = TTextEncoder(tc)
    enc.load_state_dict(jax_import.text_encoder_state_dict_from_jax(params["params"], 2))
    seq, pooled = enc(_t(ids), _t(types), _t(attn))
    _close(seq, want_seq)
    _close(pooled, want_pooled)


def test_box_multi_headed_attention(rng):
    x = rng.normal(size=(3, 4, HIDDEN)).astype(np.float32)
    boxes = rng.uniform(0, 1, size=(3, 4, 4)).astype(np.float32)
    boxes[2, 3] = 0.0  # an empty ROI slot
    mod = JBox(num_heads=8, d_model=HIDDEN)
    params = randomize(jinit(mod, x, x, x, boxes), rng)
    want = japply(mod, params, x, x, x, boxes)
    box = TBox(8, HIDDEN)
    box.load_state_dict(jax_import.box_head_state_dict(params["params"]))
    _close(box(_t(x), _t(x), _t(x), _t(boxes)), want)


RESNET_KW = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="float32")


@pytest.fixture(scope="module")
def visual_pair():
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 3, 64, 64, 3)).astype(np.float32)
    jv = JVisual(jcfg.ResNetConfig(**RESNET_KW))
    params = randomize(jinit(jv, images[0]), rng)
    tv = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    tv.load_state_dict(jax_import.visual_state_dict_from_jax(params["params"]))
    return jv, params, tv, images


@pytest.mark.parametrize("head", ["grid_features", "pooled_features"])
def test_visual_features(visual_pair, head):
    jv, params, tv, images = visual_pair
    want = japply(jv, params, images, method=getattr(JVisual, head))
    got = getattr(tv, head)(_t(images))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_visual_state_dict_round_trip(visual_pair):
    jv, params, tv, _ = visual_pair
    vp = params["params"]
    back = import_torchvision_resnet(jax_import.visual_state_dict_from_jax(vp),
                                     stage_sizes=RESNET_KW["stage_sizes"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, vp)
    back = import_torchvision_resnet(tv.state_dict(), stage_sizes=RESNET_KW["stage_sizes"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, vp)


def test_fcmf_state_dict_round_trip(rng):
    jm, tm = model_cfgs()
    jt, tt = text_cfgs()
    kw = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=64,
              max_text_len=L, box_heads=8)
    model = JFCMF(jcfg.FCMFConfig(model=jm, text=jt, **kw))
    ids = np.full((1, L), 5, np.int32)
    params = randomize(jinit(
        model, ids, np.zeros((1, 2, 4, 64), np.float32),
        np.zeros((1, 2, 2, 64), np.float32), np.zeros((1, 2, 2, 4), np.float32),
        None, np.ones_like(ids), np.ones((1, L + 4), np.int32))["params"], rng)
    sd = jax_import.fcmf_state_dict_from_jax(params, 2)
    back = torch_import.import_fcmf_classifier(sd, num_text_layers=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)

    port = TFCMF(tcfg.FCMFConfig(model=tm, text=tt, **kw))
    port.load_state_dict(sd, strict=True)
    back = torch_import.import_fcmf_classifier(port.state_dict(), num_text_layers=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


def test_normalize_reference_keys_is_the_jax_pass():
    sd = {"module.ent2img_attention.layer.0.x": np.ones(1),
          "encoder.text_pooler.dense.weight": np.ones(2),
          "comb_attention.layer.0.y": np.ones(3),
          "classifier.bias": np.ones(4)}
    got = jax_import.normalize_reference_keys(sd)
    want = torch_import.normalize_reference_keys(sd)
    assert got.keys() == want.keys()
    assert set(got) == {"encoder.text2img_attention.layer.0.x", "text_pooler.dense.weight",
                        "encoder.mm_attention.layer.0.y", "classifier.bias"}


def test_init_weights_is_seeded():
    _, tc = text_cfgs()
    a, b = TTextEncoder(tc), TTextEncoder(tc)
    tlayers.init_weights(a, torch.Generator().manual_seed(3))
    tlayers.init_weights(b, torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.isfinite(a.embeddings.word_embeddings.weight).all()


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_bert_layer_hidden_act(rng, act):
    """The activations of `ACT2FN` besides gelu."""
    jc, tc = (dataclasses.replace(c, hidden_act=act) for c in model_cfgs())
    x = rng.normal(size=(2, L, HIDDEN)).astype(np.float32)
    mask = additive_mask((L, 27), L)
    mod = jlayers.BertLayer(jc)
    params = randomize(jinit(mod, x, mask), rng)
    want = japply(mod, params, x, mask)
    layer = tlayers.BertLayer(tc)
    layer.load_state_dict(jax_import.bert_block_state_dict(params["params"]))
    _close(layer(_t(x), _t(mask)), want)
    gelu = tlayers.BertLayer(model_cfgs()[1])
    gelu.load_state_dict(layer.state_dict())
    assert (gelu(_t(x), _t(mask)) - layer(_t(x), _t(mask))).abs().max() > 1e-3
    assert set(tlayers.ACT2FN) == set(jlayers.ACT2FN)


def test_fcmf_use_mde_is_refused_only_where_jax_builds_it(rng):
    """JAX builds the MDE only when `use_mde and alpha < 1`; with alpha >= 1
    the flag changes nothing, and the port runs and matches."""
    jm, tm = model_cfgs()
    jt, tt = text_cfgs()
    kw = dict(num_imgs=2, num_roi=2, num_patches=4, visual_feat_dim=64,
              max_text_len=L, box_heads=8, use_mde=True, alpha=1.0)
    model = JFCMF(jcfg.FCMFConfig(model=jm, text=jt, **kw))
    ids = rng.integers(2, VOCAB, size=(2, L)).astype(np.int32)
    grid = rng.normal(size=(2, 2, 4, 64)).astype(np.float32)
    roi = rng.normal(size=(2, 2, 2, 64)).astype(np.float32)
    coors = rng.uniform(size=(2, 2, 2, 4)).astype(np.float32)
    attn, added = np.ones_like(ids), np.ones((2, L + 4), np.int32)
    params = randomize(jinit(model, ids, grid, roi, coors, None, attn, added)["params"], rng)
    want = japply(model, {"params": params}, ids, grid, roi, coors, None, attn, added)
    port = TFCMF(tcfg.FCMFConfig(model=tm, text=tt, **kw))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    port.eval()
    _close(port(_t(ids), _t(grid), _t(roi), _t(coors), None, _t(attn), _t(added)), want)
    with pytest.raises(NotImplementedError, match="Denoising"):
        TFCMF(tcfg.FCMFConfig(model=tm, text=tt, **{**kw, "alpha": 0.7}))
