"""The port's baselines (mRoBERTa, TomBERT, EF-CapTrRoBERTa) against the JAX
package's: models, train and eval steps, optimizer sets, importers and
datasets.

Parameters are made in JAX (then randomised from a numpy seed), carried
across by `jax_import.baseline_state_dict_from_jax`, and both sides run the
same numpy inputs in float32 at dropout 0, at JAX's own tiny width
(tests/test_baselines.py: vocab 128, hidden 32, 4 heads, 64 positions).
At L = 40 the text encoder's attention takes kernel K1 on both sides (the
Pallas kernel in interpret mode in JAX); L = 10 stays under its 32-row
floor; one case runs with `fused_attention=False`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.data import baselines as jdata
from macsa_tpu.models import baselines as jmodels
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.train import baseline_steps as jsteps
from macsa_tpu.train import common as jcommon
from macsa_tpu.train import optim as joptim
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import baselines as tdata
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.data.tokenizer import WordLevelTokenizer
from macsa_tpu_torch.models import baselines as tmodels
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.train import baseline_steps as tsteps
from macsa_tpu_torch.train import common as tcommon
from macsa_tpu_torch.train import jax_import, optim
from macsa_tpu_torch.train.state import TrainState
from test_torch_port_models import jinit, randomize

MODELS = ("mroberta", "tomroberta", "efcap")
TEXT_KW = dict(vocab_size=128, hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
               intermediate_size=32, max_position_embeddings=64,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
RESNET_KW = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, grid_size=2, dtype="float32")
B, A, I, R, T, IMG, VD = 2, 6, 2, 2, 16, 64, 128  # T: TomBERT's target length
# (model, length, fused): JAX's own L = 10 (under K1's 32 rows) and L = 40
# through K1 for each model, and one case of the plain path
CASES = [(name, length, True) for name in ("mroberta", "tomroberta", "efcap")
         for length in (10, 40)] + [("mroberta", 40, False)]
JAX_CLASSES = {"mroberta": jmodels.MRoBERTa, "tomroberta": jmodels.TomBERT,
               "efcap": jmodels.EFCapTrRoBERTa}
PORT_CLASSES = {"mroberta": tmodels.MRoBERTa, "tomroberta": tmodels.TomBERT,
                "efcap": tmodels.EFCapTrRoBERTa}


def text_cfgs(fused=True):
    return (jcfg.TextEncoderConfig(fused_attention=fused, fused_attention_interpret=fused,
                                   **TEXT_KW),
            tcfg.TextEncoderConfig(fused_attention=fused, **TEXT_KW))


def _kw(name):
    return {} if name == "efcap" else {"visual_feat_dim": VD}


def _ids(rng, rows, length, min_len):
    ids = rng.integers(2, 128, size=(rows, length)).astype(np.int32)
    mask = np.ones((rows, length), np.int32)
    for r in range(rows):
        n = int(rng.integers(min_len, length + 1))
        ids[r, n:], mask[r, n:] = 1, 0  # pad id 1
    return ids, mask


def model_inputs(name, rng, rows, length):
    """The positional inputs of the model's forward, as numpy."""
    ids, mask = _ids(rng, rows, length, 3)
    if name == "efcap":
        return ids, mask
    vis = rng.normal(size=(rows, I, 4, VD)).astype(np.float32)
    roi = rng.normal(size=(rows, I, R, VD)).astype(np.float32)
    if name == "mroberta":
        return ids, mask, vis, roi
    tids, tmask = _ids(rng, rows, T, 2)
    return tids, tmask, ids, mask, vis, roi


@pytest.fixture(scope="module")
def jax_params():
    """name -> JAX params, randomised (made once, at L = 40)."""
    rng = np.random.default_rng(11)
    out = {}
    for name in MODELS:
        model = JAX_CLASSES[name](text_cfgs(False)[0], **_kw(name))
        out[name] = randomize(jinit(model, *model_inputs(name, rng, 1, 40))["params"], rng)
    return out


def port_model(name, params, fused=True):
    model = PORT_CLASSES[name](text_cfgs(fused)[1], **_kw(name))
    model.load_state_dict(jax_import.baseline_state_dict_from_jax(params, name), strict=True)
    return model


@pytest.mark.parametrize("name,length,fused", CASES,
                         ids=[f"{n}-L{l}-{'kernel' if f and l >= 32 else 'plain'}"
                              for n, l, f in CASES])
def test_logits_match_jax(jax_params, name, length, fused):
    rng = np.random.default_rng(length + fused)
    args = model_inputs(name, rng, 3, length)
    model = JAX_CLASSES[name](text_cfgs(fused)[0], **_kw(name))
    want = np.asarray(jax.jit(model.apply)({"params": jax_params[name]}, *args))
    port = port_model(name, jax_params[name], fused).eval()
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == (3, 4) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_torch_encoder_layer_masks_padded_keys(rng):
    """JAX's `test_torch_encoder_layer_masks_padded_keys` on the port's layer."""
    layer = tmodels.TorchEncoderLayer(hidden_size=16, num_heads=4, ffn_size=32,
                                      dropout_rate=0.0)
    from macsa_tpu_torch.models.layers import init_weights
    init_weights(layer, torch.Generator().manual_seed(0), 0.2)
    x = torch.from_numpy(rng.normal(size=(2, 6, 16)).astype(np.float32))
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    with torch.no_grad():
        out = layer(x, mask)
        x2 = x.clone()
        x2[:, 4:] += 100.0
        out2 = layer(x2, mask)
    # row 0 ignores its padded keys (positions 4-5) at the other query rows
    torch.testing.assert_close(out[0, :4], out2[0, :4], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(out[1, :4], out2[1, :4])


# ---------------------------------------------------------------------------
# the steps: a batch of B reviews x 6 aspects, pixels through the ResNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_pair(jax_params):
    """name -> (JAX model, JAX visual, params, visual_params, JAX batch,
    port ResNet, port batch), at L = 40 through K1."""
    rng = np.random.default_rng(5)
    jvisual = JVisual(jcfg.ResNetConfig(**RESNET_KW))
    visual_params = randomize(jinit(jvisual, np.zeros((1, IMG, IMG, 3), np.float32)), rng)
    tvisual = TVisual(tcfg.ResNetConfig(**RESNET_KW))
    tvisual.load_state_dict(jax_import.visual_state_dict_from_jax(visual_params["params"]),
                            strict=True)
    out = {}
    for name in MODELS:
        ids, mask = _ids(rng, B * A, 40, 3)
        batch = {"input_ids": ids.reshape(B, A, 40), "attention_mask": mask.reshape(B, A, 40),
                 "labels": rng.integers(0, 4, size=(B, A)).astype(np.int32)}
        if name != "efcap":
            batch["images"] = rng.normal(size=(B, I, IMG, IMG, 3)).astype(np.float32)
            batch["roi_images"] = rng.normal(size=(B, I, R, IMG, IMG, 3)).astype(np.float32)
        if name == "tomroberta":
            tids, tmask = _ids(rng, B * A, T, 2)
            batch.update(target_ids=tids.reshape(B, A, T), target_mask=tmask.reshape(B, A, T))
        model = JAX_CLASSES[name](text_cfgs(True)[0], **_kw(name))
        vis = (None, {}) if name == "efcap" else (jvisual, visual_params)
        out[name] = (model, vis[0], jax_params[name], vis[1],
                     {k: jnp.asarray(v) for k, v in batch.items()},
                     None if name == "efcap" else tvisual,
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    return out


def _jax_run(pair, tx, steps):
    model, visual, params, visual_params, jbatch, _, _ = pair
    state = JTrainState.create(params, visual_params, tx)
    step = jsteps.make_baseline_train_step(model, visual, donate=False)
    losses = []
    for _ in range(steps):
        state, m = step(state, jbatch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return state.params, losses


def _port_state(name, pair, optimizer):
    port = port_model(name, pair[2])
    visual = pair[5] if pair[5] is not None else torch.nn.Module()
    return TrainState.create(port, visual, optimizer(port))


@pytest.mark.parametrize("name", MODELS)
def test_eval_step_matches_jax(step_pair, name):
    model, visual, params, visual_params, jbatch, tvisual, tbatch = step_pair[name]
    want_preds, want_logits = jsteps.make_baseline_eval_step(model, visual)(
        params, visual_params, jbatch)
    port = port_model(name, params).train()  # the step puts it in eval mode
    preds, logits = tsteps.make_baseline_eval_step(port, tvisual)(tbatch)
    assert port.training and logits.shape == (B, A, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(want_preds))


@pytest.mark.parametrize("name", MODELS)
def test_train_step_loss_and_gradients_match_jax(step_pair, name):
    """One SGD step at rate 1 on both sides: each parameter moves by -grad;
    the TomBERT encoder's gradient sums its two calls'."""
    pair = step_pair[name]
    params = pair[2]
    new_params, (want,) = _jax_run(pair, optax.sgd(1.0), 1)
    state = _port_state(name, pair, lambda m: torch.optim.SGD(m.parameters(), lr=1.0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    got = tsteps.make_baseline_train_step(state)(pair[6], seed=0)
    np.testing.assert_allclose(float(got["loss"]), want, rtol=1e-5)
    want_new = jax_import.baseline_state_dict_from_jax(new_params, name)
    want_old = jax_import.baseline_state_dict_from_jax(params, name)
    moved = 0
    for key, now in state.model.state_dict().items():
        got_delta = (now - before[key]).numpy()
        want_delta = (want_new[key] - want_old[key]).numpy()
        moved += bool(np.abs(want_delta).max() > 0)
        # f32, sums in other orders: 1e-4 of the parameter's largest gradient, or 1e-6
        tol = max(1e-4 * np.abs(want_delta).max(), 1e-6)
        np.testing.assert_allclose(got_delta, want_delta, rtol=0, atol=tol, err_msg=key)
    assert moved > 0.85 * len(want_new)  # all but the unused pooler


@pytest.mark.parametrize("name", ["tomroberta"])  # the most module kinds, two encoder calls
def test_two_adamw_updates_match_jax(step_pair, name):
    """The driver's optimizer (one rate, decay 0.01, clip 1.0) on both
    sides: the losses, and every parameter within 1e-5 after two updates
    and within 1e-6 but for one element in a thousand; the attention key
    biases (a gradient of rounding noise, ROADMAP §3) within two updates.
    Each model's decay set is held to JAX's below."""
    pair = step_pair[name]
    kw = dict(weight_decay=0.01, max_grad_norm=1.0)
    new_params, want = _jax_run(pair, joptim.make_adamw(
        joptim.linear_warmup_schedule(1e-3, 1, 100), **kw), 2)
    state = _port_state(name, pair, lambda m: optim.AdamW(
        m, optim.linear_warmup_schedule(1e-3, 1, 100), **kw))
    step = tsteps.make_baseline_train_step(state)
    got = [float(step(pair[6], seed=0)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_sd = jax_import.baseline_state_dict_from_jax(new_params, name)
    beyond, total = 0, 0
    for key, value in state.model.state_dict().items():
        diff = (value - want_sd[key]).abs()
        if key.endswith(("attention.self.key.bias", "k_proj.bias")):
            assert diff.max() <= 4e-3, key
            continue
        assert diff.max() <= 1e-5, key
        beyond, total = beyond + int((diff > 1e-6).sum()), total + diff.numel()
    assert beyond <= 1e-3 * total, (beyond, total)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("name", MODELS)
def test_no_decay_set_matches_jax(jax_params, name):
    """The port's module-type rule against JAX's `_decay_mask` by leaf name,
    name for name (biases and LayerNorm scales are exempt; embeddings and
    every kernel decay)."""
    params = jax_params[name]
    paths = jax_import._param_paths(lambda p: jax_import.baseline_state_dict_from_jax(p, name),
                                    params)
    mask = joptim._decay_mask(params)
    port = port_model(name, params)
    assert set(paths) == {n for n, _ in port.named_parameters()}
    want = {n for n, path in paths.items() if not _get(mask, path)}
    assert optim.no_decay_names(port) == want
    norms = {n for n in want if ".norm" in n or "LayerNorm" in n}
    assert norms and all(n.endswith(("weight", "bias")) for n in norms)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_from_jax_round_trips(jax_params, name):
    """Every JAX leaf lands under exactly one port name (once, whole), and
    the port's state dict gives back what it was loaded with."""
    params = jax_params[name]
    sd = jax_import.baseline_state_dict_from_jax(params, name)
    paths = jax_import._param_paths(lambda p: jax_import.baseline_state_dict_from_jax(p, name),
                                    params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(set(paths.values())) == len(paths) == len(leaves)
    assert sum(v.numel() for v in sd.values()) == sum(np.size(x) for _, x in leaves)
    port = port_model(name, params)
    for key, value in port.state_dict().items():
        assert torch.equal(value, sd[key]), key
    with pytest.raises(ValueError, match="not a module of|params lack"):
        jax_import.baseline_state_dict_from_jax(params, "efcap" if name != "efcap"
                                                else "mroberta")


def test_tombert_draws_two_dropout_masks_from_one_step(step_pair):
    """The shared encoder's two calls in one step take different K1 seeds
    (the host generator advances per call) and different elementwise masks."""
    from macsa_tpu_torch.models.layers import DropoutRng
    rng = DropoutRng.for_step(0, 0, "cpu")
    assert rng.kernel_seed() != rng.kernel_seed()
    pair = step_pair["tomroberta"]
    cfg = dataclasses.replace(text_cfgs()[1], hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    port = tmodels.TomBERT(cfg, visual_feat_dim=VD)
    port.load_state_dict(jax_import.baseline_state_dict_from_jax(pair[2], "tomroberta"))
    ids = pair[6]["input_ids"][0, :1]
    mask = pair[6]["attention_mask"][0, :1]
    port.train()
    r = DropoutRng.for_step(0, 0, "cpu")
    first, _ = port.roberta(ids, None, mask, r)
    second, _ = port.roberta(ids, None, mask, r)
    assert not torch.equal(first, second)


# ---------------------------------------------------------------------------
# the datasets, on the synthetic files, byte for byte
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("baseline_synth")
    synth.write_dataset(str(root))
    return str(root)


@pytest.mark.parametrize("name,max_len", [("mroberta", 16), ("tomroberta", 16),
                                          ("efcap", 24)])
def test_datasets_match_jax_byte_for_byte(synth_dir, name, max_len):
    """The JAX dataset with the HF fast tokenizer against the port's with its
    own `tokenizer.json` reader (no `transformers`): every array of every
    sample, at a length where some pairs truncate (HF's `longest_first`)
    and others pad."""
    data, images = os.path.join(synth_dir, "data"), os.path.join(synth_dir, "images")
    tok_dir = os.path.join(synth_dir, "tok")
    jrec = jcommon.load_records(os.path.join(data, "train.json"))
    trec = tcommon.load_records(os.path.join(data, "train.json"))
    assert jrec == trec
    jtok, ttok = jcommon.load_tokenizer(tok_dir), WordLevelTokenizer.from_dir(tok_dir)
    boxes = tcommon.load_metadata(data)[0]
    names = sorted(os.listdir(images))
    captions = {n: f"phòng {i} rộng đẹp view biển" for i, n in enumerate(names[::2])}
    kw = dict(num_img=2)
    if name == "mroberta":
        jds = jdata.MRoBERTaDataset(jrec, jtok, images, boxes, num_roi=2, max_len=max_len, **kw)
        tds = tdata.MRoBERTaDataset(trec, ttok, images, boxes, num_roi=2, max_len=max_len, **kw)
    elif name == "tomroberta":
        jds = jdata.TomBERTDataset(jrec, jtok, images, boxes, num_roi=2, sentence_len=max_len,
                                   **kw)
        tds = tdata.TomBERTDataset(trec, ttok, images, boxes, num_roi=2, sentence_len=max_len,
                                   **kw)
    else:
        jds = jdata.EFCapDataset(jrec, jtok, captions, max_len=max_len, **kw)
        tds = tdata.EFCapDataset(trec, ttok, captions, max_len=max_len, **kw)
    full = 0
    for i in range(len(jds)):
        want, got = jds[i], tds[i]
        assert set(want) == set(got)
        for key, value in want.items():
            if key == "text":
                assert got[key] == value
                continue
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            assert got[key].tobytes() == value.tobytes(), (i, key)
        full += int(got["attention_mask"][:, -1].sum())
    assert 0 < full < len(jds) * A  # rows that truncate and rows that pad
    if name == "tomroberta":  # the literal "</s></s>" is two special tokens
        sample = tds[0]
        assert (sample["input_ids"][:, :6] == 2).sum() >= 2 * A
