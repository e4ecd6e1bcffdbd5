"""The port's Phase-1 modules against the JAX package's, at small widths.

Parameters are initialised in JAX, randomised from a numpy seed, carried
across by `macsa_tpu_torch.train.jax_import` and run on the same numpy
inputs in float32 on both sides:

* `PerHeadAttention`: the three score functions under each mask and head
  pairing, against JAX and against a numpy golden written here (atol 1e-5),
* `IAOGDecoder` and `FCMFSeq2Seq` logits (atol 1e-4) and the loss (rtol
  1e-5), incremental decode against teacher forcing in both cross-mask
  modes,
* the chunked loss against the full loss, in value and gradient,
* greedy and beam-3 tokens against JAX's (seeded random f32 weights: two
  candidates never tie, so `torch.topk` and `jax.lax.top_k` order them alike),
* the state dict both ways through `import_fcmf_seq2seq`, and the tied
  token table's one optimizer state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models.attention import PerHeadAttention as JAttention
from macsa_tpu.models.decoder import IAOGDecoder as JDecoder
from macsa_tpu.models.decoder import sinusoidal_positions as jpositions
from macsa_tpu.models.decoder import stack_block_params
from macsa_tpu.models.seq2seq import FCMFSeq2Seq as JSeq2Seq
from macsa_tpu.models.seq2seq import chunked_seq2seq_loss as jchunked_loss
from macsa_tpu.models.seq2seq import seq2seq_loss as jloss
from macsa_tpu.train import torch_import
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models import seq2seq as tseq2seq
from macsa_tpu_torch.models.attention import PerHeadAttention as TAttention
from macsa_tpu_torch.models.decoder import IAOGDecoder as TDecoder
from macsa_tpu_torch.models.decoder import sinusoidal_positions as tpositions
from macsa_tpu_torch.train import jax_import, optim
from test_torch_port_models import jinit, randomize

VOCAB, HIDDEN, HEADS, T, L = 96, 32, 4, 8, 24
BOS, EOS = 0, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MODEL_KW = dict(hidden_size=HIDDEN, num_hidden_layers=2, num_attention_heads=HEADS,
                intermediate_size=64, **NO_DROPOUT)
TEXT_KW = dict(vocab_size=VOCAB, max_position_embeddings=64, **MODEL_KW)
FCMF_KW = dict(num_imgs=3, num_roi=2, num_patches=4, visual_feat_dim=16, max_text_len=L,
               box_heads=8)
DEC_KW = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_blocks=2, num_heads=HEADS,
              ffn_hidden=HIDDEN, max_decode_len=T, dropout=0.0)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# PerHeadAttention
# ---------------------------------------------------------------------------

def attention_golden(p, k, q, score_function, mask_kind, mask, emulate):
    """numpy: per-head projections, the value stream is kx, the score filled
    (not added to) with -1e4 where masked, softmax, heads merged, `proj`."""
    nh, _, d = p["w_kx"].shape
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    kx = np.einsum("ble,hed->bhld", k, p["w_kx"])
    qx = np.einsum("ble,hed->bhld", q, p["w_qx"])
    if emulate:  # slot c of batch element i reads weight head (c*B + i) % nh
        pick = [[(c * b + i) % nh for c in range(nh)] for i in range(b)]
        kx = np.stack([kx[i, pick[i]] for i in range(b)])
        qx = np.stack([qx[i, pick[i]] for i in range(b)])
    score = np.zeros((b, nh, lq, lk), np.float32)
    for i in range(lq):
        for j in range(lk):
            if score_function == "scaled_dot_product":
                s = (qx[:, :, i] * kx[:, :, j]).sum(-1) / np.sqrt(d)
            elif score_function == "mlp":
                s = np.tanh(np.concatenate([kx[:, :, j], qx[:, :, i]], -1) @ p["weight"][:, 0])
            else:
                s = np.tanh(np.einsum("bhd,de,bhe->bh", qx[:, :, i], p["weight"], kx[:, :, j]))
            score[:, :, i, j] = s
    keep = np.ones((b, 1, lq, lk), bool)
    if mask_kind == "causal":
        keep = np.tril(np.ones((lq, lk), bool))[None, None]
    elif mask_kind == "lengths":
        keep = (np.arange(lk)[None, :] < mask[:, None])[:, None, None, :]
    elif mask_kind == "key_mask":
        keep = mask.astype(bool)[:, None, None, :]
    score = np.where(keep, score, np.float32(-1e4))
    e = np.exp(score - score.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", probs, kx).transpose(0, 2, 1, 3).reshape(b, lq, nh * d)
    return out @ p["proj"]["kernel"] + p["proj"]["bias"]


@pytest.mark.parametrize("batch,emulate", [(1, True), (3, False), (3, True)],
                         ids=["b1-ref-heads", "b3", "b3-ref-heads"])
@pytest.mark.parametrize("mask_kind", ["none", "lengths", "causal", "key_mask"])
@pytest.mark.parametrize("score_function", ["scaled_dot_product", "mlp", "bi_linear"])
def test_per_head_attention_matches_jax_and_numpy(score_function, mask_kind, batch, emulate):
    rng = np.random.default_rng(7)
    e, d, nh, lq, lk = 16, 6, 3, 5, 7
    k = rng.normal(size=(batch, lk, e)).astype(np.float32)
    q = rng.normal(size=(batch, lq, e)).astype(np.float32)
    mask, kw = None, {}
    if mask_kind == "lengths":
        mask = rng.integers(1, lk + 1, size=(batch,)).astype(np.int32)
        kw = {"lengths": mask}
    elif mask_kind == "key_mask":
        mask = (rng.random((batch, lk)) < 0.6).astype(np.int32)
        mask[:, 0] = 1
        kw = {"key_mask": mask}
    elif mask_kind == "causal":
        kw = {"causal": True}
    jmod = JAttention(e, d, nh, score_function=score_function, emulate_reference_heads=emulate)
    params = randomize(jmod.init(jax.random.PRNGKey(0), k, q)["params"], rng)
    params = jax.tree_util.tree_map(np.asarray, params)
    want = np.asarray(jmod.apply({"params": params}, k, q,
                                 **{name: jnp.asarray(v) if name != "causal" else v
                                    for name, v in kw.items()}))

    port = TAttention(e, d, nh, score_function=score_function, emulate_reference_heads=emulate)
    sd = {"w_kx": _t(params["w_kx"]), "w_qx": _t(params["w_qx"]),
          "proj.weight": _t(params["proj"]["kernel"].T), "proj.bias": _t(params["proj"]["bias"])}
    if "weight" in params:
        sd["weight"] = _t(params["weight"])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_t(k), _t(q), **{name: _t(v) if name != "causal" else v
                                    for name, v in kw.items()}).numpy()
    golden = attention_golden(params, k, q, score_function, mask_kind, mask, emulate)
    # f32 everywhere; sums of 6 to 18 terms in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, golden, rtol=0, atol=1e-5)
    np.testing.assert_allclose(want, golden, rtol=0, atol=1e-5)


def test_per_head_attention_head_pairing_depends_on_the_batch_size_only_when_emulated():
    rng = np.random.default_rng(8)
    k = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32))
    outs = {}
    for emulate in (False, True):
        mod = TAttention(8, 4, 3, emulate_reference_heads=emulate)
        torch.manual_seed(0)
        for p in mod.parameters():
            torch.nn.init.normal_(p)
        with torch.no_grad():
            outs[emulate] = (mod(k, k), mod(k[:1], k[:1]), mod(k[1:2], k[1:2]))
    full, first, second = outs[False]
    assert torch.allclose(full[:1], first, atol=1e-6) and torch.allclose(full[1:2], second,
                                                                         atol=1e-6)
    # emulated at batch 3 with 3 heads: row i's slots all read weight head i;
    # at batch 1 slot c reads head c, which is the intended pairing
    full, first, second = outs[True]
    assert not torch.allclose(full[:1], first, atol=1e-3)
    assert not torch.allclose(full[1:2], second, atol=1e-3)
    assert torch.equal(first, outs[False][1]) and torch.equal(second, outs[False][2])
    with pytest.raises(ValueError, match="invalid score_function"):
        TAttention(8, 4, 3, score_function="dot")


def test_sinusoidal_positions_match_jax():
    np.testing.assert_allclose(tpositions(64, 32).numpy(), np.asarray(jpositions(64, 32)),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the decoder and the seq2seq model
# ---------------------------------------------------------------------------

def _configs(cross_mask_mode="causal_quirk", emulate=False):
    jconfig = jcfg.FCMFConfig(model=jcfg.ModelConfig(**MODEL_KW),
                              text=jcfg.TextEncoderConfig(**TEXT_KW),
                              decoder_cross_mask_mode=cross_mask_mode, **FCMF_KW)
    jdec = jcfg.DecoderConfig(emulate_reference_heads=emulate, **DEC_KW)
    tconfig = tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                              text=tcfg.TextEncoderConfig(**TEXT_KW),
                              decoder_cross_mask_mode=cross_mask_mode, **FCMF_KW)
    tdec = tcfg.DecoderConfig(emulate_reference_heads=emulate, **DEC_KW)
    return jconfig, jdec, tconfig, tdec


def make_inputs(rng, b=3):
    enc_ids = rng.integers(3, VOCAB, size=(b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    mask[1, 17:] = 0
    enc_ids[1, 17:] = 1  # pad
    dec_ids = rng.integers(3, VOCAB, size=(b, T)).astype(np.int32)
    labels = np.roll(dec_ids, -1, axis=1)
    labels[:, -1] = -100
    labels[2, 5:] = -100
    return {
        "enc_input_ids": enc_ids, "dec_input_ids": dec_ids, "labels": labels,
        "grid": rng.normal(size=(b, 3, 4, 16)).astype(np.float32),
        "roi": rng.normal(size=(b, 3, 2, 16)).astype(np.float32),
        "roi_coors": rng.uniform(0, 1, size=(b, 3, 2, 4)).astype(np.float32),
        "attention_mask": mask, "added_mask": np.ones((b, L + 4), np.int32)}


def encoder_args(x, wrap):
    return [wrap(x[k]) for k in ("grid", "roi", "roi_coors")] + [
        None, wrap(x["attention_mask"]), wrap(x["added_mask"])]


@pytest.fixture(scope="module", params=["causal_quirk", "padding"])
def pair(request):
    """(JAX model, its random params, the port's model with them, inputs)."""
    rng = np.random.default_rng(11)
    jconfig, jdec, tconfig, tdec = _configs(request.param)
    jmodel = JSeq2Seq(jconfig, jdec)
    x = make_inputs(rng)
    params = randomize(jinit(jmodel, x["enc_input_ids"], x["dec_input_ids"],
                             *encoder_args(x, jnp.asarray))["params"], rng)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["decoder"]["out_bias"] = rng.normal(0, 0.1, size=(VOCAB,)).astype(np.float32)
    port = tseq2seq.FCMFSeq2Seq(tconfig, tdec)
    port.load_state_dict(jax_import.seq2seq_state_dict_from_jax(params, 2, 2), strict=True)
    port.eval()
    return jmodel, params, port, x


def _jax_logits(pair):
    jmodel, params, _, x = pair
    return np.asarray(jax.jit(jmodel.apply)(
        {"params": params}, x["enc_input_ids"], x["dec_input_ids"],
        *encoder_args(x, jnp.asarray)))


def _port_logits(pair, **kw):
    _, _, port, x = pair
    return port(_t(x["enc_input_ids"]), _t(x["dec_input_ids"]), *encoder_args(x, _t), **kw)


def test_decoder_logits_match_jax(pair):
    """The decoder alone on a random encoder sequence, teacher forcing."""
    jmodel, params, port, x = pair
    rng = np.random.default_rng(12)
    enc = rng.normal(size=(3, 7, HIDDEN)).astype(np.float32)
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[0, 4:] = 0
    jdecoder = JDecoder(jmodel.decoder_config, cross_mask_mode=jmodel.config.decoder_cross_mask_mode)
    want = np.asarray(jdecoder.apply(
        {"params": params["decoder"]}, jnp.asarray(x["dec_input_ids"]), jnp.asarray(enc),
        jnp.asarray(enc_mask), jnp.asarray(params["shared_embedding"])))
    with torch.no_grad():
        got = port.decoder(_t(x["dec_input_ids"]), _t(enc), _t(enc_mask))
    assert got.dtype == torch.float32 and got.shape == (3, T, VOCAB)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    hidden = port.decoder(_t(x["dec_input_ids"]), _t(enc), _t(enc_mask), return_hidden=True)
    assert hidden.shape == (3, T, HIDDEN)
    # its own table when none is shared
    alone = TDecoder(port.decoder_config)
    assert alone.embedding.weight is alone.dense.weight
    assert alone.embedding.weight is not port.shared_embedding


def test_seq2seq_logits_and_loss_match_jax(pair):
    want = _jax_logits(pair)
    with torch.no_grad():
        got = _port_logits(pair)
    # f32; two text layers, three fusion layers and two decoder blocks deep
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    labels = pair[3]["labels"]
    want_loss = float(jloss(jnp.asarray(want), jnp.asarray(labels)))
    got_loss = float(tseq2seq.seq2seq_loss(got, _t(labels)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert float(tseq2seq.seq2seq_loss(got, torch.full_like(_t(labels), -100))) == 0.0


def test_incremental_decode_equals_teacher_forcing(pair):
    """Step t of the incremental branch on the cache gives row t of the
    teacher-forcing logits, in both cross-mask modes (in `causal_quirk` the
    tril(T, 7) of teacher forcing is `lengths = min(t + 1, 7)` here)."""
    _, _, port, x = pair
    with torch.no_grad():
        full = _port_logits(pair)
        enc_output, combined = port.encode(_t(x["enc_input_ids"]), *encoder_args(x, _t))
        assert combined.shape == (3, 7) and combined.dtype == torch.int32
        cache = port.decoder.init_cache(3)
        assert sorted(cache) == ["block0", "block1"] and cache["block0"].shape == (3, T, HIDDEN)
        for step in range(T):
            token = _t(x["dec_input_ids"][:, step:step + 1])
            logits = port.decode_step(token, enc_output, combined, cache, step)
            np.testing.assert_allclose(logits[:, 0].numpy(), full[:, step].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"step {step}")


@pytest.mark.parametrize("chunk", [7, 64, 200])
def test_chunked_loss_equals_full_loss_in_value_and_gradient(pair, chunk):
    """Chunks that do not divide the vocabulary (96), that leave a short
    last chunk, and one larger than the vocabulary."""
    _, params, port, x = pair
    rng = np.random.default_rng(13)
    labels = _t(x["labels"])
    hidden0 = rng.normal(size=(3, T, HIDDEN)).astype(np.float32)
    table0 = rng.normal(0, 0.3, size=(VOCAB, HIDDEN)).astype(np.float32)
    bias0 = rng.normal(0, 0.1, size=(VOCAB,)).astype(np.float32)

    def leaves():
        return [_t(a).clone().requires_grad_(True) for a in (hidden0, table0, bias0)]

    full = leaves()
    want = tseq2seq.seq2seq_loss(full[0] @ full[1].T + full[2], labels)
    want.backward()
    chunked = leaves()
    got, pred = tseq2seq.chunked_seq2seq_loss(*chunked, labels, chunk_size=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    for name, a, b in zip(("hidden", "table", "bias"), chunked, full):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0, atol=1e-7,
                                   err_msg=name)
    logits = (full[0] @ full[1].T + full[2]).detach()
    assert torch.equal(pred, logits.argmax(-1)) and not pred.requires_grad
    jgot, jpred = jchunked_loss(jnp.asarray(hidden0), jnp.asarray(table0), jnp.asarray(bias0),
                                jnp.asarray(x["labels"]), chunk_size=chunk)
    np.testing.assert_allclose(got.item(), float(jgot), rtol=1e-5)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))


def test_chunked_loss_keeps_the_first_index_on_ties_and_no_full_logits():
    hidden = torch.ones(1, 2, 4)
    table = torch.zeros(10, 4)
    table[3] = table[8] = 1.0  # two equal maxima, in different chunks of 5
    table[6] = 1.0             # and two within the second chunk
    labels = torch.tensor([[3, -100]])
    loss, pred = tseq2seq.chunked_seq2seq_loss(hidden, table, torch.zeros(10), labels,
                                               chunk_size=5)
    assert pred.tolist() == [[3, 3]]
    np.testing.assert_allclose(float(loss), float(tseq2seq.seq2seq_loss(
        hidden @ table.T, labels)), rtol=1e-6)
    # all labels ignored: a zero loss and zero gradients
    h = hidden.clone().requires_grad_(True)
    zero, _ = tseq2seq.chunked_seq2seq_loss(h, table, torch.zeros(10),
                                            torch.full((1, 2), -100), chunk_size=4)
    zero.backward()
    assert zero.item() == 0.0 and not h.grad.any()
    # the backward holds no [N, V] tensor: nothing saved is as large as the logits
    big_h = torch.randn(2, 8, 4, requires_grad=True)
    big_t = torch.randn(4096, 4, requires_grad=True)
    loss, _ = tseq2seq.chunked_seq2seq_loss(big_h, big_t, torch.zeros(4096),
                                            torch.randint(0, 4096, (2, 8)), chunk_size=512)
    saved = [t.numel() for t in loss.grad_fn.saved_tensors]
    assert max(saved) <= big_t.numel() < 16 * 4096


@pytest.mark.parametrize("seed,emulate", [(24, False), (23, False), (24, True)],
                         ids=["heads", "heads-eos-midway", "ref-heads"])
def test_greedy_and_beam_tokens_match_jax(seed, emulate):
    """Greedy, beam 1 and beam 3 (with and without a length penalty)
    against JAX's.  With `emulate_reference_heads` the head pairing follows
    the batch the decoder is called with: B in greedy, B*k in the beam."""
    rng = np.random.default_rng(seed)
    jconfig, jdec, tconfig, tdec = _configs(emulate=emulate)
    jmodel = JSeq2Seq(jconfig, jdec)
    x = make_inputs(rng)
    params = randomize(jinit(jmodel, x["enc_input_ids"], x["dec_input_ids"],
                             *encoder_args(x, jnp.asarray))["params"], rng)
    # a table and a bias at which the decoded tokens vary and eos wins at times
    # (seed 24: a row ends at once; seed 23: a row ends midway)
    params["shared_embedding"] = rng.normal(0, 0.05, size=(VOCAB, HIDDEN)).astype(np.float32)
    bias = rng.normal(0, 0.3, size=(VOCAB,)).astype(np.float32)
    bias[EOS] += 0.5
    params["decoder"]["out_bias"] = bias
    port = tseq2seq.FCMFSeq2Seq(tconfig, tdec)
    port.load_state_dict(jax_import.seq2seq_state_dict_from_jax(params, 2, 2), strict=True)
    port.train()  # decode passes no rng: deterministic whatever the mode

    def japply(method, *extra, **kw):
        fn = jax.jit(lambda p: jmodel.apply(
            {"params": p}, x["enc_input_ids"], *[jnp.asarray(x[k]) for k in
                                                 ("grid", "roi", "roi_coors")],
            BOS, EOS, *extra, None, jnp.asarray(x["attention_mask"]),
            jnp.asarray(x["added_mask"]), method=method, **kw))
        return fn(params)

    targs = [_t(x[k]) for k in ("enc_input_ids", "grid", "roi", "roi_coors")]
    tkw = dict(attention_mask=_t(x["attention_mask"]), added_attention_mask=_t(x["added_mask"]))
    want = np.asarray(japply(JSeq2Seq.greedy_decode))
    greedy = port.greedy_decode(*targs, BOS, EOS, **tkw)
    assert greedy.dtype == torch.int32 and greedy.shape == (3, T)
    np.testing.assert_array_equal(greedy.numpy(), want)
    assert (want != EOS).any() and (emulate or (want == EOS).any())

    if not emulate:  # emulated pairing differs between batch B and B*1 only through B: equal
        one, _ = port.beam_decode(*targs, BOS, EOS, beam_size=1, **tkw)
        np.testing.assert_array_equal(one.numpy(), want)
    for penalty in ((0.0, 0.7) if seed == 24 and not emulate else (0.0,)):
        jseqs, jscores = japply(JSeq2Seq.beam_decode, 3, length_penalty=penalty)
        seqs, scores = port.beam_decode(*targs, BOS, EOS, beam_size=3, length_penalty=penalty,
                                        **tkw)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-4)
    short = port.greedy_decode(*targs, BOS, EOS, max_len=3, **tkw)
    assert torch.equal(short, greedy[:, :3])


def test_beam_first_step_takes_beam_zeros_candidates():
    """The k-1 dead beams start at -1e9: after step 0 every chosen beam is
    a continuation of beam 0, the k best tokens of BOS's distribution."""
    rng = np.random.default_rng(22)
    *_, tconfig, tdec = _configs()
    port = tseq2seq.FCMFSeq2Seq(tconfig, tdec)
    from macsa_tpu_torch.models.layers import init_weights
    init_weights(port, torch.Generator().manual_seed(0), 0.5)
    x = make_inputs(rng)
    targs = [_t(x[k]) for k in ("enc_input_ids", "grid", "roi", "roi_coors")]
    tkw = dict(attention_mask=_t(x["attention_mask"]), added_attention_mask=_t(x["added_mask"]))
    seqs, scores = port.beam_decode(*targs, BOS, EOS, beam_size=3, max_len=1, **tkw)
    with torch.inference_mode():
        enc, mask = port.encode(targs[0], *targs[1:], None, tkw["attention_mask"],
                                tkw["added_attention_mask"])
        logits = port.decode_step(torch.full((3, 1), BOS), enc, mask,
                                  port.decoder.init_cache(3), 0)
    logp = torch.log_softmax(logits[:, 0], -1)
    assert torch.equal(seqs[:, 0].long(), logp.argmax(-1))
    np.testing.assert_allclose(scores.numpy(), logp.max(-1).values.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the state dict and the tied table
# ---------------------------------------------------------------------------

def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{path}: {sorted(a)} vs {sorted(b)}"
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_state_dict_round_trips_both_ways_through_the_jax_importer(pair):
    _, params, port, _ = pair
    sd = port.state_dict()
    assert set(tseq2seq.TIED_TABLE_NAMES) <= set(sd)
    assert not any("positions" in k for k in sd)  # the sinusoidal table is no state
    back = torch_import.import_fcmf_seq2seq(sd, num_text_layers=2, num_blocks=2)
    _assert_trees_equal(back, params)
    again = jax_import.seq2seq_state_dict_from_jax(back, 2, 2)
    assert again.keys() == sd.keys()
    for name in sd:
        assert torch.equal(again[name], sd[name]), name
    with pytest.raises(ValueError, match="unstack them first"):
        jax_import.seq2seq_state_dict_from_jax(
            {**params, "decoder": stack_block_params(params["decoder"], 2)}, 2, 2)
    paths = jax_import.seq2seq_param_paths(params, 2, 2)
    assert paths.keys() == sd.keys()
    assert {paths[n] for n in tseq2seq.TIED_TABLE_NAMES} == {("shared_embedding",)}
    assert paths["decoder.dense.bias"] == ("decoder", "out_bias")
    assert paths["decoder.blks.block1.add_norm3.ln.weight"] == (
        "decoder", "block_1", "add_norm3", "ln", "scale")


def test_tied_table_is_one_parameter_with_one_optimizer_state(pair):
    _, _, port, x = pair
    table = port.shared_embedding
    assert port.decoder.dense.weight is table
    assert port.encoder.bert.cell.embeddings.word_embeddings.weight is table
    names = [n for n, p in port.named_parameters() if p is table]
    assert len(names) == 1
    assert sum(p.numel() for p in port.parameters()) == sum(
        v.numel() for k, v in port.state_dict().items()
        if k not in tseq2seq.TIED_TABLE_NAMES[1:])
    no_decay = optim.no_decay_names(port)
    assert not set(tseq2seq.TIED_TABLE_NAMES) & no_decay  # the table decays
    assert "decoder.dense.bias" in no_decay
    assert "decoder.blks.block0.addnorm1.ln.weight" in no_decay
    assert "decoder.blks.block0.attention1.w_kx" not in no_decay
    opt = optim.AdamW(port, 1e-3, weight_decay=1e-5)
    assert sum(p is table for p in opt.params) == 1
    decayed = [g for g in opt.optimizer.param_groups if g["weight_decay"] > 0]
    assert sum(p is table for g in decayed for p in g["params"]) == 1
    assert not any(optim.is_head(n) for n, _ in port.named_parameters())
    # one gradient: the sum of the embedding's, the backbone's and the head's uses
    port.zero_grad()
    _port_logits(pair).square().mean().backward()
    total = table.grad.clone()
    port.zero_grad()
    hidden = _port_logits(pair, return_hidden=True)
    (hidden.float() @ table.detach().T + port.decoder.dense.bias).square().mean().backward()
    without_head = table.grad.clone()
    assert without_head.abs().max() > 0 and (total - without_head).abs().max() > 0
    opt.step()
    assert sum(1 for p in opt.optimizer.state if p is table) == 1
    port.zero_grad()


def test_load_state_dict_takes_the_table_once_or_thrice_and_refuses_unequal_values(pair):
    _, _, port, _ = pair
    sd = port.state_dict()
    fresh = tseq2seq.FCMFSeq2Seq(port.config, port.decoder_config)
    fresh.load_state_dict(sd, strict=True)  # three names, equal values
    for keep in tseq2seq.TIED_TABLE_NAMES:
        once = {k: v for k, v in sd.items() if k not in tseq2seq.TIED_TABLE_NAMES or k == keep}
        other = tseq2seq.FCMFSeq2Seq(port.config, port.decoder_config)
        other.load_state_dict(once, strict=True)
        assert torch.equal(other.shared_embedding, port.shared_embedding)
        assert other.decoder.dense.weight is other.shared_embedding
    unequal = dict(sd)
    unequal["decoder.dense.weight"] = sd["decoder.dense.weight"] + 1.0
    with pytest.raises(ValueError, match="one tied table"):
        fresh.load_state_dict(unequal, strict=True)
    missing = {k: v for k, v in sd.items() if k != "decoder.dense.bias"}
    with pytest.raises(RuntimeError, match="decoder.dense.bias"):
        fresh.load_state_dict(missing, strict=True)
    no_table = {k: v for k, v in sd.items() if k not in tseq2seq.TIED_TABLE_NAMES}
    with pytest.raises(RuntimeError, match="embedding.weight"):
        fresh.load_state_dict(no_table, strict=True)


def test_decoder_config_is_the_jax_one_minus_the_scan_levers():
    ours = {f.name: f.default for f in dataclasses.fields(tcfg.DecoderConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(jcfg.DecoderConfig)}
    assert set(theirs) - set(ours) == {"scan_blocks", "scan_unroll"}
    assert ours == {k: v for k, v in theirs.items() if k in ours}
    assert tcfg.DecoderConfig().head_dim == 64
    assert tcfg.DecoderConfig(dtype="bfloat16").torch_dtype == torch.bfloat16
