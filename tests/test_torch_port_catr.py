"""The port's CATR captioner and caption tool against the JAX package's.

A seeded CATR state dict under the torch-hub checkpoint's names loads into
the port's `models/catr.py` as it is, and into JAX through its own importer
(`import_torch_catr`), on JAX's tiny test config (tests/test_catr.py: ResNet
stages (1, 1, 1, 1) at 64 filters, d 8-16, 2 + 2 layers): the position
embedding, encoder memory and teacher-forced logits (atol 1e-4), greedy
tokens with the all-finished early stop, causality, both importers and the
config reader.  The caption tool: its image preparation against JAX's
(PIL), its `vocab.txt` decoder against `transformers.BertTokenizer`, and the
JSON it writes against the JAX tool's, from one seeded checkpoint.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from macsa_tpu.models import catr as jcatr
from macsa_tpu.tools import generate_captions as jtool
from macsa_tpu_torch.data import png, synth
from macsa_tpu_torch.data.tokenizer import WordPieceDecoder
from macsa_tpu_torch.models import catr as tcatr
from macsa_tpu_torch.tools import generate_captions as ttool
from macsa_tpu_torch.train import jax_import

TINY = dict(hidden_dim=16, nheads=2, enc_layers=2, dec_layers=2, dim_feedforward=32,
            vocab_size=32, max_position_embeddings=10, mlp_hidden=24,
            backbone_stages=(1, 1, 1, 1), start_token=1, end_token=2)


def pair(pre_norm=True, seed=0, end_boost=0.0):
    """(port CATR, JAX CATR, JAX params, hub state dict) from one seeded
    state dict; `end_boost` raises the head's bias of the end token."""
    cfg = tcatr.CATRConfig(pre_norm=pre_norm, **TINY)
    sd = tcatr.random_state_dict(cfg, torch.Generator().manual_seed(seed))
    if not pre_norm:
        sd = {k: v for k, v in sd.items() if not k.startswith("transformer.encoder.norm")}
    sd["mlp.layers.2.bias"][cfg.end_token] += end_boost
    port = tcatr.CATR(cfg)
    port.load_state_dict(sd, strict=True)
    icfg, params = jcatr.import_torch_catr(sd, nheads=cfg.nheads)
    icfg = dataclasses.replace(icfg, start_token=cfg.start_token, end_token=cfg.end_token)
    return port.eval(), jcatr.CATR(icfg), params, sd


def images_tokens(seed=0, b=2, hw=64, t=6):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    tokens = rng.integers(1, TINY["vocab_size"], size=(b, t)).astype(np.int64)
    return images, tokens


@pytest.mark.parametrize("h,w,feats", [(3, 4, 6), (10, 10, 128), (7, 5, 8)])
def test_sine_position_embedding_matches_jax(h, w, feats):
    want = np.asarray(jcatr.sine_position_embedding(h, w, feats))
    got = tcatr.sine_position_embedding(h, w, feats).numpy()
    assert got.shape == (h * w, 2 * feats)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre_norm", "post_norm"])
def test_encode_and_decode_logits_match_jax(pre_norm):
    port, model, params, _ = pair(pre_norm)
    images, tokens = images_tokens()
    pad = np.zeros(tokens.shape, bool)
    pad[1, 4:] = True  # the reference's tgt_key_padding_mask
    memory, pos = jax.jit(lambda p, x: model.apply(p, x, method=jcatr.CATR.encode))(
        params, images)
    logits = jax.jit(lambda p, m, q, t, k: model.apply(
        p, m, q, t, k, method=jcatr.CATR.decode_logits))(params, memory, pos, tokens, pad)
    with torch.no_grad():
        tmem, tpos = port.encode(torch.from_numpy(images))
        tlogits = port.decode_logits(tmem, tpos, torch.from_numpy(tokens),
                                     torch.from_numpy(pad))
    assert tmem.shape == (2, 4, 16) and tlogits.shape == (2, 6, 32)
    np.testing.assert_allclose(tpos.numpy(), np.asarray(pos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(memory), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), rtol=0, atol=1e-4)


def test_greedy_decode_matches_jax_and_stops_when_every_row_has_ended():
    """A raised end-token bias makes the four rows end at steps 6, 6, 3 and
    1 of 9: the tokens equal JAX's (PAD after each row's end), and the loop
    runs the decoder 6 times, not 9."""
    port, model, params, _ = pair(end_boost=1.1)
    images, _ = images_tokens(b=4)
    want = np.asarray(jcatr.greedy_decode(model, params, images))
    calls = []
    decode_hidden = port.decode_hidden
    port.decode_hidden = lambda *a: calls.append(1) or decode_hidden(*a)
    got = tcatr.greedy_decode(port, torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    ends = [row.tolist().index(2) for row in got]
    assert ends == [6, 6, 3, 1] and len(calls) == 6
    assert all((row[end + 1:] == 0).all() for row, end in zip(got, ends))
    # no decision was a near tie: the leading logit stands clear of the next
    with torch.no_grad():
        mem, pos = port.encode(torch.from_numpy(images))
        logits = decode_hidden(mem, pos, torch.from_numpy(got))
        top2 = port.head(logits).topk(2, dim=-1).values
    for row, end in enumerate(ends):
        assert (top2[row, :end, 0] - top2[row, :end, 1]).min() > 1e-3


def test_decoder_is_causal():
    port, _, _, _ = pair()
    images, tokens = images_tokens()
    changed = tokens.copy()
    changed[:, 3:] = (changed[:, 3:] + 7) % TINY["vocab_size"]
    with torch.no_grad():
        a = port(torch.from_numpy(images), torch.from_numpy(tokens))
        b = port(torch.from_numpy(images), torch.from_numpy(changed))
    torch.testing.assert_close(a[:, :3], b[:, :3], rtol=0, atol=1e-5)
    assert not torch.allclose(a[:, 3:], b[:, 3:])


@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre_norm", "post_norm"])
def test_both_importers_read_the_hub_names(pre_norm):
    """JAX's `import_torch_catr` reads the port's `state_dict()` into the
    tree its `init` makes, and `catr_state_dict_from_jax` gives it back."""
    port, model, params, sd = pair(pre_norm)
    icfg, got = jcatr.import_torch_catr(port.state_dict(), nheads=2)
    images, tokens = images_tokens()
    init = jax.eval_shape(model.init, jax.random.PRNGKey(0), images, tokens)
    shapes = lambda tree: jax.tree.map(lambda x: tuple(np.shape(x)), tree)
    assert shapes(got) == shapes(init)
    back = jax_import.catr_state_dict_from_jax(got)
    assert set(back) == set(port.state_dict()) == set(sd)
    for key, value in port.state_dict().items():
        assert torch.equal(back[key], value), key
    assert set(jax_import.catr_state_dict_from_jax(params["params"])) == set(sd)


def test_infer_catr_config_matches_jax():
    for pre_norm in (True, False):
        _, _, _, sd = pair(pre_norm)
        got = tcatr.infer_catr_config(sd, nheads=2)
        want = jcatr.infer_catr_config(sd, nheads=2)
        assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()}
        assert got.pre_norm is pre_norm and got.backbone_stages == (1, 1, 1, 1)
    # v3's defaults are the hub's: ResNet-101, 6 + 6 layers, d 256, 8 heads
    assert dataclasses.asdict(tcatr.CATRConfig()) == dataclasses.asdict(jcatr.CATRConfig())


@pytest.mark.parametrize("h,w", [(40, 70), (71, 30), (64, 64), (320, 300)])
def test_square_pad_resize_matches_jax(tmp_path, h, w):
    """Byte for byte: the padded square resized by Pillow's fixed-point
    BILINEAR (the reference uses PIL) and normalized in the same order."""
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    img[: h // 2] = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None]  # smooth rows too
    path = str(tmp_path / "img.png")
    Image.fromarray(img).save(path)
    want = jtool.square_pad_resize(path)
    got = ttool.square_pad_resize(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (299, 299, 3)
    assert got.tobytes() == want.tobytes()


def bert_vocab(size=128):
    """A BERT-layout vocabulary: [PAD] 0, [unused*], [UNK] 100, [CLS] 101,
    [SEP] 102, [MASK] 103, then words, suffix pieces and punctuation."""
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                              "[MASK]"]
    extra = ["a", "man", "dog", "room", "view", "sea", "##s", "##ing", "##ed", ".", ",", "?",
             "!", "'", "n't", "'s", "'m", "'ve", "'re", "the", "on", "with", "##y", "bed"]
    words += extra + [f"w{i}" for i in range(size - len(words) - len(extra))]
    return words[:size]


def test_wordpiece_decoder_matches_bert_tokenizer(tmp_path):
    from transformers import BertTokenizer
    (tmp_path / "vocab.txt").write_text("\n".join(bert_vocab()) + "\n", encoding="utf-8")
    want = BertTokenizer.from_pretrained(str(tmp_path))
    got = WordPieceDecoder.from_dir(str(tmp_path))
    assert len(got) == len(want) == 128
    rng = np.random.default_rng(0)
    for _ in range(500):
        ids = rng.integers(0, 128, size=rng.integers(0, 16)).tolist()
        ids += rng.choice([100, 101, 102, 0], size=rng.integers(0, 3)).tolist()
        for skip in (True, False):
            assert got.decode(ids, skip_special_tokens=skip) == \
                want.decode(ids, skip_special_tokens=skip), ids


@pytest.fixture(scope="module")
def caption_inputs(tmp_path_factory):
    """The synthetic dataset's 12 images plus two that are not square, a
    seeded checkpoint at the hub's names (8 heads, as the tools assume; the
    BERT token layout) and its vocabulary."""
    root = tmp_path_factory.mktemp("captions")
    synth.write_dataset(str(root))
    rng = np.random.default_rng(3)
    for name, shape in (("wide.png", (40, 90, 3)), ("tall.png", (100, 52, 3))):
        png.write_png(str(root / "images" / name), rng.integers(0, 256, shape, dtype=np.uint8))
    cfg = tcatr.CATRConfig(hidden_dim=16, nheads=8, enc_layers=1, dec_layers=2,
                           dim_feedforward=32, vocab_size=128, max_position_embeddings=8,
                           mlp_hidden=24, backbone_stages=(1, 1, 1, 1))
    # seed and end-token bias: two captions, both ended by [SEP], with every
    # greedy decision 6e-3 or more clear of the runner-up
    sd = tcatr.random_state_dict(cfg, torch.Generator().manual_seed(8))
    sd["mlp.layers.2.bias"][cfg.end_token] += 1.0
    torch.save({"model": sd}, root / "catr.pth")
    (root / "bert").mkdir()
    (root / "bert" / "vocab.txt").write_text("\n".join(bert_vocab()) + "\n", encoding="utf-8")
    return root


@pytest.mark.parametrize("mode", ["catr", "placeholder"])
def test_generate_captions_writes_the_jax_tools_json(caption_inputs, tmp_path, mode):
    root = caption_inputs
    flags = (["--catr_checkpoint", str(root / "catr.pth"), "--bert_tokenizer",
              str(root / "bert")] if mode == "catr" else ["--placeholder"])
    common = ["--image_dir", str(root / "images"), "--batch_size", "8", *flags]
    jtool.main(common + ["--output_file", str(tmp_path / "jax.json")])
    result = ttool.main(common + ["--output_file", str(tmp_path / "port.json"),
                                  "--device", "cpu"])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    captions = json.loads(want)
    assert len(captions) == len(result) == 14 and list(captions) == sorted(captions)
    if mode == "catr":  # captions that say something, cut short at [SEP]
        assert len(set(captions.values())) == 2 and all(
            c and c == c.capitalize() and len(c.split()) == 4 for c in captions.values())
    else:
        assert set(captions.values()) == {ttool.PLACEHOLDER}


def test_generate_captions_runs_on_the_card_unless_told_otherwise(caption_inputs, tmp_path,
                                                                   monkeypatch):
    argv = ["--image_dir", str(caption_inputs / "images"), "--output_file",
            str(tmp_path / "out.json"), "--placeholder"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttool.main(argv)
    assert ttool.build_argparser().get_default("device") == "cuda"
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    with pytest.raises(RuntimeError, match="needs the transformers package"):
        ttool.main(argv[:4] + ["--hf_caption_model", str(tmp_path), "--device", "cpu"])
    theirs = {a.dest: a.default for a in jtool.build_argparser()._actions}
    ours = {a.dest: a.default for a in ttool.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"}
    assert all(ours[k] == v for k, v in theirs.items())
