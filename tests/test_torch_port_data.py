"""The port's host data path against the JAX package's, copy by copy.

Every module here is host code that the port carries as its own copy (it
may not import `macsa_tpu`): the same inputs go through the original and
the copy, and the outputs must be equal: byte for byte where the original
pins a format.  The synthetic dataset comes from both generators
(`tools_dev/make_synth_data.py`, which needs `tokenizers` and PIL, and the
port's `data/synth.py`, which needs neither) and must be the same files.
"""

import importlib.util
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from macsa_tpu.data import images as jimages
from macsa_tpu.data import loader as jloader
from macsa_tpu.data import text_preprocess as jtext
from macsa_tpu.data import vimacsa as jvimacsa
from macsa_tpu.train import common as jcommon
from macsa_tpu.train import metrics as jmetrics
from macsa_tpu_torch import native as tnative
from macsa_tpu_torch.data import images as timages
from macsa_tpu_torch.data import loader as tloader
from macsa_tpu_torch.data import png, synth
from macsa_tpu_torch.data import text_preprocess as ttext
from macsa_tpu_torch.data import tokenizer as ttokenizer
from macsa_tpu_torch.data import vimacsa as tvimacsa
from macsa_tpu_torch.train import common as tcommon
from macsa_tpu_torch.train import metrics as tmetrics
from macsa_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_FILES = ("tok/tokenizer.json", "tok/tokenizer_config.json", "tok/config.json",
              "data/train.json", "data/dev.json", "data/test.json",
              "data/train_with_iaog.json", "data/dev_with_iaog.json", "data/roi_data.csv",
              "data/resnet152_image_label.json", "data/resnet152_roi_label.json")
TEXTS = ["Khách sạn   RẤT đẹpppp!!! :)) @user #tag1 phòng sạch 😀😀",
         "Dịch vụ tệ... nhân viên chậmmm ~~ giá (rẻ) 'tốt' \"ok\"",
         "à é ố — decomposed marks", "", "BÌNH THƯỜNG; view + biển?"]


@pytest.fixture(scope="module")
def synth_dirs(tmp_path_factory):
    """(the original generator's output, the port's) from seed 0."""
    root = tmp_path_factory.mktemp("synth")
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools_dev", "make_synth_data.py"))
    original = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(original)
    argv, sys.argv = sys.argv, ["make_synth_data.py", str(root / "original")]
    try:
        original.main()
    finally:
        sys.argv = argv
    synth.main([str(root / "port")])
    return str(root / "original"), str(root / "port")


# ---- text, metrics, logging ------------------------------------------------

@pytest.mark.parametrize("text", TEXTS)
def test_text_normalize_copy(text):
    assert ttext.convert_unicode(text) == jtext.convert_unicode(text)
    assert ttext.TextNormalize().normalize(text) == jtext.TextNormalize().normalize(text)
    assert tcommon.normalize_comment(text) == jcommon.normalize_comment(text)
    for word in text.split():
        assert ttext.TextNormalize().word_standardize(word) == \
            jtext.TextNormalize().word_standardize(word)


def test_metrics_copy_and_report_bytes(tmp_path):
    rng = np.random.default_rng(0)
    trues = rng.integers(0, 4, size=(23, 6))
    preds = rng.integers(0, 4, size=(23, 6))
    preds[:, 2] = 1  # an aspect with one predicted class only
    want, got = jmetrics.aspect_report(trues, preds), tmetrics.aspect_report(trues, preds)
    assert got == want
    assert tmetrics.macro_prf(trues[:, 0], preds[:, 0]) == jmetrics.macro_prf(trues[:, 0],
                                                                              preds[:, 0])
    texts = [f"câu {i} phòng đẹp" for i in range(23)]
    assert tmetrics.format_results_report(got) == jmetrics.format_results_report(want)
    assert tmetrics.format_predictions_dump(texts, trues, preds) == \
        jmetrics.format_predictions_dump(texts, trues, preds)
    for name, module in (("j", jmetrics), ("t", tmetrics)):
        os.makedirs(tmp_path / name)
        module.write_test_reports(str(tmp_path / name), got, texts, trues, preds)
    for file in ("test_results_fcmf.txt", "test_predictions_formatted.txt"):
        assert (tmp_path / "t" / file).read_bytes() == (tmp_path / "j" / file).read_bytes()


def test_logging_copy_writes_log_metrics_and_a_torch_trace(tmp_path):
    logger = tlogging.setup_logging(str(tmp_path), name="macsa_tpu_torch.test")
    logger.info("hello")
    for handler in logger.handlers:
        handler.flush()
    assert "hello" in (tmp_path / "train.log").read_text()
    writer = tlogging.MetricWriter(str(tmp_path))
    writer.write(3, loss=np.float32(1.5), epoch=0, note="x")
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["note"] == "x"
    with tlogging.maybe_profile(None):
        pass
    with tlogging.maybe_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    logger.handlers.clear()


# ---- synthetic data, tokenizer ----------------------------------------------

@pytest.mark.parametrize("name", DATA_FILES)
def test_synth_files_are_the_original_generators_bytes(synth_dirs, name):
    original, port = synth_dirs
    with open(os.path.join(original, name), "rb") as a, open(os.path.join(port, name), "rb") as b:
        assert a.read() == b.read()


def test_synth_images_decode_to_the_same_pixels_by_all_three_decoders(synth_dirs):
    original, port = synth_dirs
    names = sorted(os.listdir(os.path.join(original, "images")))
    assert names == sorted(os.listdir(os.path.join(port, "images"))) and len(names) == 12
    assert tnative.has_decode()
    for name in names:
        want = np.asarray(Image.open(os.path.join(original, "images", name)).convert("RGB"))
        path = os.path.join(port, "images", name)
        decoded = [decoder(path) for _, decoder in timages.DECODERS]
        assert len(decoded) == 3
        for got in decoded:
            assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert np.array_equal(timages.decode_image(path), want)


def test_synth_scales_images_and_boxes_together(tmp_path):
    synth.write_dataset(str(tmp_path), n_train=4, image_size=128, n_dev=3, n_test=2, n_images=5)
    assert png.read_png(str(tmp_path / "images" / "img_004.png")).shape == (128, 128, 3)
    boxes = timages.roi_boxes_from_csv(str(tmp_path / "data" / "roi_data.csv"))
    assert all(x2 - x1 == 48 and y2 - y1 == 48 and x2 <= 128 and y2 <= 128
               for rows in boxes.values() for x1, x2, y1, y2 in rows)
    assert [len(json.load(open(tmp_path / "data" / f"{s}.json")))
            for s in ("train", "dev", "test")] == [4, 3, 2]
    with pytest.raises(ValueError, match="multiple of 64"):
        synth.write_dataset(str(tmp_path), image_size=100)


def test_tokenizer_reader_matches_the_hf_fast_tokenizer(synth_dirs):
    from transformers import AutoTokenizer
    tok_dir = os.path.join(synth_dirs[1], "tok")
    hf = AutoTokenizer.from_pretrained(tok_dir, local_files_only=True)
    mine = ttokenizer.WordLevelTokenizer.from_dir(tok_dir)
    assert len(mine) == len(hf) and mine.pad_token_id == hf.pad_token_id
    words = list(mine.vocab) + ["xyz", "Hello", "a_b", "!!", "</s></s>", "don't", "x,y", "ồn."]
    rng = np.random.default_rng(0)
    truncated = 0
    for _ in range(300):
        a = " ".join(rng.choice(words, size=rng.integers(1, 220)))
        b = " ".join(rng.choice(words, size=rng.integers(1, 12)))
        kw = dict(max_length=int(rng.choice([48, 170])), truncation="only_first",
                  padding="max_length", return_token_type_ids=True)
        want, got = hf(a, b, **kw), mine(a, b, **kw)
        truncated += want["attention_mask"][-1] == 1
        for key in ("input_ids", "token_type_ids", "attention_mask"):
            assert list(want[key]) == got[key], (key, a, b)
    assert 50 < truncated < 290  # pairs that truncate and pairs that pad
    single = dict(max_length=16, truncation="only_first", padding="max_length")
    assert mine("phòng đẹp , sạch .", **single)["input_ids"] == \
        list(hf("phòng đẹp , sạch .", **single)["input_ids"])
    with pytest.raises(ValueError, match="must go"):
        mine("a", " ".join(["phòng"] * 60), max_length=48, truncation="only_first")
    with pytest.raises(ValueError, match="not offered"):
        mine("a", "b", max_length=48, truncation="only_second")


def test_tokenizer_reader_truncates_pairs_longest_first_as_hf(synth_dirs):
    """`truncation=True` on a pair is HF's `longest_first`: the `tokenizers`
    split of max_length between the two sides (the shorter keeps what it
    has; if both overflow, half each, the odd token to the longer side, to
    the second when they are as long), over seeded pairs that overflow
    either side or both, at odd and even lengths."""
    from transformers import AutoTokenizer
    tok_dir = os.path.join(synth_dirs[1], "tok")
    hf = AutoTokenizer.from_pretrained(tok_dir, local_files_only=True)
    mine = ttokenizer.WordLevelTokenizer.from_dir(tok_dir)
    words = list(mine.vocab) + ["xyz", "</s></s>", "ồn."]
    rng = np.random.default_rng(1)
    seen = set()
    for _ in range(400):
        n_a, n_b = (int(n) for n in rng.integers(1, 50, 2))
        a, b = (" ".join(rng.choice(words, size=n)) for n in (n_a, n_b))
        max_length = int(rng.integers(6, 60))
        for truncation in (True, "longest_first"):
            kw = dict(max_length=max_length, truncation=truncation, padding="max_length")
            want, got = hf(a, b, **kw), mine(a, b, **kw)
            assert list(want["input_ids"]) == got["input_ids"], (a, b, max_length)
            assert list(want["attention_mask"]) == got["attention_mask"]
        la, lb = len(mine.tokenize(a)), len(mine.tokenize(b))
        room = max_length - 4  # <s> A </s></s> B </s>
        if la + lb > room:
            seen.add(("both" if min(la, lb) > room // 2 else "one", la == lb, room % 2))
    assert {("both", False, 0), ("both", False, 1), ("one", False, 0),
            ("one", False, 1)} <= seen
    assert ttokenizer.longest_first_lengths(9, 9, 7) == (3, 4)  # equal: the odd one second
    assert ttokenizer.longest_first_lengths(12, 9, 7) == (4, 3)  # to the longer
    assert ttokenizer.longest_first_lengths(2, 30, 7) == (2, 5)
    assert ttokenizer.longest_first_lengths(30, 2, 7) == (5, 2)
    for a, b, m in ((9, 9, 7), (12, 9, 7), (10, 10, 12)):
        assert hf("phòng " * a, "đẹp " * b, max_length=m + 4, truncation=True)[
            "input_ids"] == mine("phòng " * a, "đẹp " * b, max_length=m + 4, truncation=True)[
            "input_ids"]


@pytest.mark.parametrize("part,value,named", [
    ("model", {"type": "BPE", "vocab": {}, "merges": []}, "BPE"),
    ("pre_tokenizer", {"type": "ByteLevel"}, "ByteLevel"),
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("post_processor", {"type": "RobertaProcessing"}, "RobertaProcessing")])
def test_tokenizer_reader_refuses_other_models_by_name(synth_dirs, tmp_path, part, value, named):
    tok_dir = os.path.join(synth_dirs[1], "tok")
    spec = json.load(open(os.path.join(tok_dir, "tokenizer.json"), encoding="utf-8"))
    spec[part] = value
    json.dump(spec, open(tmp_path / "tokenizer.json", "w"))
    with pytest.raises(ValueError, match=named):
        ttokenizer.WordLevelTokenizer.from_dir(str(tmp_path))


def test_load_tokenizer_is_thread_safe_hf_where_transformers_imports(synth_dirs):
    tok = ttokenizer.load_tokenizer(os.path.join(synth_dirs[1], "tok"))
    assert isinstance(tok, tloader.ThreadSafeTokenizer) and tok.pad_token_id == 1
    assert len(tok) == 54


# ---- images -------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", list(png.FILTERS) + ["mixed"])
def test_png_codec_against_pil_and_libpng(tmp_path, channels, filters):
    rng = np.random.default_rng(channels)
    shape = (19, 33) if channels == 1 else (19, 33, channels)
    smooth = (np.add.outer(np.arange(19) * 7, np.arange(33) * 3) % 256).astype(np.uint8)
    image = (rng.integers(0, 40, shape) + smooth.reshape(19, 33, *([1] * (len(shape) - 2)))
             ).astype(np.uint8)
    kinds = [png.FILTERS[y % 5] for y in range(19)] if filters == "mixed" else filters
    path = str(tmp_path / "x.png")
    png.write_png(path, image, kinds)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(png.read_png(path), want)
    assert np.array_equal(tnative.decode(path), want)
    if channels == 3:
        assert np.array_equal(want, image)


def test_png_reader_reads_pil_files_and_names_what_it_does_not_read(tmp_path):
    rng = np.random.default_rng(0)
    image = np.cumsum(rng.integers(0, 3, (40, 50, 3)), axis=1).astype(np.uint8)
    Image.fromarray(image).save(tmp_path / "adaptive.png")  # PIL picks filters per line
    assert np.array_equal(png.read_png(str(tmp_path / "adaptive.png")), image)
    Image.fromarray(image).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(str(tmp_path / "palette.png"))
    Image.fromarray(image[:, :, 0].astype(np.uint16) * 200).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(str(tmp_path / "deep.png"))
    data = png.encode_png(image)
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(data[:60] + bytes([data[60] ^ 1]) + data[61:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"JFIF" * 10)


def test_unreadable_image_becomes_a_zero_frame(tmp_path, caplog):
    (tmp_path / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"garbage" * 5)
    assert timages.decode_image(str(tmp_path / "broken.png")) is None
    assert timages.decode_image(str(tmp_path / "absent.png")) is None
    images, rois, coors = timages.build_visual_tensors(
        ["broken.png"], str(tmp_path), {"broken.png": [(0, 8, 0, 8)]}, 2, 2, size=16,
        pixel_mode="packed")
    assert not images.any() and not rois.any() and not coors.any()
    # which decoder served is logged once per decoder
    timages._served.clear()
    png.write_png(str(tmp_path / "ok.png"), np.zeros((4, 4, 3), np.uint8))
    with caplog.at_level(logging.INFO, logger="macsa_tpu_torch.images"):
        for _ in range(3):
            timages.decode_image(str(tmp_path / "ok.png"))
    assert [r.getMessage() for r in caplog.records] == [
        "image decode: served by native libjpeg/libpng"]


@pytest.mark.parametrize("shape", [(256, 256), (300, 180), (24, 24), (97, 131), (224, 225)])
def test_numpy_resize_is_the_native_arithmetic(shape):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    native = tnative.resize_u8(img, 224)
    got = timages.resize_u8_numpy(img, 224)
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - native.astype(int)).max() <= 1
    assert np.array_equal(native, jimages.resize_u8(img, 224))


def test_native_copy_builds_without_the_decoders(tmp_path):
    """`-DIP_NO_DECODE`: resize and normalize stay, decode says it is absent."""
    so = str(tmp_path / "nodecode.so")
    subprocess.run(tnative._FLAGS + ["-DIP_NO_DECODE", tnative._SRC, "-o", so], check=True,
                   capture_output=True, timeout=300)
    import ctypes
    lib = tnative._bind(ctypes.CDLL(so))
    assert lib.ip_has_decode() == 0 and tnative.has_decode()
    img = np.random.default_rng(0).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    out = np.empty((32, 32, 3), np.uint8)
    lib.ip_resize_u8(tnative._u8p(img), 40, 50, tnative._u8p(out), 32, 32)
    assert np.array_equal(out, tnative.resize_u8(img, 32))
    h, w = ctypes.c_int(), ctypes.c_int()
    assert not lib.ip_decode(b"/nonexistent.png", ctypes.byref(h), ctypes.byref(w))
    assert os.path.dirname(tnative.ensure_built()) == tnative.BUILD_DIR


@pytest.mark.parametrize("pixel_mode", ["f32", "packed", "u8"])
def test_build_visual_tensors_copy(synth_dirs, pixel_mode):
    folder = os.path.join(synth_dirs[1], "images")
    boxes = timages.roi_boxes_from_csv(os.path.join(synth_dirs[1], "data", "roi_data.csv"))
    assert boxes == jimages.roi_boxes_from_csv(os.path.join(synth_dirs[0], "data",
                                                           "roi_data.csv"))
    boxes["img_003.png"] = boxes["img_003.png"] + [(70, 90, 0, 10)]  # an empty crop
    names = ["img_003.png", "missing.png", "img_007.png"]
    want = jimages.build_visual_tensors(names, folder, boxes, 4, 3, size=32,
                                        pixel_mode=pixel_mode)
    got = timages.build_visual_tensors(names, folder, boxes, 4, 3, size=32,
                                       pixel_mode=pixel_mode)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
    assert got[0].dtype == {"f32": np.float32, "packed": np.int32, "u8": np.uint8}[pixel_mode]


# ---- dataset, loader, driver plumbing -----------------------------------------

def _datasets(synth_dirs, split="train", pixel_mode="packed"):
    out = []
    for module, common, load_tok, root in (
            (jvimacsa, jcommon, jcommon.load_tokenizer, synth_dirs[0]),
            (tvimacsa, tcommon, ttokenizer.load_tokenizer, synth_dirs[1])):
        data_dir = os.path.join(root, "data")
        records = common.load_records(os.path.join(data_dir, f"{split}.json"))
        boxes, dict_img, dict_roi = common.load_metadata(data_dir)
        out.append(module.MACSADataset(records, load_tok(os.path.join(root, "tok")),
                                       os.path.join(root, "images"), boxes, dict_img, dict_roi,
                                       num_img=2, num_roi=2, max_text_len=48,
                                       pixel_mode=pixel_mode))
    return out


def test_records_and_metadata_copy(synth_dirs):
    jds, tds = _datasets(synth_dirs)
    assert tds.records == jds.records and len(tds) == 16
    assert tds.roi_boxes == jds.roi_boxes and tds.dict_image_aspect == jds.dict_image_aspect
    with pytest.raises(ValueError, match="roi_data.csv"):
        tcommon.load_metadata(os.path.join(synth_dirs[1], "tok"))


@pytest.mark.parametrize("shuffle", [True, False])
def test_one_synth_batch_is_equal_from_both_loaders(synth_dirs, shuffle):
    jds, tds = _datasets(synth_dirs)
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, drop_last=shuffle, num_workers=2,
              cache=True, eval_stripe=not shuffle)
    jl, tl = jloader.DataLoader(jds, **kw), tloader.DataLoader(tds, **kw)
    jl.set_epoch(1), tl.set_epoch(1)
    assert len(jl) == len(tl) == 4
    for want, got in zip(jl, tl):
        assert list(got) == list(want)
        for key in want:
            if isinstance(want[key], list):
                assert got[key] == want[key]
            else:
                # packed pixel words: the same bytes, int32 here (torch has few
                # uint32 operations) and uint32 there
                same_type = got[key].dtype == want[key].dtype or (
                    key in ("images", "roi_images") and got[key].dtype == np.int32
                    and want[key].dtype == np.uint32)
                assert same_type and got[key].tobytes() == want[key].tobytes(), key
        assert got["images"].shape == (4, 2, 1 + 224 * 224 * 3 // 4)
        padded, jpadded = tloader.pad_batch(got, 6), jloader.pad_batch(want, 6)
        assert all(padded[k].tobytes() == jpadded[k].tobytes() for k in padded
                   if not isinstance(padded[k], list))
        assert list(padded["_idx"][-2:]) == [-1, -1]


def test_loader_gates_pixels_and_refuses_more_hosts(synth_dirs):
    jds, tds = _datasets(synth_dirs)
    warm = np.zeros(len(tds), bool)
    loader = tloader.DataLoader(tds, 4, num_workers=2, cache=True,
                                needs_pixels=lambda i: not warm[i])
    first = next(iter(loader))
    assert "images" in first and "roi_images" in first
    warm[:] = True
    light = next(iter(loader))
    assert "images" not in light and np.array_equal(light["input_ids"], first["input_ids"])
    # more hosts are no longer refused (data parallelism): each host's train
    # shard and eval stripes are the original loader's, row for row
    for host in (0, 1):
        for kw in (dict(shuffle=True, seed=3, drop_last=True), dict(eval_stripe=True)):
            got, want = (
                [b["_idx"].tolist() for b in mod.DataLoader(ds, 3, num_workers=2, num_hosts=2,
                                                            host_id=host, **kw)]
                for mod, ds in ((tloader, tds), (jloader, jds)))
            assert got == want and got, (host, kw)


def test_text_config_and_fingerprint(synth_dirs, tmp_path):
    tok_dir = os.path.join(synth_dirs[1], "tok")
    want, got = jcommon.build_text_config(tok_dir, "float32"), \
        tcommon.build_text_config(tok_dir, "float32", fused_attention=True)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                  "intermediate_size", "max_position_embeddings", "type_vocab_size",
                  "pad_token_id", "layer_norm_eps", "hidden_dropout_prob", "dtype"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.fused_attention and got.num_hidden_layers == 2 and got.vocab_size == 54
    assert tcommon.build_text_config(None).vocab_size == jcommon.build_text_config(None).vocab_size
    from macsa_tpu.config import ResNetConfig as JResNetConfig
    from macsa_tpu_torch.config import ResNetConfig as TResNetConfig
    weights = tmp_path / "resnet.pth"
    weights.write_bytes(b"weights")
    assert tcommon.resnet_fingerprint(str(weights), TResNetConfig(), 3) == \
        jcommon.resnet_fingerprint(str(weights), JResNetConfig(), 3)
    # random weights differ between the packages, so their cache entries must too
    assert tcommon.resnet_fingerprint(None, TResNetConfig(), 3) != \
        jcommon.resnet_fingerprint(None, JResNetConfig(), 3)
