"""The port's serving path against the JAX package's: the inference
pipeline and the CLI.

* The pipeline's functions give the originals' results byte for byte on
  PNGs written by the port's codec: box merging with its running-suffix
  counter, the precomputed detector, `construct_visual_features` with the
  reference's (y1, x1, y2, x2) unpack, and `predict_visual_tags` with
  classifiers carried over from JAX; the YOLO detector is behind the same
  gated import.
* Both CLIs read the same weights: a JAX train-state checkpoint written
  by the JAX package's own checkpoint code from JAX-initialized params,
  and a port checkpoint holding the same params (`jax_import`), each with
  its ResNet; the two aspect taggers likewise.  Their single-sample JSON
  and their batch JSONL are equal as data.  (Both CLIs build the fusion
  stack at 768; the test narrows both to 32 through the tokenizer's
  `config.json` and a config hook, and the JAX taggers' ResNet-152 to a
  small ResNet, so that the CPU can afford it.)
* The port CLI runs on the card unless told otherwise, and takes exactly
  one of `--checkpoint` and `--bundle` (the bundle path itself:
  `tests/test_torch_port_export.py`).
"""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.inference import cli as jcli
from macsa_tpu.inference import pipeline as jpipe
from macsa_tpu.models import aspect_classifier as jac
from macsa_tpu.models.fcmf import FCMF as JFCMF
from macsa_tpu.models.resnet import VisualFeatures as JVisual
from macsa_tpu.tools.classifier_io import save_classifier_params
from macsa_tpu.train import checkpoints as jckpt
from macsa_tpu.train import common as jcommon
from macsa_tpu.train.state import TrainState as JTrainState
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.data.png import write_png
from macsa_tpu_torch.inference import cli, pipeline
from macsa_tpu_torch.models import aspect_classifier as tac
from macsa_tpu_torch.models.fcmf import FCMF as TFCMF
from macsa_tpu_torch.models.resnet import VisualFeatures as TVisual
from macsa_tpu_torch.tools import classifier_io
from macsa_tpu_torch.train import checkpoints, common, jax_import, optim
from macsa_tpu_torch.train.state import TrainState
from test_torch_port_models import jinit, randomize

SMALL = dict(hidden_size=32, num_attention_heads=4, intermediate_size=64)
TAGGER = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, dtype="float32")
NAMES = ["Location", "Food", "Room", "Facilities", "Service"]


def _boxes(rng, n):
    cats = ["bed", "chair", "tv"]
    return [{"category": cats[rng.integers(0, 3)],
             "coordinates": [int(v) for v in rng.integers(0, 300, size=4)]} for _ in range(n)]


def test_box_merging_and_detectors_match_the_originals():
    rng = np.random.default_rng(0)
    assert pipeline.DROP_ROI_LIST == jpipe.DROP_ROI_LIST
    for n in (0, 1, 5, 20):
        for eps in (0, 30, 120):
            boxes = _boxes(rng, n)
            assert pipeline.merge_boxes(boxes, eps) == jpipe.merge_boxes(boxes, eps)
    a, b = (10, 20, 30, 40), (12, 18, 45, 39)
    assert pipeline.merge_coordinates(a, b) == jpipe.merge_coordinates(a, b)
    for eps in (1, 2, 15):
        assert pipeline.are_boxes_nearby(a, b, eps) == jpipe.are_boxes_nearby(a, b, eps)
    boxes = {"img.png": [(10, 120, 20, 200), (50, 250, 5, 150)]}
    for path in ("img.png", "/some/dir/img.png", "other.png"):
        assert pipeline.PrecomputedDetector(boxes)(path) == jpipe.PrecomputedDetector(boxes)(path)
    # without ultralytics both refuse at construction, on the same gated import
    for mod in (pipeline, jpipe):
        with pytest.raises(ImportError):
            mod.YoloDetector("yolov8.pt")


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(1)
    paths = []
    for i, (h, w) in enumerate([(300, 400), (256, 256), (180, 333)]):
        path = str(root / f"im{i}.png")
        write_png(path, rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
        paths.append(path)
    boxes = {"im0.png": [(10, 120, 20, 200), (50, 250, 5, 150), (12, 125, 22, 190)],
             "im1.png": [(0, 300, 0, 300)],  # clipped to the image
             "im2.png": [(170, 179, 40, 90), (200, 260, 10, 20)]}  # the second is empty
    return paths + [str(root / "missing.png")], boxes


@pytest.mark.parametrize("eps", [0.0, 30.0])
def test_construct_visual_features_is_the_original_byte_for_byte(pngs, eps):
    paths, boxes = pngs
    got = pipeline.construct_visual_features(pipeline.PrecomputedDetector(boxes), paths, eps,
                                             num_roi=2, num_img=4)
    want = jpipe.construct_visual_features(jpipe.PrecomputedDetector(boxes), paths, eps,
                                           num_roi=2, num_img=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert np.abs(got[0][0]).sum() > 0 and np.abs(got[0][3]).sum() == 0  # missing image


def _taggers(rng, size=224):
    """JAX image/ROI classifiers (small ResNet, random) and the port's copies."""
    out = []
    for _ in range(2):
        model = jac.AspectClassifier(5, jcfg.ResNetConfig(**TAGGER))
        params = randomize(jinit(model, np.zeros((1, size, size, 3), np.float32)), rng)
        port = tac.AspectClassifier(5, tcfg.ResNetConfig(**TAGGER))
        port.load_state_dict(jax_import.aspect_classifier_state_dict_from_jax(params["params"]))
        out.append((model, params, port))
    return out


def test_predict_visual_tags_matches_the_original(pngs):
    paths, boxes = pngs
    (jimg, ip, timg), (jroi, rp, troi) = _taggers(np.random.default_rng(2))
    # place each class's image logit threshold between this set's images
    from macsa_tpu_torch.data.images import decode_image, resize_normalize
    inputs = np.stack([resize_normalize(decode_image(p)) for p in paths[:3]])
    with torch.no_grad():
        mid = timg(torch.from_numpy(inputs)).sort(dim=0).values[1]
    ip["params"]["linear"]["bias"] = (ip["params"]["linear"]["bias"] + np.log(0.6 / 0.4)
                                      - mid.numpy() + 0.05)
    timg.load_state_dict(jax_import.aspect_classifier_state_dict_from_jax(ip["params"]))
    det = (pipeline.PrecomputedDetector(boxes), jpipe.PrecomputedDetector(boxes))
    got = pipeline.predict_visual_tags(det[0], timg, troi, paths, NAMES)
    want = jpipe.predict_visual_tags(det[1], jimg, ip, jroi, rp, paths, NAMES)
    assert got == want and got[0] and got[1]


# ---------------------------------------------------------------------------
# the two CLIs on shared weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Synthetic files, a 32-wide tokenizer config, and the shared weights
    as a JAX orbax checkpoint and a port checkpoint, with tagger files."""
    root = tmp_path_factory.mktemp("serving")
    data = str(root / "synth")
    synth.write_dataset(data)
    tok = os.path.join(data, "tok")
    with open(os.path.join(tok, "config.json")) as f:
        hf = json.load(f)
    hf.update(hidden_size=32, num_attention_heads=4, intermediate_size=64)
    with open(os.path.join(tok, "config.json"), "w") as f:
        json.dump(hf, f)

    rng = np.random.default_rng(3)
    text = jcfg.TextEncoderConfig.from_hf_config(hf, dtype="float32")
    model = JFCMF(jcfg.FCMFConfig(model=jcfg.ModelConfig(**SMALL), text=text, num_imgs=2,
                                  num_roi=2, max_text_len=48))
    ids = np.full((1, 48), 5, np.int32)
    params = randomize(jinit(model, ids, np.zeros((1, 2, 49, 2048), np.float32),
                             np.zeros((1, 2, 2, 2048), np.float32),
                             np.zeros((1, 2, 2, 4), np.float32), None, np.ones_like(ids),
                             np.ones((1, 48 + 49), np.int32))["params"], rng)
    # a head steep enough that the reviews' predictions differ
    params["classifier"]["kernel"] = params["classifier"]["kernel"] * 20.0
    params["classifier"]["bias"] = np.zeros_like(params["classifier"]["bias"])
    visual = JVisual(jcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), dtype="float32"))
    visual_params = randomize(jinit(visual, np.zeros((1, 224, 224, 3), np.float32)), rng)
    jax_dir = str(root / "jax")
    manager = jckpt.CheckpointManager(jax_dir)
    manager.save("best", JTrainState.create(params, visual_params, optax.sgd(0.1)), 1)
    manager.finalize()

    port = TFCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(dtype="float32", fused_attention=False,
                                                        **SMALL),
                                 text=dataclasses.replace(
                                     common.text_config_from_hf(hf, "float32"),
                                     fused_attention=False),
                                 num_imgs=2, num_roi=2, max_text_len=48))
    port.load_state_dict(jax_import.fcmf_state_dict_from_jax(params, 2), strict=True)
    port_visual = TVisual(tcfg.ResNetConfig(stage_sizes=(1, 1, 1, 1), dtype="float32"))
    port_visual.load_state_dict(jax_import.visual_state_dict_from_jax(visual_params["params"]))
    port_dir = str(root / "port")
    checkpoints.CheckpointManager(port_dir).save(
        "best", TrainState.create(port, port_visual, optim.AdamW(port, 1e-3)), 1)

    # taggers whose answers do not depend on the pixels: image tags
    # Location and Room (sigmoid > 0.6), ROI tag Food (argmax)
    taggers = {}
    for kind, bias in (("image", [3.0, -3.0, 3.0, -3.0, -3.0]),
                       ("roi", [1.0, 2.0, 0.0, -1.0, 0.5])):
        (jmodel, p, tmodel), _ = _taggers(rng)
        p["params"]["linear"]["kernel"] = np.zeros_like(p["params"]["linear"]["kernel"])
        p["params"]["linear"]["bias"] = np.asarray(bias, np.float32)
        tmodel.load_state_dict(jax_import.aspect_classifier_state_dict_from_jax(p["params"]))
        save_classifier_params(str(root / f"{kind}_jax"), p)
        classifier_io.save_classifier(str(root / f"{kind}_port"), tmodel)
        taggers[kind] = (str(root / f"{kind}_jax"), str(root / f"{kind}_port"))

    with open(os.path.join(data, "data", "train.json")) as f:
        records = [{"text": r["comment"],
                    "image_list": [os.path.join(data, "images", n) for n in r["list_img"]]}
                   for r in json.load(f)[:5]]
    records[3]["image_list"] = []  # a review without images
    with open(root / "records.json", "w") as f:
        json.dump(records, f, ensure_ascii=False)
    return {"root": root, "data": data, "jax": os.path.join(jax_dir, "best"),
            "port": port_dir, "taggers": taggers, "records": records}


def _port_hook(cfg, rcfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **SMALL)), rcfg


def _common(served, *extra):
    data = served["data"]
    return ["--pretrained_hf_model", os.path.join(data, "tok"), "--roi_csv",
            os.path.join(data, "data", "roi_data.csv"), "--num_imgs", "2", "--num_rois", "2",
            "--max_seq_length", "48", "--resnet_stages", "1,1,1,1", "--fused_attention", "off",
            *extra]


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX CLI at the test's width: its 768-wide ModelConfig and its
    taggers' ResNet-152 narrowed, no persistent compile cache."""
    monkeypatch.setattr(jcli, "ModelConfig", functools.partial(jcli.ModelConfig, **SMALL))
    monkeypatch.setattr(jac, "AspectClassifier", functools.partial(
        jac.AspectClassifier, config=jcfg.ResNetConfig(**TAGGER)))
    monkeypatch.setattr(jcommon, "enable_compilation_cache", lambda: None)
    return jcli.main


def test_single_sample_json_equals_the_jax_clis(served, jax_cli, tmp_path):
    rec = served["records"][0]
    args = _common(served, "--text", rec["text"], "--image_list", *rec["image_list"],
                   "--image_model_checkpoint", "{image}", "--roi_model_checkpoint", "{roi}")

    def argv(side, out):
        k = 0 if side == "jax" else 1
        a = [x.format(image=served["taggers"]["image"][k], roi=served["taggers"]["roi"][k])
             for x in args]
        return a + ["--checkpoint", served[side], "--output_file", str(out)]

    want = jax_cli(argv("jax", tmp_path / "jax.json"))
    got = cli.main(argv("port", tmp_path / "port.json") + ["--device", "cpu"],
                   config_hook=_port_hook)
    assert got == want
    doc = json.loads((tmp_path / "port.json").read_text())
    assert doc == json.loads((tmp_path / "jax.json").read_text())
    assert doc["image_tags"] == ["Location", "Room"] and doc["roi_tags"] == ["Food"]


def test_batch_jsonl_equals_the_jax_clis(served, jax_cli, tmp_path):
    args = _common(served, "--input_json", str(served["root"] / "records.json"),
                   "--batch_size", "2")
    want = jax_cli(args + ["--checkpoint", served["jax"], "--output_file",
                           str(tmp_path / "jax.jsonl")])
    got = cli.main(args + ["--checkpoint", served["port"], "--output_file",
                           str(tmp_path / "port.jsonl"), "--device", "cpu"],
                   config_hook=_port_hook)
    rows = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert rows == [json.loads(line)
                    for line in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert len(rows) == 5 and all(r["image_tags"] == ["empty"] for r in rows)  # no taggers
    assert len({tuple(r["prediction"].values()) for r in rows}) > 1  # reviews differ
    assert {k: got[k] for k in ("records", "batch_size")} == \
        {k: want[k] for k in ("records", "batch_size")} == {"records": 5, "batch_size": 2}
    assert got["records_per_s"] > 0 and 0 < got["host_prep_share"] + got["forward_share"] <= 1


def test_cli_runs_on_the_card_unless_told_otherwise_and_refuses_bundle(served):
    rec = served["records"][0]
    args = _common(served, "--text", rec["text"], "--checkpoint", served["port"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    with pytest.raises(SystemExit):  # --checkpoint and --bundle together
        cli.main(args + ["--device", "cpu", "--bundle", "some/bundle"])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        cli.main(args + ["--device", "cpu", "--fused_attention", "on"])
    assert cli.build_argparser().get_default("device") == "cuda"
    theirs = {a.dest for a in jcli.build_argparser()._actions}
    assert {a.dest for a in cli.build_argparser()._actions} - theirs == {"device"}
    assert theirs <= {a.dest for a in cli.build_argparser()._actions}
