"""The port's aspect classifier and offline labelers against the JAX package.

* `AspectClassifier`: logits from parameters made in JAX (atol 1e-4); a
  reference MyImgModel `.pth` (with its `no_fc.*` duplicates) loads into
  the port and gives the logits JAX gives through
  `import_torch_aspect_classifier`; the predict functions.
* The labelers' train steps: two plain-Adam updates over every parameter,
  the backbone's four BatchNorm tensors included, with the sigmoid BCE of
  `tools/image_categories.py` and the CE of `tools/roi_categories.py`,
  against `optax.adam` on the JAX module: losses and parameters.
* The label-table readers and the image-level split: the copies equal the
  originals.
* `--get_cate` of both tools from the same weights (the JAX tools'
  classifier narrowed for the CPU): the same label JSONs.  `--do_train`
  of both port tools writes the classifier file and labels every image.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from macsa_tpu import config as jcfg
from macsa_tpu.models import aspect_classifier as jac
from macsa_tpu.tools import image_categories as jimage
from macsa_tpu.tools import roi_categories as jroi
from macsa_tpu.tools.classifier_io import save_classifier_params
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.data import synth
from macsa_tpu_torch.models import aspect_classifier as tac
from macsa_tpu_torch.models.resnet import trainable_batchnorm_
from macsa_tpu_torch.tools import classifier_io
from macsa_tpu_torch.tools import image_categories as timage
from macsa_tpu_torch.tools import roi_categories as troi
from macsa_tpu_torch.train import jax_import
from test_torch_port_models import jinit, randomize

SMALL = dict(stage_sizes=(1, 1, 1, 1), num_filters=4, dtype="float32")
CLASSES = ["Location", "Food", "Room", "Facilities", "Service"]


def _pair(rng, size=64):
    model = jac.AspectClassifier(len(CLASSES), jcfg.ResNetConfig(**SMALL))
    params = randomize(jinit(model, np.zeros((1, size, size, 3), np.float32)), rng)
    port = tac.AspectClassifier(len(CLASSES), tcfg.ResNetConfig(**SMALL))
    port.load_state_dict(jax_import.aspect_classifier_state_dict_from_jax(params["params"]),
                         strict=True)
    return model, params, port


def test_classifier_logits_and_reference_pth_import_match_jax(rng, tmp_path):
    model, params, port = _pair(rng)
    x = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-4)
    # a reference MyImgModel file: `no_fc.*` views of the backbone, torchvision's
    # unused `fc`, the BN counters; JAX reads it through its own importer
    sd = dict(port.state_dict())
    for k, v in list(sd.items()):
        if k.startswith("feature_extractor."):
            sd["no_fc." + k[len("feature_extractor."):]] = v
    sd["feature_extractor.fc.weight"] = torch.zeros(7, 128)
    sd["feature_extractor.fc.bias"] = torch.zeros(7)
    sd["feature_extractor.bn1.num_batches_tracked"] = torch.tensor(5)
    path = tmp_path / "MyImgModel.pth"
    torch.save(sd, path)
    jparams = jac.import_torch_aspect_classifier(
        {k: v.numpy() for k, v in sd.items()}, stage_sizes=SMALL["stage_sizes"])
    want = np.asarray(model.apply({"params": jparams}, jnp.asarray(x)))
    loaded = classifier_io.load_classifier(
        str(path), tac.AspectClassifier(len(CLASSES), tcfg.ResNetConfig(**SMALL)))
    with torch.no_grad():
        np.testing.assert_allclose(loaded(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-4)
    # the port's own file keeps the classifier's ResNet configuration
    classifier_io.save_classifier(str(tmp_path / "own"), port)
    again = classifier_io.load_classifier(str(tmp_path / "own"))
    assert again.config == port.config
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 port.state_dict().values()))


def test_predict_functions_match_jax(rng):
    logits = rng.normal(0, 2, size=(6, 5)).astype(np.float32)
    assert tac.predict_image_aspects(torch.from_numpy(logits), CLASSES, 0.45) == \
        jac.predict_image_aspects(jnp.asarray(logits), CLASSES, 0.45)
    assert tac.predict_roi_aspects(torch.from_numpy(logits), CLASSES) == \
        jac.predict_roi_aspects(jnp.asarray(logits), CLASSES)


def _jax_ce(logits, labels):  # the loss of macsa_tpu/tools/roi_categories.py:131-134
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, labels[:, None], axis=-1).mean()


@pytest.mark.parametrize("tool", ["image", "roi"])
def test_train_steps_match_jax(rng, tool):
    """Two Adam steps at the tools' rate, 1e-4: losses (rtol 1e-5) and every
    parameter (atol 1e-6, at most one element in a thousand beyond; none
    beyond 1e-5: Adam's bias correction is f32 in optax, double in torch)."""
    model, params, port = _pair(rng)
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    if tool == "image":
        labels = (rng.uniform(size=(4, 5)) < 0.4).astype(np.float32)
        jloss, tloss = jimage.sigmoid_bce, timage.sigmoid_bce
    else:
        labels = rng.integers(0, 5, size=(4,)).astype(np.int32)
        jloss, tloss = _jax_ce, timage.softmax_ce
    tx = optax.adam(1e-4)

    @jax.jit
    def jstep(p, opt_state, x, y):  # the JAX tools' train_step
        loss, grads = jax.value_and_grad(lambda pp: jloss(model.apply({"params": pp}, x), y))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    p, opt_state, want = params["params"], tx.init(params["params"]), []
    for _ in range(2):
        p, opt_state, loss = jstep(p, opt_state, jnp.asarray(images), jnp.asarray(labels))
        want.append(float(loss))
    step = timage.make_train_step(trainable_batchnorm_(port), tloss, 1e-4)
    got = [float(step(torch.from_numpy(images), torch.from_numpy(labels))) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_sd = jax_import.aspect_classifier_state_dict_from_jax(p)
    before = jax_import.aspect_classifier_state_dict_from_jax(params["params"])
    now = port.state_dict()
    assert set(now) == set(want_sd)
    beyond, total = 0, 0
    for name, value in now.items():
        assert not torch.equal(value, before[name]), name  # every tensor trains
        diff = (value - want_sd[name]).abs()
        assert diff.max() <= 1e-5, name
        beyond, total = beyond + int((diff > 1e-6).sum()), total + diff.numel()
    assert beyond <= 1e-3 * total, (beyond, total)


def test_label_tables_and_split_equal_the_originals(tmp_path):
    rng = np.random.default_rng(1)
    names = [f"img_{i:03d}.png" for i in range(20)]
    table = {n: [c for c in CLASSES + ["Public_area"] if rng.uniform() < 0.3] for n in names}
    (tmp_path / "labels.json").write_text(json.dumps(table))
    with open(tmp_path / "labels.csv", "w") as f:
        f.write("file_name," + ",".join(CLASSES[::-1]) + "\n")
        for n in names:
            f.write(n + "," + ",".join(str(int(c in table[n])) for c in CLASSES[::-1]) + "\n")
    for name in ("labels.json", "labels.csv"):
        got = timage.load_label_table(str(tmp_path / name), CLASSES)
        want = jimage.load_label_table(str(tmp_path / name), CLASSES)
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_array_equal(np.stack([g[1] for g in got]),
                                      np.stack([w[1] for w in want]))
    with open(tmp_path / "rois.csv", "w") as f:
        f.write("file_name,x1,x2,y1,y2,label\n")
        for i in range(60):
            f.write(f"img_{i % 17:03d},{i},{i + 20},{2 * i},{2 * i + 9},{CLASSES[i % 5]}\n")
    rows = troi.load_roi_table(str(tmp_path / "rois.csv"))
    assert rows == jroi.load_roi_table(str(tmp_path / "rois.csv"))
    for seed in (18, 3):
        assert troi.image_level_split(rows, seed) == jroi.image_level_split(rows, seed)


def roi_label_csv(data_dir: str, path: str, seed: int = 0) -> None:
    """`roi_data.csv` plus a label column drawn from a seed."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(data_dir, "roi_data.csv")) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        f.write(lines[0] + ",label\n")
        for line in lines[1:]:
            f.write(f"{line},{CLASSES[rng.integers(0, len(CLASSES))]}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("labelers_synth")
    synth.write_dataset(str(root))
    roi_label_csv(str(root / "data"), str(root / "roi_labels.csv"))
    return root


@pytest.mark.parametrize("tool", ["image", "roi"])
def test_get_cate_of_both_tools_matches_jax(data, tmp_path, monkeypatch, tool):
    rng = np.random.default_rng(2)
    _, params, port = _pair(rng, size=224)
    images = str(data / "images")
    if tool == "image":
        jtool, ttool, extra = jimage, timage, []
        inputs = timage.load_images(sorted(os.listdir(images)), images)
        out_name, target = "resnet152_image_label.json", np.log(0.45 / 0.55)
    else:
        jtool, ttool = jroi, troi
        extra = ["--roi_label_path", str(data / "roi_labels.csv")]
        inputs = troi.load_crops(troi.load_roi_table(extra[1]), images)
        out_name, target = "resnet152_roi_label.json", 0.0
    # random images give a random ResNet near-equal features: move each
    # class's logit so that its median over the inputs sits at the threshold
    # (at 0 for the argmax), so that labels differ between inputs
    with torch.no_grad():
        logits = port(torch.from_numpy(inputs))
    n = len(inputs)
    mid = logits.sort(dim=0).values[(n - 1) // 2:n // 2 + 1].mean(0)
    params["params"]["linear"]["bias"] = (params["params"]["linear"]["bias"] + target
                                          - mid.numpy())
    port.load_state_dict(jax_import.aspect_classifier_state_dict_from_jax(params["params"]))
    save_classifier_params(str(tmp_path / "jax_ckpt"), params)
    classifier_io.save_classifier(str(tmp_path / "port_ckpt"), port)
    # the JAX tools build `AspectClassifier(len(classes))`: narrow it for the CPU
    monkeypatch.setattr(jac, "AspectClassifier", functools.partial(
        jac.AspectClassifier, config=jcfg.ResNetConfig(**SMALL)))
    args = ["--get_cate", "--image_dir", images, "--batch_size", "5", *extra]
    jtool.main(args + ["--output_dir", str(tmp_path / "jax"), "--checkpoint",
                       str(tmp_path / "jax_ckpt")])
    ttool.main(args + ["--output_dir", str(tmp_path / "port"), "--checkpoint",
                       str(tmp_path / "port_ckpt"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / out_name).read_text())
    got = json.loads((tmp_path / "port" / out_name).read_text())
    assert got == want and len(got) == 12
    assert len({tuple(v) for v in got.values()}) > 1, got  # not one answer for all


@pytest.mark.parametrize("tool", ["image", "roi"])
def test_do_train_writes_the_classifier_and_labels_every_image(data, tmp_path, tool):
    hook = lambda rcfg: tcfg.ResNetConfig(**SMALL)
    images = str(data / "images")
    common = ["--image_dir", images, "--output_dir", str(tmp_path), "--batch_size", "4",
              "--num_train_epochs", "1", "--device", "cpu", "--do_train", "--get_cate"]
    if tool == "image":
        result = timage.main(common + ["--image_label_path",
                                       str(data / "data" / "resnet152_image_label.json")],
                             config_hook=hook)
        ckpt, out = "image_classifier_best", "resnet152_image_label.json"
    else:
        result = troi.main(common + ["--roi_label_path", str(data / "roi_labels.csv")],
                           config_hook=hook)
        ckpt, out = "roi_classifier_best", "resnet152_roi_label.json"
    assert (tmp_path / ckpt).is_file() and 0.0 <= result["best_dev_acc"] <= 1.0
    labels = json.loads((tmp_path / out).read_text())
    assert sorted(labels) == sorted(os.listdir(images)) and labels == result["labels"]
    assert all(set(v) <= set(CLASSES) for v in labels.values())
    assert classifier_io.load_classifier(str(tmp_path / ckpt)).config == \
        tcfg.ResNetConfig(**SMALL)
