"""The port's checkpoints and feature caches.

Checkpoints are torch files in place of the JAX package's orbax
directories, so they are held to their contract, not to a file format: a
run that saves, restores into fresh objects and goes on takes bitwise the
same steps as a run that never stopped, with dropout on (it is drawn from
(seed, step), and the step is in the checkpoint) and with gradient
accumulation in progress.  The two feature caches are held against the JAX
package's: the device cache on the same updates and lookups, the disk cache
on the same files, written by one package and read by the other.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macsa_tpu.train import disk_feature_cache as jdisk
from macsa_tpu.train.feature_cache import VisualFeatureCache as JCache
from macsa_tpu_torch import config as tcfg
from macsa_tpu_torch.models.fcmf import FCMF
from macsa_tpu_torch.models.layers import init_weights
from macsa_tpu_torch.models.resnet import VisualFeatures
from macsa_tpu_torch.train import disk_feature_cache as tdisk
from macsa_tpu_torch.train import optim
from macsa_tpu_torch.ops import cuda_lib
from macsa_tpu_torch.train import common
from macsa_tpu_torch.train.checkpoints import CheckpointManager
from macsa_tpu_torch.train.feature_cache import FeatureCacheFeeder, VisualFeatureCache
from macsa_tpu_torch.train.state import TrainState
from macsa_tpu_torch.train.steps import extract_visual, make_finetune_train_step
from test_torch_port_slice import (KW, MODEL_KW, RESNET_KW, TEXT_KW, _torch_batch,
                                   serving_batch)

SEED = 11


def _fresh_state(accumulate: int, seed: int = 0) -> TrainState:
    """A small FCMF with the reference's dropout rates, weights from `seed`."""
    model = FCMF(tcfg.FCMFConfig(model=tcfg.ModelConfig(**MODEL_KW),
                                 text=tcfg.TextEncoderConfig(**TEXT_KW), **KW))
    visual = VisualFeatures(tcfg.ResNetConfig(**RESNET_KW))
    init_weights(model, torch.Generator().manual_seed(seed), 0.05)
    init_weights(visual, torch.Generator().manual_seed(seed + 1))
    opt = optim.AdamW(model, optim.linear_warmup_schedule(1e-3, 2, 20), weight_decay=0.1,
                      head_learning_rate=optim.linear_warmup_schedule(1e-2, 2, 20),
                      accumulate_steps=accumulate)
    return TrainState.create(model, visual, opt)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        batch = _torch_batch(*serving_batch(rng))
        batch["labels"] = torch.from_numpy(rng.integers(0, 4, size=(2, 6)).astype(np.int32))
        out.append(batch)
    return out


def _run(state, batches, steps, start=0):
    step = make_finetune_train_step(state)
    return [float(step(batches[(start + i) % 2], SEED)["loss"]) for i in range(steps)]


def _tensors(state):
    """Every tensor a resumed run depends on, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for index, entry in opt["optimizer"]["state"].items():
        out.update({f"opt.{index}.{k}": torch.as_tensor(v) for k, v in entry.items()})
    for i, acc in enumerate(opt["acc"] or []):
        out[f"acc.{i}"] = acc
    return out


@pytest.mark.parametrize("accumulate", [1, 2])
def test_resume_takes_bitwise_the_same_steps_as_not_stopping(tmp_path, batches, accumulate):
    straight = _fresh_state(accumulate)
    want = _run(straight, batches, 5)

    stopped = _fresh_state(accumulate)
    first = _run(stopped, batches, 3)  # with accumulate 2: one micro-step is pending
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("last", stopped, epoch=1, best_score=0.25)
    assert ckpt.exists("last") and not ckpt.exists("best")
    assert os.listdir(tmp_path) == ["last.pt"]  # no temporary file is left

    resumed = _fresh_state(accumulate, seed=99)  # other weights: all must come from the file
    resumed, epoch, best = ckpt.restore("last", resumed)
    assert (epoch, best, resumed.step) == (1, 0.25, 3)
    assert resumed.optimizer.updates == stopped.optimizer.updates == 3 // accumulate
    assert resumed.optimizer._micro == 3 % accumulate
    rest = _run(resumed, batches, 2, start=3)
    assert first + rest == want  # dropout on: the same masks, from (seed, step)
    a, b = _tensors(straight), _tensors(resumed)
    assert a.keys() == b.keys() and len(a) > 100
    for name in a:
        assert torch.equal(a[name], b[name]), name
    # and it did train: the loss moved and the rates were not zero
    assert len(set(want)) == 5


def test_dropout_is_on_in_the_resume_test(batches):
    """Another seed gives other losses from the same weights."""
    a, b = _fresh_state(1), _fresh_state(1)
    step_a, step_b = make_finetune_train_step(a), make_finetune_train_step(b)
    assert float(step_a(batches[0], SEED)["loss"]) != float(step_b(batches[0], SEED + 1)["loss"])


def test_best_last_copy_and_params_only_restore(tmp_path, batches):
    state = _fresh_state(1)
    _run(state, batches, 2)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("best", state, epoch=2, best_score=0.5)
    ckpt.copy("best", "last")
    ckpt.finalize()
    assert sorted(os.listdir(tmp_path)) == ["best.pt", "last.pt"]
    assert (tmp_path / "best.pt").read_bytes() == (tmp_path / "last.pt").read_bytes()
    other = _fresh_state(1, seed=7)
    moments_before = other.optimizer.state_dict()
    other = ckpt.restore_params_only("best", other)
    for (name, x), y in zip(other.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(x, y), name
    for x, y in zip(other.visual.state_dict().values(), state.visual.state_dict().values()):
        assert torch.equal(x, y)
    assert other.step == 0 and other.optimizer.updates == 0  # the optimizer is left alone
    assert other.optimizer.state_dict()["optimizer"]["state"] == \
        moments_before["optimizer"]["state"] == {}
    (tmp_path / "foreign.pt").write_bytes(b"")
    with pytest.raises(Exception):
        ckpt.restore("foreign", other)


def test_restore_params_only_reads_a_reference_state_dict(tmp_path):
    """A bare FCMF state dict under the reference's legacy key names
    (DDP's `module.`, `ent2img`, `comb_attention`, the head under `encoder.`)."""
    state = _fresh_state(1)
    legacy = {}
    for key, value in state.model.state_dict().items():
        key = key.replace("text2img", "ent2img").replace("text2roi", "ent2roi")
        key = key.replace("mm_attention", "comb_attention")
        if key.startswith(("text_pooler.", "classifier.")):
            key = "encoder." + key
        legacy["module." + key] = value.clone()
    path = str(tmp_path / "reference.pth")
    torch.save(legacy, path)
    other = _fresh_state(1, seed=3)
    visual_before = {k: v.clone() for k, v in other.visual.state_dict().items()}
    other = CheckpointManager(str(tmp_path / "ckpt")).restore_params_only(path, other)
    for (name, x), y in zip(other.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(x, y), name
    for name, x in other.visual.state_dict().items():
        assert torch.equal(x, visual_before[name])


# ---- feature caches -------------------------------------------------------------

def test_device_feature_cache_matches_jax(rng):
    n, imgs, rois, patches, dim = 7, 2, 3, 4, 16
    jcache = JCache(n, imgs, rois, patches, dim, dtype=jnp.bfloat16)
    tcache = VisualFeatureCache(n, imgs, rois, patches, dim, dtype=torch.bfloat16)
    assert tcache.nbytes == jcache.nbytes
    for idx in ([3, 0, 6], [1, -1, 5, -1], [6, 2]):  # -1: pad rows, dropped
        grid = rng.normal(size=(len(idx), imgs, patches, dim)).astype(np.float32)
        roi = rng.normal(size=(len(idx), imgs, rois, dim)).astype(np.float32)
        jcache.update(np.asarray(idx, np.int32), jnp.asarray(grid), jnp.asarray(roi))
        tcache.update(np.asarray(idx, np.int32), torch.from_numpy(grid), torch.from_numpy(roi))
    for got, want in ((tcache.grid, jcache.grid), (tcache.roi, jcache.roi)):
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert not tcache.grid[4].any()  # never written, and no pad row landed anywhere
    look = np.asarray([5, 0, -1], np.int32)
    for got, want in zip(tcache.lookup(look), jcache.lookup(look)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_record_key_and_content_hash_copy(tmp_path):
    (tmp_path / "a.png").write_bytes(b"one")
    (tmp_path / "b.png").write_bytes(b"two" * 1000)
    boxes = {"a.png": [(0, 8, 0, 8), (1, 9, 2, 7), (3, 4, 5, 6)], "b.png": []}
    for name in ("a.png", "b.png", "absent.png"):
        path = str(tmp_path / name)
        assert tdisk.file_content_hash(path) == jdisk.file_content_hash(path)
    args = (["a.png", "absent.png", "b.png"], str(tmp_path), boxes, 2, 2, "fp|stages1,1")
    assert tdisk.record_key(*args) == jdisk.record_key(*args)
    assert tdisk.record_key(*args) != tdisk.record_key(*args[:3], 3, 2, "fp|stages1,1")
    assert tdisk.record_key(None, str(tmp_path), boxes, 2, 2, "fp") == \
        jdisk.record_key(None, str(tmp_path), boxes, 2, 2, "fp")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_disk_cache_files_serve_both_packages(tmp_path, rng, writer):
    grid = rng.normal(size=(3, 2, 4, 16)).astype(np.float32)
    roi = rng.normal(size=(3, 2, 3, 16)).astype(np.float32)
    keys = ["k0", "k1", "k2"]
    if writer == "jax":
        disk = jdisk.DiskFeatureCache(str(tmp_path))
        disk.store_async(keys, jnp.asarray(grid, jnp.bfloat16), jnp.asarray(roi, jnp.bfloat16))
    else:
        disk = tdisk.DiskFeatureCache(str(tmp_path))
        disk.store_async(keys, torch.from_numpy(grid), torch.from_numpy(roi).bfloat16())
    disk.flush()
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{k}.{kind}.npy" for k in keys for kind in ("grid", "roi"))
    want = [torch.from_numpy(x).bfloat16().float().numpy() for x in (grid, roi)]
    jread, tread = jdisk.DiskFeatureCache(str(tmp_path)), tdisk.DiskFeatureCache(str(tmp_path))
    assert len(jread) == len(tread) == 3 and tread.has("k1") and not tread.has("k9")
    for got, ref in zip(tread.load(["k2", "k0"]), want):
        assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), ref[[2, 0]])
    for got, ref in zip(jread.load(["k2", "k0"]), want):
        assert np.array_equal(np.asarray(got, np.float32), ref[[2, 0]])
    # the files themselves are the same bytes whoever wrote them
    other = tmp_path / "other"
    if writer == "jax":
        again = tdisk.DiskFeatureCache(str(other))
        again.store_async(keys, torch.from_numpy(grid), torch.from_numpy(roi))
    else:
        again = jdisk.DiskFeatureCache(str(other))
        again.store_async(keys, jnp.asarray(grid, jnp.bfloat16), jnp.asarray(roi, jnp.bfloat16))
    again.flush()
    for name in os.listdir(other):
        assert (other / name).read_bytes() == (tmp_path / name).read_bytes(), name


def test_prefill_loads_what_the_disk_holds(tmp_path, rng):
    grid = rng.normal(size=(2, 2, 4, 16)).astype(np.float32)
    roi = rng.normal(size=(2, 2, 3, 16)).astype(np.float32)
    disk = tdisk.DiskFeatureCache(str(tmp_path))
    disk.store_async(["a", "b"], torch.from_numpy(grid), torch.from_numpy(roi))
    disk.flush()
    cache = VisualFeatureCache(4, 2, 3, 4, 16)
    loaded = tdisk.prefill_hbm_cache(disk, ["b", None, "missing", "a"], cache, chunk=1)
    assert loaded.tolist() == [True, False, False, True]
    assert torch.equal(cache.grid[0], torch.from_numpy(grid[1]).bfloat16())
    assert torch.equal(cache.roi[3], torch.from_numpy(roi[0]).bfloat16())
    assert not cache.grid[1].any() and not cache.grid[2].any()


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, line):
        self.lines.append(line)


@pytest.mark.parametrize("index_key,unit", [("_idx", "rows"), ("orig_idx", "reviews")])
def test_feeder_extracts_once_then_serves_cache_and_disk(tmp_path, rng, index_key, unit):
    """What both drivers put between loader and step: a cold batch goes
    through the ResNet and into both caches, a warm one needs no pixels, and
    a later process finds the rows on disk before its loader starts."""
    cfg = tcfg.FCMFConfig(model=tcfg.ModelConfig(dtype="float32", **MODEL_KW),
                          text=tcfg.TextEncoderConfig(**TEXT_KW), **KW)
    visual = VisualFeatures(tcfg.ResNetConfig(**RESNET_KW))
    init_weights(visual, torch.Generator().manual_seed(3))
    images, img_valid, rois, roi_valid, text = serving_batch(rng)
    packed = {k: v.numpy() for k, v in _torch_batch(images, img_valid, rois, roi_valid,
                                                    {}).items()}
    batch = {**text, **packed, index_key: np.array([3, 1]), "text": ["a", "b"]}
    keys = ["k0", "k1", "k2", "k3"]
    disk = tdisk.DiskFeatureCache(str(tmp_path))
    feeder = FeatureCacheFeeder(visual, cfg, 4, torch.device("cpu"), index_key,
                                disk_cache=disk, keys=keys)
    assert all(feeder.needs_pixels(i) for i in range(4))
    sent = feeder(batch)
    with torch.no_grad():
        grid, roi = extract_visual(visual, torch.from_numpy(packed["images"]),
                                   torch.from_numpy(packed["roi_images"]),
                                   out_dtype=torch.float32)
    assert torch.equal(sent["grid"], grid) and torch.equal(sent["roi"], roi)
    assert not {"images", "roi_images", index_key, "text"} & set(sent)
    assert torch.equal(sent["input_ids"], torch.from_numpy(text["input_ids"]))
    assert [feeder.needs_pixels(i) for i in range(4)] == [True, False, True, False]

    # warm: the loader sent no pixels; a pad row (-1) may ride along
    light = {**text, index_key: np.array([1, -1])}
    warm = feeder(light)
    assert torch.equal(warm["grid"][0], grid[1]) and torch.equal(warm["roi"][0], roi[1])
    with pytest.raises(AssertionError, match="pixel-less"):
        feeder({**text, index_key: np.array([0, 1])})

    # the next process: rows 1 and 3 come from disk (bf16 files) up front
    disk.flush()
    log = _Log()
    again = FeatureCacheFeeder(visual, cfg, 4, torch.device("cpu"), index_key,
                               disk_cache=tdisk.DiskFeatureCache(str(tmp_path)), keys=keys,
                               logger=log, name="[train]", unit=unit)
    assert again.owned.tolist() == [False, True, False, True]
    assert log.lines[0].startswith("visual feature cache[train]: ")
    assert f"feature cache[train]: prefilled 2/4 {unit} from disk" in log.lines[1]
    served = again({**text, index_key: np.array([3, 1])})
    assert torch.equal(served["grid"], grid.bfloat16().float())


def test_epoch_meter_records_steps_wait_and_launches():
    class Writer:
        def write(self, step, **kw):
            self.step, self.kw = step, kw

    cuda_lib.launch_counts["before"] += 2
    try:
        meter = common.EpochMeter(epoch=3, first_step=40)
        for batch in meter.batches([{"x": 1}, {"x": 2}, {"x": 3}]):
            cuda_lib.launch_counts["some_kernel"] += batch["x"]
            meter.count(8)
        assert meter.rate() > 0
        record = meter.stop(losses=[1.5])
    finally:
        cuda_lib.reset_launch_counts()
    assert record["kernel_launches"] == {"some_kernel": 6}  # the epoch's own, not "before"
    assert (record["epoch"], record["first_step"], record["steps"], record["samples"]) == \
        (3, 40, 3, 24)
    assert record["losses"] == [1.5]
    assert 0.0 <= record["loader_wait_seconds"] <= record["seconds"]
    writer = Writer()
    meter.write(writer, 43, epoch_mean_loss=0.5)
    assert writer.step == 43 and writer.kw["epoch_steps"] == 3
    assert writer.kw["epoch_mean_loss"] == 0.5
    assert writer.kw["epoch_samples_per_s"] == 24 / record["seconds"]
    idle = common.EpochMeter(0, 0)
    idle.stop()
    idle.write(None, 0)  # an epoch without steps writes no line
