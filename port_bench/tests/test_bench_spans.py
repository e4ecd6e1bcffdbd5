"""The readers of the port's spans (`metrics/*_host_ms.*`, `*_device_ms.*`,
`h2d_gbps.serve`) on whole traced runs at a tiny width on the CPU: each
host-clock metric a cell lists is reported in ms and above 0; the
device-clock metrics find no CUDA events here and are left out; and on a
program without spans every reader returns None without raising."""

import pytest
import torch

from port_bench.lib import bench

SEED = 3 * 2 ** 30 + 7
SPAN_METRICS = ("text_encoder_host_ms.train", "fusion_host_ms.train", "decoder_host_ms.train",
                "backward_host_ms.train", "optimizer_host_ms.train", "h2d_host_ms.train",
                "visual_device_ms.train", "visual_device_ms.serve", "h2d_gbps.serve")


def listed(manifest, cell, source):
    return {m["name"] for m in manifest["per_layer"]
            if m["name"] in SPAN_METRICS and cell in m["workloads"] and m["source"] == source}


@pytest.mark.parametrize("cell,host", [
    ("finetune.cached", {"text_encoder", "fusion", "backward", "optimizer"}),
    ("pretrain.cached", {"text_encoder", "fusion", "decoder", "backward", "optimizer"}),
    ("finetune.pixels", {"text_encoder", "fusion", "backward", "optimizer", "h2d"}),
    ("serve.f32", set()),
])
def test_a_traced_run_reports_the_span_metrics(tiny_bench, cell, host):
    files, manifest = tiny_bench
    assert listed(manifest, cell, "host_clock") == {f"{n}_host_ms.train" for n in host}
    out = bench.run_cell(files, manifest, cell, SEED, 0.3, True, torch.device("cpu"))
    assert out["correct"], out["check"]
    for name in listed(manifest, cell, "host_clock"):
        assert out["metrics"][name]["unit"] == "ms/step"
        assert out["metrics"][name]["value"] > 0, name
    for name in listed(manifest, cell, "device_trace"):
        assert name not in out["metrics"]  # no CUDA events on the CPU


def test_the_readers_find_nothing_in_a_program_without_spans(tiny_bench, monkeypatch):
    from macsa_tpu_torch.utils import logging as port_logging

    files, _ = tiny_bench
    monkeypatch.delattr(port_logging, "span_median")
    for name in SPAN_METRICS:
        assert files.module("metrics", name).read({}) is None, name
