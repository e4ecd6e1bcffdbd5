"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
narrowed to a tiny width (every cell's configuration and traffic), and the
card marker.

    python -m pytest port_bench/tests -q -p no:cacheprovider
    python -m pytest port_bench/tests -q -m gpu -p no:cacheprovider   # on the card
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def narrow(root: str) -> None:
    """Every configuration and workload under `root` at a tiny width."""
    for f in os.listdir(os.path.join(root, "configs")):
        path = os.path.join(root, "configs", f)
        with open(path) as fh:
            c = json.load(fh)
        c["text"].update(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=64)
        c["model"].update(hidden_size=32, num_attention_heads=2, intermediate_size=64)
        c.update(num_imgs=2, num_roi=2, visual_feat_dim=64, max_text_len=40, box_heads=2)
        c["resnet"] = {"stage_sizes": [1, 1, 1, 1], "num_filters": 2, "image_size": 224}
        # f32 at this width: bf16's rounding here is not the full width's, which
        # the limits were set from; the planted faults read far above either
        c["compute_dtype"] = {k: "float32" for k in c["compute_dtype"]}
        if "decoder" in c:
            c["decoder"].update(vocab_size=100, hidden_size=32, num_blocks=2, num_heads=2,
                                ffn_hidden=32, max_decode_len=8, max_position_embeddings=64)
        with open(path, "w") as fh:
            json.dump(c, fh)
    for f in os.listdir(os.path.join(root, "workloads")):
        path = os.path.join(root, "workloads", f)
        with open(path) as fh:
            w = json.load(fh)
        t = w["traffic"]
        t.update(rows=16, batch=2, text_len=[8, 40], max_steps=100)
        if "pool" in t:
            t["pool"] = 2
        if "decoder_len" in t:
            t["decoder_len"] = [3, 8]
        with open(path, "w") as fh:
            json.dump(w, fh)


@pytest.fixture
def tiny_bench(tmp_path):
    """(Files of a tiny copy of port_bench, BENCHMARK.json)."""
    from port_bench.lib import bench

    root = tmp_path / "port_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__", "_cache"))
    narrow(str(root))
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return bench.Files(str(root)), json.load(f)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
