"""No run of the harness or of the reference loads JAX or the JAX package
(top-level names compared whole: `macsa_tpu_torch` is not `macsa_tpu`),
the reference loads nothing of the port, and the harness refuses to run
without a card."""

import json
import os
import subprocess
import sys

from conftest import BENCH, CHECKOUT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "macsa_tpu")


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=CHECKOUT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, json, shutil, torch
sys.path.insert(0, {CHECKOUT!r}); sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
from conftest import narrow
from port_bench.lib import bench
shutil.copytree({BENCH!r}, {str(tmp_path / 'pb')!r}, ignore=shutil.ignore_patterns('tests', '_cache'))
narrow({str(tmp_path / 'pb')!r})
files = bench.Files({str(tmp_path / 'pb')!r})
manifest = json.load(open({os.path.join(CHECKOUT, 'BENCHMARK.json')!r}))
for cell in ("finetune.cached", "serve.f32"):
    bench.run_cell(files, manifest, cell, 1, 0.1, False, torch.device("cpu"))
"""
    names = loaded_after(code)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    assert "macsa_tpu_torch" in names  # the program under test, by its whole name


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("import port_bench.reference.model, port_bench.reference.train, "
                         "port_bench.reference.control")
    assert not names & set(FORBIDDEN + ("macsa_tpu_torch",)), names


def test_the_harness_refuses_without_a_card():
    code = "import torch; print(torch.cuda.is_available())"
    has_card = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True).stdout.strip() == "True"
    if has_card:
        return
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "serve.f32",
                          "--seed", "1", "--seconds", "1"], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
