"""BENCHMARK.json against the benchmark's files: names and units of the
allowed characters, every metric with its reader, every cell with its
configuration and entry, and the limits of the contract."""

import json
import math
import os
import re

import pytest

from conftest import BENCH, CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units(manifest):
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    for entry in manifest["configs"] + manifest["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(
        manifest["workloads"])


def test_every_cell_and_metric_has_its_files(manifest):
    for c in manifest["configs"]:
        assert os.path.isfile(os.path.join(CHECKOUT, c["file"]))
    for w in manifest["workloads"]:
        cell = json.load(open(os.path.join(BENCH, "workloads", f"{w['name']}.json")))
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"] == 1
        assert os.path.isfile(os.path.join(BENCH, "configs", f"{w['config']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "entries", f"{cell['entry']}.py"))
    for m in manifest["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py")), m["name"]


def test_contract_limits(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, (m["name"], cell)
    n = len(cells)
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43,200 seconds
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert n <= 24 and len(json.dumps(manifest)) <= 64 * 1024
    assert math.isfinite(sum(m["bound"] for m in e2e.values()))
