"""Every cell's files parse and BENCHMARK.json keeps the contract's
shape: keys, names, units, bounds, and a file for every name it uses."""

import json
import os
import re

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["command"] == ["python3", "benchmark/run.py"]
    assert s["paths"] == ["benchmark"]
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) <= 64 * 1024


def test_configs_parse():
    for c in spec()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        for key in ("fluid", "simulation", "scene", "chips"):
            assert key in body
        assert os.path.exists(os.path.join(BENCH, "scenes", body["scene"]))
        assert all(NAME.match(k) for k in c["reduced"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_have_readers(kind):
    for m in spec()[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert any(os.path.exists(os.path.join(BENCH, "metrics", n + ".py"))
                   for n in (m["name"], m["name"].split(".")[0]))
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_cells_have_their_files_and_metrics():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    names = {w["name"] for w in s["workloads"]}
    assert len(names) == len(s["workloads"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            assert json.load(f)["entry"] in ("substeps", "frames")
        with open(os.path.join(BENCH, "limits", w["name"] + ".json")) as f:
            assert json.load(f)
        reported = [m for m in s["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        layer = [m for m in s["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:  # a per-layer metric's cell reports the metric it moves
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    for m in s["per_layer"]:
        assert set(m.get("workloads", [])) <= names
