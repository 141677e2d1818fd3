"""Whole runs on the CPU at a small size: a cell's last line has exactly
the contract's keys, and the port's substeps and frames agree with the
plain reference well inside the cells' limits. A run on the card is
``tools/readings.py`` and ``run.py`` itself."""

import json

import pytest

from conftest import cpu_run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("workload", ["dambreak_1m.substeps", "dambreak_64k.substeps",
                                      "dambreak_64k.frames_geo"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(small, workload, trace):
    result, line = cpu_run(workload, trace)
    body = json.loads(line)
    assert set(body) == KEYS | ({"breakdown"} if trace else set())
    assert list(body)[-1] == "compared"
    assert DEVICE <= set(body["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(body["device"])
        assert set(body["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(body["breakdown"]["idle_gaps"]) <= 10
    assert body["correct"] is True and body["failed"] == 0 and body["attempted"] >= 1
    for name, (value, limit) in body["compared"].items():
        assert value <= limit, name
    spec_metrics = json.load(open(small.ROOT + "/BENCHMARK.json"))
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in spec_metrics[kind]}
    assert set(body["metrics"]) <= allowed
    if not trace:  # the end-to-end metrics are never missing
        assert "setup_s" in body["metrics"] and len(body["metrics"]) >= 2


def test_reference_against_port_substeps(small):
    """A few CPU substeps of the port (its plain paths) against the
    reference: every number an order inside its limit."""
    result, _ = cpu_run("dambreak_64k.substeps")
    for name, (value, limit) in result["compared"].items():
        assert value <= limit / 10 or limit == 0, (name, value, limit)


def test_mesh_run(mesh_cell):
    """The mesh cell over 4 ranks on the CPU (gloo): its last line, and
    its rows matched to the reference well inside the limits."""
    from conftest import MESH_CELL

    result, line = cpu_run(MESH_CELL)
    assert set(json.loads(line)) == KEYS and result["correct"] is True
    assert result["device"]["count"] == 4
    for name, (value, limit) in result["compared"].items():
        assert value <= limit / 10 or limit == 0, (name, value, limit)
