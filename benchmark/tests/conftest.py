"""Shared fixtures of the harness's CPU tests: the cells shrunk to a size
a test run holds (4,096 particles, an 8-substep or 2-frame segment),
through the same files and code as a run on the card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_N = 4096


@pytest.fixture
def small(monkeypatch):
    """``benchmark.spec`` serving every cell at SMALL_N particles with a
    short segment."""
    import torch

    from benchmark import spec

    torch.set_num_threads(min(4, torch.get_num_threads()))
    config, traffic = spec.config, spec.traffic

    def small_config(bench, name):
        c = config(bench, name)
        c["simulation"]["particles_count"] = SMALL_N
        return c

    def small_traffic(name):
        t = traffic(name)
        if t["entry"] == "frames":
            t["segment_frames"] = 2
        else:
            t["segment_substeps"] = 8
        return t

    monkeypatch.setattr(spec, "config", small_config)
    monkeypatch.setattr(spec, "traffic", small_traffic)
    return spec


def cpu_run(workload: str, trace: int = 0, seed: int = 2_147_483_659):
    """A whole run of ``workload`` on the CPU (the look for the card
    skipped); returns (the result, the JSON line it printed)."""
    import io
    import json

    from benchmark import run

    buf = io.StringIO()
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
                      "--trace", str(trace)])
    result = run.run(args, device="cpu", out=buf)
    line = buf.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    return result, line


MESH_CELL = "dambreak_4m_mesh4.substeps"


@pytest.fixture
def mesh_cell(small, monkeypatch):
    """The 4-rank mesh cell, served from its configuration file where
    ``BENCHMARK.json`` does not list it yet, with the 1M cell's limits
    (the mesh's rows matched one by one instead of compared in order)."""
    import json

    spec = small
    bench, limits = spec.benchmark, spec.limits

    def with_mesh():
        b = bench()
        if not any(w["name"] == MESH_CELL for w in b["workloads"]):
            b["configs"].append({"name": "dambreak_4m_mesh4", "reduced": ["particles_count"],
                                 "source": "", "file": "benchmark/configs/dambreak_4m_mesh4.json",
                                 "why": ""})
            b["workloads"].append({"name": MESH_CELL, "config": "dambreak_4m_mesh4",
                                   "traffic": "bench_substeps", "chips": 4, "why": ""})
        return b

    def mesh_limits(name):
        try:
            return limits(name)
        except FileNotFoundError:
            lim = dict(limits("dambreak_1m.substeps"))
            lim["unmatched"] = lim.pop("codes_mismatch")
            return lim

    monkeypatch.setattr(spec, "benchmark", with_mesh)
    monkeypatch.setattr(spec, "limits", mesh_limits)
    return spec
