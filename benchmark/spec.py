"""The benchmark's files, found by the names in ``BENCHMARK.json``: a
cell's configuration (``configs/``), its traffic (``traffic/``), the
limits of its comparison (``limits/``) and each per-layer metric's reader
(``metrics/<name>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SCENES = os.path.join(BENCH_DIR, "scenes")

FORBIDDEN = ("jax", "jaxlib", "flax", "libclsph_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def limits(cell_name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "limits", cell_name + ".json"))


def metrics(spec: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in spec[key] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The module of metric ``name``'s reader: ``metrics/<name>.py`` with
    a ``read(ctx)`` that returns the value, or None where it finds nothing
    to read. A name with no file of its own is read by the reader of the
    part before its first dot (``particle_steps_per_s.mesh`` by
    ``particle_steps_per_s.py``)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
