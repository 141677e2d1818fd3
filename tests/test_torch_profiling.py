"""The port's ``utils/profiling``: ``trace`` writing its trace, table and
spans; the span and counter recorder behind ``annotate`` and ``count``
(off, under a ``torch.profiler`` capture, under ``recording()``), its
parent and root ids, a span on a thread started inside a capture, the
store's bound, the spans' clock against the Chrome trace's, and the
layer spans of one small ``SPHSimulation.simulate()``."""

import json
import os
import shutil
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine.step import StepConfig
from libclsph_tpu_torch.utils import profiling
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _capture():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans) -> dict:
    return {s.name: s for s in spans}


def test_trace_writes_trace_and_table(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("phase"):
            (torch.ones(8) * 2).sum()
        profiling.count("things", 3)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [profiling.TABLE_FILE, profiling.TRACE_FILE, profiling.SPANS_FILE])
    assert "phase" in (tmp_path / profiling.TABLE_FILE).read_text()
    assert any(e.key == "phase" for e in prof.key_averages())
    assert os.path.getsize(tmp_path / profiling.TRACE_FILE) > 0
    spans = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    assert [s["name"] for s in spans["spans"]] == ["phase"]
    assert spans["counters"] == {"things": 3} and spans["dropped"] == 0


def test_off_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "record_function", lambda name: opened.append(name))
    assert not profiling.active()
    span = profiling.annotate("a")
    assert span is profiling.annotate("b") and not span  # one shared null span
    with span as s:
        s.set(x=1)
        profiling.count("n")
        assert profiling.current() is None
    assert opened == []
    assert profiling.snapshot() == dict(spans=[], counters={}, dropped=0)


@pytest.mark.parametrize("switch", ["profiler", "recording"])
def test_spans_recorded_when_on(switch):
    with (_capture() if switch == "profiler" else profiling.recording()):
        assert profiling.active()
        with profiling.annotate("outer", a=1) as span:
            span.set(b=2)
            with profiling.annotate("inner"):
                profiling.count("n", 2)
                profiling.count("n")
    assert not profiling.active()
    snap = profiling.snapshot()
    spans = _by_name(snap["spans"])
    assert [s.name for s in snap["spans"]] == ["inner", "outer"]  # in the order they closed
    assert spans["outer"].attrs == {"a": 1, "b": 2}
    assert spans["outer"].start <= spans["inner"].start <= spans["inner"].end \
        <= spans["outer"].end
    assert spans["inner"].tid == spans["outer"].tid == threading.get_native_id()
    assert snap["counters"] == {"n": 3}


def test_parent_and_root_ids_nest():
    with profiling.recording():
        for _ in range(2):
            with profiling.annotate("root"):
                with profiling.annotate("a"):
                    with profiling.annotate("b"):
                        pass
                with profiling.annotate("c"):
                    pass
    spans = profiling.snapshot()["spans"]
    assert [s.name for s in spans] == ["b", "a", "c", "root"] * 2
    for group in (spans[:4], spans[4:]):
        b, a, c, root = group
        assert root.parent is None and root.root == root.id
        assert (a.parent, c.parent, b.parent) == (root.id, root.id, a.id)
        assert {s.root for s in group} == {root.id}
    assert spans[3].id != spans[7].id
    assert len({s.id for s in spans}) == 8


def test_thread_started_in_a_capture_keeps_its_spans():
    """The saver's case: a thread started inside a capture, handed the
    loop thread's span; the profiler leaves its ranges out of the Chrome
    trace, the recorder keeps them."""
    seen = {}

    def saver(handoff):
        seen["tid"] = threading.get_native_id()
        with profiling.annotate("saver.fetch", parent=handoff):
            with profiling.annotate("inside"):
                pass

    with _capture():
        with profiling.annotate("frame"):
            t = threading.Thread(target=saver, args=(profiling.current(),))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = _by_name(profiling.snapshot()["spans"])
    frame, fetch = spans["frame"], spans["saver.fetch"]
    assert fetch.tid == seen["tid"] != frame.tid
    assert (fetch.parent, fetch.root) == (frame.id, frame.id)
    assert (spans["inside"].parent, spans["inside"].root) == (fetch.id, frame.id)


def test_store_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_REC", profiling._Recorder(4))
    with profiling.recording():
        for i in range(10):
            with profiling.annotate(f"s{i}"):
                pass
    snap = profiling.snapshot()
    assert [s.name for s in snap["spans"]] == ["s6", "s7", "s8", "s9"]  # the newest kept
    assert snap["dropped"] == 6


def test_spans_on_the_chrome_trace_clock(tmp_path):
    """A span and its own ``record_function`` range in the exported trace:
    the trace's ``ts`` is epoch microseconds less ``baseTimeNanoseconds``,
    and both ends agree within 1 ms."""
    with _capture() as prof:
        with profiling.annotate("root"):
            time.sleep(0.003)
            with profiling.annotate("child"):
                (torch.ones(64) + 1).sum()
                time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        body = json.load(f)
    base = int(body["baseTimeNanoseconds"])
    ranges = {e["name"]: e for e in body["traceEvents"] if e.get("cat") == "user_annotation"}
    spans = _by_name(profiling.snapshot()["spans"])
    for name in ("root", "child"):
        r, s = ranges[name], spans[name]
        assert r["tid"] == s.tid
        assert abs((s.start - base) * 1e-3 - r["ts"]) < 1e3
        assert abs((s.end - base) * 1e-3 - (r["ts"] + r["dur"])) < 1e3


def _small_simulation(tmp_path, frames: int) -> tsim.SPHSimulation:
    with open(os.path.join(ROOT, "simulation_properties", "tiny.json")) as f:
        sim = json.load(f)
    sim.update(simulation_time=frames / 60.0, serialize=False, particles_count=512)
    (tmp_path / "tiny.json").write_text(json.dumps(sim))
    shutil.copy(os.path.join(ROOT, "scenes", "cube.obj"), tmp_path / "cube.obj")
    # 512 particles fill 32 subblocks: no list can hold more
    engine = tsim.SPHSimulation(StepConfig(max_candidates_sub=32), device="cpu")
    engine.checkpoint_path = str(tmp_path / "none.npz")
    engine.load_settings(os.path.join(ROOT, "fluid_properties", "water.json"),
                         str(tmp_path / "tiny.json"))
    engine.load_scene("cube.obj", scenes_dir=str(tmp_path))
    return engine


def test_simulate_records_the_layer_spans(tmp_path):
    engine = _small_simulation(tmp_path, frames=2)
    engine.save_frame = lambda arrays, params: None
    with profiling.recording():
        engine.simulate()
    snap = profiling.snapshot()
    spans = {s.id: s for s in snap["spans"]}
    (root,) = [s for s in spans.values() if s.parent is None]
    assert root.name == "simulate" and {s.root for s in spans.values()} == {root.id}
    parents = {}
    for s in spans.values():
        if s.parent is not None:
            parents.setdefault(s.name, set()).add(spans[s.parent].name)
    assert parents == {
        "simulate.start": {"simulate"},
        "frame": {"simulate"},
        "dispatch": {"frame"},
        "chunk": {"dispatch"},
        "host_read": {"dispatch", "chunk"},
        "substep": {"chunk"},
        "sort": {"substep"},
        "search": {"substep"},
        "refine": {"substep"},
        "passes": {"substep"},
        "advect": {"substep"},
        "saver.wait": {"frame", "simulate"},
        "saver.fetch": {"simulate.start", "frame"},
        "saver.save": {"simulate.start", "frame"},
    }
    named = lambda n: [s for s in spans.values() if s.name == n]  # noqa: E731
    assert len(named("frame")) == 2 and len(named("saver.fetch")) == 3
    for s in named("saver.fetch") + named("saver.save"):
        assert s.tid != root.tid  # on the saver thread
    assert {s.tid for s in named("saver.wait")} == {root.tid}
    kinds = [s.attrs["kind"] for s in named("substep")]
    assert kinds[0] == "rebuild" and "reuse" in kinds
    dispatch = named("dispatch")[0].attrs
    assert dispatch["committed"] <= dispatch["ran"] and dispatch["reads"] >= 1
    assert set(dispatch["stops"]) == {"time", "stale", "retry"}
    assert all(set(c.attrs) == {"first", "length", "stop"} for c in named("chunk"))
    assert named("frame")[0].attrs == {"capacity_retries": 0}
    assert snap["counters"]["saver.bytes"] > 0 and snap["dropped"] == 0
