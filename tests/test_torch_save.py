"""The engine's host copies on the CPU: every fetch of the state to the
host runs on the saver thread, never on the loop thread; one fetch
serves a frame's save, its post_frame and the next pre_frame; and the
CLI's ``.geo`` frames and checkpoint are byte-identical to those written
with the fetch made inline on the loop thread, as the engine made it
before."""

import os
import threading
from concurrent.futures import Future

import numpy as np

from libclsph_tpu_torch import cli
from libclsph_tpu_torch.engine import simulation as tsim
from test_torch_engine import _root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def _recorded_fetch(monkeypatch, record):
    fetch = tsim.SPHSimulation._fetch

    def recorded(self, state):
        record.append(threading.current_thread())
        return fetch(self, state)

    monkeypatch.setattr(tsim.SPHSimulation, "_fetch", recorded)


def _engine(tmp_path, frames=3, **overrides):
    root = _root(tmp_path, simulation_time=frames / 60.0, serialize=False,
                 particles_count=1000, **overrides)
    sim = tsim.SPHSimulation(device="cpu")
    sim.checkpoint_path = str(tmp_path / "none.npz")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
    return sim


def test_fetch_runs_on_the_saver_thread_once_a_frame(tmp_path, monkeypatch):
    """save_frame, pre_frame and post_frame on the fast path: one fetch
    for the initial save and one a frame, none on the loop thread; the
    callbacks see the arrays that were saved, and an edit that pre_frame
    makes in place does not reach the save that shares its fetch."""
    fetched = []
    _recorded_fetch(monkeypatch, fetched)
    sim = _engine(tmp_path)
    saved, seen = [], []

    def save(arrays, params):
        saved.append({k: v.copy() for k, v in arrays.items()})

    def post(arrays, params, full):
        seen.append(("post", arrays["position"].copy()))
        return False

    def pre(arrays, params, full):
        seen.append(("pre", arrays["position"].copy()))
        arrays["density"][:] = -1.0  # an edit in place, written back
        return len(seen) == 1

    sim.save_frame, sim.pre_frame, sim.post_frame = save, pre, post
    sim.simulate()
    frames = len(saved) - 1
    assert frames == 3
    assert len(fetched) == 1 + frames
    assert threading.main_thread() not in fetched
    # frame f's save, its post_frame and the next pre_frame read one copy
    for f in range(1, frames):
        post_pos = [p for kind, p in seen if kind == "post"][f - 1]
        np.testing.assert_array_equal(post_pos, saved[f]["position"])
        np.testing.assert_array_equal([p for kind, p in seen if kind == "pre"][f], post_pos)
    # the first pre_frame's edit reached its own copy, not the save's
    assert not (saved[0]["density"] == -1.0).any()


def test_per_substep_path_fetches_on_the_saver_thread(tmp_path, monkeypatch):
    fetched = []
    _recorded_fetch(monkeypatch, fetched)
    sim = _engine(tmp_path, frames=1, write_all_frames=True)
    calls = {"save": 0, "post": 0}

    def save(arrays, params):
        calls["save"] += 1

    def post(arrays, params, full):
        calls["post"] += 1
        return False

    sim.save_frame, sim.post_frame = save, post
    sim.simulate()
    assert calls["post"] >= 10 and calls["save"] == calls["post"] + 1
    assert len(fetched) == calls["save"]  # the post_frame of a substep shares its save's
    assert threading.main_thread() not in fetched


def _inline_host(self, saver, state, save, callbacks):
    """The engine's host copy as it was made before: fetched on the loop
    thread, then saved on the saver thread."""
    arrays = self._fetch(self._gathered(state))
    p, save_cb = self.parameters, self.save_frame if save else None
    ckpt = self.checkpoint_path if self.serialize else None

    def run():
        save_cb(arrays, p)
        if ckpt:
            tsim.ckpt_mod.save_checkpoint(ckpt, arrays, p)

    if save_cb is not None:
        saver.submit(run)
    done = Future()
    done.set_result(arrays)
    return done


def test_cli_frames_and_checkpoint_match_the_inline_fetch(tmp_path, monkeypatch):
    out = {}
    for name in ("inline", "saver"):
        d = tmp_path / name
        d.mkdir()
        root = _root(d)
        with monkeypatch.context() as m:
            m.chdir(d)
            if name == "inline":
                m.setattr(tsim.SPHSimulation, "_host", _inline_host)
            assert cli.main(["water", "tiny", "cube", "out_", "--device", "cpu",
                             "--root", str(root)]) == 0
        names = sorted(os.listdir(d / "out_frames"))
        out[name] = {n: (d / "out_frames" / n).read_bytes() for n in names}
        out[name]["last_frame.npz"] = (d / "last_frame.npz").read_bytes()
    assert len(out["saver"]) == 5 and out["saver"].keys() == out["inline"].keys()
    for k in out["saver"]:
        assert out["saver"][k] == out["inline"][k], k
