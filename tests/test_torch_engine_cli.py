"""The port's engine and CLI running on the CPU.

* ``sph-torch water tiny cube``: frames, resume from ``last_frame.npz``,
  refusal of a stale checkpoint.
* The engine's capacity growth by the JAX engine's rules and the
  per-substep callback path.
"""

import os

import numpy as np
import torch

from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from test_torch_engine import _root
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_cli_writes_frames_resumes_and_refuses_stale_checkpoint(tmp_path, monkeypatch):
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    args = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root)]
    assert cli.main(args) == 0
    frames = sorted(os.listdir(tmp_path / "out_frames"))
    assert frames[0] == "frame0000001.geo" and len(frames) == 4
    head = open(tmp_path / "out_frames" / frames[-1]).read(200).splitlines()
    assert head[0] == "PGEOMETRY V5" and head[1].startswith("NPoints 2048 ")
    ck = np.load(tmp_path / "last_frame.npz")
    pos = ck["position"]
    assert np.isfinite(pos).all() and pos.shape == (2048, 3)
    assert pos[:, 1].min() > -1.6 and np.abs(pos[:, [0, 2]]).max() < 0.7
    dens = ck["density"]
    assert np.isfinite(dens).all() and 0.3 * 998.29 < np.median(dens) < 3 * 998.29
    assert ck["grid_index"].dtype == np.uint32

    # the next run starts from the checkpoint and writes a later one
    sim = tsim.SPHSimulation(device="cpu")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    np.testing.assert_array_equal(interop.to_numpy(sim.init_particles().position), pos)
    assert cli.main(args) == 0
    pos2 = np.load(tmp_path / "last_frame.npz")["position"]
    assert not np.array_equal(pos2, pos) and pos2[:, 1].min() > -1.6

    stale = _root(tmp_path / "stale", particles_count=1000)
    assert cli.main(["water", "tiny", "cube", "out_", "--device", "cpu",
                     "--root", str(stale)]) == 1


def test_engine_grows_capacity_and_runs_callbacks(tmp_path):
    """Caps too small for the first frame: the engine grows exactly the
    flagged tables by the JAX engine's rules (the subblock cap is not
    doubled: two-tier routing takes the heavy blocks), re-runs the
    frame, and the per-substep path calls the callbacks every substep."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0, serialize=False,
                 write_all_frames=True, particles_count=1000)
    sim = tsim.SPHSimulation(
        tstep.StepConfig(max_candidates_sub=24, max_candidates_hit8=8), device="cpu"
    )
    sim.checkpoint_path = str(tmp_path / "none.npz")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
    calls = {"pre": 0, "post": 0, "save": 0}

    def count(name, ret=False):
        def cb(*a):
            calls[name] += 1
            return ret
        return cb

    sim.pre_frame = count("pre")
    sim.post_frame = count("post")
    sim.save_frame = count("save")
    sim.simulate()
    cfg = sim.step_config
    assert cfg.max_candidates_sub == 24 and cfg.tier2_frac > 0
    assert cfg.max_candidates_hit8 >= 40
    assert (cfg.max_candidates_hit8 - 8) % 32 == 0
    assert calls["pre"] == calls["post"] >= 10  # one frame of substeps
    assert calls["save"] == calls["pre"] + 1  # + the initial frame
    assert sim.state.n == 1000 and torch.isfinite(sim.state.position).all()
