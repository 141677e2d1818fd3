"""The port's engine, CLI and packaging.

* A rebuild and a reuse substep with the baked cube scene against the
  JAX package (the scene is carried over by ``interop``; particles start
  on the cube's floor moving down, so the collision response runs).
* The CLI's exit codes, and the engine's refusals (CUDA without a GPU,
  a pretune that is not True, False or "auto").
* Every module imports with JAX blocked, and nothing builds at import.

The CLI's runs on the CPU and the engine's capacity growth are in
test_torch_engine_cli.py (a file of their own, so that no file sets the
length of a parallel run).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.ops import collisions as jcoll
from libclsph_tpu.scene.scene import Scene as JScene
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import interactions as tinter
from test_torch_step import assert_states_match, random_state, run_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048


@pytest.fixture(scope="module")
def cube_pair():
    params = make_params(WATER, n=N)
    scene = jcoll.build_device_scene(
        JScene.load(os.path.join(ROOT, "scenes", "cube.obj"), params.h * 2.0)
    )
    state = random_state(params, N, 31, spread=2.0)
    pos = state["position"]
    pos[:, 1] += -1.6 + 0.015 - pos[:, 1].min()  # resting on the cube's floor
    state["velocity"][:, 1] = -1.0
    state["intermediate_velocity"] = state["velocity"].copy()
    out = run_pair(params, state, params.max_dt, jax_scene=scene,
                   torch_scene=interop.scene_from_arrays(scene, "cpu"))
    return out, state


def _accel_f64(params, state, density, pressure, rows=256):
    """All-pairs float64 acceleration (interactions.force_sums +
    combine_forces over every pair): the oracle for both packages."""
    p = interop.params_from(params)
    terms = p.precomputed()
    pos = torch.as_tensor(state["position"], dtype=torch.float64)
    vel = torch.as_tensor(state["velocity"], dtype=torch.float64)
    rho = torch.as_tensor(density, dtype=torch.float64)
    pr = torch.as_tensor(pressure, dtype=torch.float64)
    n = pos.shape[0]
    out = []
    for r0 in range(0, n, rows):
        q = slice(r0, min(n, r0 + rows))
        k = q.stop - q.start
        ex = lambda a: a[None].expand((k,) + a.shape)  # noqa: E731
        f = tinter.force_sums(
            pos[q], vel[q], rho[q], pr[q], ex(pos), ex(vel), ex(rho), ex(pr),
            torch.ones((k, n), dtype=torch.bool),
            torch.arange(n)[None, :] == torch.arange(q.start, q.stop)[:, None], p, terms,
        )
        out.append(tinter.combine_forces(f, rho[q], p))
    return torch.cat(out).numpy()


def test_cube_scene_rebuild_and_reuse_match(cube_pair):
    """The floor's response pushes particles out by up to the contact
    distance, further than the reuse slack allows: both packages flag the
    reuse substep stale, and agree on everything it computed. Two
    particles pushed onto almost the same spot of the floor (r < h/20)
    are where the JAX kernel's x_i*sum(a) - sum(a*x_j) form, kept for its
    matrix unit, loses digits: there the port is held to the float64
    all-pairs oracle instead, at the same tolerance."""
    out, state = cube_pair
    params = make_params(WATER, n=N)
    (jf, pf) = out["flags"]
    assert jf == pf == (0, tstep.FLAG_CAND_STALE)
    for a, b in zip(*out["tables"]):
        np.testing.assert_array_equal(a, b)
    (jd, pd) = out["dt"]
    np.testing.assert_allclose(pd, jd, rtol=1e-5)
    assert_states_match(out["port"][0], out["jax"][0])
    p2, j2 = out["port"][1], out["jax"][1]
    s1 = out["jax"][0]  # the reuse substep's input
    oracle = _accel_f64(params, s1, j2["density"], j2["pressure"])
    tol = 1e-5 * np.abs(oracle).max()
    np.testing.assert_allclose(p2["acceleration"], oracle, atol=tol)
    pos = s1["position"].astype(np.float64)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    close = d2.min(axis=1) < (params.h / 20) ** 2
    assert close.sum() < 0.02 * N
    np.testing.assert_allclose(p2["acceleration"][~close], j2["acceleration"][~close],
                               atol=tol)
    assert_states_match({**p2, "acceleration": j2["acceleration"]}, j2)
    # the floor stopped some particles (restitution 0 removes the normal
    # component of the half-step velocity)
    vy = out["port"][0]["intermediate_velocity"][:, 1]
    assert (vy > -0.5).sum() > 10
    assert out["port"][1]["position"][:, 1].min() > -1.62


def _root(tmp_path, **sim_overrides):
    """A --root with water, cube and a copy of tiny.json (overridden)."""
    root = tmp_path / "root"
    for d in ("fluid_properties", "simulation_properties", "scenes"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "fluid_properties", "water.json"),
                root / "fluid_properties")
    shutil.copy(os.path.join(ROOT, "scenes", "cube.obj"), root / "scenes")
    sim = json.load(open(os.path.join(ROOT, "simulation_properties", "tiny.json")))
    sim.update(sim_overrides)
    (root / "simulation_properties" / "tiny.json").write_text(json.dumps(sim))
    return root


def test_cli_exit_codes(tmp_path, monkeypatch):
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--root", str(root)]
    assert cli.main(["lava", "tiny", "cube", "out_"] + base) == -1
    assert cli.main(["water", "tiny", "nosuchscene", "out_"] + base) == -1
    assert cli.main(["water", "tiny", "cube", "out_", "--cand-interval", "3"] + base) == -1
    assert cli.main(["water", "tiny", "cube", "out_", "--device", "tpu",
                     "--root", str(root)]) == -1


def test_engine_refusals():
    with pytest.raises(ValueError, match="pretune"):
        tsim.SPHSimulation(device="cpu", pretune="on")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tsim.SPHSimulation(device="cuda")


def test_imports_without_jax_and_without_building():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import libclsph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(libclsph_tpu_torch.__path__,
                                               "libclsph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from libclsph_tpu_torch.ops.kernels import build
assert build._library is None, "kernel library loaded at import"
assert not any(m == "libclsph_tpu" or m.startswith("libclsph_tpu.") for m in sys.modules)
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
