"""``bench_torch.py``'s schedule against the JAX package driven as
``bench.py`` drives it (``substep_jit`` on rebuild substeps,
``substep_reuse_jit`` in between, bench.py:325-335): 4,096 water
particles falling onto ``scenes/cube.obj`` from one lattice, 3 warm-up
substeps (rebuild, reuse, reuse), then 4 timed ones (rebuild, reuse,
reuse, reuse), on the CPU. Both runs must raise no flag; the states agree
after the warm-up and after the timed window at test_torch_step.py's
tolerances (density rtol 1e-5, acceleration atol 1e-5 * max|a|, velocity
atol 1e-5 * max|v|, position atol 1e-6)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from libclsph_tpu.core.state import init_state as jinit_state
from libclsph_tpu.engine import step as jstep
from libclsph_tpu.ops import collisions as jcoll
from libclsph_tpu.scene.scene import Scene as JScene
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine.simulation import SPHSimulation
from test_torch_step import JAX_MAIN_PATH
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
WARMUP, STEPS = 3, 4


def jax_schedule(state, dt, params, scene, cfg, steps):
    """bench.py's run_substep loop (bench.py:325-335, cand_interval > 1)."""
    flags, tables = 0, None
    for i in range(steps):
        if i % cfg.cand_interval == 0:
            state, dt, f, tables = jstep.substep_jit(
                state, dt, params, scene, cfg, do_sort=i % cfg.sort_interval == 0)
        else:
            state, dt, f, _ = jstep.substep_reuse_jit(state, dt, params, scene, cfg, tables)
        flags |= int(f)
    return state, dt, flags


def assert_close(t, j):
    t = interop.state_to_numpy(t)
    j = {k: np.asarray(getattr(j, k)) for k in t}
    np.testing.assert_array_equal(t["grid_index"], j["grid_index"])
    np.testing.assert_allclose(t["density"], j["density"], rtol=1e-5)
    for name, rel in (("acceleration", 1e-5), ("velocity", 1e-5)):
        np.testing.assert_allclose(t[name], j[name], atol=rel * np.abs(j[name]).max(),
                                   err_msg=name)
    np.testing.assert_allclose(t["position"], j["position"], atol=1e-6)


def test_bench_schedule_matches_jax():
    params = bench.build_params(N)
    jscene = jcoll.build_device_scene(JScene.load(
        os.path.join(bench_torch.ROOT, "scenes", "cube.obj"), params.h * 2))
    jcfg = jstep.StepConfig(**JAX_MAIN_PATH)
    js0 = jinit_state(params)
    js, jdt, jflags = jax_schedule(js0, jnp.float32(params.max_dt), params, jscene, jcfg,
                                   WARMUP)
    js2, jdt2, jflags2 = jax_schedule(js, jdt, params, jscene, jcfg, STEPS)
    assert jflags == jflags2 == 0

    tp = bench_torch.build_params(N)
    tscene = interop.scene_from_arrays(jscene, "cpu")
    engine = SPHSimulation(interop.step_config_from_jax(jcfg), device="cpu", pretune=False)
    ts0 = interop.state_from_arrays(js0, "cpu")
    ts, tdt = bench_torch.warm_up(ts0, tp, tscene, engine, WARMUP)
    assert engine.step_config == interop.step_config_from_jax(jcfg)  # nothing grew
    assert_close(ts, js)
    assert float(tdt) == pytest.approx(float(jdt), rel=1e-6)
    ts2, tdt2, elapsed, tflags = bench_torch.timed_run(ts, tdt, tp, tscene,
                                                       engine.step_config, STEPS)
    assert int(tflags) == 0 and elapsed > 0.0
    assert_close(ts2, js2)
    assert float(tdt2) == pytest.approx(float(jdt2), rel=1e-6)
    assert torch.isfinite(ts2.position).all()
