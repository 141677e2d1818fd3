"""One rebuild substep and one reuse substep of the port against the JAX
package's ``substep_jit`` / ``substep_reuse_jit`` at the main-path
configuration, in free space (the cube-scene pair is in
test_torch_engine.py).

Both sides run the rebuild substep from the same NumPy state; the
port's reuse substep then starts from the JAX rebuild's state and
tables, so each substep is compared on identical inputs. Integer tables (refined candidate ids and counts), the flags
and the sort order must be equal; density agrees to rtol 1e-5, the
acceleration to atol 1e-5 * max|a|, positions and velocities to float32
rounding of the integration.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep

N = 2048

# the main path as bench.py / the CLI ship it (bench.py:184-226)
JAX_MAIN_PATH = dict(
    neighbor_impl="pallas", pallas_variant="nl", block_size=128, max_candidates=96,
    nl_query_rows=128, max_candidates_sub=192, force_query_rows=32, force_sub16=True,
    density_sub16=True, force_sub8=True, max_candidates_hit8=80, sort_interval=4,
    cand_interval=4, cand_slack=0.25, adaptive_dt=True, tier2_frac=0,
    density_gate=False,
)


def jax_config(**overrides):
    return jstep.StepConfig(**dict(JAX_MAIN_PATH, **overrides))


def run_pair(params, state_np, dt, jax_scene=None, torch_scene=None):
    """A rebuild substep from ``state_np`` and a reuse substep after it,
    on both sides. Returns the states ((jax_s1, jax_s2), (port_s1,
    port_s2)) as NumPy dicts, the substeps' dt and flags, and the
    rebuild's tables."""
    js = JState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    j1, jd1, jf1, jtab = jstep.substep_jit(js, jnp.float32(dt), params, jax_scene,
                                           jax_config())
    j2, jd2, jf2, _ = jstep.substep_reuse_jit(j1, jd1, params, jax_scene, jax_config(),
                                              jtab)
    tp = interop.params_from(params)
    ts = interop.state_from_arrays(state_np, "cpu")
    cfg = tstep.StepConfig()
    t1, td1, tf1, ttab = tstep.substep(ts, torch.tensor(dt, dtype=torch.float32), tp,
                                       torch_scene, cfg)
    # the reuse substep starts from the JAX rebuild's state and tables,
    # so both sides compute it from identical inputs
    as_np = lambda s: {k: np.asarray(getattr(s, k)) for k in state_np}  # noqa: E731
    carried = tuple(torch.as_tensor(np.array(a)) for a in jtab)
    t2, td2, tf2, ttab2 = tstep.substep(
        interop.state_from_arrays(as_np(j1), "cpu"), torch.tensor(float(jd1)), tp,
        torch_scene, cfg, do_sort=False, cand_in=carried,
    )
    assert all(a is b for a, b in zip(ttab2, carried))  # passed through
    return dict(
        jax=(as_np(j1), as_np(j2)),
        port=(interop.state_to_numpy(t1), interop.state_to_numpy(t2)),
        dt=((float(jd1), float(jd2)), (float(td1), float(td2))),
        flags=((int(jf1), int(jf2)), (int(tf1), int(tf2))),
        tables=([np.asarray(a) for a in jtab[:2]], [interop.to_numpy(a) for a in ttab[:2]]),
    )


def assert_states_match(p, j):
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=1e-5)
    amax = np.abs(j["acceleration"]).max()
    np.testing.assert_allclose(p["acceleration"], j["acceleration"], atol=1e-5 * amax)
    vmax = np.abs(j["velocity"]).max()
    np.testing.assert_allclose(p["velocity"], j["velocity"], atol=1e-5 * vmax)
    np.testing.assert_allclose(p["intermediate_velocity"], j["intermediate_velocity"],
                               atol=1e-5 * vmax)
    np.testing.assert_allclose(p["position"], j["position"], atol=1e-6)
    np.testing.assert_allclose(p["pressure"], j["pressure"],
                               atol=1e-4 * np.abs(j["pressure"]).max())


def assert_pair_matches(out, flags=(0, 0)):
    (jf, pf) = out["flags"]
    assert jf == pf == flags
    jt, pt = out["tables"]
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a, b)
    (jd, pd) = out["dt"]
    np.testing.assert_allclose(pd, jd, rtol=1e-5)
    for p, j in zip(out["port"], out["jax"]):
        assert_states_match(p, j)


def random_state(params, n, seed, spread=1.3):
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * spread
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    zeros3 = np.zeros((n, 3), np.float32)
    return dict(position=pos, velocity=vel, intermediate_velocity=vel.copy(),
                acceleration=zeros3, density=np.zeros(n, np.float32),
                pressure=np.zeros(n, np.float32), grid_index=np.zeros(n, np.uint32))


@pytest.fixture(scope="module")
def free_space():
    params = make_params(WATER, n=N)
    return run_pair(params, random_state(params, N, 23), params.max_dt)


def test_rebuild_substep_matches(free_space):
    (jf, pf) = free_space["flags"]
    assert jf[0] == pf[0] == 0
    for a, b in zip(*reversed(free_space["tables"])):
        np.testing.assert_array_equal(a, b)
    assert_states_match(free_space["port"][0], free_space["jax"][0])


def test_reuse_substep_matches(free_space):
    assert_pair_matches(free_space)
    # the reuse substep kept the rebuild's order (no sort)
    p1, p2 = free_space["port"]
    assert not np.array_equal(p1["position"], p2["position"])


def test_substep_leaves_input_untouched():
    params = make_params(WATER, n=1000)
    st = random_state(params, 1000, 3)
    ts = interop.state_from_arrays(st, "cpu")
    before = interop.state_to_numpy(ts)
    tstep.substep(ts, torch.tensor(1e-3), interop.params_from(params), None,
                  tstep.StepConfig())
    after = interop.state_to_numpy(ts)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


def test_reuse_requires_skipping_the_sort():
    params = interop.params_from(make_params(WATER, n=1000))
    ts = interop.state_from_arrays(random_state(params, 1000, 4), "cpu")
    with pytest.raises(ValueError, match="skip the sort"):
        tstep.substep(ts, torch.tensor(1e-3), params, None, tstep.StepConfig(),
                      do_sort=True, cand_in=(None, None, None))


def test_stale_reuse_is_flagged():
    """A carried table used after the particles moved further than the
    slack allows raises FLAG_CAND_STALE (the reuse guard, step.py:507-510)."""
    params = make_params(WATER, n=1000)
    tp = interop.params_from(params)
    ts = interop.state_from_arrays(random_state(params, 1000, 5), "cpu")
    cfg = tstep.StepConfig()
    s1, d1, f1, tab = tstep.substep(ts, torch.tensor(1e-4), tp, None, cfg)
    assert int(f1) == 0
    moved = s1.replace(position=s1.position + 0.2 * params.h)
    _, _, f2, _ = tstep.substep(moved, d1, tp, None, cfg, do_sort=False, cand_in=tab)
    assert int(f2) & tstep.FLAG_CAND_STALE


@pytest.mark.parametrize("field,value", [
    ("neighbor_impl", "tiles"), ("neighbor_impl", "exact"), ("pallas_variant", "asm"),
    ("force_sub8", False), ("density_sub16", False), ("tier2_frac", 8),
    ("density_gate", True), ("force_query_rows", 128), ("nl_query_rows", 32),
    ("block_size", 256),
])
def test_step_config_refuses_unported_variants(field, value):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        tstep.StepConfig(**{field: value})


def test_step_config_defaults_are_the_main_path():
    cfg = tstep.StepConfig()
    for f in dataclasses.fields(cfg):
        if f.name in JAX_MAIN_PATH:
            assert getattr(cfg, f.name) == JAX_MAIN_PATH[f.name], f.name
    with pytest.raises(ValueError, match="multiple of cand_interval"):
        tstep.StepConfig(sort_interval=6, cand_interval=4)
