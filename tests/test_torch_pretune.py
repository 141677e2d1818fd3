"""The port's init-state pretune, capacity autotune and presets against
the JAX package's.

* ``_probe_counts``: every integer statistic (and the per-block refined
  depths) equals the JAX probe's, on the mildly clumped two-blob cloud
  and on the deep-column sheet of test_pretune.py.
* ``pretune_config``: the same updates and statistics on the benign
  lattice (config unchanged) and on the deep-column sheet (downgraded
  to the q-granular tables up front).
* ``_grow_capacity``: the same flag sequences drive the port's and the
  JAX ``SPHSimulation`` to equal configs (two-tier on, its multiplier,
  the pool fraction; hit8 steps to the c16 -> q downgrade, then
  max_candidates_hit doubling).
* The engine runs the probe when ``pretune`` asks for it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.core.state import init_state as jinit_state
from libclsph_tpu.engine import pretune as jpretune
from libclsph_tpu.engine.simulation import SPHSimulation as JSim
from libclsph_tpu.models import presets as jpresets
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import pretune as tpretune
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.models import presets as tpresets
from test_torch_step import jax_config
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def blob_positions(n, params, seed=1234):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0.0, 4 * params.h, (n // 2, 3)),
        rng.normal(0.35, 3 * params.h, (n - n // 2, 3)),
    ]).astype(np.float32)


def sheet_positions(n, params, seed=1234):
    """Every particle within h of a plane: a degenerate deep column."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 1] = rng.uniform(0, 0.3 * params.h, n)
    pos[:, 0] = rng.uniform(0, 0.5 * params.h, n)
    pos[:, 2] = rng.uniform(0, 0.5 * params.h, n)
    return pos


def lattice_positions(n, params):
    return np.asarray(jinit_state(params).position)


def states(pos):
    n = pos.shape[0]
    z3, z1 = np.zeros((n, 3), np.float32), np.zeros(n, np.float32)
    arrays = dict(position=pos, velocity=z3, intermediate_velocity=z3, acceleration=z3,
                  density=z1, pressure=z1, grid_index=np.zeros(n, np.uint32))
    js = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return js, interop.state_from_arrays(arrays, "cpu")


@pytest.mark.parametrize("make", [blob_positions, sheet_positions], ids=["blobs", "sheet"])
def test_probe_counts_equal_jax(make):
    n = 2048
    params = make_params(n=n)
    js, ts = states(make(n, params))
    jcfg = jax_config()
    j = jpretune._probe_counts(js, params, jcfg, cap_blocks=64, cap_sub=512)
    t = tpretune._probe_counts(ts, interop.params_from(params),
                               interop.step_config_from_jax(jcfg), cap_blocks=64,
                               cap_sub=512)
    assert set(t) == set(j)
    for k in j:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)
    assert int(t["hit16_max"]) > 0 and int(t["hit32_max"]) > 0


@pytest.mark.parametrize("make", [lattice_positions, sheet_positions],
                         ids=["lattice", "deep-column"])
def test_pretune_config_equals_jax(make):
    n = 4096
    params = make_params(n=n)
    js, ts = states(make(n, params))
    jcfg = jax_config()
    jout, jstats = jpretune.pretune_config(js, params, jcfg)
    tout, tstats = tpretune.pretune_config(ts, interop.params_from(params),
                                           interop.step_config_from_jax(jcfg))
    assert tstats == jstats
    assert tout == interop.step_config_from_jax(jout)
    if make is lattice_positions:
        assert tout == tstep.StepConfig()
    else:
        assert (tout.density_sub16, tout.force_sub16, tout.force_sub8) == (False,) * 3
        assert max(32, tout.max_candidates_hit // 2) >= tstats["hit32_max"]


def test_pretune_skips_the_q_granular_tables():
    params = interop.params_from(make_params(n=1024))
    _, ts = states(sheet_positions(1024, params))
    cfg = tstep.StepConfig(density_sub16=False, force_sub16=False, force_sub8=False)
    assert tpretune.pretune_config(ts, params, cfg) == (cfg, None)


FLAGS = dict(SUB=tstep.FLAG_CAPACITY_SUB, T2=tstep.FLAG_CAPACITY_T2,
             HIT=tstep.FLAG_CAPACITY_HIT, CAP=tstep.FLAG_CAPACITY)


@pytest.mark.parametrize("sequence", [
    ["SUB", "SUB", "T2"],
    ["HIT"] * 4 + ["HIT"],  # hit8 80 -> 112 -> 144 -> 176 -> downgrade -> hit x2
    ["CAP", "SUB|HIT", "T2|HIT", "SUB|T2|HIT|CAP"],
], ids=["tier2", "hit-downgrade", "combined"])
def test_grow_capacity_follows_jax(sequence):
    jsim = JSim(step_config=jax_config())
    tsim_ = tsim.SPHSimulation(interop.step_config_from_jax(jax_config()), device="cpu")
    seen = []
    for names in sequence:
        f = 0
        for name in names.split("|"):
            f |= FLAGS[name]
        jsim._grow_capacity(f)
        tsim_._grow_capacity(f)
        assert tsim_.step_config == interop.step_config_from_jax(jsim.step_config)
        seen.append(tsim_.step_config)
    if sequence[0] == "SUB":
        assert [c.tier2_frac for c in seen] == [8, 8, 4] and seen[1].tier2_mult == 4
        assert seen[-1].max_candidates_sub == tstep.StepConfig().max_candidates_sub
    if sequence[0] == "HIT":
        assert [c.max_candidates_hit8 for c in seen[:3]] == [112, 144, 176]
        assert not seen[3].density_sub16 and seen[3].max_candidates_hit == 96
        assert seen[4].max_candidates_hit == 192


def test_grow_capacity_gives_up_after_the_retry_limit():
    sim = tsim.SPHSimulation(device="cpu")
    for _ in range(tsim.MAX_CAPACITY_RETRIES):
        sim._grow_capacity(tstep.FLAG_CAPACITY)
    with pytest.raises(RuntimeError, match="keeps overflowing"):
        sim._grow_capacity(tstep.FLAG_CAPACITY)


@pytest.mark.parametrize("pretune,n,probes", [
    ("auto", 1000, False), ("auto", tsim.PRETUNE_AUTO_MIN, True), (True, 1000, True),
    (False, tsim.PRETUNE_AUTO_MIN, False),
])
def test_engine_runs_the_probe_when_asked(monkeypatch, pretune, n, probes):
    """simulate() probes after init_particles (simulation.py:523-533) and
    keeps the config the pretune returns."""
    calls = []
    grown = dataclasses.replace(tstep.StepConfig(), max_candidates=192)

    def fake(state, params, config):
        calls.append(state.n)
        return grown, {"probe": 1}

    monkeypatch.setattr(tpretune, "pretune_config", fake)
    sim = tsim.SPHSimulation(device="cpu", pretune=pretune)
    p = dataclasses.replace(interop.params_from(make_params(n=16)), particles_count=n,
                            simulation_time=0.0)
    sim.parameters = p
    sim.init_particles = lambda: tstep.ParticleState.zeros(16, "cpu")
    sim.simulate()
    assert bool(calls) == probes
    if probes:
        assert sim.step_config == grown and sim.pretune_stats == {"probe": 1}


def test_presets_equal_jax():
    assert tpresets.FLUIDS == jpresets.FLUIDS
    assert set(tpresets.PRESETS) == set(jpresets.PRESETS)
    for name, jp in jpresets.PRESETS.items():
        tp = tpresets.get_preset(name)
        assert (tp.fluid, tp.sim, tp.scene) == (jp.fluid, jp.sim, jp.scene)
        assert tp.parameters() == interop.params_from(jp.parameters())
    assert tpresets.simulation_config(particles_count=5) == jpresets.simulation_config(
        particles_count=5)
    with pytest.raises(KeyError, match="unknown preset"):
        tpresets.get_preset("nope")


def test_step_config_from_jax_refuses_knobs_without_a_port():
    with pytest.raises(ValueError, match="hit_compact"):
        interop.step_config_from_jax(jax_config(hit_compact=False))
    cfg = interop.step_config_from_jax(jax_config(tier2_frac=8, tier2_mult=4))
    assert (cfg.tier2_frac, cfg.tier2_mult) == (8, 4)
