"""Two-tier capacity routing in the port against the JAX package
(``tiles.route_overflow``, ``engine/step.nl_two_tier_passes``), the
tier-2 pool's overflow flag, and the configs and flags the engine and
the CLI accept. The q32 two-tier substep and the agreement of every
configuration the port runs are in test_torch_tier2_q32.py, the CLI's
runs and refusal in test_torch_tier2_cli.py, the engine's runs of the
16-wide force shapes in test_torch_tier2_engine.py (files of their own,
so that no file sets the length of a parallel run).

The two-tier substeps start from one clustered cloud on both sides:
the base subblock capacity lies below the heavy blocks and above the
light median (test_tier2.py's recipe), so the heavy blocks run in the
tier-2 pool through the kernels' query-block map. Tolerances: density
rtol 1e-5, acceleration atol 1e-5 * max|a|; tables and flags equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import tiles as ttiles
from test_torch_qpath import Q_PATH, assert_passes_match, clustered_state, port_substep
from test_torch_step import JAX_MAIN_PATH
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("count,c1,nb2", [
    ([3, 50, 7, 90, 2, 60, 1, 4], 10, 4),  # test_tier2.py's unit case
    ([3, 50, 7, 90, 2, 60, 1, 4], 10, 2),  # pool overflow
    ([40, 12, 40, 40, 5, 40, 13, 40, 40], 12, 3),  # ties: lowest rows first
    ([1, 2, 3], 10, 2),  # nothing heavy: every slot unused
])
def test_route_overflow_equals_jax(count, c1, nb2):
    j = jtiles.route_overflow(jnp.asarray(count, jnp.int32), c1, nb2)
    t = ttiles.route_overflow(torch.tensor(count, dtype=torch.int32), c1, nb2)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))  # used
    used = np.asarray(j[1])
    # routed rows equal; unused slots point at arbitrary rows in both
    np.testing.assert_array_equal(t[0].numpy()[used], np.asarray(j[0])[used])
    assert len(set(t[0].tolist())) == nb2  # distinct rows: the merge is a scatter
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert bool(t[3]) == bool(j[3])


def test_route_overflow_random_ties_equal_jax():
    rng = np.random.default_rng(3)
    count = rng.integers(0, 8, size=500).astype(np.int32)
    for c1, nb2 in ((4, 63), (5, 200), (6, 30)):
        j = jtiles.route_overflow(jnp.asarray(count), c1, nb2)
        t = ttiles.route_overflow(torch.as_tensor(count), c1, nb2)
        used = np.asarray(j[1])
        np.testing.assert_array_equal(t[1].numpy(), used)
        np.testing.assert_array_equal(t[0].numpy()[used], np.asarray(j[0])[used])
        assert bool(t[3]) == bool(j[3])


def refined_counts(params, state_np, cfg):
    """Per-block refined counts of the port's candidate build (tier 2
    off, a cap no block reaches)."""
    tp = interop.params_from(params)
    st, real, _ = tstep.pad_and_sort(interop.state_from_arrays(state_np, "cpu"), tp, True)
    big = tstep.StepConfig(**{**vars_of(cfg), "tier2_frac": 0, "max_candidates_sub": 1024})
    _, count, flags = tstep.build_candidates(st, real, tp, big)
    assert int(flags) == 0
    return count.numpy()


def vars_of(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def two_tier_config(params, state_np, base):
    """``base`` with max_candidates_sub below the heavy blocks, and a
    tier-2 pool and multiplier that hold them."""
    counts = refined_counts(params, state_np, tstep.StepConfig(**base))
    c1 = max(16, int(np.median(counts)) + 8)
    assert (counts > c1).any(), "the cloud produced no heavy blocks"
    assert (counts <= c1).sum() > len(counts) // 2, "the cloud is too uniform"
    mult = 2
    while c1 * mult < counts.max():
        mult *= 2
    heavy, nb = int((counts > c1).sum()), len(counts)
    frac = next(k for k in (8, 4, 2, 1) if -(-nb // k) >= heavy)
    return dict(base, max_candidates_sub=c1, tier2_frac=frac, tier2_mult=mult)


CONFIGS = {
    "main": dict(max_candidates_hit8=160),
    "c16-sub16": dict(force_sub8=False, max_candidates_hit16=192),
    "c32-sub16": dict(Q_PATH, force_sub16=True, max_candidates_hit16=192,
                      max_candidates_hit=192),
    "q32": dict(Q_PATH, max_candidates_hit=192),
    "q128": dict(Q_PATH, max_candidates_hit=192, force_query_rows=128),
}


@pytest.fixture(scope="module")
def cloud():
    params = make_params(WATER, n=N)
    return params, clustered_state(params, N, 41)


def assert_two_tier_substep_matches_jax(cloud, name):
    """q32 + tier 2 (tier 2 on density_c32 at one hit row per block and
    forces_q128_c32) and main + tier 2 (tier 2 on the main-path kernels
    through the query-block map), against JAX substep_jit; the carried
    table is the tier-2-width one on both sides. The q32 case runs in
    test_torch_tier2_q32.py."""
    params, state = cloud
    over = two_tier_config(params, state, CONFIGS[name])
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **over))
    from libclsph_tpu.core.state import ParticleState as JState

    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    j1, _, jf, jtab = jstep.substep_jit(js, jnp.float32(params.max_dt), params, None, jcfg)
    cfg = interop.step_config_from_jax(jcfg)
    t1, _, tf, ttab = tstep.substep(interop.state_from_arrays(state, "cpu"),
                                    torch.tensor(params.max_dt, dtype=torch.float32),
                                    interop.params_from(params), None, cfg)
    assert int(jf) == int(tf) == 0
    assert ttab[0].shape[1] > cfg.max_candidates_sub  # the tier-2 width
    for a, b in zip(ttab[:2], jtab[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    j = {k: np.asarray(getattr(j1, k)) for k in state}
    assert_passes_match(interop.state_to_numpy(t1), j)


@pytest.mark.parametrize("name", ["main"])
def test_two_tier_substep_matches_jax(cloud, name):
    assert_two_tier_substep_matches_jax(cloud, name)


def test_pool_overflow_raises_the_t2_flag(cloud):
    params, state = cloud
    over = two_tier_config(params, state, CONFIGS["q32"])
    nb = -(-N // 128)
    _, flags = port_substep(params, state, tstep.StepConfig(**dict(over, tier2_frac=nb * 2)))
    assert flags & tstep.FLAG_CAPACITY_T2


def _tiny_root(tmp_path):
    """A --root with water, cube.obj and tiny.json (2048 particles, 3
    frames)."""
    import shutil

    root = tmp_path / "root"
    for d in ("fluid_properties", "simulation_properties", "scenes"):
        (root / d).mkdir(parents=True)
    for d, name in (("fluid_properties", "water.json"), ("scenes", "cube.obj"),
                    ("simulation_properties", "tiny.json")):
        shutil.copy(os.path.join(ROOT, d, name), root / d)
    return root


def test_step_config_accepts_the_ported_shapes():
    for over in ({}, dict(tier2_frac=8), Q_PATH, dict(Q_PATH, force_query_rows=128),
                 dict(Q_PATH, force_query_rows=128, tier2_frac=1)):
        tstep.StepConfig(**over)
    with pytest.raises(ValueError, match="tier2_frac"):
        tstep.StepConfig(tier2_frac=-1)


@pytest.mark.parametrize("pretune", ["on", 1, None, "yes"])
def test_engine_refuses_other_pretune_values(pretune):
    with pytest.raises(ValueError, match="pretune"):
        tsim.SPHSimulation(device="cpu", pretune=pretune)


def test_cli_flags_reach_the_config(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake(step_config=None, device="cuda", pretune="auto"):
        seen.update(cfg=step_config, device=device, pretune=pretune)
        raise Stop

    monkeypatch.setattr(cli, "SPHSimulation", fake)
    with pytest.raises(Stop):
        cli.main(["water", "tiny", "cube", "out_", "--device", "cpu",
                  "--no-density-sub16", "--no-force-sub16", "--force-query-rows", "128",
                  "--tier2-frac", "4", "--max-candidates-hit", "200",
                  "--max-candidates-hit16", "80", "--pretune", "off"])
    cfg = seen["cfg"]
    assert (cfg.density_sub16, cfg.force_sub16, cfg.force_sub8) == (False, False, False)
    assert (cfg.force_query_rows, cfg.tier2_frac, cfg.max_candidates_hit,
            cfg.max_candidates_hit16) == (128, 4, 200, 80)
    assert seen["pretune"] is False
    with pytest.raises(Stop):
        cli.main(["water", "tiny", "cube", "out_"])
    assert seen["cfg"] == tstep.StepConfig() and seen["pretune"] == "auto"
