"""The block-granular and nl variants end to end: ``hit_compact=False``
with two-tier routing against JAX's ``substep_jit`` on a clustered cloud
(and bit for bit against the single-tier substep), the engine's capacity
growth off the nl variant, and the CLI on the tiny cube with the tiles
impl and the row variant. Tolerances as in test_torch_blocks.py.
"""

import os

import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from test_torch_blocks import SUBSTEP_CONFIGS
from test_torch_engine import _root
from test_torch_qpath import assert_passes_match, clustered_state, jax_substep, port_substep
from test_torch_step import JAX_MAIN_PATH
from test_torch_tier2 import N as TIER2_N
from test_torch_tier2 import two_tier_config
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_no_hit_compact_two_tier_substep_matches_jax():
    """hit_compact=False with two-tier routing, which the engine turns on
    for this config on a refined-capacity overflow: the heavy blocks of a
    clustered cloud go to the tier-2 pool and both tiers' force passes
    run over their full refined lists (step.py:842-850). The cloud is
    test_torch_tier2's. Each block runs its candidates in one order in
    either tier, so the result equals the single-tier substep's bit for
    bit."""
    params = make_params(WATER, n=TIER2_N)
    state = clustered_state(params, TIER2_N, 41)
    base = SUBSTEP_CONFIGS["no_hit_compact"]
    over = two_tier_config(params, state, base)
    assert over["tier2_frac"] > 0
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **over))
    j, jf = jax_substep(params, state, jcfg)
    p, pf = port_substep(params, state, interop.step_config_from_jax(jcfg))
    assert jf == pf == 0
    assert_passes_match(p, j)  # the pair passes, as test_torch_tier2 holds this cloud
    single, sf = port_substep(params, state, tstep.StepConfig(**base))
    assert sf == 0
    for k in ("density", "acceleration"):
        np.testing.assert_array_equal(p[k], single[k])


@pytest.mark.parametrize("flag", [["--neighbor-impl", "tiles"],
                                  ["--neighbor-impl", "tiles", "--tile-mode", "mxu"],
                                  ["--pallas-variant", "row"]],
                         ids=["tiles", "tiles-mxu", "row"])
def test_cli_runs_the_tiny_cube(tmp_path, monkeypatch, flag):
    """One frame of the tiny cube through the CLI (the engine's fast
    path), with the checkpoint's state checked."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0)
    monkeypatch.chdir(tmp_path)
    args = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root)] + flag
    assert cli.main(args) == 0
    frames = sorted(os.listdir(tmp_path / "out_frames"))
    assert frames == ["frame0000001.geo", "frame0000002.geo"]
    ck = np.load(tmp_path / "last_frame.npz")
    pos, dens = ck["position"], ck["density"]
    assert np.isfinite(pos).all() and pos.shape == (2048, 3)
    assert pos[:, 1].min() > -1.6 and np.abs(pos[:, [0, 2]]).max() < 0.7
    assert np.isfinite(dens).all() and 0.3 * 998.29 < np.median(dens) < 3 * 998.29


@pytest.mark.parametrize("variant", ["row", "asm"])
def test_engine_grows_capacity_off_the_nl_variant(tmp_path, variant):
    """A block cap too small for the first frame doubles (row), and on
    asm a short subblock cap doubles, since asm runs single tier
    (simulation.py:207-232). The 8 blocks of 1000 particles hold at most
    32 32-wide subblocks, so one doubling from 16 suffices."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0, serialize=False,
                 particles_count=1000)
    kw = dict(pallas_variant=variant, cand_interval=1, max_candidates=4)
    if variant == "asm":
        kw.update(density_sub16=False, force_sub8=False, max_candidates_sub=16,
                  max_candidates=96)
    sim = tsim.SPHSimulation(tstep.StepConfig(**kw), device="cpu")
    sim.checkpoint_path = str(tmp_path / "none.npz")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
    sim.simulate()
    cfg = sim.step_config
    assert sim.capacity_retries >= 1 and cfg.tier2_frac == 0
    if variant == "asm":
        assert cfg.max_candidates_sub >= 32
    else:
        assert cfg.max_candidates >= 8
    assert sim.state.n == 1000 and torch.isfinite(sim.state.position).all()
