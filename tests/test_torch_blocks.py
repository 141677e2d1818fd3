"""The block-granular impls of the port against the JAX package: the
``tiles`` impl (dense pair tiles in plain PyTorch), the ``row``, ``fine``
and ``asym`` variants (whole candidate blocks through the 32-wide
kernels, ``ops.kernels.blocks``), ``asm`` and the nl variant without hit
compaction.

* The expanded 32-wide tables against JAX's block tables.
* ``tiles.density_pass`` / ``force_pass`` against JAX's (direct mode).
* ``density_blocks`` / ``forces_blocks`` plain against JAX's Pallas
  ``neighbor.fused_density`` / ``fused_forces`` at ``q_div`` 1 (row) and
  4 (fine) and ``neighbor_asym``'s (asym), interpret mode on the CPU, on
  the same tables: density rtol 1e-5, acceleration atol 1e-5 * max|a|.
* Whole substeps of each config against JAX's ``substep_jit`` with the
  same config (``hit_compact=False`` also with two-tier routing on a
  clustered cloud), and the row variant against the tiles impl at JAX's own
  tolerance for that pair (acceleration atol 1e-4 * max|a|,
  test_physics.py:334-352).
* The engine and the CLI on the tiny cube scene, the engine's capacity
  growth off the nl variant, and the CLI's clamps and refusals.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor as jrow
from libclsph_tpu.ops.pallas import neighbor_asym as jasym
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import tiles as ttiles
from libclsph_tpu_torch.ops.kernels import blocks, density, forces
from test_torch_engine import _root
from test_torch_qpath import assert_passes_match, clustered_state, jax_substep, port_substep
from test_torch_step import JAX_MAIN_PATH, assert_states_match, random_state
from test_torch_tier2 import N as TIER2_N
from test_torch_tier2 import two_tier_config

N = 2000
B = 128
CAP = 96



def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def ref():
    """A sorted, padded cloud (16 blocks) with one coincident pair of
    distinct particles, JAX's block tables for it, and the outputs of
    JAX's tile passes and block kernels, as NumPy."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    rng = np.random.default_rng(53)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    pos[1] = pos[0]
    vel = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    npad = jtiles.padded_count(N, B)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - N, 3))]).astype(np.float32)
    vel = np.concatenate([vel, np.zeros((npad - N, 3), np.float32)])
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[N:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    pos, vel = pos[order], vel[order]
    real = order < N
    nb = npad // B

    jpos, jvel, jreal = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(real)
    bmin, bmax = jtiles.split_block_bounds(jpos.reshape(nb, B, 3), jreal.reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, CAP)
    assert not bool(ovf)
    zeros = jnp.zeros(npad, jnp.float32)
    tcfg = jtiles.TileConfig(block_size=B, max_candidates=CAP, mode="direct")
    blocked = jtiles.make_blocked(jpos, jvel, zeros, zeros, jreal, B)
    dens = jtiles.density_pass(blocked, cand, count, params, terms, tcfg)
    pres = jnp.where(jreal, jinter.tait_pressure(dens, params), 0.0)
    blocked = blocked._replace(density=dens.reshape(nb, B), pressure=pres.reshape(nb, B))
    out = dict(pos=pos, vel=vel, real=real, cand=cand, count=count, dens=dens, pres=pres,
               accel_tiles=jtiles.force_pass(blocked, cand, count, params, terms, tcfg))
    mass = params.particle_mass
    for variant, mod, kw in (("row", jrow, dict(q_div=1)), ("fine", jrow, dict(q_div=4)),
                             ("asym", jasym, {})):
        planes = mod.make_planes(jpos, jvel, zeros, zeros, jreal, B, mass=mass, **kw)
        out[f"dens_{variant}"] = mod.fused_density(planes, cand, count, params, terms, jreal)
        # the force pass of every variant runs on the tiles' density, so
        # all of them see the same pressures
        planes = mod.make_planes(jpos, jvel, dens, pres, jreal, B, mass=mass, **kw)
        out[f"accel_{variant}"] = mod.fused_forces(planes, cand, count, params, terms,
                                                   jreal, dens)
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    return out


def test_expanded_table_covers_jax_block_table(ref):
    """Block id c becomes the 32-wide subblocks 4c .. 4c+3 in its slot's
    four positions, sentinels stay sentinels, counts x4, up to the deepest
    live slot: the particles of the expanded live slots are those of JAX's
    live blocks, in order."""
    cand, count = ref["cand"], ref["count"]
    ids, counts = blocks.expand_block_table(T(cand), T(count))
    ids, counts = np_(ids), np_(counts)
    assert ids.dtype == np.int32 and ids.shape == (cand.shape[0], 4 * count.max())
    np.testing.assert_array_equal(counts, 4 * count)
    for i in range(cand.shape[0]):
        live = cand[i, : count[i]]
        blk_particles = (live[:, None] * B + np.arange(B)).reshape(-1)
        sub = ids[i, : counts[i]]
        np.testing.assert_array_equal((sub[:, None] * 32 + np.arange(32)).reshape(-1),
                                      blk_particles)
    sent = np.array([[5, jtiles.REFINE_SENTINEL, 9], [6, 7, 9]], np.int32)
    e, c = blocks.expand_block_table(T(sent), T(np.array([1, 2], np.int32)))
    np.testing.assert_array_equal(np_(e), [[20, 21, 22, 23] + [jtiles.REFINE_SENTINEL] * 4,
                                           list(range(24, 32))])
    np.testing.assert_array_equal(np_(c), [4, 8])
    assert count.min() >= 1 and count.max() < CAP


def test_tile_passes_match_jax(ref):
    p = ref["params"]
    blocked = ttiles.make_blocked(T(ref["pos"]), T(ref["vel"]), T(ref["dens"]) * 0,
                                  T(ref["pres"]) * 0, T(ref["real"]), B)
    d = ttiles.density_pass(blocked, T(ref["cand"]), T(ref["count"]), p)
    np.testing.assert_allclose(np_(d), ref["dens"], rtol=1e-5)
    nb = blocked.real.shape[0]
    blocked = blocked._replace(density=T(ref["dens"]).reshape(nb, B),
                               pressure=T(ref["pres"]).reshape(nb, B))
    a = np_(ttiles.force_pass(blocked, T(ref["cand"]), T(ref["count"]), p))
    j = ref["accel_tiles"]
    real = ref["real"]
    np.testing.assert_allclose(a[real], j[real], atol=1e-5 * np.abs(j[real]).max())
    # the rest density on padding rows, and a table of sentinels past
    # the counts is read as dead (the clamp before the gather)
    assert np.all(np_(d)[~real] == np.float32(p.fluid_density))
    dead = T(ref["cand"]).clone()
    for i, c in enumerate(ref["count"]):
        dead[i, c:] = ttiles.REFINE_SENTINEL
    d2 = ttiles.density_pass(blocked, dead, T(ref["count"]), p)
    assert torch.isfinite(d2).all()
    np.testing.assert_array_equal(np_(d2), np_(d))


def _block_args(ref):
    pos4 = density.pos_pack(T(ref["pos"]), T(ref["real"]))
    f8 = forces.force_pack(T(ref["pos"]), T(ref["vel"]), T(ref["dens"]), T(ref["pres"]),
                           T(ref["real"]), ref["params"].particle_mass)
    return pos4, f8, T(ref["dens"]), T(ref["real"]), T(ref["cand"]), T(ref["count"])


@pytest.mark.parametrize("variant", ["row", "fine", "asym"])
def test_block_passes_plain_match_pallas(ref, variant):
    """The plain block passes against the variant's Pallas kernels, and
    the wrappers on CPU tensors are the plain versions with no launch."""
    p = ref["params"]
    pos4, f8, dens, real, cand, count = _block_args(ref)
    q_div = 4 if variant == "fine" else 1  # JAX's q_div: the engine's choice
    d = blocks.density_blocks_torch(pos4, cand, count, p)
    np.testing.assert_allclose(np_(d), ref[f"dens_{variant}"], rtol=1e-5)
    a = np_(blocks.forces_blocks_torch(f8, dens, real, cand, count, p, q_div))
    j = ref[f"accel_{variant}"]
    np.testing.assert_allclose(a, j, atol=1e-5 * np.abs(j).max())
    assert not np.any(a[~ref["real"]])
    before = (density.density_c32.launches, forces.forces_q128_c32.launches,
              forces.forces_q32_c32.launches)
    assert torch.equal(blocks.density_blocks(pos4, cand, count, p), d)
    assert np.array_equal(np_(blocks.forces_blocks(f8, dens, real, cand, count, p, q_div)), a)
    assert (density.density_c32.launches, forces.forces_q128_c32.launches,
            forces.forces_q32_c32.launches) == before


def test_block_wrappers_check_inputs(ref):
    p = ref["params"]
    pos4, f8, dens, real, cand, count = _block_args(ref)
    with pytest.raises(ValueError, match="q_div"):
        blocks.forces_blocks(f8, dens, real, cand, count, p, 2)
    with pytest.raises(ValueError, match="q_div"):
        blocks.forces_blocks_torch(f8, dens, real, cand, count, p, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        blocks.density_blocks(pos4.to("meta"), cand.to("meta"), count.to("meta"), p)


# each config off JAX's main path: the fields set, for both packages
SUBSTEP_CONFIGS = {
    "tiles": dict(neighbor_impl="tiles", cand_interval=1),
    "row": dict(pallas_variant="row", cand_interval=1),
    "fine": dict(pallas_variant="fine", cand_interval=1),
    "asym": dict(pallas_variant="asym", cand_interval=1),
    "asm": dict(pallas_variant="asm", cand_interval=1, density_sub16=False,
                force_sub8=False, max_candidates_hit=192),
    "no_hit_compact": dict(hit_compact=False, density_sub16=False, force_sub8=False),
}


@pytest.mark.parametrize("name", list(SUBSTEP_CONFIGS))
def test_substep_matches_jax(name):
    """One substep of each config, both packages from the same state and
    one config: equal order and flags, density rtol 1e-5, acceleration
    atol 1e-5 * max|a|, and the integrated state."""
    n = 2048
    params = make_params(WATER, n=n)
    state = random_state(params, n, 61)
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **SUBSTEP_CONFIGS[name]))
    j, jf = jax_substep(params, state, jcfg)
    cfg = interop.step_config_from_jax(jcfg)
    p, pf = port_substep(params, state, cfg)
    assert jf == pf == 0
    assert_states_match(p, j)


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


def test_row_substep_matches_tiles_substep():
    """The row variant against the tiles impl in the port, from one state
    at JAX's tolerance for this pair (test_physics.py:334-352)."""
    n = 2048
    params = make_params(WATER, n=n)
    state = random_state(params, n, 67)
    t, tf = port_substep(params, state, tstep.StepConfig(neighbor_impl="tiles",
                                                         cand_interval=1))
    r, rf = port_substep(params, state, tstep.StepConfig(pallas_variant="row",
                                                         cand_interval=1))
    assert tf == rf == 0
    np.testing.assert_array_equal(r["grid_index"], t["grid_index"])
    np.testing.assert_allclose(r["density"], t["density"], rtol=1e-5)
    amax = np.abs(t["acceleration"]).max()
    np.testing.assert_allclose(r["acceleration"], t["acceleration"], atol=1e-4 * amax)


@pytest.mark.parametrize("flag", [["--neighbor-impl", "tiles"], ["--pallas-variant", "row"]],
                         ids=["tiles", "row"])
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


def test_cli_clamps_and_refusals(tmp_path, monkeypatch):
    """The JAX CLI's rules: candidate reuse and the 16-granular tables go
    quietly off where the impl or variant has none; asm on the
    16-granular tables and an undivided --cand-interval exit -1."""
    root = _root(tmp_path)
    monkeypatch.chdir(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root)]
    seen = {}

    class Stop(Exception):
        pass

    def capture(self):
        seen["cfg"] = self.step_config
        raise Stop

    monkeypatch.setattr(tsim.SPHSimulation, "simulate", capture)
    for flags, expect in [
        (["--neighbor-impl", "tiles"], dict(cand_interval=1, density_sub16=False,
                                            force_sub8=False)),
        (["--pallas-variant", "fine"], dict(cand_interval=1, density_sub16=True)),
        (["--pallas-variant", "asm", "--no-density-sub16"],
         dict(cand_interval=1, force_sub8=False, pallas_variant="asm")),
        (["--no-hit-compact", "--no-density-sub16"], dict(hit_compact=False, cand_interval=4)),
        (["--sort-interval", "2"], dict(cand_interval=2)),
    ]:
        with pytest.raises(Stop):
            cli.main(base + flags)
        for k, v in expect.items():
            assert getattr(seen["cfg"], k) == v, (flags, k)
    assert cli.main(base + ["--pallas-variant", "asm"]) == -1
    assert cli.main(base + ["--no-hit-compact"]) == -1
    assert cli.main(base + ["--neighbor-impl", "tiles", "--cand-interval", "3"]) == -1


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
