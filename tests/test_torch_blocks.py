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
  same config, and the row variant against the tiles impl at JAX's own
  tolerance for that pair (acceleration atol 1e-4 * max|a|,
  test_physics.py:334-352).
* The CLI's clamps and refusals.

``hit_compact=False`` with two-tier routing, the engine's capacity
growth off the nl variant and the CLI's runs of the tiny cube are in
test_torch_blocks_engine.py (a file of their own, so that no file sets
the length of a parallel run).
"""

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
from test_torch_qpath import jax_substep, port_substep
from test_torch_step import JAX_MAIN_PATH, assert_states_match, random_state
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

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


def assert_substep_matches_jax(name):
    """One substep of each config, both packages from the same state and
    one config: equal order and flags, density rtol 1e-5, acceleration
    atol 1e-5 * max|a|, and the integrated state. The asm and
    no-hit-compact configs run in test_torch_blocks_substeps.py."""
    n = 2048
    params = make_params(WATER, n=n)
    state = random_state(params, n, 61)
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **SUBSTEP_CONFIGS[name]))
    j, jf = jax_substep(params, state, jcfg)
    cfg = interop.step_config_from_jax(jcfg)
    p, pf = port_substep(params, state, cfg)
    assert jf == pf == 0
    assert_states_match(p, j)


@pytest.mark.parametrize("name", ["tiles", "row", "fine", "asym"])
def test_substep_matches_jax(name):
    assert_substep_matches_jax(name)


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
