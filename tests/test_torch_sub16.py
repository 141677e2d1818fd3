"""The 16-wide force path of the port against the JAX package: the
density kernels' hit_sub-16 modes and the dilated tile counts,
``pack_tile_nibbles``, ``fused_forces_nl32_c16``, the 16-wide hit lists
of both table shapes, and the autotune's and the pretune's c16 -> q
downgrade from both; whole substeps of (density_sub16, force_sub16,
force_sub8) = (True, True, False) and (False, True, False) are in
test_torch_sub16_ttf.py and test_torch_sub16_ftf.py.

The JAX side runs ``fused_density_nl`` (``c16`` True and False at
``hit_sub=16``, ``hit2_h``) and ``fused_forces_nl32_c16`` on a
``with_gid=False`` pack in interpret mode (picked automatically on the
CPU) on tables built by its own candidate machinery from one random
cloud with one coincident pair; the port's plain versions get the same
tables and fields. Tolerances, as in test_torch_kernels.py: density rtol
1e-5, acceleration atol 1e-5 * max|a| (float32 summation order); hit
counts, tile counts, mask bits and tables are integers and must be
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import pretune as jpretune
from libclsph_tpu.engine.simulation import SPHSimulation as JSim
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import pretune as tpretune
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops.kernels import density, forces
from test_torch_pretune import FLAGS, lattice_positions, sheet_positions, states
from test_torch_step import assert_pair_matches, jax_config, random_state, run_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 2000
B = 128
SLACK = 0.25
CAP_SUB = {16: 192, 32: 96}  # refined capacity by subblock width
CAP_HIT16 = 96
SHAPES = {  # (density_sub16, force_sub16, force_sub8) by subblock width
    16: dict(density_sub16=True, force_sub16=True, force_sub8=False),
    32: dict(density_sub16=False, force_sub16=True, force_sub8=False),
}


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(a):
    return torch.as_tensor(np.array(a))


def sorted_cloud(params, n, seed):
    """A random cloud with one coincident pair, padded with far sentinels
    to whole blocks and sorted by a coarse cell key (compact blocks).
    Returns (pos, vel, real) as NumPy."""
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    pos[1] = pos[0]  # a coincident pair of distinct particles
    vel = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    npad = jtiles.padded_count(n, B)
    far = pos.max(axis=0) + 1000.0 * params.h
    pos = np.concatenate([pos, np.broadcast_to(far, (npad - n, 3))]).astype(np.float32)
    vel = np.concatenate([vel, np.zeros((npad - n, 3), np.float32)])
    cell = np.floor(pos / (2 * params.h)).astype(np.int64)
    key = (cell[:, 0] * 1_000_003 + cell[:, 1]) * 1_000_003 + cell[:, 2]
    key[n:] = np.iinfo(np.int64).max
    order = np.argsort(key, kind="stable")
    return pos[order], vel[order], order < n


def jax_blocks(pos, real, h_search):
    """The JAX block search at ``h_search``: (pos_b, bmin, bmax, cand,
    count)."""
    nb = pos.shape[0] // B
    pos_b = jnp.asarray(pos.reshape(nb, B, 3))
    bmin, bmax = jtiles.split_block_bounds(pos_b, jnp.asarray(real).reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, h_search, 96)
    assert not bool(ovf)
    return pos_b, bmin, bmax, cand, count


@pytest.fixture(scope="module")
def ref():
    """Sorted, padded cloud + the JAX 16-wide force path's tables and
    kernel outputs at both subblock widths, all as NumPy. The tables are
    built at (1 + slack) h, as on a reuse run, so the dilated tile counts
    see pairs between h and (1 + slack) h."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    pos, vel, real = sorted_cloud(params, N, 53)
    nb = pos.shape[0] // B
    h_search = params.h * (1.0 + SLACK)

    pos_j, vel_j, real_j = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(real)
    pos_b, bmin, bmax, cand, count = jax_blocks(pos, real, h_search)
    zeros = jnp.zeros(pos.shape[0], jnp.float32)
    q_pos, _ = nl.make_query_planes(pos_j, vel_j, zeros, zeros, real_j, B,
                                    mass=params.particle_mass)
    out = dict(pos=pos, vel=vel, real=real)
    for width in (16, 32):
        sub = B // width
        self_lo = jnp.arange(nb, dtype=jnp.int32) * sub
        cand_sub, count_sub, ovf2 = jtiles.refine_candidates_exact(
            cand, count, bmin, bmax, pos_b, h_search, sub, CAP_SUB[width],
            self_lo=self_lo, self_width=sub,
        )
        assert not bool(ovf2)
        if width == 16:
            c_pos = nl.make_c16_pos_pack(pos_j, real_j)
            dens, hits, tiles = nl.fused_density_nl(
                q_pos, c_pos, cand_sub, count_sub, params, terms, real_j,
                want_hits=True, hit_groups=nl.QG, hit_sub=nl.SUB16, c16=True,
                hit2_h=h_search,
            )
            out["tiles"] = tiles
            out["mask"] = nl.pack_tile_nibbles(tiles, nb)
            ids, lo, sw = cand_sub, self_lo, sub
        else:
            c_pos, _ = nl.make_csub_packs(pos_j, vel_j, zeros, zeros, real_j,
                                          mass=params.particle_mass)
            dens, hits = nl.fused_density_nl(
                q_pos, c_pos, cand_sub, count_sub, params, terms, real_j,
                want_hits=True, hit_groups=nl.QG, hit_sub=nl.SUB16, c16=False,
            )
            sent = jtiles.REFINE_SENTINEL
            twice = jnp.where(cand_sub == sent, sent, cand_sub * 2)
            ids = jnp.stack([twice, jnp.where(cand_sub == sent, sent, twice + 1)],
                            axis=-1).reshape(nb, -1)
            lo, sw = self_lo * 2, 2 * sub
        hits = hits[:, : ids.shape[1]]
        cand_f, count_f, ovf3 = jtiles.compact_hits(
            jnp.repeat(ids, nl.QG, axis=0), hits, CAP_HIT16,
            self_lo=jnp.repeat(lo, nl.QG), self_width=sw,
        )
        assert not bool(ovf3)
        pres = jnp.where(real_j, jinter.tait_pressure(dens, params), 0.0)
        _, q_force = nl.make_query_planes(pos_j, vel_j, dens, pres, real_j, B,
                                          mass=params.particle_mass)
        c16_force = nl.make_c16_force_pack(pos_j, vel_j, dens, pres, real_j,
                                           mass=params.particle_mass, with_gid=False)
        accel = nl.fused_forces_nl32_c16(q_force, c16_force, cand_f, count_f, params,
                                         terms, real_j, dens)
        for k, v in dict(cand_sub=cand_sub, count_sub=count_sub, dens=dens, hits=hits,
                         pres=pres, cand_f=cand_f, count_f=count_f, accel=accel).items():
            out[f"{k}{width}"] = v
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    out["h_search"] = h_search
    return out


def _density_args(r, width):
    return (density.pos_pack(T(r["pos"]), T(r["real"])), T(r[f"cand_sub{width}"]),
            T(r[f"count_sub{width}"]), r["params"])


def _f8(r, width):
    return forces.force_pack(T(r["pos"]), T(r["vel"]), T(r[f"dens{width}"]),
                             T(r[f"pres{width}"]), T(r["real"]), r["params"].particle_mass)


@pytest.mark.parametrize("dilated", [False, True], ids=["hits", "hits+tiles"])
def test_density_c16_hit16_plain_matches_pallas(ref, dilated):
    """c16 at hit_sub 16: one count a slot; with hit2_h also the dilated
    per-(subgroup, tile) counts, which JAX pads to whole 8-tile steps."""
    out = density.density_c16_torch(*_density_args(ref, 16), hit_sub=16,
                                    hit2_h=ref["h_search"] if dilated else None)
    d, hits = out[:2]
    np.testing.assert_allclose(np_(d), ref["dens16"], rtol=1e-5)
    assert hits.dtype == torch.int32 and hits.shape == ref["hits16"].shape
    np.testing.assert_array_equal(np_(hits), ref["hits16"].astype(np.int64))
    assert len(out) == 2 + dilated
    if dilated:
        tiles = np_(out[2])
        jt = ref["tiles"].astype(np.int64)
        assert tiles.shape == (hits.shape[0], -(-hits.shape[1] // 8))
        np.testing.assert_array_equal(tiles, jt[:, : tiles.shape[1]])
        assert not jt[:, tiles.shape[1]:].any()
        # the dilated counts see the pairs between h and (1 + slack) h
        assert (jt.sum() > ref["hits16"].sum()) and ((jt > 0).sum() > 0)


def test_pack_tile_nibbles_bits_equal_jax(ref):
    """The port's mask words hold JAX's bits: bit (t % 8) * 4 + g of word
    t // 8 for subgroup g and tile t, from the port's own tile counts."""
    _, _, tiles = density.density_c16_torch(*_density_args(ref, 16), hit_sub=16,
                                            hit2_h=ref["h_search"])
    mask = density.pack_tile_nibbles(tiles)
    assert mask.dtype == torch.int32
    np.testing.assert_array_equal(np_(mask), ref["mask"])
    assert ref["mask"].any()
    panels = np_(density.mask_panels(mask, ref["cand_sub16"].shape[1]))
    flags = np_(tiles).reshape(mask.shape[0], 4, -1) > 0
    np.testing.assert_array_equal(panels, np.repeat(flags, 8, axis=2)[..., :panels.shape[2]])


def test_density_c32_hit16_plain_matches_pallas(ref):
    """c32 tables at hit_sub 16: two counts a slot (halves of the
    32-particle subblock)."""
    d, hits = density.density_c32_torch(*_density_args(ref, 32), groups=4, hit_sub=16)
    np.testing.assert_allclose(np_(d), ref["dens32"], rtol=1e-5)
    assert hits.shape == ref["hits32"].shape
    np.testing.assert_array_equal(np_(hits), ref["hits32"].astype(np.int64))
    assert ref["hits32"].sum() > 0


@pytest.mark.parametrize("width", [16, 32], ids=["c16-tables", "c32-tables"])
def test_hit_lists_16_wide_equal_jax(ref, width):
    """The 16-wide force lists: 16-granular ids as they are (cap
    max_candidates_hit16, self range block*8) or 32-granular ids split
    into [2c, 2c + 1] (self range block*8, width 8)."""
    cfg = tstep.StepConfig(**SHAPES[width], max_candidates_hit16=CAP_HIT16)
    cand_f, count_f, flags = tstep.hit_lists(
        T(ref[f"cand_sub{width}"]), T(ref[f"hits{width}"].astype(np.int32)), cfg)
    np.testing.assert_array_equal(np_(cand_f), ref[f"cand_f{width}"])
    np.testing.assert_array_equal(np_(count_f), ref[f"count_f{width}"])
    assert int(flags) == 0
    short = tstep.StepConfig(**SHAPES[width], max_candidates_hit16=4)
    assert int(tstep.hit_lists(T(ref[f"cand_sub{width}"]),
                               T(ref[f"hits{width}"].astype(np.int32)), short)[2]) \
        == tstep.FLAG_CAPACITY_HIT


@pytest.mark.parametrize("width", [16, 32], ids=["c16-tables", "c32-tables"])
def test_forces_q32_c16_plain_matches_pallas(ref, width):
    a = np_(forces.forces_q32_c16_torch(_f8(ref, width), T(ref[f"dens{width}"]),
                                        T(ref["real"]), T(ref[f"cand_f{width}"]),
                                        T(ref[f"count_f{width}"]), ref["params"]))
    j = ref[f"accel{width}"]
    np.testing.assert_allclose(a, j, atol=1e-5 * np.abs(j).max())
    assert not np.any(a[~ref["real"]])


def test_forces_q32_c16_qblock_maps_rows(ref):
    f8, dens, real, p = _f8(ref, 16), T(ref["dens16"]), T(ref["real"]), ref["params"]
    cand, count = T(ref["cand_f16"]), T(ref["count_f16"])
    nb = f8.shape[0] // B
    idx = torch.arange(0, nb, 4, dtype=torch.int32).flip(0)
    rows = (idx.long()[:, None] * 4 + torch.arange(4)).reshape(-1)
    a0 = forces.forces_q32_c16_torch(f8, dens, real, cand, count, p)
    a = forces.forces_q32_c16_torch(f8, dens, real, cand[rows].contiguous(),
                                    count[rows].contiguous(), p, qblock=idx)
    torch.testing.assert_close(a, a0.reshape(nb, B, 3)[idx.long()].reshape(-1, 3),
                               rtol=0, atol=0)


def test_wrappers_take_the_plain_versions_on_cpu(ref):
    before = (density.density_c16.launches, density.density_c32.launches,
              forces.forces_q32_c16.launches)
    args = _density_args(ref, 16)
    out = density.density_c16(*args, hit_sub=16, hit2_h=ref["h_search"])
    out0 = density.density_c16_torch(*args, hit_sub=16, hit2_h=ref["h_search"])
    assert all(torch.equal(a, b) for a, b in zip(out, out0)) and len(out) == 3
    d, h = density.density_c32(*_density_args(ref, 32), hit_sub=16)
    assert torch.equal(h, density.density_c32_torch(*_density_args(ref, 32), hit_sub=16)[1])
    fargs = (_f8(ref, 16), T(ref["dens16"]), T(ref["real"]), T(ref["cand_f16"]),
             T(ref["count_f16"]), ref["params"])
    assert torch.equal(forces.forces_q32_c16(*fargs), forces.forces_q32_c16_torch(*fargs))
    assert (density.density_c16.launches, density.density_c32.launches,
            forces.forces_q32_c16.launches) == before
    with pytest.raises(ValueError, match="hit_sub"):
        density.density_c16(*args, hit_sub=8, hit2_h=1.0)
    with pytest.raises(ValueError, match="hit_sub"):
        density.density_c32(*_density_args(ref, 32), groups=1, hit_sub=16)
    with pytest.raises(ValueError, match="unsupported device"):
        forces.forces_q32_c16(*(a.to("meta") for a in fargs[:5]), fargs[5])


def assert_substep_pair_matches_jax(width):
    """A rebuild and a reuse substep of one table shape in free space,
    both packages (the port's reuse substep starts from the JAX rebuild's
    state and tables); test_torch_sub16_ttf.py and test_torch_sub16_ftf.py
    run it, one shape each, since each takes minutes to compile on the
    JAX side."""
    params = make_params(WATER, n=2048)
    over = dict(SHAPES[width], max_candidates_hit16=CAP_HIT16)
    pair = run_pair(params, random_state(params, 2048, 61), params.max_dt, **over)
    assert_pair_matches(pair)
    p1, p2 = pair["port"]
    assert not np.array_equal(p1["position"], p2["position"])


def test_16_wide_path_reaches_the_16_wide_kernels(monkeypatch):
    """The substep's routing: (T, T, F) runs the c16 density at hit_sub 16
    and forces_q32_c16; (F, T, F) the c32 density at hit_sub 16 and
    forces_q32_c16."""
    params = interop.params_from(make_params(WATER, n=1000))
    st = interop.state_from_arrays(random_state(params, 1000, 62), "cpu")
    for width, dens_name in ((16, "density_c16"), (32, "density_c32")):
        seen = []
        for name in (dens_name, "forces_q32_c16"):
            mod = density if name.startswith("density") else forces
            real_fn = getattr(mod, name)

            def spy(*a, _fn=real_fn, _name=name, **k):
                seen.append((_name, k.get("hit_sub")))
                return _fn(*a, **k)

            monkeypatch.setattr(tstep.kernels, name, spy)
        _, _, flags, _ = tstep.substep(st, torch.tensor(1e-4), params, None,
                                       tstep.StepConfig(**SHAPES[width]))
        assert int(flags) == 0
        assert seen == [(dens_name, 16), ("forces_q32_c16", None)]
        monkeypatch.undo()


@pytest.mark.parametrize("width", [16, 32], ids=["TTF", "FTF"])
def test_grow_capacity_downgrades_as_jax(width):
    """A hit overflow on either 16-wide shape downgrades to the q-granular
    tables (no max_candidates_hit8 step without force_sub8), and the next
    one doubles max_candidates_hit, as in the JAX engine."""
    jsim = JSim(step_config=jax_config(**SHAPES[width]))
    sim = tsim.SPHSimulation(interop.step_config_from_jax(jax_config(**SHAPES[width])),
                             device="cpu")
    seen = []
    for _ in range(2):
        jsim._grow_capacity(FLAGS["HIT"])
        sim._grow_capacity(FLAGS["HIT"])
        assert sim.step_config == interop.step_config_from_jax(jsim.step_config)
        seen.append(sim.step_config)
    assert (seen[0].density_sub16, seen[0].force_sub16, seen[0].force_sub8) == (False,) * 3
    assert seen[0].max_candidates_hit8 == tstep.StepConfig().max_candidates_hit8
    assert seen[1].max_candidates_hit == 2 * seen[0].max_candidates_hit


@pytest.mark.parametrize("width", [16, 32], ids=["TTF", "FTF"])
@pytest.mark.parametrize("make", [lattice_positions, sheet_positions],
                         ids=["lattice", "deep-column"])
def test_pretune_config_equals_jax_on_16_wide_shapes(width, make):
    """The pretune probes both 16-wide shapes, leaves max_candidates_hit8
    alone without force_sub8, and downgrades the deep column."""
    n = 4096
    params = make_params(n=n)
    js, ts = states(make(n, params))
    jcfg = jax_config(**SHAPES[width])
    jout, jstats = jpretune.pretune_config(js, params, jcfg)
    tout, tstats = tpretune.pretune_config(ts, interop.params_from(params),
                                           interop.step_config_from_jax(jcfg))
    assert tstats == jstats and tstats is not None
    assert tout == interop.step_config_from_jax(jout)
    assert tout.max_candidates_hit8 == jcfg.max_candidates_hit8
    if make is sheet_positions:
        assert (tout.density_sub16, tout.force_sub16, tout.force_sub8) == (False,) * 3
    else:
        assert tout == interop.step_config_from_jax(jcfg)
