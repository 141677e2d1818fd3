"""The q-granular path of the port against the JAX package: the 32-wide
density and force kernels' plain versions, the tables at 32-particle
granularity, the query-block map of all four kernels, and whole substeps
of the q32 and q128 configurations.

The JAX side runs ``fused_density_nl(c16=False)`` at ``hit_groups`` 4
and 1, ``fused_forces_nl32`` and ``fused_forces_nl`` in interpret mode
(picked automatically on the CPU) on tables built by its own candidate
machinery from one random cloud; the port's kernels get the same tables
and fields. Tolerances, as in test_torch_kernels.py: density rtol 1e-5,
acceleration atol 1e-5 * max|a| (float32 summation order); hit counts
and tables are integers and must be equal. The cloud holds one
coincident pair of distinct particles (the spiky r -> 0 branch and the
id-based self-exclusion).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.ops import tiles as jtiles
from libclsph_tpu.ops.pallas import neighbor_nl as nl
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import tiles as ttiles
from libclsph_tpu_torch.ops.kernels import density, forces
from test_torch_step import JAX_MAIN_PATH, random_state
from test_torch_tiles import assert_tables_equal
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 2000
B = 128
SUB = B // 32  # 32-particle subblocks per block
CAP_SUB, CAP_HIT = 96, 96
Q_PATH = dict(density_sub16=False, force_sub16=False, force_sub8=False)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def ref():
    """Sorted, padded cloud + the JAX q path's tables and kernel outputs,
    all as NumPy."""
    params = make_params(WATER, n=N)
    terms = params.precomputed()
    rng = np.random.default_rng(29)
    side = params.initial_volume ** (1 / 3) * 1.2
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    pos[1] = pos[0]  # a coincident pair of distinct particles
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

    pos_b = jnp.asarray(pos.reshape(nb, B, 3))
    real_j = jnp.asarray(real)
    bmin, bmax = jtiles.split_block_bounds(pos_b, real_j.reshape(nb, B))
    cand, count, ovf = jtiles.candidate_blocks_auto(bmin, bmax, params.h, 96)
    self_lo = jnp.arange(nb, dtype=jnp.int32) * SUB
    cand_sub, count_sub, ovf2 = jtiles.refine_candidates_exact(
        cand, count, bmin, bmax, pos_b, params.h, SUB, CAP_SUB,
        self_lo=self_lo, self_width=SUB,
    )
    assert not bool(ovf) and not bool(ovf2)
    zeros = jnp.zeros(npad, jnp.float32)
    q_pos, _ = nl.make_query_planes(jnp.asarray(pos), jnp.asarray(vel), zeros, zeros,
                                    real_j, B, mass=params.particle_mass)
    c_pos, _ = nl.make_csub_packs(jnp.asarray(pos), jnp.asarray(vel), zeros, zeros,
                                  real_j, mass=params.particle_mass)
    out = dict(pos=pos, vel=vel, real=real, block_cand=cand, block_count=count,
               bmin=bmin, bmax=bmax, cand_sub=cand_sub, count_sub=count_sub)
    for g in (4, 1):
        dens, hits = nl.fused_density_nl(
            q_pos, c_pos, cand_sub, count_sub, params, terms, real_j,
            want_hits=True, hit_groups=g, hit_sub=nl.SUB, c16=False,
        )
        out[f"dens{g}"], out[f"hits{g}"] = dens, hits[:, :CAP_SUB]
    dens = out["dens4"]
    pres = jnp.where(real_j, jinter.tait_pressure(dens, params), 0.0)
    _, q_force = nl.make_query_planes(jnp.asarray(pos), jnp.asarray(vel), dens, pres,
                                      real_j, B, mass=params.particle_mass)
    _, c_force = nl.make_csub_packs(jnp.asarray(pos), jnp.asarray(vel), dens, pres,
                                    real_j, mass=params.particle_mass)
    cap32 = max(32, CAP_HIT // 2)
    cand32, count32, ovf3 = jtiles.compact_hits(
        jnp.repeat(cand_sub, nl.QG, axis=0), out["hits4"], cap32,
        self_lo=jnp.repeat(self_lo, nl.QG), self_width=SUB,
    )
    cand128, count128, ovf4 = jtiles.compact_hits(
        cand_sub, out["hits1"], CAP_HIT, self_lo=self_lo, self_width=SUB,
    )
    assert not bool(ovf3) and not bool(ovf4)
    out.update(
        pres=pres, cand32=cand32, count32=count32, cand128=cand128, count128=count128,
        accel32=nl.fused_forces_nl32(q_force, c_force, cand32, count32, params, terms,
                                     real_j, dens),
        accel128=nl.fused_forces_nl(q_force, c_force, cand128, count128, params, terms,
                                    real_j, dens),
    )
    out = {k: np.array(v) for k, v in out.items()}
    out["params"] = interop.params_from(params)
    return out


def _density_args(r):
    return (density.pos_pack(T(r["pos"]), T(r["real"])), T(r["cand_sub"]),
            T(r["count_sub"]), r["params"])


def _f8(r):
    return forces.force_pack(T(r["pos"]), T(r["vel"]), T(r["dens4"]), T(r["pres"]),
                             T(r["real"]), r["params"].particle_mass)


@pytest.mark.parametrize("groups", [4, 1])
def test_density_c32_plain_matches_pallas(ref, groups):
    d, hits = density.density_c32_torch(*_density_args(ref), groups=groups)
    np.testing.assert_allclose(np_(d), ref[f"dens{groups}"], rtol=1e-5)
    assert hits.dtype == torch.int32 and hits.shape == ref[f"hits{groups}"].shape
    np.testing.assert_array_equal(np_(hits), ref[f"hits{groups}"].astype(np.int64))
    assert ref[f"hits{groups}"].sum() > 0


@pytest.mark.parametrize("qrows", [32, 128])
def test_forces_c32_plain_matches_pallas(ref, qrows):
    fn = forces.forces_q32_c32_torch if qrows == 32 else forces.forces_q128_c32_torch
    a = np_(fn(_f8(ref), T(ref["dens4"]), T(ref["real"]), T(ref[f"cand{qrows}"]),
               T(ref[f"count{qrows}"]), ref["params"]))
    j = ref[f"accel{qrows}"]
    np.testing.assert_allclose(a, j, atol=1e-5 * np.abs(j).max())
    assert not np.any(a[~ref["real"]])


def test_refine_exact_at_32_wide_subblocks_equals_jax(ref):
    """The refine at sub = 4 (32-particle ids, self range block*4) gives
    JAX's table slot for slot, truncated and not."""
    p = ref["params"]
    nb = ref["pos"].shape[0] // B
    pos_b = T(ref["pos"].reshape(nb, B, 3))
    self_lo = torch.arange(nb, dtype=torch.int32) * SUB
    for cap in (CAP_SUB, 12):
        t = ttiles.refine_candidates_exact(
            T(ref["block_cand"]), T(ref["block_count"]), T(ref["bmin"]), T(ref["bmax"]),
            pos_b, p.h, SUB, cap, self_lo=self_lo, self_width=SUB,
        )
        j = jtiles.refine_candidates_exact(
            jnp.asarray(ref["block_cand"]), jnp.asarray(ref["block_count"]),
            jnp.asarray(ref["bmin"]), jnp.asarray(ref["bmax"]),
            jnp.asarray(ref["pos"].reshape(nb, B, 3)), p.h, SUB, cap,
            self_lo=jnp.asarray(np_(self_lo)), self_width=SUB,
        )
        assert_tables_equal(t, j)
    assert bool(j[2])  # the truncated table was exercised


@pytest.mark.parametrize("groups", [4, 1])
def test_hit_lists_at_32_wide_equal_jax(ref, groups):
    """compact_hits at cap32 (per subgroup) and at max_candidates_hit
    (per block), through the port's hit_lists."""
    cfg = tstep.StepConfig(**Q_PATH, max_candidates_hit=CAP_HIT)
    cand_f, count_f, flags = tstep.hit_lists(
        T(ref["cand_sub"]), T(ref[f"hits{groups}"].astype(np.int32)), cfg, groups)
    key = 32 if groups == 4 else 128
    np.testing.assert_array_equal(np_(cand_f), ref[f"cand{key}"])
    np.testing.assert_array_equal(np_(count_f), ref[f"count{key}"])
    assert int(flags) == 0


def _pool(nb):
    return torch.arange(0, nb, 8, dtype=torch.int32).flip(0)  # every 8th, reordered


def test_density_qblock_maps_rows(ref):
    """A query-block map runs the gathered rows against the full pack:
    the same as gathering the identity run's outputs."""
    pos4, cand, count, p = _density_args(ref)
    nb = cand.shape[0]
    idx = _pool(nb)
    li = idx.long()
    rows = lambda a, g: a.reshape(nb, g, -1)[li].reshape(len(li) * g, -1)  # noqa: E731
    d16, hits16 = _main_tables(ref)
    cases = [
        (density.density_c16_torch, (pos4, d16[0], d16[1], p), {}, 4),
        (density.density_c32_torch, (pos4, cand, count, p), dict(groups=4), 4),
        (density.density_c32_torch, (pos4, cand, count, p), dict(groups=1), 1),
    ]
    for fn, args, kw, g in cases:
        d0, h0 = fn(*args, **kw)
        d, h = fn(args[0], args[1][li].contiguous(), args[2][li].contiguous(), p,
                  qblock=idx, **kw)
        torch.testing.assert_close(d, d0.reshape(nb, B)[li].reshape(-1), rtol=0, atol=0)
        assert torch.equal(h, rows(h0, g)) and int(h0.sum()) > 0


def _main_tables(ref):
    """Main-path (16-granular) tables of the fixture's cloud."""
    p = ref["params"]
    nb = ref["pos"].shape[0] // B
    pos_b = T(ref["pos"].reshape(nb, B, 3))
    self_lo = torch.arange(nb, dtype=torch.int32) * 8
    cand16, count16, _ = ttiles.refine_candidates_exact(
        T(ref["block_cand"]), T(ref["block_count"]), T(ref["bmin"]), T(ref["bmax"]),
        pos_b, p.h, 8, 192, self_lo=self_lo, self_width=8,
    )
    pos4 = density.pos_pack(T(ref["pos"]), T(ref["real"]))
    _, hits = density.density_c16_torch(pos4, cand16, count16, p)
    return (cand16, count16), hits


def test_forces_qblock_maps_rows(ref):
    p = ref["params"]
    f8, dens, real = _f8(ref), T(ref["dens4"]), T(ref["real"])
    nb = f8.shape[0] // B
    idx = _pool(nb)
    li = idx.long()
    (cand16, _), hits16 = _main_tables(ref)
    cand8, count8, _ = tstep.hit_lists(cand16, hits16, tstep.StepConfig(max_candidates_hit8=160))
    cases = [
        (forces.forces_q32_c8_torch, cand8, count8, 4),
        (forces.forces_q32_c32_torch, T(ref["cand32"]), T(ref["count32"]), 4),
        (forces.forces_q128_c32_torch, T(ref["cand128"]), T(ref["count128"]), 1),
    ]
    for fn, cand, count, lists in cases:
        a0 = fn(f8, dens, real, cand, count, p)
        lrows = (li[:, None] * lists + torch.arange(lists)).reshape(-1)
        a = fn(f8, dens, real, cand[lrows].contiguous(), count[lrows].contiguous(), p,
               qblock=idx)
        torch.testing.assert_close(a, a0.reshape(nb, B, 3)[li].reshape(-1, 3), rtol=0,
                                   atol=0)
        assert float(a.abs().max()) > 0


def test_wrappers_take_the_plain_version_on_cpu_and_check_inputs(ref):
    before = (density.density_c32.launches, forces.forces_q32_c32.launches,
              forces.forces_q128_c32.launches)
    args = _density_args(ref)
    d, h = density.density_c32(*args, groups=1)
    d0, h0 = density.density_c32_torch(*args, groups=1)
    assert torch.equal(d, d0) and torch.equal(h, h0)
    fargs = (_f8(ref), T(ref["dens4"]), T(ref["real"]), T(ref["cand128"]),
             T(ref["count128"]), ref["params"])
    assert torch.equal(forces.forces_q128_c32(*fargs), forces.forces_q128_c32_torch(*fargs))
    assert (density.density_c32.launches, forces.forces_q32_c32.launches,
            forces.forces_q128_c32.launches) == before
    with pytest.raises(ValueError, match="groups"):
        density.density_c32(*args, groups=2)
    with pytest.raises(ValueError, match="unsupported device"):
        density.density_c32(*(a.to("meta") for a in args[:3]), args[3])
    with pytest.raises(ValueError, match="qblock"):
        density.density_c32(*args, qblock=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="cand"):
        forces.forces_q32_c32(*fargs)  # lists per block, not per subgroup


def clustered_state(params, n, seed, frac=0.2):
    """A random cloud with ``frac`` of the particles packed into a cube of
    side h (test_tier2.py's clustered cloud): the blocks there see far
    more candidate subblocks than the rest (a deep column's bottom)."""
    st = random_state(params, n, seed)
    rng = np.random.default_rng(seed + 1)
    k = int(n * frac)
    pos = st["position"]
    pos[:k] = (rng.random((k, 3)).astype(np.float32) - 0.5) * params.h + pos[n - 1]
    return st


def assert_passes_match(p, j):
    """The substep's pair passes: equal order, density rtol 1e-5 and
    acceleration atol 1e-5 * max|a|."""
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=1e-5)
    amax = np.abs(j["acceleration"]).max()
    np.testing.assert_allclose(p["acceleration"], j["acceleration"], atol=1e-5 * amax)


def jax_substep(params, state_np, cfg):
    from libclsph_tpu.core.state import ParticleState as JState

    js = JState(**{k: jnp.asarray(v) for k, v in state_np.items()})
    out = jstep.substep_jit(js, jnp.float32(params.max_dt), params, None, cfg)
    return {k: np.asarray(getattr(out[0], k)) for k in state_np}, int(out[2])


def port_substep(params, state_np, cfg):
    out = tstep.substep(interop.state_from_arrays(state_np, "cpu"),
                        torch.tensor(params.max_dt, dtype=torch.float32),
                        interop.params_from(params), None, cfg)
    return interop.state_to_numpy(out[0]), int(out[2])


@pytest.mark.parametrize("force_query_rows", [32, 128], ids=["q32", "q128"])
def test_q_path_substep_matches_jax(force_query_rows):
    """One substep of the q-granular configuration (the autotune's
    downgrade target) on a clustered cloud, both packages from the same
    state and one config."""
    n = 4096
    params = make_params(WATER, n=n)
    state = clustered_state(params, n, 41)
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **Q_PATH, max_candidates_hit=192,
                                   force_query_rows=force_query_rows))
    j, jf = jax_substep(params, state, jcfg)
    p, pf = port_substep(params, state, interop.step_config_from_jax(jcfg))
    assert jf == pf == 0
    assert_passes_match(p, j)
