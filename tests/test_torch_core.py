"""The PyTorch port's core and XLA-glue modules against the JAX package.

Same inputs (NumPy, fixed seeds) through both packages via
``libclsph_tpu_torch.interop``: parameters, smoothing kernels, Morton
codes, the lattice, grid bounds and sort order, integration, the
O(N*K) interaction reference and the mesh collisions. Tolerances: exact
where both sides run the same float32 operations in the same order;
2 ulp (rtol 2.4e-7) where a library routine (a norm, a power) may round
differently; summation-order tolerances where sums are reduced in
another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import MUCUS, WATER, make_params
from libclsph_tpu.core import morton as jmorton
from libclsph_tpu.core import params as jparams
from libclsph_tpu.core import smoothing as jsmoothing
from libclsph_tpu.core import state as jstate
from libclsph_tpu.ops import collisions as jcoll
from libclsph_tpu.ops import grid as jgrid
from libclsph_tpu.ops import integrate as jintegrate
from libclsph_tpu.ops import interactions as jinter
from libclsph_tpu.scene.scene import Scene as JScene
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.core import morton as tmorton
from libclsph_tpu_torch.core import params as tparams
from libclsph_tpu_torch.core import smoothing as tsmoothing
from libclsph_tpu_torch.core import state as tstate
from libclsph_tpu_torch.ops import collisions as tcoll
from libclsph_tpu_torch.ops import grid as tgrid
from libclsph_tpu_torch.ops import integrate as tintegrate
from libclsph_tpu_torch.ops import interactions as tinter
from libclsph_tpu_torch.scene.scene import Scene as TScene
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP2 = 2.4e-7  # two float32 ulps, relative
T = torch.as_tensor


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def params():
    return make_params(WATER, n=2048)


def test_load_parameters_matches_with_trailing_semicolon(tmp_path):
    fluid = os.path.join(ROOT, "fluid_properties", "water.json")
    sim_src = os.path.join(ROOT, "simulation_properties", "default.json")
    sim = tmp_path / "sim.json"
    sim.write_text(open(sim_src).read().rstrip() + ";\n")
    pj = jparams.load_parameters(fluid, sim)
    pt = tparams.load_parameters(fluid, sim)
    assert pt == interop.params_from(pj)
    assert pt.precomputed() == tparams.PrecomputedKernelValues(
        **vars(pj.precomputed())
    )
    assert (pt.cell_side, pt.frame_time, pt.max_dt) == (pj.cell_side, pj.frame_time, pj.max_dt)


@pytest.mark.parametrize("fluid", [WATER, MUCUS], ids=["water", "mucus"])
def test_derive_parameters_identical(fluid):
    pj = make_params(fluid, n=3000)
    sim = dict(particles_count=3000, particle_mass=0.05, simulation_time=3,
               target_fps=60, simulation_scale=0.1,
               constant_acceleration=dict(x=0, y=-9.8, z=0))
    assert tparams.derive_parameters(dict(fluid), sim) == interop.params_from(pj)


def test_smoothing_kernels_match(params):
    rng = np.random.default_rng(7)
    h = params.h
    terms_j = params.precomputed()
    terms_t = interop.params_from(params).precomputed()
    rvec = ((rng.random((4096, 3)) - 0.5) * 2.4 * h).astype(np.float32)
    rvec[:16] = 0.0  # the spiky r -> 0 branch
    rvec[16:32] *= 1e-9
    r = np.linalg.norm(rvec, axis=-1).astype(np.float32)
    pairs = [
        (jsmoothing.poly_6(jnp.asarray(r), h, terms_j), tsmoothing.poly_6(T(r), h, terms_t)),
        (jsmoothing.poly_6_laplacian(jnp.asarray(r), h, terms_j),
         tsmoothing.poly_6_laplacian(T(r), h, terms_t)),
        (jsmoothing.viscosity_laplacian(jnp.asarray(r), h, terms_j),
         tsmoothing.viscosity_laplacian(T(r), h, terms_t)),
        (jsmoothing.poly_6_gradient(jnp.asarray(rvec), h, terms_j),
         tsmoothing.poly_6_gradient(T(rvec), h, terms_t)),
        (jsmoothing.spiky_gradient(jnp.asarray(rvec), h, terms_j),
         tsmoothing.spiky_gradient(T(rvec), h, terms_t)),
    ]
    for j, t in pairs:
        j, t = np_(j), np_(t)
        np.testing.assert_allclose(t, j, rtol=ULP2, atol=ULP2 * np.abs(j).max())
    # the singular branch splats the scalar exactly
    spiky = np_(tsmoothing.spiky_gradient(T(rvec[:16]), h, terms_t))
    assert np.all(spiky == np.float32(terms_t.spiky))


def test_morton_encode_decode_exact():
    rng = np.random.default_rng(3)
    xyz = rng.integers(0, jmorton.MAX_GRID_DIM, size=(3, 10000)).astype(np.uint32)
    cj = np.asarray(jmorton.encode(*map(jnp.asarray, xyz)))
    ct = np_(tmorton.encode(*(T(a.astype(np.int32)) for a in xyz)))
    np.testing.assert_array_equal(ct, cj.astype(np.int64))
    for a, b in zip(tmorton.decode(T(ct)), xyz):
        np.testing.assert_array_equal(np_(a), b)


@pytest.mark.parametrize("n", [1000, 4096])
def test_lattice_exact(n):
    p = make_params(WATER, n=n)
    sj = jstate.init_state(p)
    st = tstate.init_state(interop.params_from(p), "cpu")
    np.testing.assert_array_equal(np_(st.position), np.asarray(sj.position))
    assert st.grid_index.dtype == torch.int32 and st.n == n


def _cloud(params, n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    side = params.initial_volume ** (1 / 3) * spread
    pos = ((rng.random((n, 3)) - 0.5) * side).astype(np.float32)
    vel = ((rng.random((n, 3)) - 0.5) * 2.0).astype(np.float32)
    return pos, vel


@pytest.mark.parametrize("cloud", ["random", "lattice", "boundary"])
def test_bounds_codes_and_sort_order_match(params, cloud):
    if cloud == "random":
        pos, _ = _cloud(params, 2048, 11)
    elif cloud == "boundary":  # on the cube's floor: a particle sits on a cell edge
        pos, _ = _cloud(params, 2048, 31, spread=1.3)
        pos[:, 1] += -1.6 + 0.015 - pos[:, 1].min()
    else:
        pos = jstate.init_lattice_positions(params)
    tp = interop.params_from(params)
    # as the substep compiles them: XLA turns the division by the
    # constant cell side into a multiplication by its reciprocal
    @jax.jit
    def bounds_codes(p):
        g = jgrid.compute_bounds(p, params)
        return g, jgrid.locate_in_grid(p, g)

    gj, cj = bounds_codes(jnp.asarray(pos))
    cj = np.asarray(cj)
    gt = tgrid.compute_bounds(T(pos), tp)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    ct = np_(tgrid.locate_in_grid(T(pos), gt))
    np.testing.assert_array_equal(ct, cj.astype(np.int64))
    state = jstate.init_state(params).replace(position=jnp.asarray(pos))
    _, sorted_j, order_j = jgrid.sort_by_cell(state, jnp.asarray(cj))
    sorted_t, order_t = tgrid.sort_codes(T(ct))
    np.testing.assert_array_equal(np_(order_t), np.asarray(order_j))
    np.testing.assert_array_equal(np_(sorted_t), np.asarray(sorted_j).astype(np.int64))
    if cloud == "lattice":
        assert len(np.unique(cj)) < len(cj)  # ties: stability matters


def test_integrate_matches(params):
    rng = np.random.default_rng(5)
    pos, vel = _cloud(params, 2048, 5)
    acc = (rng.normal(size=(2048, 3)) * 20).astype(np.float32)
    dt = np.float32(1.3e-3)
    aj = jintegrate.advect(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc), jnp.float32(dt))
    at = tintegrate.advect(T(pos), T(vel), T(acc), T(dt))
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    for a, b in zip(tintegrate.reconstruct_velocities(T(vel), T(acc)),
                    jintegrate.reconstruct_velocities(jnp.asarray(vel), jnp.asarray(acc))):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    tp = interop.params_from(params)
    dj = float(jintegrate.compute_time_step(jnp.asarray(vel), jnp.asarray(acc), params))
    dtt = tintegrate.compute_time_step(T(vel), T(acc), tp)
    assert dtt.dtype == torch.float32 and dtt.dim() == 0
    np.testing.assert_allclose(float(dtt), dj, rtol=ULP2)
    zero = np.zeros_like(acc)
    assert float(tintegrate.compute_time_step(T(vel), T(zero), tp)) == pytest.approx(
        float(jintegrate.compute_time_step(jnp.asarray(vel), jnp.asarray(zero), params)),
        rel=ULP2)


def test_interactions_reference_matches(params):
    """density_sum / tait_pressure / force_sums / combine_forces on the
    same padded candidate sets (K=48 random candidates per query, some
    invalid, self included)."""
    rng = np.random.default_rng(9)
    n, k = 512, 48
    h = params.h
    q = (rng.random((n, 3)) * h * 3).astype(np.float32)
    c = (q[:, None, :] + (rng.random((n, k, 3)) - 0.5) * 2.2 * h).astype(np.float32)
    c[:, 0] = q  # self
    valid = rng.random((n, k)) < 0.9
    valid[:, 0] = True
    is_self = np.zeros((n, k), bool)
    is_self[:, 0] = True
    qv = rng.normal(size=(n, 3)).astype(np.float32)
    cv = rng.normal(size=(n, k, 3)).astype(np.float32)
    tp = interop.params_from(params)
    terms_j, terms_t = params.precomputed(), tp.precomputed()
    dj = jinter.density_sum(jnp.asarray(q), jnp.asarray(c), jnp.asarray(valid), params, terms_j)
    dt_ = tinter.density_sum(T(q), T(c), T(valid), tp, terms_t)
    np.testing.assert_allclose(np_(dt_), np.asarray(dj), rtol=1e-6)
    dens = np.array(dj)
    cdens = (dens[rng.integers(0, n, size=(n, k))] * 1.01).astype(np.float32)
    pj = jinter.tait_pressure(jnp.asarray(dens), params)
    pt = tinter.tait_pressure(T(dens), tp)
    np.testing.assert_allclose(np_(pt), np.asarray(pj), rtol=1e-6, atol=1e-6 * np.abs(pj).max())
    cpres = np.asarray(jinter.tait_pressure(jnp.asarray(cdens), params))
    args_j = [jnp.asarray(a) for a in (q, qv, dens, np.asarray(pj), c, cv, cdens, cpres,
                                       valid, is_self)]
    args_t = [T(a) for a in (q, qv, dens, np.asarray(pj), c, cv, cdens, cpres, valid, is_self)]
    fj = jinter.force_sums(*args_j, params, terms_j)
    ft = tinter.force_sums(*args_t, tp, terms_t)
    for a, b in zip(ft, fj):
        b = np.asarray(b)
        np.testing.assert_allclose(np_(a), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    aj = np.asarray(jinter.combine_forces(fj, jnp.asarray(dens), params))
    at = np_(tinter.combine_forces(ft, T(dens), tp))
    np.testing.assert_allclose(at, aj, atol=1e-5 * np.abs(aj).max())


@pytest.fixture(scope="module")
def cube(params):
    path = os.path.join(ROOT, "scenes", "cube.obj")
    sj = JScene.load(path, params.h * 2.0)
    st = TScene.load(path, params.h * 2.0)
    dev_j = jcoll.build_device_scene(sj)
    return sj, st, dev_j


def test_scene_copy_identical(cube):
    sj, st, _ = cube
    for f in ("bb_min", "bb_max", "bb_size", "bb_offset", "rotations",
              "translations", "rvertices"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    assert st.total_gridpoints == sj.total_gridpoints


def test_bake_and_corner_table_match(cube):
    sj, st, dev_j = cube
    df_t = tcoll.bake_distance_field(st, "cpu")
    df_j = np.asarray(dev_j.df)
    # XLA contracts some of the distance arithmetic into fused
    # multiply-adds; the port rounds each operation (measured 2.2e-8)
    np.testing.assert_allclose(np_(df_t), df_j, rtol=0, atol=1e-6)
    # the corner table is a pure gather: exact on the same DF
    arrs = tcoll.device_scene_arrays(st, "cpu")
    c8 = tcoll.build_corner_table(T(df_j), arrs["bb_size"], arrs["bb_offset"])
    np.testing.assert_array_equal(np_(c8), np.asarray(dev_j.corner8))


def test_handle_collisions_matches(cube, params):
    """Particles pushed through the cube's floor and walls, with the
    JAX-baked scene carried over by interop."""
    _, _, dev_j = cube
    rng = np.random.default_rng(21)
    n = 4096
    old = ((rng.random((n, 3)) - 0.5) * np.array([1.3, 0.2, 1.3]) + [0, -1.5, 0])
    old = old.astype(np.float32)
    vel = (rng.normal(size=(n, 3)) * np.array([1, 3, 1])).astype(np.float32)
    dt = np.float32(1.7e-3)
    new = (old + vel * dt).astype(np.float32)
    for restitution in (0.0, 0.5):
        rj = jcoll.handle_collisions(dev_j, jnp.asarray(old), jnp.asarray(new),
                                     jnp.asarray(vel), restitution, jnp.float32(dt))
        rt = tcoll.handle_collisions(interop.scene_from_arrays(dev_j, "cpu"), T(old),
                                     T(new), T(vel), restitution, T(dt))
        hit = np.asarray(rj.collision_happened)
        assert hit.sum() > 50  # the test exercises the response
        np.testing.assert_array_equal(np_(rt.collision_happened), hit)
        np.testing.assert_allclose(np_(rt.position), np.asarray(rj.position), atol=2e-6)
        np.testing.assert_allclose(np_(rt.next_velocity), np.asarray(rj.next_velocity),
                                   atol=2e-5 * np.abs(vel).max())
    free = tcoll.handle_collisions(None, T(old), T(new), T(vel), 0.0, T(dt))
    assert not free.collision_happened.any()
