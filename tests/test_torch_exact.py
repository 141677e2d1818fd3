"""The ``exact`` impl of the port and its sort against the JAX package.

* ``neighbor_codes``, ``cell_ranges``, ``neighbor_indices`` and
  ``max_cell_occupancy``: integer tables, equal to JAX's.
* One ``exact`` substep against JAX's ``substep_jit`` (density rtol
  1e-5, acceleration atol 1e-5 * max|a|), and against the port's main
  path from the same state at JAX's tolerance for a pair of impls
  (atol 1e-4 * max|a|, test_physics.py:334-352).
* ``radix_sort_key_val``'s refusals (its results against JAX's sort are
  in test_torch_radix.py).
* ``rank_hist_torch`` (the rank stage of the sort's plain version)
  against JAX's ``_rank_hist_kernel`` in interpret mode.
* ``sort_by_cell`` under each ``LIBCLSPH_TPU_SORT`` value, the reduced
  key width raising FLAG_GRID_DIM, the engine doubling ``cell_capacity``
  on FLAG_CAPACITY, and the CLI's exact run and refusal.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conftest import WATER, make_params
from libclsph_tpu.core import morton as jmorton
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.engine import step as jstep
from libclsph_tpu.ops import grid as jgrid
from libclsph_tpu.ops import neighbors as jneighbors
from libclsph_tpu.ops import radix_sort as jradix
from libclsph_tpu_torch import cli, interop
from libclsph_tpu_torch.core import morton as tmorton
from libclsph_tpu_torch.core.state import init_state
from libclsph_tpu_torch.engine import simulation as tsim
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.ops import grid as tgrid
from libclsph_tpu_torch.ops import neighbors as tneighbors
from libclsph_tpu_torch.ops import radix_sort as tradix
from libclsph_tpu_torch.ops.kernels import radix as tradix_kernels
from test_torch_engine import _root
from test_torch_qpath import jax_substep, port_substep
from test_torch_step import JAX_MAIN_PATH, assert_states_match, random_state
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

EXACT = dict(neighbor_impl="exact", sort_interval=1, cand_interval=1, cell_capacity=96)



def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def cloud():
    """Sorted Morton codes of a random 1024-particle cloud, as JAX makes
    them (uint32) and as the port holds them (int32)."""
    params = make_params(WATER, n=1024)
    st = random_state(params, 1024, 71)
    pos = jnp.asarray(st["position"])
    codes = jgrid.locate_in_grid(pos, jgrid.compute_bounds(pos, params))
    sorted_codes = np.sort(np.asarray(codes))
    return sorted_codes, torch.as_tensor(sorted_codes.astype(np.int32))


def test_neighbor_codes_equal_jax(cloud):
    codes = np.concatenate([cloud[0], np.array([0, 1, 1023, (1 << 30) - 1], np.uint32)])
    j = np.asarray(jmorton.neighbor_codes(jnp.asarray(codes)))
    t = np_(tmorton.neighbor_codes(torch.as_tensor(codes.astype(np.int32))))
    assert t.shape == codes.shape + (27,)
    np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64))


def test_cell_ranges_and_occupancy_equal_jax(cloud):
    j_codes, t_codes = cloud
    query = jmorton.neighbor_codes(jnp.asarray(j_codes))
    js, je = jgrid.cell_ranges(jnp.asarray(j_codes), query)
    ts, te = tgrid.cell_ranges(t_codes, tmorton.neighbor_codes(t_codes))
    assert ts.dtype == te.dtype == torch.int32
    np.testing.assert_array_equal(np_(ts), np.asarray(js))
    np.testing.assert_array_equal(np_(te), np.asarray(je))
    occ = tneighbors.max_cell_occupancy(t_codes)
    assert int(occ) == int(jneighbors.max_cell_occupancy(jnp.asarray(j_codes))) > 1


@pytest.mark.parametrize("cap", [4, 96])
def test_neighbor_indices_equal_jax(cloud, cap):
    j_codes, t_codes = cloud
    ji, jv = jneighbors.neighbor_indices(jnp.asarray(j_codes), cap)
    ti, tv = tneighbors.neighbor_indices(t_codes, cap)
    np.testing.assert_array_equal(np_(ti), np.asarray(ji))
    np.testing.assert_array_equal(np_(tv), np.asarray(jv))
    # a chunk of query rows gives those rows of the whole table
    ci, cv = tneighbors.neighbor_indices(t_codes, cap, t_codes[100:300])
    assert torch.equal(ci, ti[100:300]) and torch.equal(cv, tv[100:300])


def test_exact_substep_matches_jax(monkeypatch):
    """The exact substep, in two chunks of gathers, against JAX's."""
    n = 1024
    params = make_params(WATER, n=n)
    state = random_state(params, n, 73)
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **EXACT))
    j, jf = jax_substep(params, state, jcfg)
    monkeypatch.setattr(tstep, "EXACT_CHUNK_SLOTS", 600 * 27 * 96)
    p, pf = port_substep(params, state, interop.step_config_from_jax(jcfg))
    assert jf == pf == 0
    assert_states_match(p, j)


def test_exact_substep_matches_main_path():
    n = 2048
    params = make_params(WATER, n=n)
    state = random_state(params, n, 79)
    e, ef = port_substep(params, state, tstep.StepConfig(**EXACT))
    m, mf = port_substep(params, state, tstep.StepConfig())
    assert ef == mf == 0
    np.testing.assert_array_equal(e["grid_index"], m["grid_index"])
    np.testing.assert_allclose(e["density"], m["density"], rtol=1e-5)
    amax = np.abs(m["acceleration"]).max()
    np.testing.assert_allclose(e["acceleration"], m["acceleration"], atol=1e-4 * amax)


def _keys(n, num_bits, seed):
    """Half uniform keys, half drawn from 40 values (heavy duplicates)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << num_bits, size=n, dtype=np.int64)
    dup = rng.integers(0, 1 << num_bits, size=40)
    keys[::2] = dup[rng.integers(0, 40, size=keys[::2].shape[0])]
    return keys.astype(np.int32), rng.permutation(n).astype(np.int32)


def test_radix_sort_refusals():
    z = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="bits_per_pass"):
        tradix.radix_sort_key_val(z, z, bits_per_pass=8)
    with pytest.raises(ValueError, match="num_bits"):
        tradix.radix_sort_key_val(z, z, num_bits=32)
    with pytest.raises(ValueError, match="apply"):
        tradix.radix_sort_key_val(z, z, apply="swap")
    with pytest.raises(ValueError, match="int32"):
        tradix.radix_sort_key_val(z.to(torch.int64), z)
    with pytest.raises(ValueError, match="multiple of 128"):
        tradix_kernels.rank_hist_torch(torch.zeros(100, dtype=torch.int32), 0, 5)


def _jax_rank_hist(keys, shift, bits, groups=8):
    """JAX's rank kernel through its own pallas_call layout
    (radix_sort.py:139-155), interpret mode."""
    nb = keys.shape[0] // 128
    local, hist3 = pl.pallas_call(
        functools.partial(jradix._rank_hist_kernel, shift=shift, d=1 << bits,
                          groups=groups),
        grid=(nb // groups,),
        in_specs=[pl.BlockSpec((groups, 128), lambda g: (g, 0))],
        out_specs=[pl.BlockSpec((groups, 128), lambda g: (g, 0)),
                   pl.BlockSpec((1, 128, groups), lambda g: (g, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((nb, 128), jnp.int32),
                   jax.ShapeDtypeStruct((nb // groups, 128, groups), jnp.float32)],
        interpret=True,
    )(jnp.asarray(keys).reshape(nb, 128))
    hist = np.asarray(hist3).transpose(1, 0, 2).reshape(128, nb)[: 1 << bits]
    return np.asarray(local).reshape(-1), hist.astype(np.int32)


@pytest.mark.parametrize("shift,bits", [(0, 5), (25, 5), (12, 7), (3, 1)])
def test_rank_hist_plain_matches_jax_kernel(shift, bits):
    keys, _ = _keys(2048, 30, seed=shift + bits)
    local, hist = tradix_kernels.rank_hist_torch(torch.as_tensor(keys), shift, bits)
    assert local.dtype == hist.dtype == torch.int32 and hist.shape == (1 << bits, 16)
    jl, jh = _jax_rank_hist(keys, shift, bits)
    np.testing.assert_array_equal(np_(local), jl)
    np.testing.assert_array_equal(np_(hist), jh)
    assert int(hist.sum()) == 2048 and tradix_kernels.radix_sort.launches == 0


@pytest.mark.parametrize("impl", ["xla", "radix", "radix-fused"])
@pytest.mark.parametrize("apply", ["scatter", "gather"])
def test_sort_by_cell_backends(monkeypatch, impl, apply):
    """Every backend sorts the whole state as JAX's sort_by_cell does."""
    params = make_params(WATER, n=700)
    tp = interop.params_from(params)
    st = init_state(tp, "cpu")
    rng = np.random.default_rng(5)
    st = st.replace(position=st.position + torch.as_tensor(
        rng.normal(size=(700, 3)).astype(np.float32) * 0.01),
        velocity=torch.as_tensor(rng.normal(size=(700, 3)).astype(np.float32)))
    codes = tgrid.locate_in_grid(st.position, tgrid.compute_bounds(st.position, tp))
    monkeypatch.setattr(tgrid, "_SORT_IMPL", impl)
    monkeypatch.setattr(tgrid, "_SORT_APPLY", apply)
    s, sc, order = tgrid.sort_by_cell(st, codes)
    js = JState(**{k: jnp.asarray(np_(getattr(st, k)).astype(
        np.uint32 if k == "grid_index" else np.float32)) for k in interop.state_to_numpy(st)})
    j, jc, jo = jgrid.sort_by_cell(js, jnp.asarray(np_(codes).astype(np.uint32)))
    np.testing.assert_array_equal(np_(order), np.asarray(jo))
    np.testing.assert_array_equal(np_(sc), np.asarray(jc).astype(np.int32))
    for k in ("position", "velocity", "intermediate_velocity"):
        np.testing.assert_array_equal(np_(getattr(s, k)), np.asarray(getattr(j, k)))
    assert torch.equal(s.grid_index, sc)


def test_sort_by_cell_refuses_an_unknown_backend(monkeypatch):
    monkeypatch.setattr(tgrid, "_SORT_IMPL", "bitonic")
    st = init_state(interop.params_from(make_params(WATER, n=256)), "cpu")
    with pytest.raises(ValueError, match="LIBCLSPH_TPU_SORT"):
        tgrid.sort_by_cell(st, torch.zeros(256, dtype=torch.int32))


def test_reduced_sort_bits_raise_the_grid_flag(monkeypatch):
    """A grid that outgrows LIBCLSPH_TPU_SORT_BITS raises FLAG_GRID_DIM in
    the substep of every impl, as JAX's grid_exceeds_sort_bits does."""
    size = torch.tensor([9, 4, 4], dtype=torch.int32)
    assert not bool(tgrid.grid_exceeds_sort_bits(size))
    monkeypatch.setattr(tgrid, "_SORT_IMPL", "radix-fused")
    monkeypatch.setattr(tgrid, "_SORT_BITS", 9)  # 8 cells an axis at most
    assert bool(tgrid.grid_exceeds_sort_bits(size))
    assert not bool(tgrid.grid_exceeds_sort_bits(torch.tensor([8, 8, 8], dtype=torch.int32)))
    params = make_params(WATER, n=512)
    st = interop.state_from_arrays(random_state(params, 512, 83), "cpu")
    tp = interop.params_from(params)
    grid = tgrid.compute_bounds(st.position, tp)
    assert int(grid.grid_size.max()) > 4
    monkeypatch.setattr(tgrid, "_SORT_BITS", 6)  # 4 cells an axis at most
    for cfg in (tstep.StepConfig(**EXACT), tstep.StepConfig(neighbor_impl="tiles",
                                                            cand_interval=1)):
        _, _, flags, _ = tstep.substep(st, torch.tensor(1e-4), tp, None, cfg)
        assert int(flags) & tstep.FLAG_GRID_DIM


def test_engine_grows_cell_capacity(tmp_path):
    """A cell capacity too small for the lattice: FLAG_CAPACITY doubles
    cell_capacity (and nothing else) and the frame re-runs."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0, serialize=False,
                 particles_count=512)
    sim = tsim.SPHSimulation(tstep.StepConfig(**dict(EXACT, cell_capacity=2)), device="cpu")
    sim.checkpoint_path = str(tmp_path / "none.npz")
    sim.load_settings(str(root / "fluid_properties" / "water.json"),
                      str(root / "simulation_properties" / "tiny.json"))
    sim.load_scene("cube.obj", scenes_dir=str(root / "scenes"))
    sim.simulate()
    cfg = sim.step_config
    assert cfg.cell_capacity > 2 and sim.capacity_retries >= 1
    assert cfg.max_candidates == tstep.StepConfig().max_candidates
    codes = sim.state.grid_index
    assert sim.state.n == 512 and torch.isfinite(sim.state.position).all()
    assert int(tneighbors.max_cell_occupancy(torch.sort(codes).values)) <= cfg.cell_capacity


def test_cli_exact_run_and_refusal(tmp_path, monkeypatch):
    """One frame of a 1000-particle cube through the CLI on the exact
    impl with the fused radix sort, and its refusal of a sort interval."""
    root = _root(tmp_path, simulation_time=1.0 / 60.0, particles_count=1000)
    monkeypatch.chdir(tmp_path)
    base = ["water", "tiny", "cube", "out_", "--device", "cpu", "--root", str(root),
            "--neighbor-impl", "exact"]
    assert cli.main(base) == -1  # the default --sort-interval 4
    monkeypatch.setattr(tgrid, "_SORT_IMPL", "radix-fused")
    assert cli.main(base + ["--sort-interval", "1"]) == 0
    frames = sorted(os.listdir(tmp_path / "out_frames"))
    assert len(frames) == 2
    ck = np.load(tmp_path / "last_frame.npz")
    pos, dens = ck["position"], ck["density"]
    assert np.isfinite(pos).all() and pos[:, 1].min() > -1.6
    assert np.isfinite(dens).all() and 0.3 * 998.29 < np.median(dens) < 3 * 998.29
