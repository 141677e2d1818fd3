"""The port's sharded frame loop and the rest of the sharded substep's
semantics on gloo ranks:

* the cadenced frame (a re-sort and a candidate rebuild every 4th
  substep, the tables and surface sets carried in between) against the
  JAX package's ``make_sharded_frame`` on a 4-device CPU mesh, at
  ``test_parallel.py:395-418``'s tolerances;
* the frame loop against the per-substep loop (the engine's two paths);
* the tiles impl under the mesh against the port's single-chip tiles
  substep;
* the status word OR'd per bit over ranks that raise different bits."""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import torch_mesh_ref as ref
from conftest import WATER, make_params
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.engine.step import FLAG_CAPACITY_HIT, FLAG_EXCHANGE, StepConfig
from libclsph_tpu_torch.parallel import mesh, sharded_step
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

TILES = dict(neighbor_impl="tiles", block_size=64, max_candidates=32, density_sub16=False,
             force_sub8=False, sort_interval=1, cand_interval=1)


def matched(pos_a, pos_b):
    """Row of ``pos_b`` nearest each row of ``pos_a`` (one to one)."""
    dist, idx = cKDTree(pos_b).query(pos_a)
    assert np.unique(idx).shape[0] == idx.shape[0]
    return dist, idx


def real_rows(state):
    return np.abs(state["position"]).max(axis=1) < 1e30


def test_cadenced_frame_matches_jax():
    """One frame (about ten substeps) of the mesh path with the 4/4
    cadence and the all_gather exchange on both sides: positions atol
    1e-4, velocities atol 1e-3 (test_parallel.py:416-417), no flag."""
    params, state = ref.lattice(2048)
    jcfg = ref.jax_config(cand_interval=4, sort_interval=4)
    want = ref.run_jax(params, state, jcfg, frame_time=params.frame_time, record=False)
    ranks, got = ref.run_port(params, state, interop.step_config_from_jax(jcfg),
                              frame_time=params.frame_time, record=False)
    assert want["flags"] == 0 and all(r["flags"] == 0 for r in ranks)
    rj, rp = real_rows(want["state"]), real_rows(got)
    assert rj.sum() == rp.sum() == params.particles_count
    dist, idx = matched(want["state"]["position"][rj], got["position"][rp])
    assert dist.max() < 1e-4
    np.testing.assert_allclose(got["velocity"][rp][idx], want["state"]["velocity"][rj],
                               atol=1e-3)
    assert all(r["dt"] == pytest.approx(want["dt"], abs=1e-6) for r in ranks)


@pytest.mark.parametrize("exchange", ["halo", "ring"])
def test_frame_matches_substep_loop(exchange):
    """The frame loop (the engine's fast path) and the per-substep loop
    with the time left on the host (its callback path) give the same
    state: the tiles impl, rebuilt and sorted every substep."""
    params = interop.params_from(make_params(WATER, n=1024))
    cfg = StepConfig(**TILES)
    state = ref.padded_state(make_params(WATER, n=1024), block=64)
    shards = interop.split_for_mesh(state, 4)
    kw = dict(device="cpu", timeout=ref.LAUNCH_S, threads=1)
    args = (shards, params, cfg, exchange, 4, 2, params.frame_time, False)
    frame = mesh.launch(sharded_step.run_shards, 4, args=args, **kw)
    loop = mesh.launch(sharded_step.run_shards, 4, args=args + (True,), **kw)
    assert loop[0]["calls"] > 1 and frame[0]["calls"] < loop[0]["calls"]
    for f, s in zip(frame, loop):
        assert f["flags"] == s["flags"] == 0
        np.testing.assert_allclose(f["state"]["position"], s["state"]["position"], atol=1e-6)
        np.testing.assert_allclose(f["state"]["velocity"], s["state"]["velocity"], atol=1e-6)
        assert f["dt"] == pytest.approx(s["dt"], abs=1e-7)


@pytest.mark.parametrize("exchange", ["all_gather", "halo"])
def test_tiles_impl_under_the_mesh_matches_single_chip(exchange):
    """The tiles impl's sums over the exchanged table: one substep on 4
    ranks against the single-chip tiles substep, matched by position
    (density rtol 1e-5, acceleration atol 5e-4 * max|a|, the tolerances
    of test_parallel.py:72-81)."""
    jparams = make_params(WATER, n=1024)
    params = interop.params_from(jparams)
    cfg = StepConfig(**TILES)
    state = ref.padded_state(jparams, block=64)
    halo_max = 0 if exchange == "all_gather" else 4
    ranks = mesh.launch(sharded_step.run_shards, 4, device="cpu", timeout=ref.LAUNCH_S, threads=1,
                        args=(interop.split_for_mesh(state, 4), params, cfg, exchange,
                              halo_max))
    got = {k: np.concatenate([r["state"][k] for r in ranks]) for k in interop.FIELDS}
    real = real_rows(got)
    lattice = {k: v[real_rows(state)] for k, v in state.items()}
    s1, dt1, f1, _ = tstep.substep(interop.state_from_arrays(lattice, "cpu"),
                                   torch.tensor(params.max_dt), params, None, cfg)
    assert int(f1) == 0 and all(r["flags"] == 0 for r in ranks)
    want = interop.state_to_numpy(s1)
    dist, idx = matched(want["position"], got["position"][real])
    assert dist.max() < 1e-5
    np.testing.assert_allclose(got["density"][real][idx], want["density"], rtol=1e-5)
    a = want["acceleration"]
    np.testing.assert_allclose(got["acceleration"][real][idx], a, atol=5e-4 * np.abs(a).max())
    assert ranks[0]["dt"] == pytest.approx(float(dt1), rel=1e-5)


def _shard(pos, params):
    n = pos.shape[0]
    zeros = np.zeros((n, 3), np.float32)
    return dict(position=pos.astype(np.float32), velocity=zeros, intermediate_velocity=zeros,
                acceleration=zeros, density=np.full(n, params.fluid_density, np.float32),
                pressure=np.zeros(n, np.float32), grid_index=np.zeros(n, np.uint32))


def _block(spacing, x0):
    ax = [np.arange(k) * spacing for k in (4, 4, 8)]
    g = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    return g + np.float32([x0, 0.0, 0.0])


def test_flag_bits_or_over_ranks():
    """Four ranks of one block each, the ring at 1 hop: ranks 0 and 2
    hold sparse lattices whose boxes overlap though they are two hops
    apart (FLAG_EXCHANGE on both), rank 1 a dense clump whose hit lists
    overflow a capacity of 4 (FLAG_CAPACITY_HIT), rank 3 a sparse lattice
    far from all. Every rank returns the OR of the four words."""
    params = interop.params_from(make_params(WATER, n=512))
    h = params.h
    blocks = [_block(1.1 * h, 0.0), _block(0.2 * h, 20 * h), _block(1.1 * h, 4.0 * h),
              _block(1.1 * h, 40 * h)]
    cfg = StepConfig(force_sub8=False, max_candidates_hit16=4, cand_interval=1)
    ranks = mesh.launch(sharded_step.run_shards, 4, device="cpu", timeout=ref.LAUNCH_S, threads=1,
                        args=([_shard(b, params) for b in blocks], params, cfg, "ring", 1, 1,
                              None, True))
    local = [int(r["tables"]["local_flags"]) for r in ranks]
    assert local == [FLAG_EXCHANGE, FLAG_CAPACITY_HIT, FLAG_EXCHANGE, 0]
    assert all(r["flags"] == FLAG_EXCHANGE | FLAG_CAPACITY_HIT for r in ranks)


def test_two_tier_under_the_mesh_matches_single_tier():
    """Two-tier routing stays shard-local (sharded_step.py:233-266): at a
    base subblock capacity below the deepest blocks, the sharded two-tier
    substep equals the sharded single-tier one at full capacity, density
    bit for bit (the kernels sum each list in the same order in either
    tier) and acceleration to atol 1e-5 * max|a| (test_parallel.py:192-252)."""
    jparams = make_params(WATER, n=4096)
    params = interop.params_from(jparams)
    shards = interop.split_for_mesh(ref.padded_state(jparams), 4)
    base = dict(force_sub8=False, cand_interval=1)

    def run(**over):
        cfg = StepConfig(**dict(base, **over))
        return mesh.launch(sharded_step.run_shards, 4, device="cpu", timeout=ref.LAUNCH_S,
                           threads=1, args=(shards, params, cfg, "halo", 8, 1, None, True))

    full = run()
    counts = np.concatenate([r["tables"]["count_sub"] for r in full])
    c1 = int(np.percentile(counts, 75))
    assert (counts > c1).any() and all(r["flags"] == 0 for r in full)
    mult = 2
    while c1 * mult < counts.max():
        mult *= 2
    routed = run(max_candidates_sub=c1, tier2_frac=2, tier2_mult=mult,
                 max_candidates_hit16=128)
    assert [r["flags"] for r in routed] == [0] * 4
    for f, t in zip(full, routed):
        np.testing.assert_array_equal(t["state"]["density"], f["state"]["density"])
        a = f["state"]["acceleration"]
        np.testing.assert_allclose(t["state"]["acceleration"], a, atol=1e-5 * np.abs(a).max())
