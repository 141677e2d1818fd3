"""Sharded candidate reuse with two-tier routing on gloo ranks.

The engine reaches this path by itself on a mesh: ``cand_interval``
defaults to 4 there, and the first subblock overflow turns two-tier
routing on. JAX's sharded step refuses the pair
(``libclsph_tpu/parallel/sharded_step.py:157-162``); its single-chip
frame runs it, carrying the refined table at the tier-2 width
(``libclsph_tpu/engine/simulation.py:212-216``). So the reference is
JAX's single-chip ``frame_jit`` with the same config from the same
state, and the single-chip semantics applied per shard: 8 substeps of
the frame loop (a rebuild at substeps 0 and 4, the tables carried
between) with a base subblock capacity below the deepest blocks.

* The port's single-chip ``engine.step.frame`` against ``frame_jit``,
  row for row (both sort the same way): density rtol 1e-5, acceleration
  atol 1e-5 * max|a|, positions atol 1e-6, the same dt, no flag.
* The sharded frame against ``frame_jit``, matched by position
  (positions atol 1e-5, density rtol 1e-5, acceleration atol
  5e-4 * max|a|, the tolerances of ``chip_smoke.compare_sharded``), the
  same dt, no flag.
* The sharded frame against itself with tier 2 off and the subblock
  capacity at full depth: density equal and acceleration atol
  1e-5 * max|a|, as ``test_torch_parallel_frame.py``'s one-substep
  two-tier test holds them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ref as ref
from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.engine.step import StepConfig
from libclsph_tpu_torch.parallel import mesh, sharded_step
from test_torch_parallel_frame import matched, real_rows
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

SUBSTEPS = 8
N = 4096
# the mesh path with the 4/4 cadence
BASE = dict(force_sub8=False, cand_interval=4, sort_interval=4)
FRAME_TIME = 3.0e38  # the dispatch ends at SUBSTEPS, not at the frame's end


@pytest.fixture(scope="module")
def lattice():
    jparams = make_params(WATER, n=N)
    return jparams, interop.params_from(jparams), ref.padded_state(jparams)


def _run(params, state, cfg, exchange, record=False):
    halo_max = 0 if exchange == "all_gather" else sharded_step.default_halo_max(
        N, ref.SHARDS, cfg.block_size)
    args = (interop.split_for_mesh(state, ref.SHARDS), params, cfg, exchange, halo_max, 1)
    args += (None, True) if record else (None, False, False, SUBSTEPS)
    return mesh.launch(sharded_step.run_shards, ref.SHARDS, device="cpu",
                       timeout=ref.LAUNCH_S, threads=1, args=args)


def _gathered(ranks):
    return {k: np.concatenate([r["state"][k] for r in ranks]) for k in interop.FIELDS}


def _start(state):
    real = real_rows(state)
    return {k: v[real] for k, v in state.items()}


@pytest.fixture(scope="module")
def routed_cfg(lattice):
    """The base subblock capacity c1: the refined counts at the reuse
    radius, (1 + cand_slack) h, at full depth, on the shards and on one
    device (whose blocks differ), leave a quarter of the blocks or fewer
    over it on either, within the tier-2 pools of both (tier2_frac 2).
    The shards' tables are the same under every exchange."""
    _, params, state = lattice
    counts = np.concatenate([r["tables"]["count_sub"]
                             for r in _run(params, state, StepConfig(**BASE), "all_gather",
                                           record=True)])
    start = interop.state_from_arrays(_start(state), "cpu")
    st1, real1, _ = tstep.pad_and_sort(start, params, True)
    counts1 = tstep.build_candidates(st1, real1, params, StepConfig(**BASE))[1].numpy()
    c1 = int(max(np.percentile(counts, 75), np.percentile(counts1, 75)))
    mult = 2
    while c1 * mult < max(counts.max(), counts1.max()):
        mult *= 2
    assert (counts > c1).any() and (counts1 > c1).any()
    return StepConfig(**dict(BASE, max_candidates_sub=c1, tier2_frac=2, tier2_mult=mult,
                             max_candidates_hit16=128))


@pytest.fixture(scope="module")
def jax_frame(lattice, routed_cfg):
    """JAX's single-chip frame_jit: SUBSTEPS substeps from the real rows."""
    jparams, params, state = lattice
    jcfg = jstep.StepConfig(**dict(dataclasses.asdict(routed_cfg),
                                   substeps_per_dispatch=SUBSTEPS))
    js = JState(**{k: jnp.asarray(v) for k, v in _start(state).items()})
    j1, dt, _, flags = jstep.frame_jit(js, jnp.float32(params.max_dt),
                                       jnp.float32(FRAME_TIME), jparams, None, jcfg)
    assert int(flags) == 0
    return {k: np.asarray(getattr(j1, k)) for k in interop.FIELDS}, float(dt)


def test_single_chip_reuse_with_tier2_matches_jax(lattice, routed_cfg, jax_frame):
    """The port's single-chip frame against frame_jit, row for row."""
    _, params, state = lattice
    want, jdt = jax_frame
    cfg1 = dataclasses.replace(routed_cfg, substeps_per_dispatch=SUBSTEPS)
    stats = {}
    s1, dt1, _, f1 = tstep.frame(interop.state_from_arrays(_start(state), "cpu"),
                                 torch.tensor(params.max_dt), torch.tensor(FRAME_TIME),
                                 params, None, cfg1, stats)
    assert int(f1) == 0
    assert (stats["substeps"], stats["reuses"]) == (SUBSTEPS, SUBSTEPS - 2)
    assert stats["tier2_blocks"] > 0
    assert stats["carry_width"] == routed_cfg.max_candidates_sub * routed_cfg.tier2_mult
    got = interop.state_to_numpy(s1)
    np.testing.assert_array_equal(got["grid_index"], want["grid_index"])
    np.testing.assert_allclose(got["density"], want["density"], rtol=1e-5)
    a = want["acceleration"]
    np.testing.assert_allclose(got["acceleration"], a, atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(got["position"], want["position"], atol=1e-6)
    assert float(dt1) == pytest.approx(jdt, rel=1e-5)


@pytest.mark.parametrize("exchange", ["halo", "all_gather"])
def test_sharded_reuse_with_tier2_matches_single_chip(lattice, routed_cfg, jax_frame, exchange):
    _, params, state = lattice
    c1 = routed_cfg.max_candidates_sub
    full_cfg = StepConfig(**dict(BASE, max_candidates_hit16=128))
    routed = _run(params, state, routed_cfg, exchange)
    full = _run(params, state, full_cfg, exchange)

    # reuse substeps ran, tier 2 received blocks, and the carried table
    # has the tier-2 width
    for r in routed:
        st = r["frame_stats"]
        assert (st["substeps"], st["rebuilds"], st["reuses"]) == (SUBSTEPS, 2, SUBSTEPS - 2)
        assert st["carry_width"] == c1 * routed_cfg.tier2_mult
        assert r["flags"] == 0
    assert sum(r["frame_stats"]["tier2_blocks"] for r in routed) > 0
    assert all(r["flags"] == 0 and r["frame_stats"]["reuses"] == SUBSTEPS - 2 for r in full)

    # against single tier at full depth, shard for shard
    for t, f in zip(routed, full):
        np.testing.assert_array_equal(t["state"]["density"], f["state"]["density"])
        a = f["state"]["acceleration"]
        np.testing.assert_allclose(t["state"]["acceleration"], a, atol=1e-5 * np.abs(a).max())
        assert t["dt"] == f["dt"]

    # against JAX's single-chip frame with the same config from the same state
    want, jdt = jax_frame
    got = _gathered(routed)
    rp = real_rows(got)
    dist, idx = matched(want["position"], got["position"][rp])
    assert dist.max() < 1e-5
    np.testing.assert_allclose(got["density"][rp][idx], want["density"], rtol=1e-5)
    a = want["acceleration"]
    np.testing.assert_allclose(got["acceleration"][rp][idx], a, atol=5e-4 * np.abs(a).max())
    assert all(r["dt"] == pytest.approx(jdt, rel=1e-5) for r in routed)
