"""The identity mode (``StepConfig.pair_r2 = "mxu"``) off the main path:
the nl variant at 32 query rows and the asm variant at 128 against the
JAX package's ``substep_jit`` (one substep each, the cases of
``tests/test_physics.py:323-355``, on that test's cloud and criterion as
``test_torch_pair_r2_step.py`` sets out), and one sharded substep on 2
gloo ranks (the mesh path, all_gather; and the tiles impl in
``tile_mode="mxu"``) against the port's own single-chip substep from the
same real rows, matched by position.

Port against port: both centre on the same real rows' bounds, so each
pair's r^2 has the same bits and only the summation order differs:
density rtol 1e-5, acceleration atol 5e-4 * max|a|
(``chip_smoke.compare_sharded``'s tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from libclsph_tpu_torch.parallel import mesh, sharded_step
from test_torch_pair_r2_step import MXU, N, assert_mxu_state_matches, cloud
from test_torch_parallel_frame import TILES, matched, real_rows
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def params():
    return make_params(WATER, n=N)


@pytest.mark.parametrize("variant,q_rows", [("nl", 32), ("asm", 128)])
def test_variant_substep_matches_jax(params, variant, q_rows):
    state = cloud(params)
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    want = {}
    for mode in ("vpu", "mxu"):
        jcfg = jstep.StepConfig(neighbor_impl="pallas", pallas_variant=variant,
                                nl_query_rows=q_rows, adaptive_dt=False, pair_r2=mode)
        out = jstep.substep_jit(js, jnp.float32(1e-9), params, None, jcfg)
        assert int(out[2]) == 0
        want[mode] = {k: np.asarray(getattr(out[0], k)) for k in state}
    cfg = interop.step_config_from_jax(jcfg)
    assert cfg.r2_mxu
    t1, _, tf, _ = tstep.substep(interop.state_from_arrays(state, "cpu"),
                                 torch.tensor(1e-9), interop.params_from(params), None, cfg)
    assert int(tf) == 0
    got = interop.state_to_numpy(t1)
    assert_mxu_state_matches(got, want["mxu"], 1e-3)
    assert_mxu_state_matches(got, want["vpu"], 5e-4)


@pytest.mark.parametrize("fields,n,block,rtol", [
    (dict(mref.MESH_PATH, **MXU), 4096, 128, 1e-5),
    (dict(TILES, tile_mode="mxu"), 1024, 64, 2e-4),
], ids=["pair_r2", "tile_mode"])
def test_sharded_substep_matches_single_chip(fields, n, block, rtol):
    """The tiles impl (test_torch_parallel_frame.py's config) centres
    each query block on its first particle, and the shards' blocks are
    not the single chip's, so there r^2 is rounded from other centres
    (the densities differ by up to 1.2e-5 relative at this size):
    density rtol 2e-4, the JAX package's bound for its identity mode, in
    place of 1e-5."""
    jparams = make_params(WATER, n=n)
    params = interop.params_from(jparams)
    state = mref.padded_state(jparams, n_shards=2, block=block)
    cfg = tstep.StepConfig(**fields)
    ranks = mesh.launch(sharded_step.run_shards, 2, device="cpu", timeout=mref.LAUNCH_S,
                        threads=1, args=(interop.split_for_mesh(state, 2), params, cfg,
                                         "all_gather", 0, 1, None, False))
    got = {k: np.concatenate([r["state"][k] for r in ranks]) for k in interop.FIELDS}
    real = real_rows(state)
    start = interop.state_from_arrays({k: v[real] for k, v in state.items()}, "cpu")
    t1, dt1, flags, _ = tstep.substep(start, torch.tensor(float(jparams.max_dt)), params,
                                      None, cfg)
    want = interop.state_to_numpy(t1)
    assert int(flags) == 0 and all(r["flags"] == 0 for r in ranks)
    rp = real_rows(got)
    dist, idx = matched(want["position"], got["position"][rp])
    assert dist.max() < 1e-5
    np.testing.assert_allclose(got["density"][rp][idx], want["density"], rtol=rtol)
    a = want["acceleration"]
    np.testing.assert_allclose(got["acceleration"][rp][idx], a, atol=5e-4 * np.abs(a).max())
    assert all(r["dt"] == pytest.approx(float(dt1), rel=1e-5) for r in ranks)
