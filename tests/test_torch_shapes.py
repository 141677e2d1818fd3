"""Whole substeps of the port on finer query blocks against the JAX
package's ``substep_jit`` (Pallas in interpret mode on the CPU), as
``tests/test_physics.py:325-357`` holds the JAX variants to the tiles
impl: (nl, 64), (nl, 32) and (asm, 32) query rows, on the JAX package's own
StepConfig defaults (the q-granular whole-list route: 32-wide tables,
one hit row a list, rebuilt every substep). 1,024 particles of a random
cloud made with numpy from a seed. The sort order and the flags must be
equal, density agrees to rtol 1e-5 and the acceleration to atol 1e-4 *
max|a| (the JAX kernel's x_i * sum(a) - sum(a x_j) form).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.core.state import ParticleState as JState
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from test_torch_step import random_state
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 1024


def substep_pair(jcfg, n=N, seed=1234, dt=1e-9):
    """One substep of each package from one NumPy state at ``jcfg`` (the
    port's config from ``step_config_from_jax``). Returns the JAX and
    port states as NumPy dicts, their flags and the port's config."""
    params = make_params(WATER, n=n)
    state = random_state(params, n, seed)
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    j1, _, jf = jstep.substep_jit(js, jnp.float32(dt), params, None, jcfg)[:3]
    cfg = interop.step_config_from_jax(jcfg)
    t1, _, tf, _ = tstep.substep(interop.state_from_arrays(state, "cpu"),
                                 torch.tensor(dt, dtype=torch.float32),
                                 interop.params_from(params), None, cfg)
    jnp_state = {k: np.asarray(getattr(j1, k)) for k in state}
    return jnp_state, interop.state_to_numpy(t1), (int(jf), int(tf)), cfg


def assert_substeps_match(j, p, flags):
    assert flags[0] == flags[1] == 0
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=1e-5)
    a = j["acceleration"]
    np.testing.assert_allclose(p["acceleration"], a, atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("variant,q_rows", [("nl", 64), ("nl", 32), ("asm", 32)],
                         ids=["nl-64", "nl-32", "asm-32"])
def test_shape_substep_matches_jax(variant, q_rows):
    jcfg = jstep.StepConfig(neighbor_impl="pallas", pallas_variant=variant,
                            nl_query_rows=q_rows, adaptive_dt=False)
    j, p, flags, cfg = substep_pair(jcfg)
    assert (cfg.q_rows, cfg.pallas_variant) == (q_rows, variant)
    assert_substeps_match(j, p, flags)
