"""The force sums on a clustered cloud where the two packages differ most
(seed 43 of ``test_torch_qpath.clustered_state``, 4,096 particles; the
other tests use seed 41, where they differ by 1.5e-6 * max|a|).

The port sums a_ij * (x_i - x_j) pair by pair; the JAX kernel, shaped
for its matrix unit, forms x_i * sum(a_ij) - sum(a_ij * x_j), which
cancels digits where a particle's pair weights are large. On the q128
and ``hit_compact=False`` configs one substep from this cloud is held
to a float64 all-pairs oracle (``test_torch_engine._accel_f64``) on the
same densities and pressures: the port at its own bound, 1e-5 * max|a|;
JAX's substep, computed here, at 2e-5 * max|a|, the bound its 1.1e-5
needs. On JAX's worst rows a float32 emulation of the pressure term in
both forms, from the oracle's pair weights, shows where the error comes
from: the pair-by-pair form stays within 1e-6 * max|a|, the split form
errs by more than 4e-6 * max|a|, the order of JAX's error."""

import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.core import smoothing
from libclsph_tpu_torch.engine import step as tstep
from test_torch_engine import _accel_f64
from test_torch_qpath import Q_PATH, clustered_state, jax_substep, port_substep
from test_torch_step import JAX_MAIN_PATH
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 4096
SEED = 43
CONFIGS = {
    "q128": dict(Q_PATH, max_candidates_hit=192, force_query_rows=128),
    "no_hit_compact": dict(hit_compact=False, density_sub16=False, force_sub8=False),
}


@pytest.fixture(scope="module")
def cloud():
    """The cloud, and its positions and velocities in the substep's
    (Morton) order, which both packages share."""
    params = make_params(WATER, n=N)
    state = clustered_state(params, N, SEED)
    st, _, _ = tstep.pad_and_sort(interop.state_from_arrays(state, "cpu"),
                                  interop.params_from(params), True)
    assert st.n == N  # 32 whole blocks: no padding
    return params, state, dict(position=st.position.numpy(), velocity=st.velocity.numpy())


def _row_errors(accel, oracle, scale):
    return np.abs(accel - oracle).max(axis=1) / scale


def _pressure_forms(params, sorted_in, density, pressure, row):
    """Row ``row``'s pressure sum from the float64 pair weights w_ij
    (a_ij = w_ij * (x_i - x_j)): exact in float64, and in float32 pair by
    pair and as x_i * sum(w) - sum(w * x_j). Returns the two float32
    forms' largest error."""
    p = interop.params_from(params)
    x = torch.as_tensor(sorted_in["position"], dtype=torch.float64)
    rho = torch.as_tensor(density, dtype=torch.float64)
    pr = torch.as_tensor(pressure, dtype=torch.float64)
    rvec = x[row] - x
    near = (torch.linalg.vector_norm(rvec, dim=-1) < p.h) & (torch.arange(N) != row)
    coeff = (pr[near] / rho[near] ** 2 + pr[row] / rho[row] ** 2) * p.particle_mass
    term = coeff[:, None] * smoothing.spiky_gradient(rvec[near], p.h, p.precomputed())
    w = (term * rvec[near]).sum(-1) / (rvec[near] ** 2).sum(-1)
    exact = (w[:, None] * rvec[near]).sum(0)
    w32, xi, xj = w.float(), x[row].float(), x[near].float()
    direct = (w32[:, None] * (xi - xj)).sum(0)
    split = xi * w32.sum() - (w32[:, None] * xj).sum(0)
    return ((direct.double() - exact).abs().max().item(),
            (split.double() - exact).abs().max().item())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_force_sums_against_the_float64_oracle(cloud, name):
    params, state, sorted_in = cloud
    jcfg = jstep.StepConfig(**dict(JAX_MAIN_PATH, **CONFIGS[name]))
    j, jf = jax_substep(params, state, jcfg)
    p, pf = port_substep(params, state, interop.step_config_from_jax(jcfg))
    assert jf == pf == 0
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    oracle_p = _accel_f64(params, sorted_in, p["density"], p["pressure"])
    oracle_j = _accel_f64(params, sorted_in, j["density"], j["pressure"])
    scale = np.abs(oracle_j).max()
    err_p = _row_errors(p["acceleration"], oracle_p, scale)
    err_j = _row_errors(j["acceleration"], oracle_j, scale)
    assert err_p.max() <= 1e-5
    assert err_j.max() <= 2e-5
    # the cloud shows the difference: JAX's error is past the port's bound
    assert err_j.max() > 1e-5 > 10 * err_p.max()
    worst = np.argsort(-err_j)[:8]
    forms = np.array([_pressure_forms(params, sorted_in, j["density"], j["pressure"], i)
                      for i in worst]) / scale
    assert forms[:, 0].max() <= 1e-6 and forms[:, 1].max() > 4e-6
