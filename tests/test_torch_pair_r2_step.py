"""Substeps in the identity mode (``StepConfig.pair_r2 = "mxu"``) of the
port against the JAX package's ``substep_jit`` / ``substep_reuse_jit``.

The main path (``test_torch_step.run_pair``: a rebuild substep and a
reuse substep from the JAX rebuild's state and tables), and the 16-wide
force path with the gated reuse density, whose reuse substep runs the
direct form on the centred packs as JAX's does. The nl variant at 32
query rows, the asm variant and the sharded substep are in
test_torch_pair_r2_shapes.py.

Against JAX the inputs are those with which the JAX package holds the
mode to its direct form (``test_physics.py:323-350``: 1,024 particles of
``random_cloud`` from the seed-1234 generator), and so is the criterion:
the port's identity-mode substep against JAX's direct one within density
rtol 2e-4 and acceleration atol 5e-4 * max|a|. Against JAX's
identity-mode substep the acceleration bound doubles, 1e-3 * max|a|: the
two packages round the identity in other orders, and each is held to
5e-4 from the direct form. The mode is ill-conditioned for close pairs
(r^2 carries an absolute error of about |p|^2 * 6e-8, so 1/r of a pair
far inside h moves by far more than a float32 rounding): on this cloud
the two identity-mode accelerations differ by 7e-4 * max|a| at one pair.
The refined tables, which the mode does not touch, must be equal to
JAX's, and so must the flags.
"""

import numpy as np
import pytest

from conftest import WATER, make_params
from test_torch_step import run_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 1024
MXU = dict(pair_r2="mxu")


def cloud(params):
    """test_physics.py's input: random_cloud(rng 1234, params, 1024)."""
    rng = np.random.default_rng(1234)
    side = params.initial_volume ** (1 / 3) * 2.0
    pos = ((rng.random((N, 3)) - 0.5) * side).astype(np.float32)
    vel = ((rng.random((N, 3)) - 0.5) * 2.0).astype(np.float32)
    zeros3 = np.zeros((N, 3), np.float32)
    return dict(position=pos, velocity=vel, intermediate_velocity=vel.copy(),
                acceleration=zeros3, density=np.zeros(N, np.float32),
                pressure=np.zeros(N, np.float32), grid_index=np.zeros(N, np.uint32))


def assert_mxu_state_matches(p, j, accel_tol):
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=2e-4)
    a = j["acceleration"]
    np.testing.assert_allclose(p["acceleration"], a, atol=accel_tol * np.abs(a).max())
    np.testing.assert_allclose(p["position"], j["position"], atol=1e-6)


def assert_mxu_pair_matches(out, direct=None):
    """``out``: run_pair in the identity mode; ``direct``: in the direct
    form, whose JAX side is the reference of the mode's criterion."""
    (jf, pf) = out["flags"]
    assert jf == pf == (0, 0)
    jt, pt = out["tables"]
    for a, b in zip(pt[:2], jt[:2]):  # the refined ids and counts
        np.testing.assert_array_equal(a, b)
    (jd, pd) = out["dt"]
    np.testing.assert_allclose(pd, jd, rtol=2e-4)
    for k, (p, j) in enumerate(zip(out["port"], out["jax"])):
        assert_mxu_state_matches(p, j, 1e-3)
        if direct is not None:
            assert_mxu_state_matches(p, direct["jax"][k], 5e-4)


@pytest.fixture(scope="module")
def params():
    return make_params(WATER, n=N)


def test_main_path_pair_matches_jax(params):
    state = cloud(params)
    assert_mxu_pair_matches(run_pair(params, state, params.max_dt, **MXU),
                            run_pair(params, state, params.max_dt))


def test_gated_reuse_pair_matches_jax(params):
    """The build substep emits the dilated tile counts in the identity
    mode; the reuse substep's gated density takes r^2 directly on the
    centred packs (JAX's fused_density_gated16 has no identity mode).
    Against JAX's identity-mode pair only (the main path's test holds the
    mode to the direct form)."""
    out = run_pair(params, cloud(params), params.max_dt, force_sub8=False,
                   density_gate=True, **MXU)
    assert_mxu_pair_matches(out)
    jt, pt = out["tables"]
    assert len(pt) == 3  # the gate's mask travels with the carried table
