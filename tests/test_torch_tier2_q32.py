"""The q32 + tier-2 substep against JAX's (test_torch_tier2.py runs the
main path's), and every configuration the port runs agreeing with the
others on one clustered cloud, with and without tier 2. Tolerances:
density rtol 1e-5, acceleration atol 1e-5 * max|a|.
"""

import pytest

from conftest import WATER, make_params
from libclsph_tpu_torch.engine import step as tstep
from test_torch_qpath import assert_passes_match, clustered_state, port_substep
from test_torch_tier2 import CONFIGS, N, assert_two_tier_substep_matches_jax, two_tier_config
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def cloud():
    params = make_params(WATER, n=N)
    return params, clustered_state(params, N, 41)


@pytest.mark.parametrize("name", ["q32"])
def test_two_tier_substep_matches_jax(cloud, name):
    assert_two_tier_substep_matches_jax(cloud, name)


def test_all_port_configurations_agree(cloud):
    """Every configuration the port runs, with and without tier 2, gives
    the same density and acceleration on one cloud (main single-tier is
    the reference)."""
    params, state = cloud
    ref, flags = port_substep(params, state, tstep.StepConfig(**CONFIGS["main"]))
    assert flags == 0
    for name, base in CONFIGS.items():
        for over in (base, two_tier_config(params, state, base)):
            out, flags = port_substep(params, state, tstep.StepConfig(**over))
            assert flags == 0, (name, over)
            assert_passes_match(out, ref)
