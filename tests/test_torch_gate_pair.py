"""The gated reuse density in whole substeps against the JAX package: a
rebuild and a reuse substep of (density_sub16, force_sub16, force_sub8)
= (True, True, False) with ``density_gate`` and ``cand_interval=2``.
Tolerances as in test_torch_sub16.py.
"""

from conftest import WATER, make_params
from test_torch_gate import TTF
from test_torch_step import assert_pair_matches, random_state, run_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_gated_substep_pair_matches_jax():
    """(T, T, F) with the gate and candidate reuse every other substep:
    the rebuild emits the dilated tile counts and packs the mask (the
    carried fourth leaf, compared with JAX's), the reuse substep runs the
    gated density on the JAX rebuild's table and mask."""
    params = make_params(WATER, n=2048)
    out = run_pair(params, random_state(params, 2048, 73), params.max_dt,
                   **TTF, density_gate=True, cand_interval=2)
    assert len(out["tables"][1]) == 3  # table, counts, mask
    assert_pair_matches(out)
