"""Two-tier routing on the 16-wide force path in the port against the
JAX package: a rebuild and a reuse substep of (density_sub16,
force_sub16, force_sub8) = (True, True, False) with heavy blocks forced
as in test_torch_tier2.py. Tolerances as in test_torch_sub16.py.
"""

from conftest import WATER, make_params
from test_torch_gate import TTF
from test_torch_step import assert_pair_matches, random_state, run_pair
from test_torch_tier2 import two_tier_config
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


def test_two_tier_substep_pair_matches_jax():
    """(T, T, F) with two-tier routing: both tiers on the c16 density at
    hit_sub 16 and forces_q32_c16, tier 2 at tier2_mult x
    max_candidates_hit16 through the query-block map; the reuse substep
    carries the tier-2-width table. The base capacity lies above the
    median block and below the heavy ones (test_torch_tier2.py's recipe)
    on a random cloud whose blocks near its faces see fewer candidates
    (a clump dense enough to need tier 2 at this size throws particles
    off the support in one substep, and the reuse substep would compare
    stale tables)."""
    params = make_params(WATER, n=4096)
    state = random_state(params, 4096, 75)
    over = two_tier_config(params, state, TTF)
    out = run_pair(params, state, params.max_dt, **over)
    assert out["tables"][1][0].shape[1] > over["max_candidates_sub"]
    assert_pair_matches(out)
