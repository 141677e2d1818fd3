"""Substeps of the port at block_size 64 and 256 against the JAX
package's. At 64 the nl variant runs 64-row lists at whole-block query
rows, so JAX's rules allow candidate reuse and two-tier routing: a
rebuild and a reuse substep with routed heavy blocks, through
test_torch_step.py's ``run_pair`` (tables equal, density rtol 1e-5,
acceleration atol 1e-5 * max|a|). At 256 a block holds two or more
query blocks (q_rep > 1: no reuse, single tier): one substep at 128
query rows (acceleration atol 1e-4 * max|a|, as test_torch_shapes.py;
test_torch_shapes_tables.py holds 256 at 32 rows; the tiles impl and the
block variants at these sizes are in test_torch_shapes_impls.py).
"""

from conftest import WATER, make_params
from libclsph_tpu.engine import step as jstep
from test_torch_shapes import assert_substeps_match, substep_pair
from test_torch_step import assert_pair_matches, random_state, run_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

# block_size 64: the 16-granular tables need 128 query rows
B64 = dict(block_size=64, density_sub16=False, force_sub8=False)


def test_block64_reuse_and_two_tier_match_jax():
    n = 2048
    params = make_params(WATER, n=n)
    over = dict(B64, tier2_frac=2, tier2_mult=4, max_candidates_sub=32)
    out = run_pair(params, random_state(params, n, 41), params.max_dt, **over)
    assert_pair_matches(out)
    counts = out["tables"][1][1]
    assert counts.max() > over["max_candidates_sub"]  # heavy blocks were routed


def test_block256_substep_matches_jax():
    jcfg = jstep.StepConfig(neighbor_impl="pallas", pallas_variant="nl", block_size=256,
                            adaptive_dt=False, max_candidates=96)
    j, p, flags, cfg = substep_pair(jcfg)
    assert cfg.q_rep == 2
    assert_substeps_match(j, p, flags)
