"""The port's candidate tables on 64-row lists with the exact refine
(block 128 at 64 query rows, and block 64), against the JAX package's
(the composition of ``libclsph_tpu/engine/step.py:424-490`` and
``:674-683``; see ``test_torch_shapes_ref.py``): refined ids and counts,
hit counts and the compacted lists equal, density rtol 1e-5,
acceleration atol 1e-4 * max|a|. The two shapes give the JAX kernels the
same array shapes, so they share one compile in this module
(``test_torch_shapes_aabb.py`` holds the 32-row shapes and the aabb
refine). Also hit compaction against the full lists at (nl, 64) and
(asm, 64), with bit-equal density (``tests/test_physics.py:360-383``).
"""

import pytest

from test_torch_shapes_ref import (check_density_hits_and_lists, check_forces,
                                   check_tables, make_shape, np_)
import numpy as np
import torch

from conftest import WATER, make_params
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.engine import step as tstep
from test_torch_step import random_state
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = [(128, 64, "exact"), (64, 64, "exact")]


@pytest.fixture(scope="module", params=SHAPES, ids=[f"b{b}-q{q}-{m}" for b, q, m in SHAPES])
def shape(request):
    return make_shape(*request.param)


def test_refined_tables_equal_jax(shape):
    check_tables(shape)


def test_density_hits_and_lists_equal_jax(shape):
    """The plain density at the shape's rows against fused_density_nl:
    densities, one hit row a list, and the per-list compaction."""
    check_density_hits_and_lists(shape)


def test_forces_equal_jax(shape):
    """forces_q128_c32_torch at the shape's rows against fused_forces_nl
    over the same compacted lists."""
    check_forces(shape)


@pytest.mark.parametrize("variant", ["nl", "asm"])
def test_hit_compaction_matches_full_at_64_rows(variant):
    """The force pass over the hit-compacted lists against the full
    refined lists at 64 query rows: density is computed before the
    compaction (equal bits), the acceleration differs only in summation
    order (atol 1e-5 * max|a|)."""
    params = interop.params_from(make_params(WATER, n=2048))
    st = interop.state_from_arrays(random_state(params, 2048, 37), "cpu")
    dt = torch.tensor(1e-9)
    base = dict(pallas_variant=variant, nl_query_rows=64, density_sub16=False,
                force_sub16=False, force_sub8=False, cand_interval=1, adaptive_dt=False,
                max_candidates_sub=192, max_candidates_hit=192)
    s_full, _, f_full, _ = tstep.substep(st, dt, params, None,
                                         tstep.StepConfig(hit_compact=False, **base))
    s_hit, _, f_hit, _ = tstep.substep(st, dt, params, None,
                                       tstep.StepConfig(hit_compact=True, **base))
    assert int(f_full) == int(f_hit) == 0
    assert torch.equal(s_full.density, s_hit.density)
    a1, a2 = np_(s_full.acceleration), np_(s_hit.acceleration)
    np.testing.assert_allclose(a2, a1, atol=1e-5 * np.abs(a1).max())
