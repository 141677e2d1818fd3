"""The port's candidate tables on 32-row lists (block 256 with the exact
refine, block 128 with the aabb refine: subblock boxes against the query
blocks' boxes, ``refine_mode="aabb"``) and with the aabb refine at
whole-block query rows, against the JAX package's, as in
test_torch_shapes_tables.py (see ``test_torch_shapes_ref.py``). The two
32-row shapes share one compile of the JAX kernels in this module."""

import pytest

from test_torch_shapes_ref import (check_density_hits_and_lists, check_forces,
                                   check_tables, make_shape)
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPES = [(256, 32, "exact"), (128, 32, "aabb"), (128, 128, "aabb")]


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
