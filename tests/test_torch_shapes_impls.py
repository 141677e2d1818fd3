"""The tiles impl and the block-granular variants at block_size 64 and
256 against the JAX package's ``substep_jit`` (its Pallas ``neighbor``
kernels in interpret mode): the row variant's 64-row lists, the fine
variant's 256-particle blocks whose list serves two 128-row halves, and
the tiles impl's (64, 64) pair tiles. The sort order and flags equal,
density rtol 1e-5, acceleration atol 1e-5 * max|a|."""

import numpy as np
import pytest

from libclsph_tpu.engine import step as jstep
from test_torch_shapes import substep_pair
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("impl,variant,block", [("tiles", "nl", 64), ("pallas", "row", 64),
                                                ("pallas", "fine", 256)])
def test_block_impls_match_jax(impl, variant, block):
    jcfg = jstep.StepConfig(neighbor_impl=impl, pallas_variant=variant, block_size=block,
                            adaptive_dt=False, max_candidates=96)
    j, p, flags, cfg = substep_pair(jcfg)
    assert cfg.block_size == block
    assert flags[0] == flags[1] == 0
    np.testing.assert_array_equal(p["grid_index"], j["grid_index"])
    np.testing.assert_allclose(p["density"], j["density"], rtol=1e-5)
    a = j["acceleration"]
    np.testing.assert_allclose(p["acceleration"], a, atol=1e-5 * np.abs(a).max())
