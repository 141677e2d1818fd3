"""The port's ``utils/diagnostics`` against the JAX package's on the
same seeded positions: ``neighbor_stats`` at two block lengths and with
an overflowing candidate cap (integer fields equal, the mean count to
rtol 1e-6), and ``density_summary``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import WATER, make_params
from libclsph_tpu.utils import diagnostics as jdiag
from libclsph_tpu_torch import interop
from libclsph_tpu_torch.utils import diagnostics
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)

N = 1000


@pytest.mark.parametrize("block_size,max_candidates", [(64, 1024), (128, 1024), (64, 4)],
                         ids=["b64", "b128", "b64-overflow"])
def test_neighbor_stats_match_jax(block_size, max_candidates):
    params = make_params(WATER, n=N)
    rng = np.random.default_rng(1234)
    pos = (rng.random((N, 3)).astype(np.float32) - 0.5) * 0.5
    j = jdiag.neighbor_stats(jnp.asarray(pos), params, block_size=block_size,
                             max_candidates=max_candidates)
    t = diagnostics.neighbor_stats(torch.as_tensor(pos), interop.params_from(params),
                                   block_size=block_size, max_candidates=max_candidates)
    assert int(t.count_max) == int(j.count_max) >= 1
    assert bool(t.overflowed) == bool(j.overflowed) == (max_candidates == 4)
    assert int(t.occupancy_max) == int(j.occupancy_max) >= 1
    np.testing.assert_allclose(float(t.count_mean), float(j.count_mean), rtol=1e-6)
    assert float(t.count_mean) <= float(t.count_max)


def test_density_summary_matches_jax():
    params = make_params(WATER, n=N)
    rng = np.random.default_rng(7)
    d = (998.0 + rng.normal(0.0, 80.0, 500)).astype(np.float32)
    d[3] = np.inf
    for dens in (d, np.full(100, 998.0, np.float32)):
        t = diagnostics.density_summary(torch.as_tensor(dens), interop.params_from(params))
        assert t == jdiag.density_summary(dens, params)
    assert t["frac_within_10pct_rest"] == 1.0 and not t["any_nonfinite"]
