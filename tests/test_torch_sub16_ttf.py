"""One rebuild and one reuse substep of the 16-wide force path on the
(True, True, False) tables ((density_sub16, force_sub16, force_sub8)) against
the JAX package, at test_torch_step.py's tolerances. The rest of the
16-wide path is in test_torch_sub16.py; each shape's substeps have a
file of their own, so that no file sets the length of a parallel run.
"""

import pytest

from test_torch_sub16 import assert_substep_pair_matches_jax
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("width", [16], ids=["TTF"])
def test_substep_pair_matches_jax(width):
    assert_substep_pair_matches_jax(width)
