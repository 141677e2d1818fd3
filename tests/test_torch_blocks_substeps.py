"""One substep of the asm variant and of the nl variant without hit
compaction against JAX's ``substep_jit`` (test_torch_blocks.py holds the
tiles, row, fine and asym substeps; these two take longest to compile
on the JAX side, so they have a file of their own).
"""

import pytest

from test_torch_blocks import assert_substep_matches_jax
from torch_cpu import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("name", ["asm", "no_hit_compact"])
def test_substep_matches_jax(name):
    assert_substep_matches_jax(name)
