"""Exact 27-cell neighbour gather (the ``exact`` impl).

PyTorch counterpart of ``libclsph_tpu/ops/neighbors.py``: the
reference's neighbour iteration (forces.cl:24-30) as tensors. For each
particle, the 3x3x3 Morton cells around its cell are resolved to [start,
end) ranges of the sorted array (grid.cl:19-29), and each range is
padded to ``cell_capacity`` slots with a validity mask. Exact whenever no
cell holds more than ``cell_capacity`` particles, which
:func:`max_cell_occupancy` checks.
"""

from __future__ import annotations

import torch

from ..core import morton
from . import grid as grid_ops


def neighbor_indices(sorted_codes: torch.Tensor, cell_capacity: int,
                     query_codes: torch.Tensor | None = None):
    """Padded candidate indices into the sorted arrays: for each query
    (default: every sorted particle) the first ``cell_capacity`` particles
    of each of its 27 cells' ranges. Returns (idx (Q, 27 * cell_capacity)
    int32 clipped to the array, valid (Q, 27 * cell_capacity) bool)."""
    if query_codes is None:
        query_codes = sorted_codes
    codes27 = morton.neighbor_codes(query_codes)  # (Q, 27)
    start, end = grid_ops.cell_ranges(sorted_codes, codes27)
    k = torch.arange(cell_capacity, dtype=torch.int32, device=sorted_codes.device)
    idx = start[..., None] + k  # (Q, 27, C)
    valid = idx < end[..., None]
    idx = torch.clamp(idx, 0, sorted_codes.shape[0] - 1)
    q = query_codes.shape[0]
    return idx.reshape(q, -1), valid.reshape(q, -1)


def max_cell_occupancy(sorted_codes: torch.Tensor) -> torch.Tensor:
    """The largest number of particles sharing one cell (0-d int32)."""
    start, end = grid_ops.cell_ranges(sorted_codes, sorted_codes)
    return torch.amax(end - start)


def gather_candidates(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-candidate field values: (N, ...) x (Q, K) -> (Q, K, ...)."""
    return arr[idx.to(torch.int64)]
