"""Spatial grid: bounds, Morton cell codes and the stable sort.

PyTorch counterpart of ``libclsph_tpu/ops/grid.py`` (its ``xla`` sort
backend): bounds with the 2-cell padding of findMinMaxPosition
(sph_simulation.cpp:634-728), cell assignment (locate_in_grid,
grid.cl:40-64), and a stable sort by code that reproduces
``lax.sort_key_val(codes, iota)``'s order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import morton
from ..core.params import SimulationParameters


class GridInfo(NamedTuple):
    """Per-substep grid geometry (device tensors)."""

    min_point: torch.Tensor  # (3,) f32, includes the 2-cell padding
    max_point: torch.Tensor  # (3,) f32
    grid_size: torch.Tensor  # (3,) int32
    cell_side: torch.Tensor  # () f32


def compute_bounds(position: torch.Tensor, params: SimulationParameters) -> GridInfo:
    """Bounds padded by two cells on every side, so 3x3x3 neighbourhood
    coordinates never underflow (sph_simulation.cpp:668-702)."""
    cell = torch.tensor(params.cell_side, dtype=torch.float32, device=position.device)
    pmin = position.amin(dim=0) - 2.0 * cell
    pmax = position.amax(dim=0) + 2.0 * cell
    grid_size = ((pmax - pmin) * (1.0 / cell)).to(torch.int32)
    return GridInfo(min_point=pmin, max_point=pmax, grid_size=grid_size, cell_side=cell)


def locate_in_grid(position: torch.Tensor, grid: GridInfo) -> torch.Tensor:
    """Per-particle Morton cell code, int32. The division by the cell
    side is a multiplication by its float32 reciprocal, as XLA compiles
    the JAX package's division by that constant: a particle on a cell
    boundary then lands in the same cell in both packages."""
    coords = ((position - grid.min_point) * (1.0 / grid.cell_side)).to(torch.int32)
    return morton.encode(coords[:, 0], coords[:, 1], coords[:, 2])


def sort_codes(codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort: (sorted codes, order) with order[k] the
    original index of sorted slot k; equal codes keep their index order,
    as ``lax.sort_key_val(codes, iota)`` does."""
    return torch.sort(codes, stable=True)
