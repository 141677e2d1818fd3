"""Spatial grid: bounds, Morton cell codes, the sort and cell ranges.

PyTorch counterpart of ``libclsph_tpu/ops/grid.py``: bounds with the
2-cell padding of findMinMaxPosition (sph_simulation.cpp:634-728), cell
assignment (locate_in_grid, grid.cl:40-64), the stable sort by code that
reproduces ``lax.sort_key_val(codes, iota)``'s order, and the cell ranges
of the sorted codes (get_start_end_indices_for_cell, grid.cl:19-29).

:func:`sort_by_cell` (the ``exact`` impl's sort) reads its backend at
import from the variables the JAX package reads, so a user's environment
means the same in both packages:

* ``LIBCLSPH_TPU_SORT``: ``xla`` (default; the stable ``torch.sort``),
  or ``radix`` / ``radix-fused``: the radix sort of :mod:`ops.radix_sort`
  (the JAX package's two forms of its rank stage are one function in the
  port, so both names run the same passes);
* ``LIBCLSPH_TPU_SORT_BITS``: the radix sorts' key bits (30); fewer skip
  passes, and :func:`grid_exceeds_sort_bits` flags a grid that outgrows
  them;
* ``LIBCLSPH_TPU_SORT_APPLY``: ``scatter`` (default) or ``gather``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from . import radix_sort

SORT_IMPLS = ("xla", "radix", "radix-fused")
_SORT_IMPL = os.environ.get("LIBCLSPH_TPU_SORT", "xla")
_SORT_BITS = int(os.environ.get("LIBCLSPH_TPU_SORT_BITS", "30"))
_SORT_APPLY = os.environ.get("LIBCLSPH_TPU_SORT_APPLY", "scatter")


class GridInfo(NamedTuple):
    """Per-substep grid geometry (device tensors)."""

    min_point: torch.Tensor  # (3,) f32, includes the 2-cell padding
    max_point: torch.Tensor  # (3,) f32
    grid_size: torch.Tensor  # (3,) int32
    cell_side: torch.Tensor  # () f32


_SCALARS: dict = {}


def device_scalar(value: float, device) -> torch.Tensor:
    """A 0-d float32 tensor of ``value`` on ``device``, made once a process:
    a constant that an op needs as a device tensor (a CPU scalar would
    change its rounding) costs a synchronising host-to-device copy each
    time it is made. Callers must not write to it."""
    key = (float(value), str(torch.device(device)))
    t = _SCALARS.get(key)
    if t is None:
        t = _SCALARS[key] = torch.tensor(value, dtype=torch.float32, device=device)
    return t


def compute_bounds(position: torch.Tensor, params: SimulationParameters) -> GridInfo:
    """Bounds padded by two cells on every side, so 3x3x3 neighbourhood
    coordinates never underflow (sph_simulation.cpp:668-702)."""
    cell = device_scalar(params.cell_side, position.device)
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


def grid_exceeds_sort_bits(grid_size: torch.Tensor) -> torch.Tensor:
    """True when the grid outgrows the radix sorts' key width: with b
    sorted bits, codes are ordered only below 2^b, which needs every axis
    at most 2^(b // 3) cells. False for 30 bits or the ``xla`` backend."""
    if _SORT_IMPL not in ("radix", "radix-fused") or _SORT_BITS >= 30:
        return torch.zeros((), dtype=torch.bool, device=grid_size.device)
    return torch.any(grid_size > (1 << (_SORT_BITS // 3)))


def sort_by_cell(state: ParticleState, codes: torch.Tensor):
    """Sort every field of ``state`` by Morton code with the configured
    backend (the reference's radix pipeline, sph_simulation.cpp:110-198).
    Returns (sorted state with ``grid_index`` = the sorted codes, sorted
    codes, order), ``order`` mapping sorted slot -> original index."""
    if _SORT_IMPL not in SORT_IMPLS:
        raise ValueError(f"LIBCLSPH_TPU_SORT={_SORT_IMPL!r}: use one of {SORT_IMPLS}")
    if _SORT_IMPL == "xla":
        sorted_codes, order = sort_codes(codes)
    else:
        iota = torch.arange(codes.shape[0], dtype=torch.int32, device=codes.device)
        sorted_codes, order = radix_sort.radix_sort_key_val(
            codes, iota, num_bits=_SORT_BITS, apply=_SORT_APPLY)
    order = order.to(torch.int64)
    sorted_state = state.map(lambda a: a[order]).replace(grid_index=sorted_codes)
    return sorted_state, sorted_codes, order


def cell_ranges(sorted_codes: torch.Tensor, query_codes: torch.Tensor):
    """[start, end) of each query cell in the sorted codes: the
    back-filled cell table (sort.cl:62-79) as binary searches, start =
    searchsorted(codes, c, left), end = searchsorted(codes, c, right).
    Returns two int32 tensors of ``query_codes``' shape."""
    start = torch.searchsorted(sorted_codes, query_codes, side="left")
    end = torch.searchsorted(sorted_codes, query_codes, side="right")
    return start.to(torch.int32), end.to(torch.int32)
