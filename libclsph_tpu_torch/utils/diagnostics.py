"""Runtime diagnostics for the neighbour machinery.

PyTorch counterpart of ``libclsph_tpu/utils/diagnostics.py``: the
candidate-capacity statistics of the current particle distribution
(through the port's own block search) and a host-side density summary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.params import SimulationParameters
from ..ops import grid as grid_ops
from ..ops import tiles as tiles_ops


class NeighborStats(NamedTuple):
    count_mean: torch.Tensor
    count_max: torch.Tensor
    overflowed: torch.Tensor
    occupancy_max: torch.Tensor  # particles in the fullest grid cell


def neighbor_stats(
    position: torch.Tensor,
    params: SimulationParameters,
    block_size: int = 128,
    max_candidates: int = 1024,
) -> NeighborStats:
    """Candidate-list statistics for the current particle distribution,
    to pick ``StepConfig.max_candidates`` before a long run (the engine
    also grows it on overflow). ``block_size`` is any block length: the
    statistics do not run the substep, so they are not bound to its
    128-row blocks. Positions are padded with far sentinels to whole
    blocks, sorted stably by Morton code, cut into blocks and searched
    with the dense block-overlap test."""
    n = position.shape[0]
    pad = (-n) % block_size
    grid = grid_ops.compute_bounds(position, params)
    codes = grid_ops.locate_in_grid(position, grid)
    if pad:
        far = grid.max_point + 1000.0 * params.h
        position = torch.cat([position, far.expand(pad, 3)])
        codes = torch.cat([codes, torch.full((pad,), tiles_ops.SENTINEL_CODE,
                                             dtype=codes.dtype, device=codes.device)])
    sorted_codes, order = torch.sort(codes, stable=True)
    real = torch.arange(n + pad, device=position.device) < n
    blocked_pos = position[order].reshape(-1, block_size, 3)
    real_b = real[order].reshape(-1, block_size)
    bmin, bmax = tiles_ops.split_block_bounds(blocked_pos, real_b)
    _, count, ovf = tiles_ops.candidate_blocks(bmin, bmax, params.h, max_candidates)
    start, end = grid_ops.cell_ranges(sorted_codes, sorted_codes)
    return NeighborStats(
        count_mean=count.float().mean(),
        count_max=count.max(),
        overflowed=ovf,
        occupancy_max=torch.max(end - start),
    )


def density_summary(density, params: SimulationParameters) -> dict:
    """Host-side density health check (the fraction near rest density)."""
    d = np.asarray(density.cpu() if isinstance(density, torch.Tensor) else density)
    rho0 = params.fluid_density
    return {
        "min": float(d.min()),
        "max": float(d.max()),
        "mean": float(d.mean()),
        "frac_within_10pct_rest": float(np.mean(np.abs(d - rho0) < 0.1 * rho0)),
        "any_nonfinite": bool(~np.isfinite(d).all()),
    }
