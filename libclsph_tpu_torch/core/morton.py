"""Vectorised 3-D Morton (z-order) codes.

PyTorch counterpart of ``libclsph_tpu/core/morton.py``: the same
10-bit-per-axis interleave as the reference (``libclsph/common/util.h:
4-62``). Codes are 30-bit, so they are held in ``int32`` (torch's
unsigned bit operations are thin); every shift and mask below stays
inside 30 bits.
"""

from __future__ import annotations

import torch

MAX_GRID_DIM = 1024  # 10 bits per axis


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits out to every 3rd bit (util.h:41-62)."""
    v = v.to(torch.int32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact1by2(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2 (util.h:4-19)."""
    v = v.to(torch.int32) & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def encode(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave three 10-bit coordinates: x in bit 0, y in bit 1, z in
    bit 2 (get_grid_index_z_curve, util.h:41-62)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def decode(code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Morton code -> (x, y, z) cell coordinates (util.h:21-38)."""
    code = code.to(torch.int32)
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def neighbor_codes(code: torch.Tensor) -> torch.Tensor:
    """Codes of the 3x3x3 cells around each input cell, shape
    ``code.shape + (27,)``, dz outermost and dx innermost as the triple
    loop of compute_density_with_grid (forces.cl:24-27). A coordinate
    stepped past an edge wraps in its 10 bits as the JAX package's uint32
    arithmetic does; the 2-cell bound padding keeps real cells off the
    edges."""
    x, y, z = decode(code)
    out = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                out.append(encode(x + dx, y + dy, z + dz))
    return torch.stack(out, dim=-1)
