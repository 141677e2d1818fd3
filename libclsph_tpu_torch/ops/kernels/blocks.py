"""Density and force passes over whole 128-particle candidate blocks:
the ``row``, ``fine`` and ``asym`` variants of the ``pallas`` impl.

Counterpart of ``libclsph_tpu/ops/pallas/neighbor.py`` (``fused_density``
and ``fused_forces``; ``q_div`` 1 is ``row``, 4 is ``fine``) and of
``libclsph_tpu/ops/pallas/neighbor_asym.py`` (``fused_density`` and
``fused_forces`` on 128-query x 32-candidate sub-tiles, ``asym``). All
three compute one function: the density and the force sums of each query
against every particle of its block's live candidate blocks. What tells
them apart is Mosaic's (8, 128) tiling on the TPU (which axis rides the
lanes, and how wide a skip panel is), and that does not exist on
Hopper.

A 128-particle block ``c`` is exactly the 32-particle subblocks ``4c ..
4c+3``, contiguous in the sorted order (a block of B particles: ``c*B/32
.. c*B/32 + B/32 - 1``), so :func:`expand_block_table` writes a block
table at 32-particle granularity and the port's 32-wide kernels run it;
at ``block_size`` 64 each list serves 64 query rows (the kernels'
``rows``), at 256 each block's list serves its two 128-row halves:

* density (every variant): :func:`density.density_c32` with no hit
  counts (``groups=0``, ``csrc/density_c32.cu``);
* forces (every variant): :func:`forces.forces_q128_c32`, one list a
  block (``csrc/forces_c32.cu``). Its warp g runs query subgroup g (rows
  g*32 .. g*32+31) against the block's shared list, which is JAX's
  ``q_div`` 4 of ``fine`` (finer query blocks sharing their parent's
  list) as much as ``q_div`` 1 of ``row`` and ``asym``: each query adds
  its in-support candidates in ascending order, so both give the same
  bits.

The plain versions are those kernels' plain versions over the same
expanded table (``forces_q128_c32_torch`` equals ``forces_q32_c32_torch``
over the table repeated for the four subgroups, bit for bit). The
wrappers count no launches of their own: the 32-wide kernels they call
count theirs.
"""

from __future__ import annotations

import torch

from ...core.params import SimulationParameters
from ..tiles import REFINE_SENTINEL
from . import density, forces

SUB = 32  # particles per subblock of the expanded table
BLOCK = 128  # Morton block size of the defaults
BLOCK_SIZES = (64, 128, 256)  # particles per Morton block
GROUPS = 4  # query subgroups per block of fine (q_div 4)


def expand_block_table(cand: torch.Tensor, count: torch.Tensor, block: int = BLOCK):
    """Block ids (nb, M) of ``block``-particle blocks -> 32-particle
    subblock ids (nb, sL), s = block / 32: slot k of block id c becomes
    slots sk .. sk+s-1 with ids sc .. sc+s-1 (the split of
    ``engine.step.hit_lists``); ``REFINE_SENTINEL`` stays a sentinel, and
    the counts are multiplied by s. L is the deepest live slot (at least
    1): the slots past every count hold nothing the passes read. Returns
    (ids int32, counts int32)."""
    if cand.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expand_block_table: unsupported device {cand.device}")
    if block not in BLOCK_SIZES:
        raise ValueError(f"block must be one of {BLOCK_SIZES}, not {block}")
    split = block // SUB
    live = max(1, int(count.max())) if count.numel() else 1
    cand = cand[:, :live]
    dead = cand == REFINE_SENTINEL
    parts = torch.where(dead, 0, cand)[..., None] * split + torch.arange(
        split, dtype=cand.dtype, device=cand.device)
    ids = torch.where(dead[..., None], REFINE_SENTINEL, parts).reshape(cand.shape[0], -1)
    return ids.to(torch.int32).contiguous(), (count * split).to(torch.int32).contiguous()


def _lists(cand, count, block):
    """The expanded table as the kernels' lists and the rows each list
    serves: a list a block of 64 or 128 rows; a 256-particle block's list
    repeated for its two 128-row halves."""
    ids, counts = expand_block_table(cand, count, block)
    if block > BLOCK:
        rep = block // BLOCK
        ids = torch.repeat_interleave(ids, rep, dim=0)
        counts = torch.repeat_interleave(counts, rep)
    return ids, counts, min(block, BLOCK)


def _check_q_div(q_div):
    if q_div not in (1, GROUPS):
        raise ValueError(f"q_div must be 1 (row, asym) or {GROUPS} (fine), not {q_div}")


def density_blocks_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                         params: SimulationParameters, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of :func:`density_blocks`."""
    ids, counts, rows = _lists(cand, count, block)
    return density.density_c32_torch(pos4, ids, counts, params, groups=0, rows=rows)[0]


def density_blocks(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                   params: SimulationParameters, block: int = BLOCK) -> torch.Tensor:
    """Density (np,) of every query against its block's live candidate
    blocks (``cand`` (nb, M) ids of ``block``-particle blocks, ``count``
    (nb,)); rest density on padding queries. CPU tensors take the plain
    version; CUDA tensors launch ``density_c32`` or raise."""
    ids, counts, rows = _lists(cand, count, block)
    return density.density_c32(pos4, ids, counts, params, groups=0, rows=rows)[0]


def forces_blocks_torch(f8, density_, real, cand, count, params: SimulationParameters,
                        q_div: int = 1, block: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch version of :func:`forces_blocks`."""
    _check_q_div(q_div)
    ids, counts, rows = _lists(cand, count, block)
    return forces.forces_q128_c32_torch(f8, density_, real, ids, counts, params, rows=rows)


def forces_blocks(f8, density_, real, cand, count, params: SimulationParameters,
                  q_div: int = 1, block: int = BLOCK) -> torch.Tensor:
    """Accelerations (np, 3) over the block's live candidate blocks, 0 on
    padding queries: the whole block shares one list (``q_div`` 1: row,
    asym) or each of its ``q_div`` query subgroups runs it (``q_div`` 4:
    fine); both are one function, and one kernel runs it. CPU tensors
    take the plain version; CUDA tensors launch ``forces_q128_c32`` or
    raise."""
    _check_q_div(q_div)
    ids, counts, rows = _lists(cand, count, block)
    return forces.forces_q128_c32(f8, density_, real, ids, counts, params, rows=rows)
