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
4c+3``, contiguous in the sorted order, so :func:`expand_block_table`
writes a block table at 32-particle granularity and the port's 32-wide
kernels run it:

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

SPLIT = 4  # 32-particle subblocks per 128-particle block
GROUPS = 4  # 32-row query subgroups per block


def expand_block_table(cand: torch.Tensor, count: torch.Tensor):
    """Block ids (nb, M) -> 32-particle subblock ids (nb, 4L): slot k of
    block id c becomes slots 4k .. 4k+3 with ids 4c .. 4c+3 (the split of
    ``engine.step.hit_lists``); ``REFINE_SENTINEL`` stays a sentinel, and
    the counts are multiplied by 4. L is the deepest live slot (at least
    1): the slots past every count hold nothing the passes read. Returns
    (ids int32, counts int32)."""
    if cand.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expand_block_table: unsupported device {cand.device}")
    live = max(1, int(count.max())) if count.numel() else 1
    cand = cand[:, :live]
    dead = cand == REFINE_SENTINEL
    parts = torch.where(dead, 0, cand)[..., None] * SPLIT + torch.arange(
        SPLIT, dtype=cand.dtype, device=cand.device)
    ids = torch.where(dead[..., None], REFINE_SENTINEL, parts).reshape(cand.shape[0], -1)
    return ids.to(torch.int32).contiguous(), (count * SPLIT).to(torch.int32).contiguous()


def _check_q_div(q_div):
    if q_div not in (1, GROUPS):
        raise ValueError(f"q_div must be 1 (row, asym) or {GROUPS} (fine), not {q_div}")


def density_blocks_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                         params: SimulationParameters) -> torch.Tensor:
    """Plain PyTorch version of :func:`density_blocks`."""
    ids, counts = expand_block_table(cand, count)
    return density.density_c32_torch(pos4, ids, counts, params, groups=0)[0]


def density_blocks(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                   params: SimulationParameters) -> torch.Tensor:
    """Density (np,) of every query against its block's live candidate
    blocks (``cand`` (nb, M) block ids, ``count`` (nb,)); rest density on
    padding queries. CPU tensors take the plain version; CUDA tensors
    launch ``density_c32`` or raise."""
    ids, counts = expand_block_table(cand, count)
    return density.density_c32(pos4, ids, counts, params, groups=0)[0]


def forces_blocks_torch(f8, density_, real, cand, count, params: SimulationParameters,
                        q_div: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`forces_blocks`."""
    _check_q_div(q_div)
    ids, counts = expand_block_table(cand, count)
    return forces.forces_q128_c32_torch(f8, density_, real, ids, counts, params)


def forces_blocks(f8, density_, real, cand, count, params: SimulationParameters,
                  q_div: int = 1) -> torch.Tensor:
    """Accelerations (np, 3) over the block's live candidate blocks, 0 on
    padding queries: the whole block shares one list (``q_div`` 1: row,
    asym) or each 32-row subgroup runs it (``q_div`` 4: fine); both are
    one function, and one kernel runs it. CPU tensors take the plain
    version; CUDA tensors launch ``forces_q128_c32`` or raise."""
    _check_q_div(q_div)
    ids, counts = expand_block_table(cand, count)
    return forces.forces_q128_c32(f8, density_, real, ids, counts, params)
