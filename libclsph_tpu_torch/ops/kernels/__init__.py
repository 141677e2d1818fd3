"""The hand-written CUDA kernels, each beside its plain PyTorch version;
the wrappers dispatch by the tensors' device."""

from .density import (
    density_c16,
    density_c16_torch,
    density_c32,
    density_c32_torch,
    density_gated16,
    density_gated16_torch,
    pack_tile_nibbles,
    pos_pack,
)
from .forces import (
    force_pack,
    forces_q32_c8,
    forces_q32_c8_torch,
    forces_q32_c16,
    forces_q32_c16_torch,
    forces_q32_c32,
    forces_q32_c32_torch,
    forces_q128_c32,
    forces_q128_c32_torch,
)
from .radix import radix_sort, radix_sort_torch, rank_hist_torch
from .blocks import (
    density_blocks,
    density_blocks_torch,
    expand_block_table,
    forces_blocks,
    forces_blocks_torch,
)

__all__ = [
    "radix_sort",
    "radix_sort_torch",
    "rank_hist_torch",
    "density_blocks",
    "density_blocks_torch",
    "expand_block_table",
    "forces_blocks",
    "forces_blocks_torch",
    "density_c16",
    "density_c16_torch",
    "density_c32",
    "density_c32_torch",
    "density_gated16",
    "density_gated16_torch",
    "pack_tile_nibbles",
    "pos_pack",
    "forces_q32_c8",
    "forces_q32_c8_torch",
    "forces_q32_c16",
    "forces_q32_c16_torch",
    "forces_q32_c32",
    "forces_q32_c32_torch",
    "forces_q128_c32",
    "forces_q128_c32_torch",
    "force_pack",
]
