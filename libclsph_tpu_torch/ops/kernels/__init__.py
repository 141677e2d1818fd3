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
from .advect import advect_collide, advect_collide_torch
from .refine import refine_exact_keys, refine_exact_keys_torch
from .radix import radix_sort, radix_sort_torch, rank_hist_torch
from .stream import (
    forces_c32_stream,
    forces_c32_stream_torch,
    gather_stream,
    gather_stream_torch,
)
from .blocks import (
    density_blocks,
    density_blocks_torch,
    expand_block_table,
    forces_blocks,
    forces_blocks_torch,
)

WRAPPERS = (density_c16, density_c32, density_gated16, forces_q32_c8, forces_q32_c16,
            forces_q32_c32, forces_q128_c32, radix_sort, gather_stream, forces_c32_stream,
            advect_collide, refine_exact_keys)


def launch_counts() -> dict:
    """Each wrapper's launches (and its launches by variant, where it
    counts them) since the last :func:`reset_launch_counts`."""
    return {fn.__name__: (fn.launches, dict(getattr(fn, "variants", {})))
            for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "variants"):
            fn.variants = {}


__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "advect_collide",
    "advect_collide_torch",
    "refine_exact_keys",
    "refine_exact_keys_torch",
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
    "gather_stream",
    "gather_stream_torch",
    "forces_c32_stream",
    "forces_c32_stream_torch",
]
