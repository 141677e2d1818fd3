"""The main path's hand-written CUDA kernels, each beside its plain
PyTorch version; the wrappers dispatch by the tensors' device."""

from .density import density_c16_hit8, density_c16_hit8_torch, pos_pack
from .forces import force_pack, forces_q32_c8, forces_q32_c8_torch

__all__ = [
    "density_c16_hit8",
    "density_c16_hit8_torch",
    "pos_pack",
    "forces_q32_c8",
    "forces_q32_c8_torch",
    "force_pack",
]
