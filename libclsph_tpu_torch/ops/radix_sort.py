"""Stable LSD radix sort over Morton cell codes.

PyTorch counterpart of ``libclsph_tpu/ops/radix_sort.py``, the
reference's sort pipeline (sort.cl:1-200, sph_simulation.cpp:110-198):
passes of per-tile digit histograms, one exclusive scan over the
digit-major histogram table for the offsets, and the move of keys and
values to their destinations. On the card every pass runs as kernels
(:func:`kernels.radix.radix_sort`, ``csrc/radix_sort.cu``: an upsweep, a
scan and a downsweep); on the CPU the plain version runs the
reference's form, with the rank stage of 128-key blocks.

The JAX package has two forms of the rank stage, a one-hot and
cumulative sum in XLA and the fused Pallas kernel; both compute the same
ranks and histograms, so the port has one sort. The offsets are integer
sums (JAX's float32 ones are exact below 2^24 too). Every pass is
stable, so the result equals a stable sort (``torch.sort(stable=True)``,
``lax.sort_key_val``) bit for bit. Keys are int32 below 2^num_bits, as
Morton codes are.
"""

from __future__ import annotations

import torch

from .kernels import radix as radix_kernels

MORTON_BITS = 30


def radix_sort_key_val(keys: torch.Tensor, vals: torch.Tensor, *,
                       num_bits: int = MORTON_BITS, bits_per_pass: int = 5,
                       apply: str = "scatter"):
    """Stable radix sort of ``(keys, vals)`` by ``keys`` (int32, each
    below 2^num_bits): bit-identical to a stable sort. ``bits_per_pass``
    <= 7 (a pass counts at most 128 digits); ``apply``: "scatter" or
    "gather" (how the values move, :mod:`kernels.radix`)."""
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError("radix_sort_key_val expects matching 1D arrays")
    if keys.dtype != torch.int32:
        raise ValueError("keys must be int32 (Morton codes)")
    if not 1 <= num_bits <= 31:
        raise ValueError("num_bits must be in 1..31 for int32 keys")
    if apply not in radix_kernels.APPLY:
        raise ValueError("apply must be 'scatter' or 'gather'")
    if not 1 <= bits_per_pass <= radix_kernels.MAX_BITS:
        raise ValueError("a pass counts at most 128 digits (bits_per_pass in 1..7)")
    return radix_kernels.radix_sort(keys, vals, num_bits, bits_per_pass, apply)
