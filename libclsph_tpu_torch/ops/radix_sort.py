"""Stable LSD radix sort over Morton cell codes.

PyTorch counterpart of ``libclsph_tpu/ops/radix_sort.py``, the
reference's sort pipeline (sort.cl:1-200, sph_simulation.cpp:110-198)
as passes of: each key's rank among the equal digits of its 128-key
block and the blocks' digit histograms (:func:`kernels.radix.rank_hist`:
``csrc/radix_rank.cu`` on the card, its plain version on the CPU), one
exclusive scan over the digit-major histogram table for the offsets, and
the move of keys and values to their destinations.

The JAX package has two forms of the rank stage, a one-hot and cumulative
sum in XLA and the fused Pallas kernel; both compute the same ranks and
histograms, which here are the one function ``rank_hist``, so the port has
one pass. The offsets are integer sums (JAX's float32 ones are exact
below 2^24 too). Every pass is stable, so the result equals a stable sort
(``torch.sort(stable=True)``, ``lax.sort_key_val``) bit for bit. Keys are
int32 below 2^num_bits, as Morton codes are.
"""

from __future__ import annotations

import torch

from .kernels import radix as radix_kernels

MORTON_BITS = 30
LANES = radix_kernels.BLOCK  # keys per block of the rank stage


def _apply_dest(keys, vals, dest, mode):
    """Move (keys, vals) to their destination slots: ``scatter`` writes
    both by ``dest``; ``gather`` scatters the inverse permutation once and
    gathers both through it. Equal results."""
    idx = dest.to(torch.int64)
    if mode == "gather":
        inv = torch.empty_like(idx)
        inv[idx] = torch.arange(idx.shape[0], device=idx.device)
        return keys[inv], vals[inv]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    out_k[idx] = keys
    out_v[idx] = vals
    return out_k, out_v


def _radix_pass(keys, vals, shift, *, bits, apply):
    """One stable counting-sort pass on digit ``(keys >> shift) & mask``:
    each key's slot is the exclusive offset of (its digit, its block) in
    the digit-major histogram table plus its 1-based in-block rank less
    one."""
    local, hist = radix_kernels.rank_hist(keys, shift, bits)
    dg = radix_kernels.digits(keys, shift, bits).reshape(-1, LANES).to(torch.int64)
    flat = hist.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(flat, 0) - flat).reshape(hist.shape)
    base = offsets[dg, torch.arange(dg.shape[0], device=dg.device)[:, None]]
    dest = (base + local.reshape(dg.shape) - 1).reshape(-1)
    return _apply_dest(keys, vals, dest, apply)


def radix_sort_key_val(keys: torch.Tensor, vals: torch.Tensor, *,
                       num_bits: int = MORTON_BITS, bits_per_pass: int = 5,
                       apply: str = "scatter"):
    """Stable radix sort of ``(keys, vals)`` by ``keys`` (int32, each
    below 2^num_bits): bit-identical to a stable sort. ``bits_per_pass``
    <= 7 (the rank stage counts at most 128 digits); ``apply``: "scatter"
    or "gather" (:func:`_apply_dest`)."""
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError("radix_sort_key_val expects matching 1D arrays")
    if keys.dtype != torch.int32:
        raise ValueError("keys must be int32 (Morton codes)")
    if not 1 <= num_bits <= 31:
        raise ValueError("num_bits must be in 1..31 for int32 keys")
    if apply not in ("scatter", "gather"):
        raise ValueError("apply must be 'scatter' or 'gather'")
    if not 1 <= bits_per_pass <= radix_kernels.MAX_BITS:
        raise ValueError("the rank stage needs digits <= 128 (bits_per_pass in 1..7)")
    n = keys.shape[0]
    pad = (-n) % LANES
    if pad:
        # max in-range key, appended AFTER the real elements: stable
        # passes keep pads behind every real tie, so [:n] is exact
        keys = torch.cat([keys, torch.full((pad,), (1 << num_bits) - 1, dtype=keys.dtype,
                                           device=keys.device)])
        vals = torch.cat([vals, torch.zeros((pad,), dtype=vals.dtype, device=vals.device)])
    keys = keys.contiguous()
    for shift in range(0, num_bits, bits_per_pass):
        bits = min(bits_per_pass, num_bits - shift)
        keys, vals = _radix_pass(keys, vals, shift, bits=bits, apply=apply)
    return keys[:n], vals[:n]
