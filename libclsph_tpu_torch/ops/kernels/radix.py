"""The stable LSD radix sort: the CUDA kernels, their plain PyTorch
version and the wrapper that picks between them by device.

:func:`radix_sort` replaces ``libclsph_tpu/ops/radix_sort.py``
``_rank_hist_kernel`` and the glue of its passes (``_radix_pass_fused``,
``radix_sort_key_val``); ``csrc/radix_sort.cu``: one kernel counts the
digits of every pass, then one kernel a pass ranks, offsets (by a
look-back over the earlier tiles) and moves tiles of 8,192 keys. It
sorts (keys, vals) (n,) int32 by the low ``num_bits`` bits of the keys,
``bits_per_pass`` bits a pass, ties in index order: for keys below
2^num_bits that is the stable sort. ``apply`` says how the card moves
the values: "scatter" moves each value with its key on every pass;
"gather" moves each key's index in the input instead and gathers the
values once after the last pass. Equal results.

The plain version, :func:`radix_sort_torch`, runs the passes of the
reference's form: :func:`rank_hist_torch` gives each key's rank among
the equal digits of its 128-key block and the blocks' digit histograms,
an exclusive scan of the digit-major histogram table gives the offsets,
and the keys and values are scattered to their destinations (or, with
"gather", the inverse permutation is scattered and both are gathered).
Both forms compute exact integers, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from . import build

BLOCK = 128  # keys per block of the plain version's rank stage
TILE = 8192  # keys per tile of a pass kernel
MAX_BITS = 7  # digits <= 128 a pass
APPLY = ("scatter", "gather")


def digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """The pass's digit of each key."""
    return (keys >> shift) & ((1 << bits) - 1)


def passes(num_bits: int, bits_per_pass: int) -> list[tuple[int, int]]:
    """(shift, bits) of each pass, from the lowest bits up."""
    return [(s, min(bits_per_pass, num_bits - s)) for s in range(0, num_bits, bits_per_pass)]


def rank_hist_torch(keys: torch.Tensor, shift: int, bits: int):
    """The rank and histogram stage of one plain pass (JAX's
    ``_rank_hist_kernel``) for keys (n,) int32, n a multiple of 128:
    ``local`` (n,) int32, each key's 1-based rank among the keys of its
    128-key block with the same digit, at or before it, and ``hist``
    (2^bits, n / 128) int32, digit-major: block b's count of digit k at
    ``hist[k, b]``. A one-hot of the digits, its inclusive scan down each
    block and the scan's last row."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("keys must be (n,) int32")
    if keys.shape[0] % BLOCK:
        raise ValueError(f"key count {keys.shape[0]} is not a multiple of {BLOCK}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in 1..{MAX_BITS}, not {bits}")
    d = 1 << bits
    nb = keys.shape[0] // BLOCK
    dg = digits(keys, shift, bits).reshape(nb, BLOCK).to(torch.int64)
    onehot = (dg[..., None] == torch.arange(d, device=keys.device)).to(torch.int32)
    scan = torch.cumsum(onehot, dim=1, dtype=torch.int32)  # (nb, 128, d)
    local = torch.gather(scan, 2, dg[..., None])[..., 0].reshape(-1)
    hist = scan[:, -1, :].t().contiguous()
    return local, hist


def _apply_dest(keys, vals, dest, apply):
    """Move (keys, vals) to their destination slots: "scatter" writes
    both by ``dest``; "gather" scatters the inverse permutation once and
    gathers both through it. Equal results."""
    idx = dest.to(torch.int64)
    if apply == "gather":
        inv = torch.empty_like(idx)
        inv[idx] = torch.arange(idx.shape[0], device=idx.device)
        return keys[inv], vals[inv]
    out_k = torch.empty_like(keys)
    out_v = torch.empty_like(vals)
    out_k[idx] = keys
    out_v[idx] = vals
    return out_k, out_v


def radix_pass_torch(keys, vals, shift, bits, apply):
    """One stable counting-sort pass on digit ``(keys >> shift) & mask``
    (n a multiple of 128): each key's slot is the exclusive offset of (its
    digit, its block) in the digit-major histogram table plus its 1-based
    in-block rank less one."""
    local, hist = rank_hist_torch(keys, shift, bits)
    dg = digits(keys, shift, bits).reshape(-1, BLOCK).to(torch.int64)
    flat = hist.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(flat, 0) - flat).reshape(hist.shape)
    base = offsets[dg, torch.arange(dg.shape[0], device=dg.device)[:, None]]
    dest = (base + local.reshape(dg.shape) - 1).reshape(-1)
    return _apply_dest(keys, vals, dest, apply)


def radix_sort_torch(keys: torch.Tensor, vals: torch.Tensor, num_bits: int,
                     bits_per_pass: int, apply: str):
    """Plain PyTorch version of :func:`radix_sort`: the keys padded to
    whole 128-key blocks with the largest key of ``num_bits`` bits, placed
    after the real keys (stable passes keep the pads behind every real
    tie, so the first n slots are exact), then the plain passes."""
    n = keys.shape[0]
    pad = (-n) % BLOCK
    if pad:
        keys = torch.cat([keys, torch.full((pad,), (1 << num_bits) - 1, dtype=keys.dtype,
                                           device=keys.device)])
        vals = torch.cat([vals, torch.zeros((pad,), dtype=vals.dtype, device=vals.device)])
    keys = keys.contiguous()
    for shift, bits in passes(num_bits, bits_per_pass):
        keys, vals = radix_pass_torch(keys, vals, shift, bits, apply)
    return keys[:n], vals[:n]


def radix_sort(keys: torch.Tensor, vals: torch.Tensor, num_bits: int, bits_per_pass: int,
               apply: str):
    """Stable radix sort of (keys, vals) (module docstring); the caller
    checks the arguments (``ops.radix_sort.radix_sort_key_val``). CPU
    tensors take the plain version; CUDA tensors launch the kernels
    (building them at first use), every pass counted, or raise (n must
    be below 2^30 there)."""
    if keys.device.type == "cpu":
        return radix_sort_torch(keys, vals, num_bits, bits_per_pass, apply)
    if keys.device.type != "cuda" or vals.device != keys.device:
        raise ValueError(f"radix_sort: unsupported devices {keys.device}, {vals.device}")
    n = keys.shape[0]
    if n >= 1 << 30:
        raise ValueError(f"radix_sort: {n} keys; the kernels count below 2^30")
    keys, vals = keys.contiguous(), vals.contiguous()
    if keys.data_ptr() % 16:
        keys = keys.clone()  # the histogram kernel reads whole tiles with 16-byte loads
    gather = apply == "gather"
    npass = len(passes(num_bits, bits_per_pass))
    # one allocation: the outputs, the ping-pong buffers (and the indices
    # of a gather), then the digit counts, tile counters and tile status
    # words of csrc/radix_sort.cu
    arrays = 5 if gather else 4
    buf = torch.empty(arrays * n + npass * (129 + (1 << bits_per_pass) * -(-n // TILE)),
                      dtype=torch.int32, device=keys.device)
    at = [buf.data_ptr() + 4 * n * i for i in range(arrays + 1)]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    status = build.load_library().radix_sort_launch(
        keys.data_ptr(), vals.data_ptr(), n, num_bits, bits_per_pass, int(gather), at[0],
        at[1], at[2], at[3], at[4] if gather else None, at[-1], stream)
    build.check(status, "radix_sort")
    if n:
        radix_sort.launches += npass
    return buf[:n], buf[n:2 * n]


radix_sort.launches = 0
