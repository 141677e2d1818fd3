"""The rank and histogram stage of a radix sort pass: the CUDA kernel,
its plain PyTorch version and the wrapper that picks between them by
device.

:func:`rank_hist` replaces ``libclsph_tpu/ops/radix_sort.py``
``_rank_hist_kernel`` (with ``_radix_pass_fused``, which calls it), and
the XLA one-hot rank stage of its ``_radix_pass``; ``csrc/radix_rank.cu``. For keys (n,) int32, n a multiple of 128, and the
digit ``(key >> shift) & (2^bits - 1)``:

* ``local`` (n,) int32: each key's 1-based rank among the keys of its
  128-key block with the same digit, at or before it;
* ``hist`` (2^bits, n / 128) int32, digit-major: block b's count of
  digit k at ``hist[k, b]``.

Both are exact integers, so the kernel and the plain version agree bit
for bit.
"""

from __future__ import annotations

import torch

from . import build

BLOCK = 128  # keys per rank block
MAX_BITS = 7  # digits <= 128: one warp-count row a thread


def _check(keys: torch.Tensor, shift: int, bits: int):
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise ValueError("keys must be (n,) int32")
    if keys.shape[0] % BLOCK:
        raise ValueError(f"key count {keys.shape[0]} is not a multiple of {BLOCK}")
    if not 1 <= bits <= MAX_BITS:
        raise ValueError(f"bits must be in 1..{MAX_BITS}, not {bits}")
    if not 0 <= shift <= 30:
        raise ValueError(f"shift must be in 0..30, not {shift}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")


def digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """The pass's digit of each key."""
    return (keys >> shift) & ((1 << bits) - 1)


def rank_hist_torch(keys: torch.Tensor, shift: int, bits: int):
    """Plain PyTorch version of :func:`rank_hist`: a one-hot of the
    digits, its inclusive scan down each block and the scan's last row."""
    d = 1 << bits
    nb = keys.shape[0] // BLOCK
    dg = digits(keys, shift, bits).reshape(nb, BLOCK).to(torch.int64)
    onehot = (dg[..., None] == torch.arange(d, device=keys.device)).to(torch.int32)
    scan = torch.cumsum(onehot, dim=1, dtype=torch.int32)  # (nb, 128, d)
    local = torch.gather(scan, 2, dg[..., None])[..., 0].reshape(-1)
    hist = scan[:, -1, :].t().contiguous()
    return local, hist


def rank_hist(keys: torch.Tensor, shift: int, bits: int):
    """(local, hist) of one radix pass (module docstring). CPU tensors
    take the plain version; CUDA tensors launch the kernel (building it at
    first use) or raise."""
    _check(keys, shift, bits)
    if keys.device.type == "cpu":
        return rank_hist_torch(keys, shift, bits)
    if keys.device.type != "cuda":
        raise ValueError(f"rank_hist: unsupported device {keys.device}")
    n = keys.shape[0]
    local = torch.empty(n, dtype=torch.int32, device=keys.device)
    hist = torch.empty((1 << bits, n // BLOCK), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    status = build.load_library().radix_rank_launch(
        keys.data_ptr(), n, shift, bits, local.data_ptr(), hist.data_ptr(), stream)
    build.check(status, "radix_rank")
    rank_hist.launches += 1
    return local, hist


rank_hist.launches = 0
