"""Density pass with true-hit counts: the CUDA kernel, its plain
PyTorch version and the wrapper that picks between them by device.

Replaces ``libclsph_tpu/ops/pallas/neighbor_nl.py`` ``fused_density_nl``
at ``c16=True, hit_sub=8, hit_groups=4`` (the main path's density
pass). See ``csrc/density_c16_hit8.cu`` for the kernel.

Inputs, for ``np`` particles in ``nb = np / 128`` Morton blocks:

* ``pos4`` (np, 4) float32: x, y, z and the real mask (1.0 / 0.0), from
  :func:`pos_pack`;
* ``cand`` (nb, cap) int32: 16-particle candidate subblock ids per
  query block, dead slots ``REFINE_SENTINEL`` after ``count``;
* ``count`` (nb,) int32.

Outputs: ``density`` (np,) float32 (rest density on padding rows) and
``hits`` (nb*4, 2*cap) int32, the number of pairs with r < h between
query subgroup g (rows g*32 .. g*32+31 of block b, row b*4 + g) and
half e of slot k (column 2k + e).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.params import SimulationParameters
from . import build

BLOCK = 128  # queries per block
SUB = 16  # particles per candidate subblock
GROUPS = 4  # query subgroups of 32 rows
# pair elements per chunk of the plain version
CHUNK_PAIRS = 1 << 24


def pos_pack(position: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """(np, 4) float32 [x, y, z, real]."""
    return torch.cat([position, real.to(torch.float32)[:, None]], dim=1).contiguous()


def _consts(params: SimulationParameters):
    h = float(params.h)
    return dict(
        h2=float(np.float32(h * h)),
        poly6=float(np.float32(params.precomputed().poly_6)),
        mass=float(np.float32(params.particle_mass)),
        fluid_density=float(np.float32(params.fluid_density)),
    )


def density_c16_hit8_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                           params: SimulationParameters):
    """Plain PyTorch version, chunked over query blocks."""
    c = _consts(params)
    npart = pos4.shape[0]
    nb, cap = cand.shape
    dev = pos4.device
    density = torch.empty(npart, dtype=torch.float32, device=dev)
    hits = torch.zeros((nb * GROUPS, 2 * cap), dtype=torch.int32, device=dev)
    slot = torch.arange(cap, device=dev)
    lane = torch.arange(SUB, device=dev)
    rows = max(1, CHUNK_PAIRS // (BLOCK * cap * SUB))
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        r = b1 - b0
        live = slot[None, :] < count[b0:b1, None]  # (r, cap)
        ids = torch.where(live, cand[b0:b1], 0).to(torch.int64)[:, :, None] * SUB + lane
        cp = pos4[ids]  # (r, cap, 16, 4)
        q = pos4[b0 * BLOCK : b1 * BLOCK].reshape(r, BLOCK, 1, 1, 4)
        cq = cp[:, None]
        dx = q[..., 0] - cq[..., 0]
        dy = q[..., 1] - cq[..., 1]
        dz = q[..., 2] - cq[..., 2]
        r2 = (dx * dx + dy * dy) + dz * dz  # (r, 128, cap, 16)
        live4 = live[:, None, :, None]
        t = torch.clamp(c["h2"] - r2, min=0.0)
        w = (c["poly6"] * cq[..., 3]) * (t * t * t)
        wsum = torch.where(live4, w, 0.0).sum(dim=(2, 3))
        real_q = q[:, :, 0, 0, 3] > 0
        density[b0 * BLOCK : b1 * BLOCK] = torch.where(
            real_q, c["mass"] * wsum, c["fluid_density"]
        ).reshape(-1)
        incl = (r2 < c["h2"]) & live4
        cnt = incl.reshape(r, GROUPS, BLOCK // GROUPS, cap, 2, SUB // 2).sum(
            dim=(2, 5), dtype=torch.int32
        )
        hits[b0 * GROUPS : b1 * GROUPS] = cnt.reshape(r * GROUPS, 2 * cap)
    return density, hits


def _check(pos4, cand, count):
    if pos4.dtype != torch.float32 or pos4.dim() != 2 or pos4.shape[1] != 4:
        raise ValueError("pos4 must be (np, 4) float32")
    if pos4.shape[0] % BLOCK:
        raise ValueError(f"particle count {pos4.shape[0]} is not a multiple of {BLOCK}")
    nb = pos4.shape[0] // BLOCK
    if cand.dtype != torch.int32 or cand.dim() != 2 or cand.shape[0] != nb:
        raise ValueError("cand must be (np/128, cap) int32")
    if count.dtype != torch.int32 or count.shape != (nb,):
        raise ValueError("count must be (np/128,) int32")
    for name, t in (("pos4", pos4), ("cand", cand), ("count", count)):
        if t.device != pos4.device:
            raise ValueError(f"{name} is on {t.device}, pos4 on {pos4.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def density_c16_hit8(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                     params: SimulationParameters):
    """Density and hit counts. CPU tensors take the plain version; CUDA
    tensors launch the kernel (building it at first use) or raise."""
    _check(pos4, cand, count)
    if pos4.device.type == "cpu":
        return density_c16_hit8_torch(pos4, cand, count, params)
    if pos4.device.type != "cuda":
        raise ValueError(f"density_c16_hit8: unsupported device {pos4.device}")
    lib = build.load_library()
    c = _consts(params)
    nb, cap = cand.shape
    density = torch.empty(pos4.shape[0], dtype=torch.float32, device=pos4.device)
    hits = torch.zeros((nb * GROUPS, 2 * cap), dtype=torch.int32, device=pos4.device)
    stream = torch.cuda.current_stream(pos4.device).cuda_stream
    status = lib.density_c16_hit8_launch(
        pos4.data_ptr(), cand.data_ptr(), count.data_ptr(), nb, cap,
        c["h2"], c["poly6"], c["mass"], c["fluid_density"],
        density.data_ptr(), hits.data_ptr(), stream,
    )
    build.check(status, "density_c16_hit8")
    density_c16_hit8.launches += 1
    return density, hits


density_c16_hit8.launches = 0
