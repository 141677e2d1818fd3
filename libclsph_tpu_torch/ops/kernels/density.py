"""Density passes with true-hit counts: the CUDA kernels, their plain
PyTorch versions and the wrappers that pick between them by device.

Two kernels replace ``libclsph_tpu/ops/pallas/neighbor_nl.py``
``fused_density_nl``:

* :func:`density_c16_hit8` at ``c16=True, hit_sub=8, hit_groups=4``
  (the main path); ``csrc/density_c16_hit8.cu``;
* :func:`density_c32` at ``c16=False`` with ``hit_groups`` 4 or 1 (the
  q-granular path and its tier 2); ``csrc/density_c32.cu``.

Inputs, for ``np`` particles in ``np / 128`` Morton blocks:

* ``pos4`` (np, 4) float32: x, y, z and the real mask (1.0 / 0.0), from
  :func:`pos_pack`;
* ``cand`` (nq, cap) int32: candidate subblock ids (16 or 32 particles)
  per list row, dead slots ``REFINE_SENTINEL`` after ``count``;
* ``count`` (nq,) int32;
* ``qblock`` (nq,) int32 or None: the query block of each list row (the
  two-tier path runs gathered heavy blocks against the full ``pos4``);
  None is the identity, nq = np / 128.

Outputs: ``density`` (nq*128,) float32 for the rows' queries (rest
density on padding queries) and ``hits`` int32. ``density_c16_hit8``:
(nq*4, 2*cap), the pairs with r < h between query subgroup g (rows
g*32 .. g*32+31, row b*4 + g) and half e of slot k (column 2k + e).
``density_c32``: (nq*4, cap) pair counts per (subgroup, slot) at
``groups=4``; (nq, cap) at ``groups=1``, the particles of the slot
within h of some query of the block. Only ``hits > 0`` is read
downstream; the counts are the JAX kernel's.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.params import SimulationParameters
from . import build

BLOCK = 128  # queries per block
GROUPS = 4  # query subgroups of 32 rows
# pair elements per chunk of the plain versions
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


def _density_torch(pos4, cand, count, params, qblock, sub: int, hit_sub: int,
                   groups: int):
    """Plain density over ``sub``-particle candidate subblocks with hit
    counts per (query subgroup of 128/groups rows, run of ``hit_sub``
    candidate particles); at groups=1 the count is of the run's particles
    that some query hits. Chunked over list rows."""
    c = _consts(params)
    nq, cap = cand.shape
    dev = pos4.device
    runs = sub // hit_sub
    density = torch.empty(nq * BLOCK, dtype=torch.float32, device=dev)
    hits = torch.zeros((nq * groups, cap * runs), dtype=torch.int32, device=dev)
    slot = torch.arange(cap, device=dev)
    lane = torch.arange(sub, device=dev)
    qlane = torch.arange(BLOCK, device=dev)
    rows = max(1, CHUNK_PAIRS // (BLOCK * cap * sub))
    for b0 in range(0, nq, rows):
        b1 = min(nq, b0 + rows)
        r = b1 - b0
        live = slot[None, :] < count[b0:b1, None]  # (r, cap)
        ids = torch.where(live, cand[b0:b1], 0).to(torch.int64)[:, :, None] * sub + lane
        cp = pos4[ids]  # (r, cap, sub, 4)
        qb = (torch.arange(b0, b1, device=dev) if qblock is None
              else qblock[b0:b1].to(torch.int64))
        q = pos4[qb[:, None] * BLOCK + qlane].reshape(r, BLOCK, 1, 1, 4)
        cq = cp[:, None]
        dx = q[..., 0] - cq[..., 0]
        dy = q[..., 1] - cq[..., 1]
        dz = q[..., 2] - cq[..., 2]
        r2 = (dx * dx + dy * dy) + dz * dz  # (r, 128, cap, sub)
        live4 = live[:, None, :, None]
        t = torch.clamp(c["h2"] - r2, min=0.0)
        w = (c["poly6"] * cq[..., 3]) * (t * t * t)
        wsum = torch.where(live4, w, 0.0).sum(dim=(2, 3))
        real_q = q[:, :, 0, 0, 3] > 0
        density[b0 * BLOCK : b1 * BLOCK] = torch.where(
            real_q, c["mass"] * wsum, c["fluid_density"]
        ).reshape(-1)
        incl = (r2 < c["h2"]) & live4
        if groups == 1:
            cnt = incl.any(dim=1).reshape(r, 1, cap * runs, hit_sub).sum(
                dim=-1, dtype=torch.int32)
        else:
            cnt = incl.reshape(r, groups, BLOCK // groups, cap, runs, hit_sub).sum(
                dim=(2, 5), dtype=torch.int32)
        hits[b0 * groups : b1 * groups] = cnt.reshape(r * groups, cap * runs)
    return density, hits


def density_c16_hit8_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                           params: SimulationParameters, qblock=None):
    """Plain PyTorch version of :func:`density_c16_hit8`."""
    return _density_torch(pos4, cand, count, params, qblock, 16, 8, GROUPS)


def density_c32_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                      params: SimulationParameters, groups: int = GROUPS, qblock=None):
    """Plain PyTorch version of :func:`density_c32`."""
    return _density_torch(pos4, cand, count, params, qblock, 32, 32, groups)


def _check(pos4, cand, count, qblock):
    if pos4.dtype != torch.float32 or pos4.dim() != 2 or pos4.shape[1] != 4:
        raise ValueError("pos4 must be (np, 4) float32")
    if pos4.shape[0] % BLOCK:
        raise ValueError(f"particle count {pos4.shape[0]} is not a multiple of {BLOCK}")
    nb = pos4.shape[0] // BLOCK
    if cand.dtype != torch.int32 or cand.dim() != 2:
        raise ValueError("cand must be (nq, cap) int32")
    nq = cand.shape[0]
    if qblock is None:
        if nq != nb:
            raise ValueError("cand must have np/128 rows without a qblock map")
    elif qblock.dtype != torch.int32 or qblock.shape != (nq,):
        raise ValueError("qblock must be (nq,) int32")
    if count.dtype != torch.int32 or count.shape != (nq,):
        raise ValueError("count must be (nq,) int32")
    named = (("pos4", pos4), ("cand", cand), ("count", count)) + (
        () if qblock is None else (("qblock", qblock),))
    for name, t in named:
        if t.device != pos4.device:
            raise ValueError(f"{name} is on {t.device}, pos4 on {pos4.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(name, pos4, cand, count, qblock, params, hit_shape, *extra):
    c = _consts(params)
    nq, cap = cand.shape
    density = torch.empty(nq * BLOCK, dtype=torch.float32, device=pos4.device)
    hits = torch.zeros(hit_shape, dtype=torch.int32, device=pos4.device)
    stream = torch.cuda.current_stream(pos4.device).cuda_stream
    status = getattr(build.load_library(), name + "_launch")(
        pos4.data_ptr(), cand.data_ptr(), count.data_ptr(),
        None if qblock is None else qblock.data_ptr(), nq, cap, *extra,
        c["h2"], c["poly6"], c["mass"], c["fluid_density"],
        density.data_ptr(), hits.data_ptr(), stream,
    )
    build.check(status, name)
    return density, hits


def density_c16_hit8(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                     params: SimulationParameters, qblock=None):
    """Density and hit counts over 16-wide lists. CPU tensors take the
    plain version; CUDA tensors launch the kernel (building it at first
    use) or raise."""
    _check(pos4, cand, count, qblock)
    if pos4.device.type == "cpu":
        return density_c16_hit8_torch(pos4, cand, count, params, qblock)
    if pos4.device.type != "cuda":
        raise ValueError(f"density_c16_hit8: unsupported device {pos4.device}")
    nq, cap = cand.shape
    out = _launch("density_c16_hit8", pos4, cand, count, qblock, params,
                  (nq * GROUPS, 2 * cap))
    density_c16_hit8.launches += 1
    return out


def density_c32(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                params: SimulationParameters, groups: int = GROUPS, qblock=None):
    """Density and hit counts over 32-wide lists, hits per query subgroup
    (``groups=4``) or per block (``groups=1``). CPU tensors take the
    plain version; CUDA tensors launch the kernel (building it at first
    use) or raise."""
    _check(pos4, cand, count, qblock)
    if groups not in (1, GROUPS):
        raise ValueError(f"density_c32: groups must be 1 or {GROUPS}, not {groups}")
    if pos4.device.type == "cpu":
        return density_c32_torch(pos4, cand, count, params, groups, qblock)
    if pos4.device.type != "cuda":
        raise ValueError(f"density_c32: unsupported device {pos4.device}")
    nq, cap = cand.shape
    out = _launch("density_c32", pos4, cand, count, qblock, params,
                  (nq * groups, cap), groups)
    density_c32.launches += 1
    return out


density_c16_hit8.launches = 0
density_c32.launches = 0
