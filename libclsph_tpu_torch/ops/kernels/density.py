"""Density passes with true-hit counts: the CUDA kernels, their plain
PyTorch versions and the wrappers that pick between them by device.

Three kernels replace ``libclsph_tpu/ops/pallas/neighbor_nl.py``
``fused_density_nl`` and ``fused_density_gated16``:

* :func:`density_c16` at ``c16=True, hit_groups=4``: ``hit_sub`` 8 (the
  main path) or 16 (the 16-wide force path), the latter optionally with
  the dilated per-tile counts of ``hit2_h``; ``csrc/density_c16.cu``;
* :func:`density_c32` at ``c16=False`` with ``hit_groups`` 4 or 1 (the
  q-granular path, its tier 2 and the asm variant), at 4 groups with
  ``hit_sub`` 16 (the 16-wide force pass over 32-wide tables), and with
  no hit counts (``groups=0``: the densities of the row, fine and asym
  variants, ``ops/kernels/blocks.py``); at 1 or 0 groups also on finer
  query blocks, lists that serve ``rows`` = 64 or 32 queries
  (``nl_query_rows`` 64 or 32, ``block_size`` 64, asm at 32 rows);
  ``csrc/density_c32.cu``;
* :func:`density_gated16`, the reuse substep's c16 density at hit_sub 16
  over the (subgroup, tile) panels that a mask from
  :func:`pack_tile_nibbles` flags; ``csrc/density_gated16.cu``.

Inputs, for ``np`` particles in ``np / R`` query blocks of the R rows a
list serves (R = 128 but for ``density_c32``'s ``rows``):

* ``pos4`` (np, 4) float32: x, y, z and the real mask (1.0 / 0.0), from
  :func:`pos_pack`;
* ``cand`` (nq, cap) int32: candidate subblock ids (16 or 32 particles)
  per list row, dead slots ``REFINE_SENTINEL`` after ``count``;
* ``count`` (nq,) int32;
* ``qblock`` (nq,) int32 or None: the query block of each list row (the
  two-tier path runs gathered heavy blocks against the full ``pos4``);
  None is the identity, nq = np / R.

Outputs: ``density`` (nq*R,) float32 for the rows' queries (rest
density on padding queries) and ``hits`` int32. At 4 groups: (nq*4,
cap * sub / hit_sub), the pairs with r < h between query subgroup g
(rows g*32 .. g*32+31, row b*4 + g) and run e of ``hit_sub`` particles
of slot k (column k * sub / hit_sub + e). ``density_c32`` at
``groups=1``: (nq, cap), the particles of the slot within h of some
query of the block; at ``groups=0`` no counts ((0, cap) int32). With
``hit2_h``, ``tiles`` (nq*4, ceil(cap / 8)) counts the pairs within
``hit2_h`` between subgroup g and tile t (slots 8t .. 8t+7). Only
``hits > 0`` and ``tiles > 0`` are read downstream; the counts are the
JAX kernel's.

Every kernel but the gated one also has the JAX kernels' ``r2_mxu`` mode
(``StepConfig.pair_r2 = "mxu"``): r^2 by the identity |q|^2 + |c|^2 -
2 q.c on coordinates centred on the domain (``pos_pack``'s ``center``),
in the one order of :func:`pair_r2_identity`, clamped at 0. Its
rounding (about |p|^2 * 6e-8) moves support decisions near h, so the
mode has results of its own; the kernel and its plain version agree bit
for bit in it as in the direct form.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.params import SimulationParameters
from . import build

BLOCK = 128  # queries per block
GROUPS = 4  # query subgroups of 32 rows
TILE = 8  # candidate slots per tile of the dilated counts and the gate
TILES_PER_WORD = 32 // GROUPS  # tiles packed into one int32 mask word
DENSITY_ONLY = "densities only"  # density_c32's launch variant at groups=0
FINE_ROWS = (32, 64)  # the queries a list serves on finer query blocks
# pair elements per chunk of the plain versions
CHUNK_PAIRS = 1 << 24


def pos_pack(position: torch.Tensor, real: torch.Tensor, center=None) -> torch.Tensor:
    """(np, 4) float32 [x, y, z, real], the positions less ``center``
    ((3,) float32) where one is given (the identity mode's packs,
    neighbor_nl.py make_query_planes)."""
    if center is not None:
        position = position - center
    return torch.cat([position, real.to(torch.float32)[:, None]], dim=1).contiguous()


def norm2(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 over the last axis of (..., 3), as (x*x + y*y) + z*z."""
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def pair_r2_identity(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """r^2 of the JAX kernels' ``r2_mxu`` mode (neighbor.py ``_r2_mxu``)
    for queries ``q`` and candidates ``c`` ((..., 3), broadcast), in the
    one order the CUDA kernels take (sph_pair.cuh ``pair_r2_id``): the
    K = 5 dot [-2q, |q|^2, 1] . [c, 1, |c|^2] summed term by term, each
    product and sum rounded once, then clamped at 0 by ``fmax`` (a NaN,
    from two rows at the 1e32 sentinel, becomes 0 as fmaxf makes it)."""
    m = -2.0 * q
    s = m[..., 0] * c[..., 0]
    s = s + m[..., 1] * c[..., 1]
    s = s + m[..., 2] * c[..., 2]
    s = s + norm2(q)
    s = s + norm2(c)
    return torch.fmax(s, torch.zeros((), dtype=s.dtype, device=s.device))


def _f32(x: float) -> float:
    return float(np.float32(x))


def _consts(params: SimulationParameters):
    h = float(params.h)
    return dict(
        h2=_f32(h * h),
        poly6=_f32(params.precomputed().poly_6),
        mass=_f32(params.particle_mass),
        fluid_density=_f32(params.fluid_density),
    )


def _density_torch(pos4, cand, count, params, qblock, sub: int, hit_sub: int,
                   groups: int, hit2_h=None, panels=None, qrows: int = BLOCK,
                   r2_mxu: bool = False):
    """Plain density over ``sub``-particle candidate subblocks for lists
    that serve ``qrows`` queries each, with hit counts per (query subgroup
    of qrows/groups rows, run of ``hit_sub`` candidate particles); at
    groups=1 the count is of the run's particles that some query hits, at
    groups=0 there is none. ``hit2_h`` adds the dilated per-(subgroup,
    tile) pair counts; ``panels`` (nq, 4, cap) bool restricts the sums and
    counts to the flagged (subgroup, slot) panels; ``r2_mxu`` takes r^2
    by :func:`pair_r2_identity`. Chunked over list rows."""
    c = _consts(params)
    nq, cap = cand.shape
    dev = pos4.device
    runs = sub // hit_sub
    density = torch.empty(nq * qrows, dtype=torch.float32, device=dev)
    hits = torch.zeros((nq * groups, cap * runs), dtype=torch.int32, device=dev)
    ntiles = -(-cap // TILE)
    tiles = (None if hit2_h is None else
             torch.zeros((nq * GROUPS, ntiles), dtype=torch.int32, device=dev))
    slot = torch.arange(cap, device=dev)
    lane = torch.arange(sub, device=dev)
    qlane = torch.arange(qrows, device=dev)
    rows = max(1, CHUNK_PAIRS // (qrows * cap * sub))
    for b0 in range(0, nq, rows):
        b1 = min(nq, b0 + rows)
        r = b1 - b0
        live = slot[None, :] < count[b0:b1, None]  # (r, cap)
        ids = torch.where(live, cand[b0:b1], 0).to(torch.int64)[:, :, None] * sub + lane
        cp = pos4[ids]  # (r, cap, sub, 4)
        qb = (torch.arange(b0, b1, device=dev) if qblock is None
              else qblock[b0:b1].to(torch.int64))
        q = pos4[qb[:, None] * qrows + qlane].reshape(r, qrows, 1, 1, 4)
        cq = cp[:, None]
        if r2_mxu:
            r2 = pair_r2_identity(q[..., :3], cq[..., :3])  # (r, qrows, cap, sub)
        else:
            dx = q[..., 0] - cq[..., 0]
            dy = q[..., 1] - cq[..., 1]
            dz = q[..., 2] - cq[..., 2]
            r2 = (dx * dx + dy * dy) + dz * dz  # (r, qrows, cap, sub)
        live4 = live[:, None, :, None]
        if panels is not None:
            rows_on = panels[b0:b1, :, None, :].expand(r, GROUPS, qrows // GROUPS, cap)
            live4 = live4 & rows_on.reshape(r, qrows, cap, 1)
        t = torch.clamp(c["h2"] - r2, min=0.0)
        w = (c["poly6"] * cq[..., 3]) * (t * t * t)
        wsum = torch.where(live4, w, 0.0).sum(dim=(2, 3))
        real_q = q[:, :, 0, 0, 3] > 0
        density[b0 * qrows : b1 * qrows] = torch.where(
            real_q, c["mass"] * wsum, c["fluid_density"]
        ).reshape(-1)
        incl = (r2 < c["h2"]) & live4
        if groups == 1:
            cnt = incl.any(dim=1).reshape(r, 1, cap * runs, hit_sub).sum(
                dim=-1, dtype=torch.int32)
            hits[b0:b1] = cnt.reshape(r, cap * runs)
        elif groups:
            cnt = incl.reshape(r, groups, qrows // groups, cap, runs, hit_sub).sum(
                dim=(2, 5), dtype=torch.int32)
            hits[b0 * groups : b1 * groups] = cnt.reshape(r * groups, cap * runs)
        if tiles is not None:
            near = (r2 < _f32(hit2_h * hit2_h)) & live4
            per_slot = near.reshape(r, GROUPS, qrows // GROUPS, cap, sub).sum(
                dim=(2, 4), dtype=torch.int32)
            padded = torch.zeros((r, GROUPS, ntiles * TILE), dtype=torch.int32,
                                 device=dev)
            padded[..., :cap] = per_slot
            tiles[b0 * GROUPS : b1 * GROUPS] = padded.reshape(
                r * GROUPS, ntiles, TILE).sum(dim=-1, dtype=torch.int32)
    if tiles is not None:
        return density, hits, tiles
    return density, hits


def density_c16_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                      params: SimulationParameters, hit_sub: int = 8, hit2_h=None,
                      qblock=None, r2_mxu: bool = False):
    """Plain PyTorch version of :func:`density_c16`."""
    return _density_torch(pos4, cand, count, params, qblock, 16, hit_sub, GROUPS,
                          hit2_h=hit2_h, r2_mxu=r2_mxu)


def density_c32_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                      params: SimulationParameters, groups: int = GROUPS,
                      hit_sub: int = 32, qblock=None, rows: int = BLOCK,
                      r2_mxu: bool = False):
    """Plain PyTorch version of :func:`density_c32`."""
    return _density_torch(pos4, cand, count, params, qblock, 32, hit_sub, groups,
                          qrows=rows, r2_mxu=r2_mxu)


def pack_tile_nibbles(tiles: torch.Tensor) -> torch.Tensor:
    """(nb*4, ntiles) dilated per-tile counts (rows b*4 + g) -> (nb,
    ceil(ntiles / 8)) int32 words: bit (t % 8) * 4 + g of word t // 8 is
    set iff subgroup g of block b has a dilated pair in tile t
    (``neighbor_nl.py`` ``pack_tile_nibbles``, whose word per 8 tiles
    this keeps)."""
    rows, ntiles = tiles.shape
    nb = rows // GROUPS
    words = -(-ntiles // TILES_PER_WORD)
    flags = torch.zeros((nb, GROUPS, words * TILES_PER_WORD), dtype=torch.int64,
                        device=tiles.device)
    flags[..., :ntiles] = (tiles > 0).reshape(nb, GROUPS, ntiles)
    tile = torch.arange(words * TILES_PER_WORD, device=tiles.device)
    shift = (tile % TILES_PER_WORD)[None, :] * GROUPS + torch.arange(
        GROUPS, device=tiles.device)[:, None]
    bits = (flags << shift).reshape(nb, GROUPS, words, TILES_PER_WORD).sum(dim=(1, 3))
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)


def mask_panels(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """The (nb, 4, cap) bool (subgroup, slot) panels that ``mask`` flags:
    slot k lies in tile k // 8."""
    tile = torch.arange(cap, device=mask.device) // TILE
    words = (mask.to(torch.int64) & 0xFFFFFFFF)[:, tile // TILES_PER_WORD]  # (nb, cap)
    shift = (tile % TILES_PER_WORD)[None, :] * GROUPS + torch.arange(
        GROUPS, device=mask.device)[:, None]
    return ((words[:, None, :] >> shift) & 1).bool()


def density_gated16_torch(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                          mask: torch.Tensor, params: SimulationParameters):
    """Plain PyTorch version of :func:`density_gated16`: the c16 density
    at hit_sub 16 with every pair outside the flagged panels dropped."""
    return _density_torch(pos4, cand, count, params, None, 16, 16, GROUPS,
                          panels=mask_panels(mask, cand.shape[1]))


def _check(pos4, cand, count, qblock, extra=(), rows: int = BLOCK):
    if pos4.dtype != torch.float32 or pos4.dim() != 2 or pos4.shape[1] != 4:
        raise ValueError("pos4 must be (np, 4) float32")
    if pos4.shape[0] % rows:
        raise ValueError(f"particle count {pos4.shape[0]} is not a multiple of {rows}")
    nb = pos4.shape[0] // rows
    if cand.dtype != torch.int32 or cand.dim() != 2:
        raise ValueError("cand must be (nq, cap) int32")
    nq = cand.shape[0]
    if qblock is None:
        if nq != nb:
            raise ValueError(f"cand must have np/{rows} rows without a qblock map")
    elif qblock.dtype != torch.int32 or qblock.shape != (nq,):
        raise ValueError("qblock must be (nq,) int32")
    if count.dtype != torch.int32 or count.shape != (nq,):
        raise ValueError("count must be (nq,) int32")
    named = (("pos4", pos4), ("cand", cand), ("count", count)) + (
        () if qblock is None else (("qblock", qblock),)) + tuple(extra)
    for name, t in named:
        if t.device != pos4.device:
            raise ValueError(f"{name} is on {t.device}, pos4 on {pos4.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _device(name, pos4):
    """True for CPU tensors (the plain version), False for CUDA ones;
    raises on any other device."""
    if pos4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {pos4.device}")
    return pos4.device.type == "cpu"


def _count(fn, variant: str) -> None:
    fn.launches += 1
    fn.variants[variant] = fn.variants.get(variant, 0) + 1


def _mode(r2_mxu: bool) -> str:
    """The suffix of an identity-mode launch's variant name."""
    return ", mxu" if r2_mxu else ""


def _launch(entry, pos4, cand, count, table, mode, consts, hit_shape, tile_shape=None,
            rows: int = BLOCK, r2_mxu: bool = False):
    """Launch C entry point ``entry`` (its ``_mxu`` twin with ``r2_mxu``)
    on (pos4, cand, count, ``table``: the qblock map or the gate mask)
    with its integer ``mode`` arguments and float ``consts`` for lists of
    ``rows`` queries; density_c16's entry also takes the tile counts (a
    null pointer without ``tile_shape``)."""
    nq, cap = cand.shape
    density = torch.empty(nq * rows, dtype=torch.float32, device=pos4.device)
    hits = torch.zeros(hit_shape, dtype=torch.int32, device=pos4.device)
    tiles = (None if tile_shape is None else
             torch.zeros(tile_shape, dtype=torch.int32, device=pos4.device))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outs = (density.data_ptr(), hits.data_ptr())
    if entry == "density_c16":
        outs += (ptr(tiles),)
    stream = torch.cuda.current_stream(pos4.device).cuda_stream
    status = getattr(build.load_library(), entry + ("_mxu" if r2_mxu else "") + "_launch")(
        pos4.data_ptr(), cand.data_ptr(), count.data_ptr(), ptr(table), nq, cap, *mode,
        *consts, *outs, stream,
    )
    build.check(status, entry)
    return (density, hits) if tiles is None else (density, hits, tiles)


def _kernel_consts(params, *h2_dil):
    c = _consts(params)
    return (c["h2"], *h2_dil, c["poly6"], c["mass"], c["fluid_density"])


def density_c16(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                params: SimulationParameters, hit_sub: int = 8, hit2_h=None,
                qblock=None, r2_mxu: bool = False):
    """Density and hit counts over 16-wide lists at ``hit_sub`` 8 or 16;
    with ``hit2_h`` (hit_sub 16 only) also the dilated per-tile counts,
    returned third; ``r2_mxu``: r^2 by the identity (on a centred pack).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (building it at first use) or raise."""
    _check(pos4, cand, count, qblock)
    if hit_sub not in (8, 16) or (hit2_h is not None and hit_sub != 16):
        raise ValueError(f"density_c16: hit_sub must be 8 or 16 (16 with hit2_h), "
                         f"not {hit_sub}")
    if _device("density_c16", pos4):
        return density_c16_torch(pos4, cand, count, params, hit_sub, hit2_h, qblock,
                                 r2_mxu)
    nq, cap = cand.shape
    tile_shape = None if hit2_h is None else (nq * GROUPS, -(-cap // TILE))
    h2_dil = 0.0 if hit2_h is None else _f32(hit2_h * hit2_h)
    out = _launch("density_c16", pos4, cand, count, qblock, (hit_sub,),
                  _kernel_consts(params, h2_dil), (nq * GROUPS, cap * 16 // hit_sub),
                  tile_shape, r2_mxu=r2_mxu)
    _count(density_c16, f"hit_sub {hit_sub}" + ("" if hit2_h is None else ", hit2_h")
           + _mode(r2_mxu))
    return out


def density_c32(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                params: SimulationParameters, groups: int = GROUPS, hit_sub: int = 32,
                qblock=None, rows: int = BLOCK, r2_mxu: bool = False):
    """Density and hit counts over 32-wide lists, hits per query subgroup
    (``groups=4``, at ``hit_sub`` 32 or 16), per block (``groups=1``,
    hit_sub 32) or none (``groups=0``, hit_sub 32: the hits are (0, cap)).
    ``rows``: the queries a list row serves, 128, or 64 and 32 on finer
    query blocks (groups 1 or 0 there; ``qblock`` counts blocks of
    ``rows``). CPU tensors take the plain version; CUDA tensors launch
    the kernel (building it at first use) or raise."""
    _check(pos4, cand, count, qblock, rows=rows)
    if (groups, hit_sub) not in ((GROUPS, 32), (1, 32), (GROUPS, 16), (0, 32)):
        raise ValueError(f"density_c32: groups must be 0, 1 or {GROUPS} and hit_sub 32, "
                         f"or groups {GROUPS} at hit_sub 16; not ({groups}, {hit_sub})")
    if rows not in FINE_ROWS + (BLOCK,) or (rows != BLOCK and groups not in (0, 1)):
        raise ValueError(f"density_c32: rows must be {BLOCK}, or {FINE_ROWS} at groups 0 "
                         f"or 1; not rows {rows} at groups {groups}")
    if _device("density_c32", pos4):
        return density_c32_torch(pos4, cand, count, params, groups, hit_sub, qblock, rows,
                                 r2_mxu)
    nq, cap = cand.shape
    if rows == BLOCK:
        out = _launch("density_c32", pos4, cand, count, qblock, (groups, hit_sub),
                      _kernel_consts(params), (nq * groups, cap * 32 // hit_sub),
                      r2_mxu=r2_mxu)
        _count(density_c32, (f"groups {groups}, hit_sub {hit_sub}" if groups
                             else DENSITY_ONLY) + _mode(r2_mxu))
    else:
        out = _launch("density_c32_rows", pos4, cand, count, qblock, (groups, rows),
                      _kernel_consts(params), (nq * groups, cap), rows=rows, r2_mxu=r2_mxu)
        _count(density_c32, (f"groups 1, rows {rows}" if groups
                             else f"{DENSITY_ONLY}, rows {rows}") + _mode(r2_mxu))
    return out


def density_gated16(pos4: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                    mask: torch.Tensor, params: SimulationParameters):
    """Reuse-substep density and hit_sub-16 counts over a carried 16-wide
    table (nb rows), gated by ``mask`` ((nb, ceil(cap / 64)) int32 from
    :func:`pack_tile_nibbles`). CPU tensors take the plain version; CUDA
    tensors launch the kernel (building it at first use) or raise."""
    _check(pos4, cand, count, None, (("mask", mask),))
    nb, cap = cand.shape
    words = -(-cap // (TILE * TILES_PER_WORD))
    if mask.dtype != torch.int32 or mask.shape != (nb, words):
        raise ValueError(f"mask must be ({nb}, {words}) int32 for cap {cap}")
    if _device("density_gated16", pos4):
        return density_gated16_torch(pos4, cand, count, mask, params)
    out = _launch("density_gated16", pos4, cand, count, mask, (words,),
                  _kernel_consts(params), (nb * GROUPS, cap))
    _count(density_gated16, "hit_sub 16")
    return out


for _fn in (density_c16, density_c32, density_gated16):
    _fn.launches = 0
    _fn.variants = {}
