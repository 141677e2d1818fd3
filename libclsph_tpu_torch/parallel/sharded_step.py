"""The Morton-partitioned sharded substep and frame over ``torch.distributed``.

PyTorch counterpart of ``libclsph_tpu/parallel/sharded_step.py``. Each
shard is a rank (:mod:`parallel.mesh`) holding ``n_local`` rows of the
state that :func:`pad_for_mesh` Morton-partitions once on the host
(sentinel rows sit at 1e32 and stay frozen). Per substep, on every rank:

1. global bounds over the real rows (one ``all_reduce`` of the negated
   minima and the maxima) and the 10-bit Morton guard;
2. the local sort by Morton code under the global grid (skipped on
   reuse substeps);
3. the local blocks' split boxes and one of three exchanges of block
   tables, each giving a combined candidate table in JAX's layout, row
   for row:

   * ``all_gather``: every rank's blocks, the queries at rows
     ``rank * n_local`` onward;
   * ``halo``: the local blocks, then ``world * halo_max`` gathered
     surface blocks (blocks whose dilated boxes reach another rank's
     box), this rank's own rows dead;
   * ``ring``: the local blocks, then the surface blocks of the ranks
     ``halo_hops`` hops forward and then backward (point-to-point), with
     ``FLAG_EXCHANGE`` when a rank whose box overlaps is out of reach;

4. the block search against the combined table, the refine and the nl
   kernels through the port's wrappers, the queries read through their
   ``qblock`` argument (the offset of the local blocks in the combined
   table). The kernels exclude self by index in the one array they read,
   which equals JAX's exclusion by global id because each live particle
   appears once in the combined table. The force pack ``(n_local, 8)``
   is exchanged once a substep. ``neighbor_impl`` other than pallas runs
   the tiles passes over the combined table, as in JAX;
5. the adaptive dt on maxima reduced over the ranks inside the retry,
   the status flags OR'd per bit (a maximum per bit) and, with the
   stale-reuse guard's displacement, folded into the first of those
   reductions.

As in JAX, the sharded passes run the nl kernels whatever
``pallas_variant`` says, never gate the density and keep the 16-wide
force pass (``force_sub8`` off); :func:`mesh_config` makes that explicit
and logs it once.

Every Python branch that decides whether a rank calls a collective reads
only values already reduced over the ranks (the dt retry, rebuild or
reuse, the frame's time left), so no rank waits on a collective that
another skips.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import FIELDS, ParticleState
from ..engine import step as step_mod
from ..engine.step import (
    FLAG_CAND_STALE,
    FLAG_CAPACITY,
    FLAG_CAPACITY_SUB,
    FLAG_EXCHANGE,
    FLAG_GRID_DIM,
    StepConfig,
)
from ..ops import grid as grid_ops
from ..ops import integrate as integrate_ops
from ..ops import interactions as interactions_ops
from ..ops import kernels
from ..ops import tiles as tiles_ops
from ..utils.logging import get_logger
from .mesh import Mesh, morton_partition, shard_rows

EXCHANGES = ("all_gather", "halo", "ring")
FAR = 1.0e32  # sentinel position of the padding rows (sharded_step.py:1109)
LIVE_LIMIT = 1.0e30  # rows beyond it are sentinels
FLAG_BITS = 8  # the status word's bits, OR'd one by one
_INF = 3.0e38

log = get_logger(__name__)
_logged = set()


def mesh_config(config: StepConfig) -> StepConfig:
    """The config the sharded passes run (sharded_step.py:79-373): the
    pallas impl runs the nl kernels whatever ``pallas_variant`` says,
    without the density gate and with the 16-wide force pass (JAX's
    ``cli.py:161`` turns ``force_sub8`` off under the mesh). Logs once
    what it changes."""
    if config.neighbor_impl != "pallas":
        return config
    changed = dict(pallas_variant="nl", density_gate=False, force_sub8=False)
    changed = {k: v for k, v in changed.items() if getattr(config, k) != v}
    if not changed:
        return config
    key = tuple(sorted(changed))
    if key not in _logged:
        _logged.add(key)
        log.info("sharded passes: the nl kernels run as in JAX's sharded step; "
                 "ignoring %s", {k: getattr(config, k) for k in changed})
    return dataclasses.replace(config, **changed)


# ---- host-side partition ------------------------------------------------------

def pad_for_mesh(state: ParticleState, params: SimulationParameters, n_shards: int,
                 config: StepConfig) -> ParticleState:
    """Morton-partition the state and pad it to a whole number of
    ``n_shards * block_size`` rows (sharded_step.py:1090-1120): sentinel
    rows at 1e32 with the rest density and zeros elsewhere. Rank r takes
    rows :func:`parallel.mesh.shard_rows` of the result."""
    n = state.n
    chunk = n_shards * config.block_size
    n_pad = (-n) % chunk
    order = torch.from_numpy(morton_partition(state.position.cpu().numpy(), n_shards))
    state = state.map(lambda a: a[order.to(a.device)])
    if n_pad:
        state = state.map(lambda a: torch.cat(
            [a, torch.zeros((n_pad,) + a.shape[1:], dtype=a.dtype, device=a.device)]))
        position, density = state.position.clone(), state.density.clone()
        position[n:] = FAR
        density[n:] = params.fluid_density
        state = state.replace(position=position, density=density)
    return state


def local_rows(state: ParticleState, rank: int, world: int) -> ParticleState:
    """Rank ``rank``'s rows of a padded, partitioned state."""
    rows = shard_rows(state.n, rank, world)
    return state.map(lambda a: a[rows].contiguous())


def default_halo_max(n: int, world: int, block_size: int) -> int:
    """The surface budget when none is given: every local block
    (simulation.py:403-406)."""
    chunk = world * block_size
    return -(-n // chunk) * chunk // chunk


def live_rows(position: torch.Tensor) -> torch.Tensor:
    """The real rows: finite and inside 1e30 (sentinels sit at 1e32)."""
    return torch.isfinite(position).all(dim=1) & (position.abs().amax(dim=1) < LIVE_LIMIT)


# ---- the exchange -----------------------------------------------------------

def _dead_rows(pack: torch.Tensor, live: torch.Tensor, cols) -> torch.Tensor:
    """Zero the real-mask columns ``cols`` of ``pack`` (K, B, C) on the
    blocks where ``live`` (K,) is False (JAX's ``real & surf_valid`` and
    ``real & ~mine``)."""
    mask = torch.ones(pack.shape[-1], dtype=torch.bool, device=pack.device)
    mask[list(cols)] = False
    keep = live[:, None, None] | mask
    return torch.where(keep, pack, 0.0)


class Exchange:
    """The combined candidate table of one substep. ``qoff``: the row of
    the first query in it; ``self_index`` (nb_local,): each local block's
    index in it; ``combine(pack, real_cols)`` -> the (n_comb, C) table of
    a local per-particle float pack (n_local, C) in the exchange's layout,
    the real-mask columns ``real_cols`` zeroed on dead rows."""

    def __init__(self, mesh: Mesh, kind: str, nb_local: int, bsize: int, surf=None,
                 hops=(0, 0), halo_max: int = 0):
        self.mesh, self.kind, self.bsize = mesh, kind, bsize
        self.surf, self.hops, self.halo_max = surf, hops, halo_max
        dev = mesh.device
        local = torch.arange(nb_local, dtype=torch.int32, device=dev)
        if kind == "all_gather":
            self.self_index = mesh.rank * nb_local + local
            self.qoff = mesh.rank * nb_local * bsize
        else:
            self.self_index = local
            self.qoff = 0

    def surface(self, pack: torch.Tensor, real_cols) -> torch.Tensor:
        """The local surface blocks of ``pack`` (halo_max, B, C), dead
        where the surface set has no block."""
        idx, valid = self.surf
        blocks = pack.reshape(-1, self.bsize, pack.shape[-1])[idx.long()]
        return _dead_rows(blocks, valid, real_cols)

    def mine(self) -> torch.Tensor:
        """(world * halo_max,) bool: this rank's rows of the gathered
        surface table."""
        rows = torch.arange(self.mesh.world * self.halo_max, device=self.mesh.device)
        return rows // self.halo_max == self.mesh.rank

    def assemble(self, pack, real_cols, remote) -> torch.Tensor:
        """Local rows, then the received surface blocks."""
        c = pack.shape[-1]
        if self.kind == "halo":
            remote = [_dead_rows(remote[0], ~self.mine(), real_cols)]
        return torch.cat([pack] + [r.reshape(-1, c) for r in remote])

    def combine(self, pack: torch.Tensor, real_cols=()) -> torch.Tensor:
        if self.kind == "all_gather":
            return self.mesh.all_gather(pack)
        surf = self.surface(pack, real_cols)
        if self.kind == "halo":
            remote = [self.mesh.all_gather(surf)]
        else:
            remote = [hop[0] for hop in self.mesh.ring([surf], *self.hops)]
        return self.assemble(pack, real_cols, remote)


def _reach(bmin, bmax, lo, hi, hdil):
    """(nb,) bool: some split box of a block, dilated by ``hdil``, overlaps
    some box [lo, hi] (S', 3)."""
    return torch.any(torch.all(
        (bmin[:, :, None, :] - hdil <= hi[None, None]) & (bmax[:, :, None, :] + hdil >= lo[None, None]),
        dim=-1), dim=(1, 2))


def exchange_tables(mesh: Mesh, kind: str, bmin, bmax, pos4, local_min, local_max,
                    h_search: float, config: StepConfig, halo_max: int, halo_hops: int,
                    carried=None):
    """Step 3 (sharded_step.py:513-757): the exchange of block tables.
    Returns (Exchange, pos4 over the combined table, cand, count,
    overflow, exchange_bad, (surf_idx, surf_valid) or None). On a reuse
    substep (``carried``: the build substep's surface set, or () under
    all_gather) the block search is skipped (cand and count None) and
    only the positions travel."""
    dev = mesh.device
    nb_local, bsize = bmin.shape[0], pos4.shape[0] // bmin.shape[0]
    cap = config.max_candidates
    false = torch.zeros((), dtype=torch.bool, device=dev)
    build = carried is None
    if kind == "all_gather":
        ex = Exchange(mesh, kind, nb_local, bsize)
        if not build:
            return ex, mesh.all_gather(pos4), None, None, false, false, None
        g_bmin, g_bmax, pos4_c = mesh.all_gather_many([bmin, bmax, pos4])
        cand, count, ovf = tiles_ops.candidate_blocks(
            bmin, bmax, h_search, cap, g_bmin, g_bmax, self_index=ex.self_index)
        return ex, pos4_c, cand, count, ovf, false, None

    world, rank = mesh.world, mesh.rank
    hops = (0, 0)
    if kind == "ring":
        r_fwd = min(halo_hops, world // 2)
        hops = (r_fwd, min(halo_hops, world - 1 - r_fwd))
    exchange_bad = false
    if build:
        sh = mesh.all_gather(torch.cat([local_min, local_max])[None])  # (world, 6)
        sh_min, sh_max = sh[:, :3], sh[:, 3:]
        jidx = torch.arange(world, device=dev)
        if kind == "halo":
            near = jidx != rank
        else:
            fwd_d = torch.remainder(jidx - rank, world)
            bwd_d = torch.remainder(rank - jidx, world)
            near = ((fwd_d >= 1) & (fwd_d <= hops[0])) | ((bwd_d >= 1) & (bwd_d <= hops[1]))
            overlap = torch.all((local_min[None] - h_search <= sh_max)
                                & (local_max[None] + h_search >= sh_min), dim=-1)
            exchange_bad = torch.any(overlap & ~near & (jidx != rank))
        lo = torch.where(near[:, None], sh_min, _INF)
        hi = torch.where(near[:, None], sh_max, -_INF)
        surf_idx, surf_valid, surf_ovf = tiles_ops.compact_mask(
            _reach(bmin, bmax, lo, hi, h_search), halo_max)
    else:
        surf_idx, surf_valid = carried
    ex = Exchange(mesh, kind, nb_local, bsize, surf=(surf_idx, surf_valid), hops=hops,
                  halo_max=halo_max)
    if not build:
        return ex, ex.combine(pos4, (3,)), None, None, false, false, (surf_idx, surf_valid)
    surf_pos = ex.surface(pos4, (3,))
    live = surf_valid[:, None, None]
    s_bmin = torch.where(live, bmin[surf_idx.long()], _INF)
    s_bmax = torch.where(live, bmax[surf_idx.long()], -_INF)
    if kind == "halo":
        g_bmin, g_bmax, g_pos = mesh.all_gather_many([s_bmin, s_bmax, surf_pos])
        mine = ex.mine()[:, None, None]
        # this rank's own surface rows must not duplicate its local blocks
        r_bmin = [torch.where(mine, _INF, g_bmin)]
        r_bmax = [torch.where(mine, -_INF, g_bmax)]
        r_pos = [g_pos]
    else:
        recv = mesh.ring([s_bmin, s_bmax, surf_pos], *hops)
        r_bmin, r_bmax, r_pos = ([hop[k] for hop in recv] for k in range(3))
    comb_bmin = torch.cat([bmin] + r_bmin)
    comb_bmax = torch.cat([bmax] + r_bmax)
    cand, count, cand_ovf = tiles_ops.candidate_blocks(
        bmin, bmax, h_search, cap, comb_bmin, comb_bmax, self_index=ex.self_index)
    pos4_c = ex.assemble(pos4, (3,), r_pos)
    return (ex, pos4_c, cand, count, cand_ovf | surf_ovf, exchange_bad,
            (surf_idx, surf_valid))


# ---- the passes ---------------------------------------------------------------

def nl_passes(state_s, valid_s, bmin, bmax, cand, count, ex: Exchange, pos4_c,
              params: SimulationParameters, config: StepConfig, cand_in=None,
              h_search=None, record=None, center=None):
    """Step 4 on the pallas impl (``_nl_passes``, sharded_step.py:79-373)
    over the combined table ``pos4_c``: the refine from the block lists
    (skipped with ``cand_in`` = the carried (cand_sub, count_sub)), the
    density kernel, hit compaction and the force kernel, or their
    two-tier form, all through :mod:`engine.step`'s helpers with the
    queries at ``qblock``. ``record``: a dict that receives the tables.
    ``center`` (the identity mode's, from the global bounds, the same on
    every rank): the kernels' packs are taken less it, after the refine
    has read the exchanged positions as they are.
    Returns (density, pressure, accel, flags, (cand_sub, count_sub))."""
    bsize, q_rows, q_rep = config.block_size, config.q_rows, config.q_rep
    n = valid_s.shape[0]
    nb = n // bsize
    nq = nb * q_rep
    sub = bsize // config.subblock
    dev = valid_s.device
    qblock = (ex.qoff // q_rows
              + torch.arange(nq, dtype=torch.int32, device=dev)).to(torch.int32)
    self_lo = torch.repeat_interleave(ex.self_index, q_rep) * sub
    pos_s = state_s.position
    if cand_in is not None:
        cand_sub, count_sub = cand_in
        flags = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        cap_sub = config.max_candidates_sub * (config.tier2_mult if config.two_tier else 1)
        h_refine = params.h if h_search is None else h_search
        cand_q = torch.repeat_interleave(cand, q_rep, dim=0) if q_rep > 1 else cand
        count_q = torch.repeat_interleave(count, q_rep) if q_rep > 1 else count
        pos_c = pos4_c[:, :3].reshape(-1, bsize, 3)
        if config.refine_mode == "exact":
            if q_rep > 1:
                qlo, qhi = tiles_ops.split_block_bounds(pos_s.reshape(nq, q_rows, 3),
                                                        valid_s.reshape(nq, q_rows))
            else:
                qlo, qhi = bmin, bmax
            cand_sub, count_sub, ovf = tiles_ops.refine_candidates_exact(
                cand_q, count_q, qlo, qhi, pos_c, h_refine, sub, cap_sub,
                self_lo=self_lo, self_width=sub)
        else:
            sub_lo, sub_hi = tiles_ops.subblock_bounds(
                pos_c, (pos4_c[:, 3] > 0).reshape(-1, bsize), sub)
            if q_rep > 1:
                qlo, qhi = tiles_ops.subblock_bounds(pos_s.reshape(nb, bsize, 3),
                                                     valid_s.reshape(nb, bsize), q_rep)
                qlo, qhi = qlo[:, None, :], qhi[:, None, :]
            else:
                qlo, qhi = bmin, bmax
            cand_sub, count_sub, ovf = tiles_ops.refine_candidates(
                cand_q, count_q, qlo, qhi, sub_lo, sub_hi, h_refine, sub, cap_sub,
                self_lo=self_lo, self_width=sub)
        flags = ovf.to(torch.int32) * FLAG_CAPACITY_SUB
    n_c = pos4_c.shape[0]
    rows = slice(ex.qoff, ex.qoff + n)
    if center is not None:
        pos4_c = torch.cat([pos4_c[:, :3] - center, pos4_c[:, 3:]], dim=1)

    def force_fields(density):
        """The force kernels' (pressure, f8, density, real) over the
        combined table: the local pack exchanged once; the density and
        real mask are read at the query rows only."""
        pressure = torch.where(valid_s, interactions_ops.tait_pressure(density, params), 0.0)
        f8 = kernels.force_pack(pos_s, state_s.velocity, density, pressure, valid_s,
                                params.particle_mass, center=center)
        f8_c = ex.combine(f8, (6, 7))
        dens_c = torch.zeros(n_c, dtype=torch.float32, device=dev)
        real_c = torch.zeros(n_c, dtype=torch.bool, device=dev)
        dens_c[rows] = density
        real_c[rows] = valid_s
        if record is not None:
            record.update(f8=f8_c, density_c=dens_c, real_c=real_c)
        return pressure, f8_c, dens_c, real_c

    if record is not None:
        record.update(pos4=pos4_c, cand=cand, count=count, cand_sub=cand_sub,
                      count_sub=count_sub, qblock=qblock)
    if config.two_tier:
        density, pressure, accel, flags = step_mod.two_tier_passes(
            None, None, pos4_c, params, config, cand_sub, count_sub, flags,
            qblock=qblock, force_fields=force_fields)
        return density, pressure, accel, flags, (cand_sub, count_sub)
    groups = step_mod._groups(config, 1)
    density, hits = step_mod._density_pass(pos4_c, cand_sub, count_sub, params, config,
                                           groups, qblock=qblock)
    if config.hit_compact:
        cand_f, count_f, hit_flags = step_mod.hit_lists(cand_sub, hits, config, groups,
                                                        qblock=qblock)
        flags = flags + hit_flags
    else:
        cand_f, count_f = cand_sub.contiguous(), count_sub.contiguous()
    pressure, f8_c, dens_c, real_c = force_fields(density)
    if record is not None:
        record.update(density=density, hits=hits, cand_f=cand_f, count_f=count_f)
    accel = step_mod._force_pass(f8_c, dens_c, real_c, cand_f, count_f, params, config,
                                 groups, qblock=qblock)
    return density, pressure, accel, flags, (cand_sub, count_sub)


def tiles_passes(state_s, valid_s, cand, count, ex: Exchange, pos4_c,
                 params: SimulationParameters, config: StepConfig):
    """Step 4 off the pallas impl (sharded_step.py:786-801): the tiles
    impl's dense pair tiles over the combined table, self excluded by the
    row in it. Returns (density, pressure, accel)."""
    bsize = config.block_size
    n_c = pos4_c.shape[0]
    blocked = tiles_ops.make_blocked(state_s.position, state_s.velocity, state_s.density,
                                     state_s.pressure, valid_s, bsize, gid_offset=ex.qoff)
    pos_c = pos4_c[:, :3].reshape(-1, bsize, 3)
    real_c = (pos4_c[:, 3] > 0).reshape(-1, bsize)
    gid_c = torch.arange(n_c, dtype=torch.int32, device=pos4_c.device).reshape(-1, bsize)
    pos_fields = tiles_ops.BlockedFields(position=pos_c, velocity=pos_c, density=real_c,
                                         pressure=real_c, real=real_c, gid=gid_c)
    density = tiles_ops.density_pass(blocked, cand, count, params, cand_fields=pos_fields,
                                     mode=config.tile_mode)
    pressure = torch.where(valid_s, interactions_ops.tait_pressure(density, params), 0.0)
    blocked = blocked._replace(density=density.reshape(blocked.real.shape),
                               pressure=pressure.reshape(blocked.real.shape))
    pack = torch.cat([state_s.position, state_s.velocity, density[:, None],
                      pressure[:, None], valid_s.to(torch.float32)[:, None]], dim=1)
    tc = ex.combine(pack, (8,))
    cf = tiles_ops.BlockedFields(
        position=tc[:, :3].reshape(-1, bsize, 3), velocity=tc[:, 3:6].reshape(-1, bsize, 3),
        density=tc[:, 6].reshape(-1, bsize), pressure=tc[:, 7].reshape(-1, bsize),
        real=(tc[:, 8] > 0).reshape(-1, bsize), gid=gid_c)
    accel = tiles_ops.force_pass(blocked, cand, count, params, cand_fields=cf,
                                 mode=config.tile_mode)
    return density, pressure, accel


# ---- the substep ------------------------------------------------------------

def _freeze(new: ParticleState, old: ParticleState, live: torch.Tensor) -> ParticleState:
    """Sentinel rows keep their old values."""
    return ParticleState(**{
        k: torch.where(live.reshape((-1,) + (1,) * (getattr(new, k).dim() - 1)),
                       getattr(new, k), getattr(old, k))
        for k in FIELDS})


def local_substep(mesh: Mesh, state: ParticleState, dt: torch.Tensor,
                  params: SimulationParameters, scene, config: StepConfig,
                  exchange: str = "all_gather", halo_max: int = 0, halo_hops: int = 1,
                  do_sort: bool = True, cand_in=None, record=None,
                  speculative: bool = False):
    """One substep of rank ``mesh.rank`` over its ``n_local`` rows
    (``_local_substep``, sharded_step.py:375-870). ``cand_in``: the
    carried dict of a build substep (cand_sub, count_sub, anchor, and
    surf_idx / surf_valid under halo and ring) on a reuse substep, which
    must not sort. ``record``: a dict that receives the exchanged tables.
    Returns (state, dt, flags, cand_out); ``flags`` is the same on every
    rank; ``cand_out`` is the carry when ``cand_interval > 1``, else
    None. ``speculative``: no host read and no dt retry; returns
    :func:`engine.step.substep`'s six speculative values instead."""
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, not {exchange!r}")
    config = mesh_config(config)
    dev = state.device
    bsize = config.block_size
    n_local = state.n
    if n_local % bsize:
        raise ValueError(f"{n_local} local rows are not whole blocks of {bsize} "
                         "(pad with pad_for_mesh)")
    nb_local = n_local // bsize
    reuse_on = config.cand_interval > 1
    is_reuse = cand_in is not None
    if reuse_on and config.neighbor_impl != "pallas":
        raise ValueError("sharded candidate reuse requires the pallas impl")
    if is_reuse and do_sort:
        raise ValueError("sharded reuse substeps must skip the sort (the carried ids "
                         "index the build substep's local order)")
    if exchange != "all_gather" and halo_max < 1:
        raise ValueError(f"the {exchange} exchange needs halo_max >= 1")
    h_search = params.h * (1.0 + config.cand_slack) if reuse_on else params.h

    # 1. global bounds over the real rows
    valid = live_rows(state.position)
    local_min = torch.where(valid[:, None], state.position, _INF).amin(dim=0)
    local_max = torch.where(valid[:, None], state.position, -_INF).amax(dim=0)
    ext = mesh.all_reduce_max(torch.cat([-local_min, local_max]))
    # the identity mode's centre, alike on every rank (sharded_step.py:765)
    center = 0.5 * (-ext[:3] + ext[3:]) if config.r2_mxu else None
    cell = torch.tensor(params.cell_side, dtype=torch.float32, device=dev)
    gmin, gmax = -ext[:3] - 2.0 * cell, ext[3:] + 2.0 * cell
    grid = grid_ops.GridInfo(min_point=gmin, max_point=gmax,
                             grid_size=((gmax - gmin) * (1.0 / cell)).to(torch.int32),
                             cell_side=cell)
    grid_bad = torch.any(grid.grid_size >= morton.MAX_GRID_DIM) | (
        grid_ops.grid_exceeds_sort_bits(grid.grid_size))

    # 2. the local sort, under the global grid
    if do_sort:
        codes = torch.where(valid, grid_ops.locate_in_grid(state.position, grid),
                            tiles_ops.SENTINEL_CODE)
        state_s, _, order = grid_ops.sort_by_cell(state, codes)
        valid_s = valid[order]
    else:
        state_s, valid_s = state, valid

    # the carried tables' staleness: the displacement since the anchor,
    # its maximum reduced with the flags below
    d2max = torch.zeros((), dtype=torch.float32, device=dev)
    if is_reuse:
        d2 = torch.sum((state_s.position - cand_in["anchor"]) ** 2, dim=1)
        d2max = torch.amax(torch.where(valid_s, d2, 0.0))

    # 3. blocks and the exchange
    pos_b = state_s.position.reshape(nb_local, bsize, 3)
    bmin, bmax = tiles_ops.split_block_bounds(pos_b, valid_s.reshape(nb_local, bsize))
    pos4 = kernels.pos_pack(state_s.position, valid_s)
    carried = None
    if is_reuse:
        carried = (() if exchange == "all_gather"
                   else (cand_in["surf_idx"], cand_in["surf_valid"]))
    ex, pos4_c, cand, count, overflow, exchange_bad, surf = exchange_tables(
        mesh, exchange, bmin, bmax, pos4, local_min, local_max, h_search, config,
        halo_max, halo_hops, carried)

    # 4. density and forces over the combined table
    cand_out = None
    if config.neighbor_impl == "pallas":
        density, pressure, accel, nl_flags, tables = nl_passes(
            state_s, valid_s, bmin, bmax, cand, count, ex, pos4_c, params, config,
            cand_in=(cand_in["cand_sub"], cand_in["count_sub"]) if is_reuse else None,
            h_search=h_search if reuse_on else None, record=record, center=center)
        cap_flags = overflow.to(torch.int32) * FLAG_CAPACITY + nl_flags
        if reuse_on:
            cand_out = cand_in if is_reuse else dict(
                cand_sub=tables[0], count_sub=tables[1], anchor=state_s.position)
            if not is_reuse and surf is not None:
                cand_out.update(surf_idx=surf[0], surf_valid=surf[1])
    else:
        density, pressure, accel = tiles_passes(state_s, valid_s, cand, count, ex, pos4_c,
                                                params, config)
        cap_flags = overflow.to(torch.int32) * FLAG_CAPACITY
    density = torch.where(valid_s, density, params.fluid_density)
    accel = torch.where(valid_s[:, None], accel, 0.0)
    state_s = state_s.replace(density=density, pressure=pressure, acceleration=accel)

    # 5. adaptive dt on reduced maxima; the first reduction also carries
    # the flag bits and the staleness displacement
    flags = (cap_flags + grid_bad.to(torch.int32) * FLAG_GRID_DIM
             + exchange_bad.to(torch.int32) * FLAG_EXCHANGE)
    if record is not None:
        record["local_flags"] = flags
    bit = torch.arange(FLAG_BITS, dtype=torch.int32, device=dev)
    extra = torch.cat([((flags >> bit) & 1).to(torch.float32), d2max[None]])

    def advance(dt_try, extra=None):
        new = _freeze(step_mod._advect_collide(state_s, scene, dt_try, params), state_s,
                      valid_s)
        mv2 = torch.amax(torch.where(valid_s, torch.sum(new.velocity ** 2, dim=-1), 0.0))
        ma2 = torch.amax(torch.where(valid_s, torch.sum(new.acceleration ** 2, dim=-1), 0.0))
        parts = [torch.stack([mv2, ma2])] + ([] if extra is None else [extra])
        red = mesh.all_reduce_max(torch.cat(parts))
        mv2, ma2 = red[0], red[1]
        max_vel = torch.sqrt(mv2)
        max_accel = torch.clamp(torch.sqrt(ma2), min=1e-12)
        dt_new = (torch.sqrt(2.0 * max_accel * params.h + mv2) - max_vel) / (2.0 * max_accel)
        return new, torch.clamp(dt_new, integrate_ops.DT_MIN, params.max_dt), red[2:]

    new_state, dt_out, red = advance(dt, extra)
    flags = torch.sum(red[:FLAG_BITS].to(torch.int32) << bit)
    if is_reuse:
        stale = 4.0 * red[FLAG_BITS] > (config.cand_slack * params.h) ** 2
        flags = flags | stale.to(torch.int32) * FLAG_CAND_STALE
    flags = flags.to(torch.int32)
    retry = dt - dt_out > integrate_ops.DT_RETRY_EPS if config.adaptive_dt else None

    def finish(retry=None):
        return step_mod.retry_loop(lambda d: advance(d)[:2], dt, new_state, dt_out, retry)

    if speculative:
        return new_state, dt_out, flags, cand_out, retry, finish
    if retry is not None:
        new_state, dt_out = finish()
    return new_state, dt_out, flags, cand_out


def local_frame(mesh: Mesh, state: ParticleState, dt: torch.Tensor, timeleft: torch.Tensor,
                params: SimulationParameters, scene, config: StepConfig,
                exchange: str = "all_gather", halo_max: int = 0, halo_hops: int = 1,
                stats: Optional[dict] = None, host: Optional[dict] = None):
    """A frame's substeps on rank ``mesh.rank`` (``_local_frame``,
    sharded_step.py:873-990): up to ``substeps_per_dispatch`` substeps
    while time is left, dt clamped to it; a re-sort every
    ``sort_interval``-th substep, a candidate rebuild every
    ``cand_interval``-th and wherever the displacement since the carried
    anchor, reduced over the ranks, already exceeds the slack (the
    predictive staleness check); the tables carried in between, with the
    surface sets under halo and ring. The substeps run through
    :func:`engine.step.dispatch`: one host read a candidate period, of
    predicates all-reduced first, so that every rank takes the same
    branch. ``stats``: a dict that counts this rank's substeps
    (:func:`engine.step.count_substep`); ``host``: the dispatch's host
    values (``more``, ``flags``). Returns (state, dt, timeleft, flags),
    flags OR'd over the substeps."""
    config = mesh_config(config)
    interval, ci = config.sort_interval, config.cand_interval
    slack2 = (config.cand_slack * params.h) ** 2
    run = partial(local_substep, mesh, params=params, scene=scene, config=config,
                  exchange=exchange, halo_max=halo_max, halo_hops=halo_hops,
                  speculative=True)

    def run_one(st, d, k, tables, rebuild):
        if rebuild:
            return run(st, d, do_sort=interval <= 1 or k % interval == 0)
        return run(st, d, do_sort=False, cand_in=tables)

    def stale(st, tables):
        d2 = torch.sum((st.position - tables["anchor"]) ** 2, dim=1)
        ok = st.position.abs().amax(dim=1) < LIVE_LIMIT
        d2max = mesh.all_reduce_max(torch.amax(torch.where(ok, d2, 0.0))[None])[0]
        return 4.0 * d2max > slack2

    def on_commit(k, rebuild, before, after, dt_next, flags, tables):
        carried = None if tables is None else (tables["cand_sub"], tables["count_sub"])
        step_mod.count_substep(stats, rebuild, carried, config)

    return step_mod.dispatch(state, dt, timeleft, config.substeps_per_dispatch, ci, run_one,
                             stale if ci > 1 else None, combine=mesh.all_reduce_max,
                             on_commit=on_commit if stats is not None else None, host=host)


def make_sharded_substep(mesh: Mesh, params: SimulationParameters, scene,
                         config: StepConfig, exchange: str = "all_gather",
                         halo_max: int = 0, halo_hops: int = 1):
    """``step(state, dt) -> (state, dt, flags)`` for this rank
    (sharded_step.py:1033-1088). Candidate reuse is pinned off: this
    entry point serves the engine's per-substep path, whose callbacks may
    move particles between substeps."""
    if config.cand_interval > 1:
        config = dataclasses.replace(config, cand_interval=1)

    def step(state, dt):
        return local_substep(mesh, state, dt, params, scene, config, exchange, halo_max,
                             halo_hops)[:3]

    return step


def make_sharded_frame(mesh: Mesh, params: SimulationParameters, scene,
                       config: StepConfig, exchange: str = "all_gather",
                       halo_max: int = 0, halo_hops: int = 1):
    """``frame(state, dt, timeleft) -> (state, dt, timeleft, flags)`` for
    this rank (sharded_step.py:992-1030): :func:`local_frame`."""
    return partial(local_frame, mesh, params=params, scene=scene, config=config,
                   exchange=exchange, halo_max=halo_max, halo_hops=halo_hops)


# ---- the whole state -------------------------------------------------------------

def gather_real(mesh: Mesh, state: ParticleState) -> ParticleState:
    """The real rows of every rank, in rank order, on every rank (one
    all_gather; the int32 Morton codes travel as their float32 bits)."""
    cols = [state.position, state.velocity, state.intermediate_velocity,
            state.acceleration, state.density[:, None], state.pressure[:, None],
            state.grid_index.contiguous().view(torch.float32)[:, None]]
    full = mesh.all_gather(torch.cat(cols, dim=1))
    full = full[live_rows(full[:, 0:3])]
    return ParticleState(
        position=full[:, 0:3], velocity=full[:, 3:6], intermediate_velocity=full[:, 6:9],
        acceleration=full[:, 9:12], density=full[:, 12].contiguous(),
        pressure=full[:, 13].contiguous(),
        grid_index=full[:, 14].contiguous().view(torch.int32))


def scatter_state(mesh: Mesh, state: Optional[ParticleState], params: SimulationParameters,
                  config: StepConfig, n: int) -> ParticleState:
    """Rank 0's ``state`` (``n`` real rows; None elsewhere) re-partitioned
    and padded (:func:`pad_for_mesh`) and each rank's rows handed to it
    (one broadcast)."""
    world = mesh.world
    n_pad = n + (-n) % (world * config.block_size)
    buf = torch.zeros((n_pad, 15), dtype=torch.float32, device=mesh.device)
    if mesh.rank == 0:
        st = pad_for_mesh(state, params, world, config)
        buf = torch.cat([st.position, st.velocity, st.intermediate_velocity,
                         st.acceleration, st.density[:, None], st.pressure[:, None],
                         st.grid_index.contiguous().view(torch.float32)[:, None]], dim=1)
    full = mesh.broadcast(buf)[shard_rows(n_pad, mesh.rank, world)]
    return ParticleState(
        position=full[:, 0:3].contiguous(), velocity=full[:, 3:6].contiguous(),
        intermediate_velocity=full[:, 6:9].contiguous(),
        acceleration=full[:, 9:12].contiguous(), density=full[:, 12].contiguous(),
        pressure=full[:, 13].contiguous(), grid_index=full[:, 14].contiguous().view(torch.int32))


def run_shards(mesh: Mesh, shards, params: SimulationParameters, config: StepConfig,
               exchange: str = "all_gather", halo_max: int = 0, halo_hops: int = 1,
               frame_time: Optional[float] = None, record: bool = False,
               per_substep: bool = False, substeps: Optional[int] = None) -> dict:
    """A rank body for :func:`parallel.mesh.launch`: rank r takes
    ``shards[r]`` (host arrays of its rows, as ``io.checkpoint`` writes
    them) and, in free space from dt = max_dt, runs one
    :func:`local_substep` or, with ``frame_time``, that much simulated
    time: through the frame loop, or with ``per_substep`` through
    :func:`make_sharded_substep` with the time left kept on the host (the
    engine's per-substep path); or, with ``substeps``, one call of the
    frame loop that runs exactly that many (its time never runs out).
    Returns host arrays of the rank's state, dt, flags, ``calls``
    (substeps, or frame-loop calls), the frame loop's ``frame_stats``
    (:func:`local_frame`), the collectives' counts and, with ``record``,
    the substep's exchanged tables."""
    from ..io import checkpoint

    dev = mesh.device
    state = checkpoint.arrays_to_state(shards[mesh.rank], dev)
    dt_t = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)
    tables = {} if record else None
    flags = torch.zeros((), dtype=torch.int32, device=dev)
    calls = 0
    frame_stats = {}
    if substeps is not None:
        config = dataclasses.replace(config, substeps_per_dispatch=substeps)
        timeleft = torch.tensor(_INF, dtype=torch.float32, device=dev)
        state, dt_t, _, flags = local_frame(mesh, state, dt_t, timeleft, params, None, config,
                                            exchange, halo_max, halo_hops, frame_stats)
        calls = 1
    elif frame_time is None:
        state, dt_t, flags, _ = local_substep(mesh, state, dt_t, params, None, config,
                                              exchange, halo_max, halo_hops, record=tables)
        calls = 1
    elif per_substep:
        step = make_sharded_substep(mesh, params, None, config, exchange, halo_max, halo_hops)
        timeleft = frame_time
        while timeleft > 0.0:
            state, dt_dev, f = step(state, dt_t)
            flags = flags | f
            dt_f = float(dt_dev)
            timeleft -= dt_f
            dt_t = torch.tensor(min(dt_f, timeleft) if timeleft < dt_f else dt_f,
                                dtype=torch.float32, device=dev)
            calls += 1
    else:
        timeleft = torch.tensor(frame_time, dtype=torch.float32, device=dev)
        while bool(timeleft > 0.0):
            state, dt_t, timeleft, f = local_frame(mesh, state, dt_t, timeleft, params, None,
                                                   config, exchange, halo_max, halo_hops,
                                                   frame_stats)
            flags = flags | f
            calls += 1
    return dict(state=checkpoint.state_to_arrays(state), dt=float(dt_t), flags=int(flags),
                stats=mesh.read_stats(), calls=calls, frame_stats=frame_stats,
                tables=None if tables is None else {
                    k: v.cpu().numpy() for k, v in tables.items() if v is not None})


def dryrun(n_ranks: int, device: str = "cuda") -> None:
    """The JAX module's dry run (sharded_step.py:1123-1248) on
    ``n_ranks`` ranks: one tiles substep, one substep of the nl kernels
    over the ring at full coverage with two-tier routing and a floor
    scene, a frame of the frame loop, and a frame with the cadence; each
    checked on every rank for finite state, every particle kept and a
    positive dt. The ranks run on the card unless ``device`` is "cpu"."""
    from .mesh import launch

    launch(_dryrun_rank, n_ranks, device=device)


def _dryrun_rank(mesh: Mesh) -> None:
    from ..core.params import derive_parameters
    from ..core.state import init_state
    from ..ops import collisions as collisions_ops
    from ..scene.obj_loader import ObjMesh
    from ..scene.scene import Scene

    fluid = dict(fluid_density=998.29, dynamic_viscosity=3.5, restitution=0, k=100,
                 surface_tension_threshold=7.065, surface_tension=0.0728,
                 particles_inside_influence_radius=20)
    sim = dict(particles_count=2048, particle_mass=0.05, simulation_time=3, target_fps=60,
               simulation_scale=0.1, constant_acceleration=dict(x=0, y=-9.8, z=0))
    params = derive_parameters(fluid, sim)
    dev, world = mesh.device, mesh.world
    # JAX's StepConfig defaults at block 64: the 32-wide tables, 128 force rows
    jax_defaults = dict(block_size=64, max_candidates=32, density_sub16=False,
                        force_sub16=False, force_sub8=False, force_query_rows=128,
                        sort_interval=1, cand_interval=1)
    config = StepConfig(neighbor_impl="tiles", **jax_defaults)
    state = local_rows(pad_for_mesh(init_state(params, dev), params, world, config),
                       mesh.rank, world)
    dt = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)

    def check(st, dt_out, flags):
        if int(flags):
            raise RuntimeError(f"dryrun: flags {int(flags)}")
        real = gather_real(mesh, st)
        if real.n != params.particles_count or not bool(torch.isfinite(real.position).all()):
            raise RuntimeError(f"dryrun: {real.n} finite real rows, not "
                               f"{params.particles_count}")
        if not (float(real.density.min()) > 0 and float(dt_out) > 0):
            raise RuntimeError("dryrun: a density or the dt is not positive")

    check(*make_sharded_substep(mesh, params, None, config)(state, dt))
    floor = ObjMesh(
        vertices=np.asarray([[-2, -0.5, -2], [2, -0.5, -2], [2, -0.5, 2], [-2, -0.5, 2]],
                            np.float32),
        triangles=np.asarray([[0, 2, 1], [0, 3, 2]], np.int32))
    scene = collisions_ops.build_device_scene(Scene.from_mesh(floor, params.h * 2.0), dev)
    nb_local = state.n // config.block_size
    config_p = StepConfig(neighbor_impl="pallas", pallas_variant="nl",
                          max_candidates_sub=96, tier2_frac=8, tier2_mult=2,
                          **jax_defaults)
    check(*make_sharded_substep(mesh, params, scene, config_p, "ring", nb_local,
                                (world + 1) // 2)(state, dt))
    frame_time = torch.tensor(params.frame_time, dtype=torch.float32, device=dev)
    st, dt3, tl, flags = make_sharded_frame(mesh, params, scene, config_p)(state, dt,
                                                                           frame_time)
    check(st, dt3 if float(tl) > 0 else dt, flags)
    config_c = StepConfig(neighbor_impl="pallas", pallas_variant="nl",
                          max_candidates_sub=96, max_candidates_hit=96,
                          **dict(jax_defaults, sort_interval=2, cand_interval=2),
                          cand_slack=0.3)
    st, dt4, tl, flags = make_sharded_frame(mesh, params, scene, config_c)(state, dt,
                                                                           frame_time)
    check(st, dt4 if float(tl) > 0 else dt, flags)
