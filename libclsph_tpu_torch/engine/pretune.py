"""Init-state capacity pretune.

PyTorch counterpart of ``libclsph_tpu/engine/pretune.py``. The engine's
reactive capacity autotune (``SPHSimulation._grow_capacity``) is exact
but re-runs the flagged frame under a new ``StepConfig``. This module
sizes the capacities before the first frame instead, from the initial
particle distribution:

* exact per-query-subgroup true-hit counts at 8-, 16- and 32-wide
  candidate granularity (what trips FLAG_CAPACITY_HIT),
* refined candidate-list depths at 16-wide granularity
  (FLAG_CAPACITY_SUB, tier-2 sizing),
* block-level candidate counts (FLAG_CAPACITY),

and applies the autotune's rules up front: a deep-column scene (river,
labyrinth) starts on the q-granular tables. The probe is plain torch (no
kernel of the TPU package reaches it); its integer statistics equal the
JAX probe's. It sees only the initial state: a distribution that deepens
later still falls back to the reactive autotune.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from ..ops import grid as grid_ops
from ..ops import tiles as tiles_ops
from ..utils.logging import get_logger

log = get_logger(__name__)

# capacities are sized so the probed max fills at most this fraction
HEADROOM = 0.875
# pair elements per chunk of the probe's dense sweep (a memory bound;
# the JAX probe maps over 8 blocks at a time)
PROBE_CHUNK_PAIRS = 1 << 25
C16 = 16  # particles per subblock of the probe's refine
Q32 = 32  # query rows per subgroup


def _probe_counts(state: ParticleState, params: SimulationParameters, config,
                  cap_blocks: int, cap_sub: int) -> dict:
    """The substep's candidate machinery on one state at 16-particle
    granularity (pretune.py:59-183): pad and stable sort, split boxes,
    block search, AABB refine, then exact true-hit counts per 32-query
    subgroup by a dense pair sweep over the refined lists. Returns the
    statistics as tensors: ``grid_bad``, ``cand_max``, ``cand_ovf``,
    ``sub16_max``, ``sub16_ovf``, ``sub16_counts_hist`` (nb,),
    ``hit16_max``, ``hit32_max`` and ``hit8_max``."""
    n = params.particles_count
    b = config.block_size
    h = float(params.h)
    h_search = h * (1.0 + config.cand_slack) if config.cand_interval > 1 else h
    dev = state.position.device

    position = state.position
    grid = grid_ops.compute_bounds(position, params)
    codes = grid_ops.locate_in_grid(position, grid)
    grid_bad = torch.any(grid.grid_size >= morton.MAX_GRID_DIM)
    npad = tiles_ops.padded_count(n, b)
    pad = npad - n
    if pad:
        far = grid.max_point + 1000.0 * h
        position = torch.cat([position, far.expand(pad, 3)])
        codes = torch.cat([codes, torch.full((pad,), tiles_ops.SENTINEL_CODE,
                                             dtype=codes.dtype, device=dev)])
    _, order = grid_ops.sort_codes(codes)
    position = position[order]
    real = (torch.arange(npad, device=dev) < n)[order]

    nb = npad // b
    pos_blk = position.reshape(nb, b, 3)
    real_blk = real.reshape(nb, b)
    bmin, bmax = tiles_ops.split_block_bounds(pos_blk, real_blk)
    cand, count, ovf = tiles_ops.candidate_blocks_auto(bmin, bmax, h_search, cap_blocks)
    sub = b // C16
    sub_lo, sub_hi = tiles_ops.subblock_bounds(pos_blk, real_blk, sub)
    self_lo = torch.arange(nb, dtype=torch.int32, device=dev) * sub
    cand_sub, count_sub, ovf2 = tiles_ops.refine_candidates(
        cand, count, bmin, bmax, sub_lo, sub_hi, h_search, sub, cap_sub,
        self_lo=self_lo, self_width=sub,
    )

    # a 16-subblock slot is a HIT for a subgroup when one of its real
    # particles lies within h of one of the subgroup's real queries (the
    # density kernel's hit rule). Dead slots hold REFINE_SENTINEL and hit
    # nothing, so the sweep stops at the deepest live slot.
    width = max(1, int(count_sub.max()))
    ids_all = cand_sub[:, :width]
    c16_pos = position.reshape(nb * sub, C16, 3)
    c16_real = real.reshape(nb * sub, C16)
    h2 = torch.tensor(h * h, dtype=torch.float32, device=dev)
    big = nb * sub + 1
    groups = b // Q32
    cnt16, cnt32, cnt8 = [], [], []
    rows = max(1, PROBE_CHUNK_PAIRS // (b * width * C16))
    for b0 in range(0, nb, rows):
        ids = ids_all[b0 : b0 + rows]
        c = ids.shape[0]
        live = ids != tiles_ops.REFINE_SENTINEL
        safe = torch.where(live, ids, 0).long()
        cp = c16_pos[safe]  # (c, width, 16, 3)
        creal = c16_real[safe] & live[..., None]
        q = pos_blk[b0 : b0 + c].reshape(c, groups, Q32, 1, 1, 3)
        d = q - cp[:, None, None]  # (c, 4, 32, width, 16, 3)
        d = d * d
        d2 = (d[..., 0] + d[..., 1]) + d[..., 2]
        qreal = real_blk[b0 : b0 + c].reshape(c, groups, Q32)[..., None, None]
        ok = (d2 < h2) & creal[:, None, None] & qreal
        hit16 = ok.any(dim=4).any(dim=2)  # (c, 4, width)
        cnt16.append(hit16.sum(dim=-1))
        ok8 = ok.reshape(c, groups, Q32, width, 2, C16 // 2)
        cnt8.append(ok8.any(dim=5).any(dim=2).sum(dim=(-2, -1)))
        # distinct 32-wide parents among the hit 16-slots (sizes the
        # q-granular path's per-subgroup cap)
        parent = torch.where(hit16, safe[:, None, :] // 2, big)
        ps = torch.sort(parent, dim=-1).values
        cnt32.append((ps[..., 0] < big).long() + (
            (ps[..., 1:] != ps[..., :-1]) & (ps[..., 1:] < big)).sum(dim=-1))
    return dict(
        grid_bad=grid_bad,
        cand_max=torch.amax(count),
        cand_ovf=ovf,
        sub16_max=torch.amax(count_sub),
        sub16_ovf=ovf2,
        sub16_counts_hist=count_sub,
        hit16_max=torch.cat(cnt16).amax(),
        hit32_max=torch.cat(cnt32).amax(),
        hit8_max=torch.cat(cnt8).amax(),
    )


def _roundup(x, m: int = 8) -> int:
    return -(-int(x) // m) * m


def pretune_config(state, params, config, probe_cap_sub: int | None = None):
    """Probe ``state`` and return (config with the updates applied, the
    probe statistics as host ints), or (config, None) off the shape the
    probe sizes, the nl variant at whole-block query rows
    (``nl_query_rows >= block_size``) with hit compaction on the
    16-granular force tables (pretune.py:190-282): the q-granular tables,
    finer query blocks, ``asm``, the block-granular variants, ``tiles``
    and ``exact`` pass through.

    * hit16 pressure: if the max per-subgroup 16-granular hit count
      exceeds HEADROOM x max_candidates_hit16, downgrade to the
      q-granular tables now and size max_candidates_hit from the
      32-granular max; else, with force_sub8, size max_candidates_hit8
      from the 8-granular max (16-slot steps).
    * block cap: grow max_candidates until the measured max fits.
    * subblock depths: if they exceed HEADROOM x max_candidates_sub,
      turn two-tier routing on with a pool and multiplier that hold the
      heavy rows.
    """
    cfg = config
    if not (cfg.neighbor_impl == "pallas" and cfg.pallas_variant == "nl"
            and cfg.q_rep == 1
            and cfg.hit_compact and cfg.force_query_rows == 32 and cfg.force_sub16):
        return cfg, None

    cap_probe = probe_cap_sub or max(384, cfg.max_candidates_sub * max(2, cfg.tier2_mult))
    stats = _probe_counts(state, params, cfg, cap_blocks=cfg.max_candidates,
                          cap_sub=cap_probe)
    counts_sub = stats.pop("sub16_counts_hist").cpu().numpy()
    s = {k: int(v) for k, v in stats.items()}
    nb = counts_sub.shape[0]
    updates = {}

    # block-level candidate cap (FLAG_CAPACITY)
    if s["cand_ovf"] or s["cand_max"] > HEADROOM * cfg.max_candidates:
        grown = cfg.max_candidates
        while s["cand_max"] > HEADROOM * grown or s["cand_ovf"]:
            grown *= 2
            if s["cand_ovf"]:
                break  # the true max is unknown beyond the probe's cap: one step
        updates["max_candidates"] = grown

    # hit capacity: 16-granular tables or the q-granular ones
    if s["hit16_max"] > HEADROOM * cfg.max_candidates_hit16:
        updates.update(force_sub16=False, density_sub16=False, force_sub8=False)
        need32 = _roundup(s["hit32_max"] / HEADROOM)
        if need32 > max(32, cfg.max_candidates_hit // 2):
            updates["max_candidates_hit"] = 2 * need32
        scale = 0.5  # 32-wide depths are close to half the 16-wide ones
    else:
        scale = 1.0
        if cfg.force_sub8:
            need8 = _roundup(s["hit8_max"] / HEADROOM, 16)
            if need8 > cfg.max_candidates_hit8:
                updates["max_candidates_hit8"] = need8

    # refined-list depths (FLAG_CAPACITY_SUB / FLAG_CAPACITY_T2)
    depth = counts_sub * scale
    c1 = cfg.max_candidates_sub
    dmax = float(depth.max()) if nb else 0.0
    n_heavy = int(np.sum(depth > c1))
    if dmax > HEADROOM * c1:
        frac = cfg.tier2_frac or 8
        while frac > 1 and n_heavy > (nb // frac) * 0.75:
            frac //= 2
        updates["tier2_frac"] = frac
        mult = max(2, cfg.tier2_mult)
        while dmax > HEADROOM * c1 * mult:
            mult *= 2
        updates["tier2_mult"] = mult

    if not updates:
        return cfg, s
    log.warning("capacity pretune (init-state probe %s): applying %s", s, updates)
    return dataclasses.replace(cfg, **updates), s
