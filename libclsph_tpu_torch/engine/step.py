"""The SPH substep and the frame loop on one device.

PyTorch counterpart of ``libclsph_tpu/engine/step.py``: Morton blocks of
``block_size`` 64, 128 or 256 particles, candidate lists that serve query
blocks of ``q_rows = min(nl_query_rows, block_size)`` rows (128, 64 or
32; a Morton block holds ``q_rep = block_size / q_rows`` of them, each
refined from its parent block's list). Three neighbour impls, as in the
JAX package (``StepConfig.neighbor_impl``):

* ``pallas``, the default: the hand kernels behind the block candidate
  machinery, in the variant of ``pallas_variant``:

  - ``nl`` (the default): blocks refined to candidate subblocks by the
    exact refine, the density kernel's hit counts, hit compaction and the
    force kernel, a re-sort and candidate rebuild every 4th substep with
    a 0.25 h slack, and the adaptive time step with its retry. Four table
    shapes (density_sub16, force_sub16, force_sub8) run:

    * the main path, (True, True, True), the defaults: 16-particle
      subblocks, hits per (32-row query subgroup, 8-particle half-slot),
      the 8-wide force pass;
    * the 16-wide force path, (True, True, False) (``--no-force-sub8``):
      16-particle subblocks, hits per (subgroup, slot), the 16-wide force
      pass; on its reuse substeps the density may be gated per (subgroup,
      tile) by the build substep's dilated hit counts (``density_gate``);
    * (False, True, False) (``--no-density-sub16``): 32-particle
      subblocks with hits per (subgroup, half-slot) and the 16-wide force
      pass;
    * the q-granular path, (False, False, False), which the capacity
      autotune and the pretune switch to on deep columns: 32-particle
      subblocks and either the 32-row force pass (``force_query_rows=32``)
      or the whole-block one (``force_query_rows=128``), or, with
      ``hit_compact=False``, the whole-block pass over the full refined
      lists;

    each with or without two-tier routing (``tier2_frac > 0``). At
    ``q_rows`` below 128 (finer query blocks, and ``block_size`` 64)
    the tables are 32-granular with one hit row a list, the lists are
    compacted per list and the force pass runs over lists of ``q_rows``
    rows; the refine is ``refine_mode`` "exact" (each candidate particle
    against the query rows' split boxes) or "aabb" (subblock boxes
    against the query boxes);
  - ``asm``: the nl variant with in-kernel assembly of the candidate
    subblocks on the TPU; on the card every candidate load is a gather
    already, so it runs the q-granular whole-list route (32-wide tables,
    one hit row a list, ``forces_q128_c32`` at the list's rows), single
    tier, no reuse;
  - ``row``, ``fine``, ``asym``: the density and force sums over whole
    candidate blocks, no refine and no compaction
    (:mod:`ops.kernels.blocks`), rebuilt every substep;

  On the nl and asm variants ``pair_r2="mxu"`` takes r^2 in every
  density and force kernel by the identity |q|^2 + |c|^2 - 2 q.c (the
  JAX kernels' ``r2_mxu``) on packs centred on the domain
  (:func:`domain_center`); the gated reuse density keeps the direct form
  on those packs, as in JAX;
* ``tiles``: the same block sums as dense pair tiles in plain PyTorch
  (:func:`ops.tiles.density_pass`, :func:`ops.tiles.force_pass`), r^2
  taken directly or, with ``tile_mode="mxu"``, by the identity centred on
  each query block;
* ``exact``: the reference's 27-cell gather over the whole state, sorted
  by :func:`ops.grid.sort_by_cell` every substep (no block padding).

Other values of the JAX package's ``StepConfig`` are refused, with the
JAX package's reason where it refuses them too.

PyTorch runs eagerly, so the frame's loop is a Python loop. Its
dispatch layer (:func:`dispatch`) runs a chunk of substeps, a candidate
period on the main path, with every predicate kept on the device (the
time left, the staleness before each reuse, whether the dt retry would
fire) and reads them all back at the chunk's end in one ``tolist()``
(:func:`host_read`, which counts the reads). It commits the substeps
before the first that fired and runs that one by the exact path (the
host retry loop, or a rebuild), so the results are those of a loop that
read each predicate before it acted.

Both open the program's spans (:mod:`utils.profiling`): ``dispatch``,
its ``chunk`` and ``host_read`` spans, and ``substep`` with its stages
``sort`` (:func:`pad_and_sort`), ``search`` and ``refine``
(:func:`build_candidates`), ``passes`` (the density and force passes) and
``advect`` (advection, collision, the next dt, a retry's re-advance).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core import morton
from ..core.params import SimulationParameters
from ..core.state import ParticleState
from ..ops import collisions as collisions_ops
from ..ops import grid as grid_ops
from ..ops import integrate as integrate_ops
from ..ops import interactions as interactions_ops
from ..ops import neighbors as neighbors_ops
from ..ops import tiles as tiles_ops
from ..ops import kernels
from ..ops.kernels.blocks import BLOCK_SIZES
from ..utils import profiling

# Bits of the substep's status flag (int32), as in the JAX package:
FLAG_CAPACITY = 1  # block-level candidate capacity / the exact impl's cell capacity
FLAG_GRID_DIM = 2  # a grid axis reached the 10-bit Morton limit (1024)
FLAG_EXCHANGE = 4  # multi-device exchange reach (not used on one device)
FLAG_CAPACITY_SUB = 8  # refined subblock capacity (max_candidates_sub)
FLAG_CAPACITY_HIT = 16  # hit-compacted force capacity (max_candidates_hit*)
FLAG_CAPACITY_T2 = 32  # two-tier overflow pool exhausted (tier2_frac)
FLAG_CAND_STALE = 64  # reused candidate lists outran their slack margin
FLAGS_ALL_CAPACITY = (
    FLAG_CAPACITY | FLAG_CAPACITY_SUB | FLAG_CAPACITY_HIT | FLAG_CAPACITY_T2
)

BLOCK = 128  # rows of a whole query block (GROUPS subgroups of 32)
GROUPS = 4  # 32-row query subgroups per whole query block
QUERY_ROWS = (32, 64, 128)  # nl_query_rows
REFINE_MODES = ("exact", "aabb")
PAIR_R2 = ("vpu", "mxu")  # pair_r2: direct r^2, or by the identity
TILE_MODES = ("direct", "mxu")  # tile_mode of the tiles impl
IMPLS = ("pallas", "tiles", "exact")
VARIANTS = ("nl", "asm", "row", "fine", "asym")
BLOCK_VARIANTS = ("row", "fine", "asym")  # sums over whole candidate blocks
# candidate slots a chunk of the exact impl's gathers (rows x 27 x cap)
EXACT_CHUNK_SLOTS = 1 << 24
# substeps a dispatch chunk runs where no candidate period sets its length
# (cand_interval 1: every substep rebuilds)
SPEC_PERIOD = 4


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Knobs of the substep; the defaults ARE the main path
    (``bench.py:184-226``). The first ten fields select the variant;
    off the nl variant the nl-only fields are ignored, as the JAX
    package ignores them."""

    neighbor_impl: str = "pallas"
    pallas_variant: str = "nl"
    block_size: int = 128
    nl_query_rows: int = 128
    # the nl/asm refine test: candidate particles against the query rows'
    # split boxes ("exact") or subblock boxes against query boxes ("aabb")
    refine_mode: str = "exact"
    force_query_rows: int = 32
    density_sub16: bool = True
    force_sub16: bool = True
    force_sub8: bool = True
    tier2_frac: int = 0  # 0: off; k: heavy rows go to ceil(nb/k) tier-2 slots
    density_gate: bool = False
    # the nl and asm force passes over the true-hit lists (False: over
    # the full refined lists, 32-wide tables and the whole-block pass)
    hit_compact: bool = True
    # block-level candidate cap (the engine doubles it on overflow)
    max_candidates: int = 96
    # the exact impl's particles per grid cell (doubled on overflow)
    cell_capacity: int = 96
    # refined subblock cap per query block (16- or 32-particle subblocks)
    max_candidates_sub: int = 192
    # 8-particle hit runs per query subgroup (+32 on overflow, to 160)
    max_candidates_hit8: int = 80
    # q-granular force capacity: per block at force_query_rows=128, and
    # cap32 = max(32, max_candidates_hit // 2) per subgroup at 32
    max_candidates_hit: int = 96
    # 16-wide hit runs per query subgroup: the capacity of the 16-wide
    # force pass (force_sub16 without force_sub8); a shortfall downgrades
    # to the q-granular tables (the autotune's and the pretune's rule)
    max_candidates_hit16: int = 64
    # tier-2 capacities = tier2_mult x the base capacities
    tier2_mult: int = 2
    # re-sort every k-th substep; rebuild the candidate tables every
    # k-th substep (reused in between, guarded by the staleness check)
    sort_interval: int = 4
    cand_interval: int = 4
    cand_slack: float = 0.25  # refine dilation for reuse, fraction of h
    adaptive_dt: bool = True
    substeps_per_dispatch: int = 64  # substeps per frame-loop call
    # the tiles impl's r^2: "direct", or "mxu" by the identity centred on
    # each query block's first particle (tiles.py _pair_r2_mxu)
    tile_mode: str = "direct"
    # the nl and asm kernels' r^2: "vpu" (direct), or "mxu" by the
    # identity on packs centred on the domain (step.py:147-153); ignored
    # elsewhere, as in the JAX package
    pair_r2: str = "vpu"

    def __post_init__(self):
        if self.neighbor_impl not in IMPLS:
            raise ValueError(f"StepConfig.neighbor_impl={self.neighbor_impl!r}: "
                             f"use one of {IMPLS}")
        if self.pallas_variant not in VARIANTS:
            raise ValueError(f"StepConfig.pallas_variant={self.pallas_variant!r}: "
                             f"use one of {VARIANTS}")
        for name, allowed in (("block_size", BLOCK_SIZES), ("nl_query_rows", QUERY_ROWS),
                              ("refine_mode", REFINE_MODES), ("force_query_rows", (32, 128)),
                              ("pair_r2", PAIR_R2), ("tile_mode", TILE_MODES)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"StepConfig.{name}={getattr(self, name)!r}: use one of "
                                 f"{allowed}")
        if self.sort_interval < 1 or self.cand_interval < 1:
            raise ValueError("sort_interval and cand_interval must be >= 1")
        if self.cand_interval > 1 and self.sort_interval % self.cand_interval:
            raise ValueError(
                "sort_interval must be a multiple of cand_interval "
                "(re-sorts must coincide with candidate rebuilds)"
            )
        # the JAX package's own refusals, with its reasons (step.py:
        # 302-303, 391-416, 1154-1158, 1178-1179)
        if self.neighbor_impl == "exact" and self.sort_interval > 1:
            raise ValueError(
                "sort skipping needs geometric candidates; the 'exact' impl "
                "requires sorted codes every substep"
            )
        if self.nl_kernels:
            asm = self.pallas_variant == "asm"
            if self.density_sub16 and (asm or self.q_rep > 1 or self.q_rows != BLOCK
                                       or self.force_query_rows != 32
                                       or not self.force_sub16 or not self.hit_compact):
                raise ValueError(
                    "density_sub16 requires the nl variant at whole-128 query rows "
                    "(block_size >= 128) with force_query_rows=32 + force_sub16 + "
                    "hit_compact"
                )
            if self.force_sub8 and not self.density_sub16:
                raise ValueError("force_sub8 requires density_sub16 (16-granular tables)")
            if self.force_sub8 and self.density_gate:
                raise ValueError("force_sub8 is incompatible with density_gate")
            if asm and self.tier2_frac:
                raise ValueError(
                    "two-tier routing (tier2_frac) requires the nl variant: the asm "
                    "variant runs single tier"
                )
        if self.cand_interval > 1:
            if self.neighbor_impl != "pallas":
                raise ValueError("cand_interval reuse requires the pallas impl")
            if self.nl_kernels and (self.pallas_variant == "asm" or self.q_rep > 1):
                raise ValueError("cand_interval reuse requires the nl variant at "
                                 "whole-block query rows")
            if self.pallas_variant != "nl":
                raise ValueError("cand_interval reuse requires the nl variant")
        if self.tier2_frac < 0 or self.tier2_mult < 1:
            raise ValueError("tier2_frac must be >= 0 and tier2_mult >= 1")
        if self.cell_capacity < 1:
            raise ValueError("cell_capacity must be >= 1")

    @property
    def nl_kernels(self) -> bool:
        """Whether the substep runs the refined-subblock machinery (the
        pallas impl's nl and asm variants)."""
        return self.neighbor_impl == "pallas" and self.pallas_variant in ("nl", "asm")

    @property
    def q_rows(self) -> int:
        """Query rows a candidate list serves (step.py:386)."""
        return min(self.nl_query_rows, self.block_size)

    @property
    def q_rep(self) -> int:
        """Query blocks per Morton block, each refined from its parent
        block's list (step.py:387)."""
        return self.block_size // self.q_rows

    @property
    def two_tier(self) -> bool:
        """Whether two-tier routing runs (step.py:391): tier2_frac on the
        nl variant at whole-block query rows (elsewhere it is ignored, as
        in the JAX package)."""
        return self.tier2_frac > 0 and self.pallas_variant == "nl" and self.q_rep == 1

    @property
    def force_q32(self) -> bool:
        """Whether the force pass runs per 32-row query subgroup
        (step.py:582-587): the nl variant with hit compaction at
        force_query_rows=32 and 128 query rows."""
        return (self.force_query_rows == 32 and self.hit_compact
                and self.pallas_variant == "nl" and self.q_rows == BLOCK)

    @property
    def subblock(self) -> int:
        """Particles per refined candidate subblock: 16 on the 16-granular
        tables (density_sub16), else 32."""
        return 16 if self.density_sub16 else 32

    @property
    def gate_on(self) -> bool:
        """Whether reuse substeps run the gated density (step.py:424): on
        the 16-granular tables with candidate reuse and no tier 2."""
        return (self.density_gate and self.density_sub16 and self.cand_interval > 1
                and not self.two_tier)

    @property
    def r2_mxu(self) -> bool:
        """Whether the nl and asm kernels take r^2 by the identity."""
        return self.pair_r2 == "mxu"

    def hit_width(self, groups: int) -> int:
        """Particles per force-list entry for hit rows of ``groups`` lists
        per block: 8 on the sub-8 pass, 16 on the 16-wide q32 pass, else
        whole 32-wide subblocks (one list per block is always 32-wide)."""
        if groups == GROUPS and self.force_sub8:
            return 8
        if groups == GROUPS and self.force_sub16 and self.force_query_rows == 32:
            return 16
        return 32


def build_candidates(state: ParticleState, real: torch.Tensor,
                     params: SimulationParameters, config: StepConfig):
    """Block search and refine to candidate subblocks over the padded,
    sorted state (step.py:424-495), at (1 + cand_slack) h when the tables
    will be reused; with two-tier routing the table is built at the
    tier-2 width tier2_mult * max_candidates_sub. At q_rep > 1 each of a
    block's q_rep query blocks refines its parent's list against its own
    rows' boxes. Returns (cand_sub (nb * q_rep, cap) int32, count_sub
    (nb * q_rep,) int32, flags)."""
    bsize, q_rows, q_rep = config.block_size, config.q_rows, config.q_rep
    nb = state.n // bsize
    sub = bsize // config.subblock
    reuse_on = config.cand_interval > 1
    h_search = params.h * (1.0 + config.cand_slack) if reuse_on else params.h
    cap_sub = config.max_candidates_sub * (config.tier2_mult if config.two_tier else 1)
    pos_b = state.position.reshape(nb, bsize, 3)
    real_b = real.reshape(nb, bsize)
    with profiling.annotate("search"):
        bmin, bmax = tiles_ops.split_block_bounds(pos_b, real_b)
        cand, count, ovf = tiles_ops.candidate_blocks_auto(
            bmin, bmax, h_search, config.max_candidates
        )
    with profiling.annotate("refine"):
        if q_rep > 1:  # each query block starts from its parent's list
            cand = torch.repeat_interleave(cand, q_rep, dim=0)
            count = torch.repeat_interleave(count, q_rep)
        nb_q = nb * q_rep
        self_lo = (torch.arange(nb_q, dtype=torch.int32, device=state.device) // q_rep) * sub
        if config.refine_mode == "exact":
            if q_rep > 1:  # the split boxes of each query block's rows
                qlo, qhi = tiles_ops.split_block_bounds(
                    state.position.reshape(nb_q, q_rows, 3), real.reshape(nb_q, q_rows))
            else:
                qlo, qhi = bmin, bmax
            cand_sub, count_sub, ovf2 = tiles_ops.refine_candidates_exact(
                cand, count, qlo, qhi, pos_b, h_search, sub, cap_sub,
                self_lo=self_lo, self_width=sub,
            )
        else:
            sub_lo, sub_hi = tiles_ops.subblock_bounds(pos_b, real_b, sub)
            if q_rep > 1:  # one box of each query block's rows
                qlo, qhi = tiles_ops.subblock_bounds(pos_b, real_b, q_rep)
                qlo, qhi = qlo[:, None, :], qhi[:, None, :]
            else:
                qlo, qhi = bmin, bmax
            cand_sub, count_sub, ovf2 = tiles_ops.refine_candidates(
                cand, count, qlo, qhi, sub_lo, sub_hi, h_search, sub, cap_sub,
                self_lo=self_lo, self_width=sub,
            )
        flags = ovf.to(torch.int32) * FLAG_CAPACITY + ovf2.to(torch.int32) * FLAG_CAPACITY_SUB
    return cand_sub, count_sub, flags


def hit_lists(cand_sub: torch.Tensor, hits: torch.Tensor, config: StepConfig,
              groups: int = GROUPS, cap: Optional[int] = None, qblock=None):
    """The force pass's lists: ``cand_sub``'s entries with a pair inside
    the support, per hit row, self ids first (step.py:623-672). The ids
    are split to the force width w = ``config.hit_width(groups)``: an
    s-particle subblock c becomes the w-particle runs [c*s/w, ...,
    c*s/w + s/w - 1], slot-aligned with the hit columns, and the self
    range scales with it. Default capacities:

    * 8-wide runs (the main path): ``max_candidates_hit8``;
    * 16-wide runs (16-granular ids as they are, or 32-granular ids split
      in two): ``max_candidates_hit16``;
    * 32-wide subblocks per subgroup: cap32 = max(32,
      max_candidates_hit // 2); one list per block: ``max_candidates_hit``.

    ``cap`` overrides the capacity (tier 2); ``qblock`` (nq,) names the
    query block of each row, default the identity; the self range is its
    parent Morton block's (qblock // q_rep).
    Returns (cand (nq*groups, cap) int32, count, flags)."""
    ids, self_lo, self_width, width = hit_ids(cand_sub, config, groups, qblock)
    cand_f, count_f, ovf = tiles_ops.compact_hits(
        ids, hits[:, : ids.shape[1]], cap or _hit_cap(config, width, groups),
        self_lo=self_lo, self_width=self_width,
    )
    return cand_f.contiguous(), count_f, ovf.to(torch.int32) * FLAG_CAPACITY_HIT


def hit_ids(cand_sub: torch.Tensor, config: StepConfig, groups: int = GROUPS, qblock=None):
    """:func:`hit_lists`' input to :func:`tiles.compact_hits`: the ids split
    to the force width, repeated once a hit row. Returns (ids (nq*groups,
    M * split) int32, self_lo, self_width, the force width)."""
    nq = cand_sub.shape[0]
    sub = config.block_size // config.subblock
    if qblock is None:
        qblock = torch.arange(nq, dtype=torch.int32, device=cand_sub.device)
    width = config.hit_width(groups)
    split = config.subblock // width
    ids, self_width = cand_sub, sub * split
    self_lo = torch.div(qblock, config.q_rep, rounding_mode="floor") * self_width
    if split > 1:
        sent = tiles_ops.REFINE_SENTINEL
        dead = (cand_sub == sent)[..., None]
        parts = cand_sub[..., None] * split + torch.arange(
            split, dtype=cand_sub.dtype, device=cand_sub.device)
        ids = torch.where(dead, sent, parts).reshape(nq, -1)
    if groups > 1:
        ids = torch.repeat_interleave(ids, groups, dim=0)
        self_lo = torch.repeat_interleave(self_lo, groups)
    return ids, self_lo, self_width, width


def _hit_cap(config: StepConfig, width: int, groups: int) -> int:
    if width == 8:
        return config.max_candidates_hit8
    if width == 16:
        return config.max_candidates_hit16
    if groups == GROUPS:
        return max(32, config.max_candidates_hit // 2)
    return config.max_candidates_hit


def _groups(config: StepConfig, tier: int) -> int:
    """Hit rows per list of a tier's passes (step.py:614-622, :674-689,
    :827-841): 4 query subgroups on the 16-granular tables (both tiers)
    and on tier 1 of the 32-row force pass; one row per list at q128, on
    finer query blocks, for asm and on tier 2 of the 32-wide tables; none
    (densities only) without hit compaction."""
    if not config.hit_compact:
        return 0
    if config.density_sub16 or (tier == 1 and config.force_q32):
        return GROUPS
    return 1


def domain_center(position: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """The identity mode's centre, 0.5 (min + max) over the real rows,
    padding rows standing in as row 0 (step.py:380-385); (3,) float32,
    left on the device."""
    real_pos = torch.where(real[:, None], position, position[0])
    return 0.5 * (torch.amin(real_pos, dim=0) + torch.amax(real_pos, dim=0))


def _density_pass(pos4, cand, count, params, config, groups, qblock=None):
    """The density kernel for ``groups`` hit rows a list (0: densities
    only), with hits at the force width of those rows, over lists of
    ``config.q_rows`` queries, in ``config``'s r^2 mode."""
    cand, count = cand.contiguous(), count.contiguous()
    hit_sub = config.hit_width(groups)
    if config.density_sub16:
        return kernels.density_c16(pos4, cand, count, params, hit_sub=hit_sub,
                                   qblock=qblock, r2_mxu=config.r2_mxu)
    return kernels.density_c32(pos4, cand, count, params, groups=groups,
                               hit_sub=hit_sub, qblock=qblock, rows=config.q_rows,
                               r2_mxu=config.r2_mxu)


def _force_pass(f8, density, real, cand_f, count_f, params, config, groups, qblock=None):
    fn = {8: kernels.forces_q32_c8, 16: kernels.forces_q32_c16}.get(
        config.hit_width(groups))
    mxu = config.r2_mxu
    if fn is not None:
        return fn(f8, density, real, cand_f, count_f, params, qblock=qblock, r2_mxu=mxu)
    if groups == GROUPS:
        return kernels.forces_q32_c32(f8, density, real, cand_f, count_f, params,
                                      qblock=qblock, r2_mxu=mxu)
    return kernels.forces_q128_c32(f8, density, real, cand_f, count_f, params,
                                   qblock=qblock, rows=config.q_rows, r2_mxu=mxu)


def _pressure_and_pack(state, real, density, params, center=None):
    pressure = interactions_ops.tait_pressure(density, params)
    pressure = torch.where(real, pressure, 0.0)
    f8 = kernels.force_pack(state.position, state.velocity, density, pressure, real,
                            params.particle_mass, center=center)
    return pressure, f8


def _density_forces_nl(state: ParticleState, real: torch.Tensor,
                       params: SimulationParameters, config: StepConfig, cand_in=None):
    """The nl and asm variants: candidate tables (built, or carried in
    ``cand_in``), the density kernel, hit compaction (skipped without
    ``hit_compact``), Tait pressure and the force kernel (step.py:360-735),
    or their two-tier form (:func:`two_tier_passes`).
    With ``config.gate_on`` the build substep also emits the dilated
    per-tile hit counts at (1 + cand_slack) h, packed into the mask that
    the carried tables hold as a fourth leaf, and a reuse substep runs
    the gated density over the carried table and mask (step.py:596-612).
    With ``config.r2_mxu`` both packs are centred on :func:`domain_center`
    (the refine reads the positions as they are).
    Returns (density, pressure, accel, flags, cand_out)."""
    gate = config.gate_on
    mask = None
    if cand_in is None:
        cand_sub, count_sub, flags = build_candidates(state, real, params, config)
        pos_anchor = state.position
    with profiling.annotate("passes"):
        if cand_in is not None:
            # carried lists were built against pos_anchor at (1 + slack) h: a
            # pair can close by at most twice the largest displacement since
            # (the same bound covers the gate's dilated tile counts)
            cand_sub, count_sub, pos_anchor = cand_in[:3]
            if gate:
                mask = cand_in[3]
            d2 = torch.sum((state.position - pos_anchor) ** 2, dim=1)
            d2max = torch.amax(torch.where(real, d2, 0.0))
            stale = 4.0 * d2max > (config.cand_slack * params.h) ** 2
            flags = stale.to(torch.int32) * FLAG_CAND_STALE
        center = domain_center(state.position, real) if config.r2_mxu else None
        pos4 = kernels.pos_pack(state.position, real, center)
        if config.two_tier:
            # the carried table is the one built here, at the tier-2 width
            density, pressure, accel, flags = two_tier_passes(
                state, real, pos4, params, config, cand_sub, count_sub, flags, center=center
            )
            cand_out = (cand_sub, count_sub, pos_anchor) if config.cand_interval > 1 else None
            return density, pressure, accel, flags, cand_out

        groups = _groups(config, 1)
        if gate and mask is not None:
            density, hits = kernels.density_gated16(pos4, cand_sub.contiguous(),
                                                    count_sub.contiguous(), mask, params)
        elif gate:
            density, hits, tiles = kernels.density_c16(
                pos4, cand_sub.contiguous(), count_sub.contiguous(), params, hit_sub=16,
                hit2_h=params.h * (1.0 + config.cand_slack), r2_mxu=config.r2_mxu)
            mask = kernels.pack_tile_nibbles(tiles)
        else:
            density, hits = _density_pass(pos4, cand_sub, count_sub, params, config, groups)
        cand_out = None
        if config.cand_interval > 1:
            cand_out = (cand_sub, count_sub, pos_anchor) + ((mask,) if gate else ())
        if config.hit_compact:
            cand_f, count_f, hit_flags = hit_lists(cand_sub, hits, config, groups)
            flags = flags + hit_flags
        else:  # the whole-block pass over the full refined lists (step.py:684-689)
            cand_f, count_f = cand_sub.contiguous(), count_sub.contiguous()
        pressure, f8 = _pressure_and_pack(state, real, density, params, center)
        accel = _force_pass(f8, density, real, cand_f, count_f, params, config, groups)
        return density, pressure, accel, flags, cand_out


def two_tier_passes(state, real, pos4, params, config, cand_full, count_sub, flags,
                    qblock=None, force_fields=None, center=None):
    """Two-tier density/force passes (step.py:738-1025). ``cand_full``
    (nb, c2) is the refined table at the tier-2 width; rows whose count
    exceeds c1 = max_candidates_sub go to nb2 = ceil(nb / tier2_frac)
    pool slots (:func:`tiles.route_overflow`), tier 1 runs every block
    over ``cand_full[:, :c1]`` with the routed rows' counts zeroed, and
    tier 2 runs the routed blocks (gathered by the ``qblock`` map)
    against the full arrays at tier2_mult x the hit capacity. The
    results merge by scatter over the distinct routed rows; unused pool
    slots keep tier 1's value. Both tiers run each block's candidates in
    the same order, so the split only changes which launch a block's
    sums happen in. A sharded substep runs it over its exchanged table:
    ``qblock`` (nb,) places its query blocks in ``pos4`` (tier 2 takes
    ``qblock[idx]``), and ``force_fields(density)`` returns the force
    kernels' (pressure, f8, density, real) over that table (default: the
    local pack, centred on ``center`` where one is given, as ``pos4``
    is). Returns (density, pressure, accel, flags)."""
    nb = cand_full.shape[0]
    c1 = config.max_candidates_sub
    nb2 = -(-nb // config.tier2_frac)
    idx, used, count1, pool_ovf = tiles_ops.route_overflow(count_sub, c1, nb2)
    flags = flags + pool_ovf.to(torch.int32) * FLAG_CAPACITY_T2
    cand1 = cand_full[:, :c1]
    cand2 = cand_full[idx.long()]
    count2 = torch.where(used, count_sub[idx.long()], 0).to(torch.int32)
    g1, g2 = _groups(config, 1), _groups(config, 2)
    q2 = idx if qblock is None else qblock[idx.long()].contiguous()
    if force_fields is None:
        def force_fields(density):
            pressure, f8 = _pressure_and_pack(state, real, density, params, center)
            return pressure, f8, density, real

    rows = config.q_rows  # = block_size: two-tier routing runs at q_rep 1

    def merge(a1, a2):
        b1 = a1.reshape((nb, rows) + a1.shape[1:])
        b2 = a2.reshape((nb2, rows) + a2.shape[1:])
        mask = used.reshape((nb2,) + (1,) * (b2.dim() - 1))
        b2 = torch.where(mask, b2, b1[idx.long()])
        return b1.index_copy(0, idx.long(), b2).reshape(a1.shape)

    density1, hits1 = _density_pass(pos4, cand1, count1, params, config, g1, qblock=qblock)
    density2, hits2 = _density_pass(pos4, cand2, count2, params, config, g2, qblock=q2)
    density = merge(density1, density2)
    pressure, f8, dens_f, real_f = force_fields(density)

    if config.hit_compact:
        cand_f1, count_f1, ovf3 = hit_lists(cand1, hits1, config, g1, qblock=qblock)
        cap2 = _hit_cap(config, config.hit_width(g2), g2) * config.tier2_mult
        cand_f2, count_f2, ovf4 = hit_lists(cand2, hits2, config, g2, cap=cap2, qblock=q2)
    else:  # both tiers over their full lists (step.py:842-850)
        cand_f1, count_f1 = cand1.contiguous(), count1
        cand_f2, count_f2 = cand2.contiguous(), count2
        ovf3 = ovf4 = torch.zeros((), dtype=torch.int32, device=cand1.device)
    accel1 = _force_pass(f8, dens_f, real_f, cand_f1, count_f1, params, config, g1,
                         qblock=qblock)
    accel2 = _force_pass(f8, dens_f, real_f, cand_f2, count_f2, params, config, g2,
                         qblock=q2)
    accel = merge(accel1, accel2)
    return density, pressure, accel, flags + (ovf3 | ovf4)


def _density_forces_blocks(state: ParticleState, real: torch.Tensor,
                           params: SimulationParameters, config: StepConfig):
    """The row, fine and asym variants (step.py:285-357): the block
    search at h, then the density and force sums of each query against
    every particle of its block's live candidate blocks, through the
    32-wide kernels over the block table split to 32-particle subblocks
    (:mod:`ops.kernels.blocks`). Rebuilt every substep: no refine, no
    compaction, no reuse. Returns (density, pressure, accel, flags)."""
    bsize = config.block_size
    nb = state.n // bsize
    pos_b = state.position.reshape(nb, bsize, 3)
    bmin, bmax = tiles_ops.split_block_bounds(pos_b, real.reshape(nb, bsize))
    cand, count, overflow = tiles_ops.candidate_blocks_auto(
        bmin, bmax, params.h, config.max_candidates)
    pos4 = kernels.pos_pack(state.position, real)
    density = kernels.density_blocks(pos4, cand, count, params, block=bsize)
    pressure, f8 = _pressure_and_pack(state, real, density, params)
    q_div = GROUPS if config.pallas_variant == "fine" else 1
    accel = kernels.forces_blocks(f8, density, real, cand, count, params, q_div,
                                  block=bsize)
    return density, pressure, accel, overflow.to(torch.int32) * FLAG_CAPACITY


def _density_forces_tiles(state: ParticleState, real: torch.Tensor,
                          params: SimulationParameters, config: StepConfig):
    """The tiles impl (step.py:251-282): the block search at h, then
    dense (128, 128) pair tiles over whole candidate blocks in plain
    PyTorch on every device. The JAX package's tiles impl is plain XLA
    with no Pallas kernel, so this is its port, not a fallback of a
    kernel. Returns (density, pressure, accel, flags)."""
    blocked = tiles_ops.make_blocked(state.position, state.velocity, state.density,
                                     state.pressure, real, config.block_size)
    bmin, bmax = tiles_ops.split_block_bounds(blocked.position, blocked.real)
    cand, count, overflow = tiles_ops.candidate_blocks_auto(
        bmin, bmax, params.h, config.max_candidates)
    density = tiles_ops.density_pass(blocked, cand, count, params, mode=config.tile_mode)
    pressure = torch.where(real, interactions_ops.tait_pressure(density, params), 0.0)
    blocked = blocked._replace(density=density.reshape(blocked.real.shape),
                               pressure=pressure.reshape(blocked.real.shape))
    accel = tiles_ops.force_pass(blocked, cand, count, params, mode=config.tile_mode)
    return density, pressure, accel, overflow.to(torch.int32) * FLAG_CAPACITY


def _density_forces_exact(state: ParticleState, params: SimulationParameters,
                          config: StepConfig):
    """The exact impl (step.py:217-248) over the state sorted by code:
    each particle against the first ``cell_capacity`` particles of each
    of its 27 cells (:mod:`ops.neighbors`), with the reference's pair
    sums (:mod:`ops.interactions`). The gathers are taken in chunks of
    EXACT_CHUNK_SLOTS candidate slots; each row's sums are the same as
    unchunked. FLAG_CAPACITY when a cell holds more than
    ``cell_capacity``. Returns (density, pressure, accel, flags)."""
    terms = params.precomputed()
    codes = state.grid_index
    n = state.n
    cap = config.cell_capacity
    rows = max(1, EXACT_CHUNK_SLOTS // (27 * cap))

    def chunks():
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            idx, valid = neighbors_ops.neighbor_indices(codes, cap, codes[r0:r1])
            yield r0, r1, idx, valid

    density = torch.empty(n, dtype=torch.float32, device=state.device)
    for r0, r1, idx, valid in chunks():
        c_pos = neighbors_ops.gather_candidates(state.position, idx)
        density[r0:r1] = interactions_ops.density_sum(state.position[r0:r1], c_pos, valid,
                                                      params, terms)
    pressure = interactions_ops.tait_pressure(density, params)
    accel = torch.empty((n, 3), dtype=torch.float32, device=state.device)
    for r0, r1, idx, valid in chunks():
        rows_id = torch.arange(r0, r1, dtype=torch.int32, device=state.device)
        f = interactions_ops.force_sums(
            state.position[r0:r1], state.velocity[r0:r1], density[r0:r1],
            pressure[r0:r1], neighbors_ops.gather_candidates(state.position, idx),
            neighbors_ops.gather_candidates(state.velocity, idx),
            neighbors_ops.gather_candidates(density, idx),
            neighbors_ops.gather_candidates(pressure, idx),
            valid, idx == rows_id[:, None], params, terms,
        )
        accel[r0:r1] = interactions_ops.combine_forces(f, density[r0:r1], params)
    overflow = neighbors_ops.max_cell_occupancy(codes) > cap
    return density, pressure, accel, overflow.to(torch.int32) * FLAG_CAPACITY


def _density_forces(state: ParticleState, real: torch.Tensor,
                    params: SimulationParameters, config: StepConfig, cand_in=None):
    """The substep's density and force passes for ``config``'s impl and
    variant. Returns (density, pressure, accel, flags, cand_out)."""
    if config.nl_kernels:
        return _density_forces_nl(state, real, params, config, cand_in=cand_in)
    with profiling.annotate("passes"):
        if config.neighbor_impl == "exact":
            return _density_forces_exact(state, params, config) + (None,)
        if config.neighbor_impl == "tiles":
            return _density_forces_tiles(state, real, params, config) + (None,)
        return _density_forces_blocks(state, real, params, config) + (None,)


def _advect_collide(state: ParticleState, scene, dt, params: SimulationParameters):
    """advection_collision (sphb.cl:177-223): leapfrog, DF response,
    half-step velocity reconstruction."""
    adv = integrate_ops.advect(
        state.position, state.intermediate_velocity, state.acceleration, dt
    )
    resp = collisions_ops.handle_collisions(
        scene, adv.old_position, adv.new_position, adv.next_velocity,
        params.restitution, dt,
    )
    velocity, intermediate = integrate_ops.reconstruct_velocities(
        state.intermediate_velocity, resp.next_velocity
    )
    return state.replace(
        position=resp.position, velocity=velocity, intermediate_velocity=intermediate
    )


def pad_and_sort(state: ParticleState, params: SimulationParameters, do_sort: bool,
                 exact: bool = False, block_size: int = BLOCK):
    """Grid bounds and Morton codes, sentinel padding to whole blocks of
    ``block_size`` (and superblocks), and the stable sort by code when ``do_sort``
    (step.py:1099-1168). With ``exact`` (the exact impl) there is no
    padding and the whole state is sorted by :func:`grid.sort_by_cell`
    (the exact impl's StepConfig sorts every substep). ``grid_bad`` also flags a grid
    that outgrew a reduced radix key width (grid.grid_exceeds_sort_bits).
    Returns (state, real mask, grid_bad)."""
    n = params.particles_count
    dev = state.device
    grid = grid_ops.compute_bounds(state.position, params)
    codes = grid_ops.locate_in_grid(state.position, grid)
    grid_bad = torch.any(grid.grid_size >= morton.MAX_GRID_DIM) | (
        grid_ops.grid_exceeds_sort_bits(grid.grid_size))
    if exact:
        state = grid_ops.sort_by_cell(state, codes)[0]
        return state, torch.ones(n, dtype=torch.bool, device=dev), grid_bad

    # sentinels sit far away and sort last
    npad = tiles_ops.padded_count(n, block_size)
    pad = npad - n
    if pad:
        far = grid.max_point + 1000.0 * params.h
        state = state.map(
            lambda a: torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                                device=dev)])
        )
        position = state.position.clone()
        position[n:] = far
        state = state.replace(position=position)
        codes = torch.cat([
            codes, torch.full((pad,), tiles_ops.SENTINEL_CODE, dtype=torch.int32,
                              device=dev),
        ])

    if do_sort:
        # permute only what the rest of the substep reads; density,
        # pressure and acceleration are recomputed from scratch
        sorted_codes, order = grid_ops.sort_codes(codes)
        state = state.replace(
            position=state.position[order],
            velocity=state.velocity[order],
            intermediate_velocity=state.intermediate_velocity[order],
            grid_index=sorted_codes,
        )
    else:
        state = state.replace(grid_index=codes)
    real = torch.arange(npad, device=dev) < n
    return state, real, grid_bad


def host_read(t: torch.Tensor) -> list:
    """The frame loops' one way to the host: ``t.tolist()``, counted in
    ``host_read.count`` (as the kernel wrappers count their launches)."""
    host_read.count += 1
    with profiling.annotate("host_read"):
        return t.tolist()


host_read.count = 0


def retry_loop(advance: Callable, dt, new_state, dt_out, retry: Optional[bool] = None):
    """The adaptive dt's retry (sph_simulation.cpp:246-262) after a first
    ``advance(dt)`` gave (new_state, dt_out): advance again at the new dt
    while it dropped by more than DT_RETRY_EPS, one host read a test.
    ``retry``: the first test's answer, where the caller has read it.
    Returns (new_state, dt_out)."""
    dt_used = dt
    while retry if retry is not None else host_read(
            dt_used - dt_out > integrate_ops.DT_RETRY_EPS):
        retry = None
        dt_used = dt_out
        new_state, dt_out = advance(dt_used)
    return new_state, dt_out


def substep(state: ParticleState, dt: torch.Tensor, params: SimulationParameters,
            scene: Optional[collisions_ops.DeviceScene], config: StepConfig,
            do_sort: bool = True, cand_in=None, speculative: bool = False):
    """One SPH substep. Returns (new_state, dt_next, flags, cand_out).

    ``dt`` and ``dt_next`` are 0-d float32 device tensors and ``flags``
    a 0-d int32 device tensor with the FLAG_* bits. ``cand_out`` is the
    carried candidate state when ``config.cand_interval > 1``: (table,
    counts, anchor positions) and, with the gate, the tile mask (pass it
    back as ``cand_in`` on reuse substeps, which must not sort); else
    None. The input state is not modified. Like the reference, the
    returned state is in Morton-sorted order; ``grid_index`` holds the
    codes. The dt retry reads the host at least once (:func:`retry_loop`).

    ``speculative``: the substep without a host read, one advance at
    ``dt`` and no retry. Returns (new_state, dt_next, flags, cand_out,
    retry, finish): ``retry`` a 0-d bool tensor, True where the substep
    retries (None without ``adaptive_dt``), and ``finish(retry=None)`` ->
    (new_state, dt_next) runs :func:`retry_loop` from that advance, which
    gives the substep's results bit for bit.
    """
    n = params.particles_count
    if cand_in is not None and do_sort:
        raise ValueError(
            "candidate reuse substeps must skip the sort (do_sort=False): "
            "the carried ids index the sorted order"
        )
    with profiling.annotate("substep") as span:
        if span:
            span.set(kind="rebuild" if cand_in is None else "reuse")
        with profiling.annotate("sort"):
            state, real, grid_bad = pad_and_sort(state, params, do_sort,
                                                 exact=config.neighbor_impl == "exact",
                                                 block_size=config.block_size)
        density, pressure, accel, cap_flags, cand_out = _density_forces(
            state, real, params, config, cand_in=cand_in
        )
        state = state.replace(density=density, pressure=pressure, acceleration=accel)
        state = state.map(lambda a: a[:n])  # drop the sentinel tail

        # adaptive dt with retry (sph_simulation.cpp:246-262)
        def advance(dt_try):
            new_state = _advect_collide(state, scene, dt_try, params)
            dt_next = integrate_ops.compute_time_step(
                new_state.velocity, new_state.acceleration, params
            )
            return new_state, dt_next

        def readvance(dt_try):  # the retry loop's advances, in the dispatch
            with profiling.annotate("advect"):
                return advance(dt_try)

        with profiling.annotate("advect"):
            new_state, dt_out = advance(dt)
            flags = cap_flags + grid_bad.to(torch.int32) * FLAG_GRID_DIM
            retry = dt - dt_out > integrate_ops.DT_RETRY_EPS if config.adaptive_dt else None

        def finish(retry=None):
            return retry_loop(readvance, dt, new_state, dt_out, retry)

        if speculative:
            return new_state, dt_out, flags, cand_out, retry, finish
        if retry is not None:
            new_state, dt_out = finish()
        return new_state, dt_out, flags, cand_out


def count_substep(stats: Optional[dict], rebuild: bool, tables, config: StepConfig):
    """Add one substep to a frame loop's ``stats`` (nothing when None):
    ``substeps``, ``rebuilds``, ``reuses`` and, where a carried table
    ``tables`` = (cand_sub, count_sub, ...) runs two-tier routing,
    ``tier2_blocks`` (the blocks :func:`tiles.route_overflow` sends to
    tier 2 on this substep, summed over the substeps; a host read) and
    ``carry_width`` (the carried table's slots). Changes no result."""
    if stats is None:
        return
    for key, add in (("substeps", 1), ("rebuilds", int(rebuild)), ("reuses", int(not rebuild)),
                     ("tier2_blocks", 0)):
        stats[key] = stats.get(key, 0) + add
    if tables is None or not config.two_tier:
        return
    cand_sub, count_sub = tables[0], tables[1]
    nb2 = -(-count_sub.shape[0] // config.tier2_frac)
    used = tiles_ops.route_overflow(count_sub, config.max_candidates_sub, nb2)[1]
    stats["tier2_blocks"] += int(used.sum())
    stats["carry_width"] = cand_sub.shape[1]


class _Spec(NamedTuple):
    """A substep that a dispatch chunk ran before reading the host: its
    number, kind, input and results, ``finish`` (the retry loop), and
    where its predicates and flags sit in the chunk's read (None: not
    read)."""

    n: int
    rebuild: bool
    before: ParticleState
    state: ParticleState
    dt_next: torch.Tensor
    flags: torch.Tensor
    tables: object
    finish: Callable
    at_time: Optional[int]
    at_stale: Optional[int]
    at_retry: Optional[int]
    at_flags: int


def dispatch(state: ParticleState, dt: torch.Tensor, timeleft: Optional[torch.Tensor],
             steps: int, ci: int, run: Callable, stale: Optional[Callable] = None,
             combine: Optional[Callable] = None, on_commit: Optional[Callable] = None,
             host: Optional[dict] = None):
    """Up to ``steps`` substeps with one host read a chunk: the frame
    loops' dispatch layer.

    Substep n rebuilds its tables when there are none, when n % ``ci``
    == 0, or when ``stale(state, tables)`` (a 0-d bool tensor; None:
    never) holds before it; else it reuses them. ``run(state, dt, n,
    tables, rebuild)`` runs one as :func:`substep` does with
    ``speculative`` and returns its (state, dt_next, flags, tables_out,
    retry, finish). With a ``timeleft`` (a 0-d tensor) the substeps run
    while it is above 0, dt clamped to it; without, dt is dt_next and no
    time is kept (bench's fixed cadence).

    The dispatch first reads the time left and dt (its own read). A chunk
    runs from n to the end of n's period (``ci``, or SPEC_PERIOD where
    ``ci`` is 1), no further than the time left over the last dt read;
    after a stop, or a staleness read ahead, chunks of one substep run
    until a whole period has run with no predicate holding. Each substep
    whose predicates are not yet known runs as if they were false; they,
    the flags, and the next substep's time and staleness are stacked and
    read in one :func:`host_read` (``combine``, the mesh's all-reduce, is
    applied first so that every rank reads the same values). The
    substeps before the first predicate that holds are committed; there
    the frame ends (time), or that substep runs again as a rebuild
    (stale), or its retry loop runs on (retry) and the next substep's
    predicates are read. ``on_commit(n, rebuild, before, after, dt_next,
    flags, tables)`` sees each committed substep.

    ``host``, a dict, receives ``more`` (time left after the dispatch;
    None without ``timeleft``) and ``flags`` (int), both from the
    dispatch's reads, ``stops`` (the chunks that stopped, by predicate),
    ``events`` ((substep, predicate) of each stop), ``wasted`` (substeps
    run and not committed) and ``reads``. Returns (state, dt, timeleft,
    flags), flags ORed over the committed substeps: the results of a loop
    that reads each predicate before it acts on it."""
    with profiling.annotate("dispatch") as span:
        timed = timeleft is not None
        period = ci if ci > 1 else SPEC_PERIOD
        flags = torch.zeros((), dtype=torch.int32, device=state.device)
        host_flags = 0
        tables = None
        n = 0
        known = None  # (time left, stale) of substep n, read already
        streak = period  # substeps run since the last stop
        left = None  # substeps the frame has left, from the last read
        stops = dict(time=0, stale=0, retry=0)
        events = []  # (substep, predicate) of each stop
        wasted = 0
        ran = committed = 0  # substeps run and committed (the dispatch span's attributes)
        reads0 = host_read.count

        def read(preds: list) -> list:
            vec = torch.stack([p.to(torch.float32) for p in preds])
            return host_read(combine(vec) if combine is not None else vec)

        def next_preds(st, tb, tl, k: int) -> list:
            """Substep k's predicates: time left and, before a reuse, stale."""
            preds = [tl > 0.0] if timed else []
            if stale is not None and tb is not None and k < steps and k % ci != 0:
                preds.append(stale(st, tb))
            return preds

        def known_from(vals: list):
            """(time left, stale) from :func:`next_preds`' values; None where
            none were read."""
            if not vals:
                return None
            return (bool(vals[0]) if timed else True), len(vals) > timed and bool(vals[-1])

        def advance_time(tl, dt_next):
            if not timed:
                return None, dt_next
            tl_new = tl - dt_next
            return tl_new, torch.where(tl_new < dt_next, tl_new, dt_next)

        def commit(sp: _Spec, new_state, dt_next, flag_bits: int):
            nonlocal state, tables, flags, host_flags, timeleft, dt, committed
            committed += 1
            state, tables = new_state, sp.tables
            timeleft, dt = advance_time(timeleft, dt_next)
            flags = flags | sp.flags
            host_flags |= flag_bits
            if on_commit is not None:
                on_commit(sp.n, sp.rebuild, sp.before, new_state, dt_next, sp.flags, sp.tables)

        def estimate(tl_h: float, d_h: float):
            return math.ceil(tl_h / d_h) if d_h > 0.0 and tl_h < d_h * 1e6 else None

        if timed and steps > 0:  # the dispatch's own read: the time left, and dt
            vals = read([timeleft > 0.0, timeleft, dt])
            known, left = (bool(vals[0]), False), estimate(vals[1], vals[2])
        while n < steps and (known is None or known[0]):
            with profiling.annotate("chunk") as chunk_span:
                end = min(steps, (n // period + 1) * period) if streak >= period else n + 1
                if left is not None:
                    end = min(end, n + max(1, left))
                chunk, preds = [], []
                st, d, tl, tb = state, dt, timeleft, tables
                for k in range(n, end):
                    first_known = k == n and known is not None
                    rebuild = tb is None or k % ci == 0 or (first_known and known[1])
                    at_time = at_stale = at_retry = None
                    if not first_known:
                        if timed:
                            at_time = len(preds)
                            preds.append(tl > 0.0)
                        if not rebuild and stale is not None:
                            at_stale = len(preds)
                            preds.append(stale(st, tb))
                    new, dt_next, f, tb_out, retry, finish = run(st, d, k, tb, rebuild)
                    ran += 1
                    if retry is not None:
                        at_retry = len(preds)
                        preds.append(retry)
                    preds.append(f)
                    tb = tb_out if rebuild else tb
                    chunk.append(_Spec(k, rebuild, st, new, dt_next, f, tb, finish, at_time,
                                       at_stale, at_retry, len(preds) - 1))
                    st = new
                    tl, d = advance_time(tl, dt_next)
                at_end = len(preds)
                preds += next_preds(st, tb, tl, end)
                at_tail = len(preds)
                if timed:
                    preds += [tl, d]
                vals = read(preds)

                stop = None
                for sp in chunk:
                    if sp.at_time is not None and not vals[sp.at_time]:
                        stop = "time"
                    elif sp.at_stale is not None and vals[sp.at_stale]:
                        stop = "stale"
                    elif sp.at_retry is not None and vals[sp.at_retry]:
                        stop = "retry"
                    if stop is not None:
                        break
                    commit(sp, sp.state, sp.dt_next, int(vals[sp.at_flags]))
                if chunk_span:
                    chunk_span.set(first=n, length=end - n, stop=stop)
                if stop is None:
                    n, streak = end, streak + end - n
                    known = known_from(vals[at_end:at_tail])
                    if timed:
                        left = estimate(vals[-2], vals[-1])
                    if known is not None and known[1]:  # it would have stopped a longer chunk
                        streak = 0
                    continue
                wasted += sum(1 for c in chunk if c.n > sp.n) + (stop != "retry")
                stops[stop] += 1
                events.append((sp.n, stop))
                streak, left = 0, None
                if stop == "time":
                    known = (False, False)
                    break
                if stop == "stale":  # run it again as a rebuild; its time left was read
                    n, known = sp.n, (True, True)
                    continue
                new_state, dt_next = sp.finish(True)  # the retry loop, from its first advance
                commit(sp, new_state, dt_next, int(vals[sp.at_flags]))
                n = sp.n + 1
                preds = next_preds(state, tables, timeleft, n)
                known = known_from(read(preds) if preds else [])
                if known is not None and known[1]:
                    streak = 0
        if span:
            span.set(ran=ran, committed=committed, wasted=wasted, stops=dict(stops),
                     reads=host_read.count - reads0)
        if host is not None:
            host.update(more=known[0] if timed and steps > 0 else None, flags=host_flags,
                        stops=stops, events=events, wasted=wasted,
                        reads=host_read.count - reads0)
        return state, dt, timeleft, flags


def frame(state: ParticleState, dt: torch.Tensor, timeleft: torch.Tensor,
          params: SimulationParameters, scene, config: StepConfig,
          stats: Optional[dict] = None, host: Optional[dict] = None):
    """A frame's substep loop (sph_simulation.cpp:384-409; frame_jit,
    step.py:1245-1376): runs until the frame's time is spent or
    ``config.substeps_per_dispatch`` substeps ran, clamping dt to the
    time left. Substep n re-sorts when n % sort_interval == 0 and
    rebuilds the candidate tables when n % cand_interval == 0 or when
    the displacement since the carried anchor already exceeds the
    slack (the predictive staleness check); substep 0 always rebuilds.
    The substeps run through :func:`dispatch`, one host read a candidate
    period. ``stats``: a dict that counts the substeps
    (:func:`count_substep`); ``host``: a dict that receives the
    dispatch's host values (``more``, ``flags``). Returns (state, dt,
    timeleft, flags), flags ORed over the substeps.
    """
    interval = config.sort_interval
    slack2 = grid_ops.device_scalar((config.cand_slack * params.h) ** 2, state.device)

    def run(st, d, n, tables, rebuild):
        if rebuild:
            return substep(st, d, params, scene, config, do_sort=n % interval == 0,
                           speculative=True)
        return substep(st, d, params, scene, config, do_sort=False, cand_in=tables,
                       speculative=True)

    def stale(st, tables):
        d2 = torch.sum((st.position - tables[2][: st.n]) ** 2, dim=1)
        return 4.0 * torch.amax(d2) > slack2

    def on_commit(n, rebuild, before, after, dt_next, flags, tables):
        count_substep(stats, rebuild, tables, config)

    return dispatch(state, dt, timeleft, config.substeps_per_dispatch, config.cand_interval,
                    run, stale, on_commit=on_commit if stats is not None else None,
                    host=host)
