"""Block candidate machinery and the ``tiles`` impl's passes.

PyTorch counterpart of ``libclsph_tpu/ops/tiles.py``. After the Morton
sort, consecutive
particles are spatially coherent; the sorted array is cut into blocks
of ``B`` particles, each block gets up to 4 AABBs split at its largest
internal position jumps, and blocks whose dilated boxes overlap become
candidates. The candidate lists are then refined to 16-particle
subblocks against the exact point-to-box distance, and after the
density pass compacted to the subblock halves that hold a true pair.
The ``tiles`` impl instead sums over whole candidate blocks with dense
(B, B) pair tiles (:func:`density_pass`, :func:`force_pass`).

Every integer table here equals the JAX package's, slot for slot:
lists are compacted by the same ascending sort with the query's own
ids biased first, or under ``LIBCLSPH_TPU_COMPACT=scatter`` by the same
cumsum-and-scatter (:func:`_self_priority_sort`), and top-k ties go to
the lowest index as ``lax.top_k`` breaks them. Large intermediates are
computed in chunks of query rows so that the 1M-particle tables fit
the card.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core import smoothing
from ..core.params import SimulationParameters
from . import grid as grid_ops

SENTINEL_CODE = (1 << 30) - 1  # Morton code of the padding particles
# above this many blocks the superblock prefilter replaces the dense
# nb x nb overlap test (tiles.py:54)
HIERARCHICAL_THRESHOLD = 1024
SUPER = 16  # blocks per superblock
SUPER_CAND = 192  # padded candidate superblocks per superblock
SPLIT_BOXES = 4  # AABBs per block in split_block_bounds
# dead slots of refined tables
REFINE_SENTINEL = 2**30
# bias that sorts the query's own candidate ids first (so a truncated
# list never drops a particle's self-interaction)
SELF_BIAS = 2**29
# elements per chunk of the refine's gathered (rows, M, B, 3) stream
REFINE_CHUNK_ELEMS = 1 << 26
_BIG = 3.0e38


def num_blocks(n: int, block_size: int) -> int:
    return -(-n // block_size)


def padded_count(n: int, block_size: int) -> int:
    """Particles after sentinel padding: a whole number of blocks AND of
    SUPER-block groups (the hierarchical search needs nb % SUPER == 0)."""
    nb = num_blocks(n, block_size)
    nb = -(-nb // SUPER) * SUPER
    return nb * block_size


def _topk_lowest_index(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, ties to the
    lowest index (``lax.top_k``'s rule; ``torch.topk`` leaves ties
    unspecified)."""
    order = torch.sort(values, dim=-1, descending=True, stable=True).indices
    return order[..., :k]


def _segment_boxes(lo, hi, mask, seg, n_boxes):
    """Per-segment masked AABBs of member boxes [lo, hi] (R, W, 3) (a
    point is the box lo == hi), mask/seg (R, W) -> (R, n_boxes, 3)
    twice; empty segments give inverted boxes."""
    mins, maxs = [], []
    for s in range(n_boxes):
        m = ((seg == s) & mask)[..., None]
        mins.append(torch.amin(torch.where(m, lo, _BIG), dim=1))
        maxs.append(torch.amax(torch.where(m, hi, -_BIG), dim=1))
    return torch.stack(mins, dim=1), torch.stack(maxs, dim=1)


def _jump(a: torch.Tensor) -> torch.Tensor:
    """|a[k+1] - a[k]| along axis 1, rounded as ``jnp.linalg.norm``
    rounds on the CPU: sqrt(fma(z, z, fma(y, y, x * x))), the fused
    multiply-adds emulated in float64. The split points are the top-k
    of these values, so only the same rounding gives the same ties."""
    d = a[:, 1:] - a[:, :-1]
    acc = d[..., 0] * d[..., 0]
    for k in (1, 2):
        dk = d[..., k].double()
        acc = (dk * dk + acc.double()).float()
    return torch.sqrt(acc)


def _split_segments(jump: torch.Tensor, n_boxes: int, width: int) -> torch.Tensor:
    """Segment id of each member: the number of split points (the
    n_boxes-1 largest jumps, plus one) at or below its index."""
    top_idx = _topk_lowest_index(jump, n_boxes - 1)
    splits = torch.sort(top_idx + 1, dim=1).values
    idx = torch.arange(width, device=jump.device)[None, :]
    return torch.sum(idx[:, :, None] >= splits[:, None, :], dim=-1)


def split_block_bounds(pos_blocked: torch.Tensor, real_blocked: torch.Tensor,
                       n_boxes: int = SPLIT_BOXES):
    """``n_boxes`` AABBs per block, split at the largest position jumps
    between consecutive sorted particles (tiles.py:103-135): the Morton
    curve jumps across octants, and one box over the gaps overlaps far
    more blocks than the particles do. Returns (bmin, bmax) of shape
    (nb, n_boxes, 3)."""
    b = pos_blocked.shape[1]
    jump = _jump(pos_blocked)
    jump = torch.where(real_blocked[:, 1:] & real_blocked[:, :-1], jump, -1.0)
    seg = _split_segments(jump, n_boxes, b)
    return _segment_boxes(pos_blocked, pos_blocked, real_blocked, seg, n_boxes)


def _box_overlap(lo_a, hi_a, lo_b, hi_b) -> torch.Tensor:
    """Any-of-SxS box overlap between row sets a (R, S, 3) and b (C, S, 3)
    -> (R, C) bool. ``lo_a``/``hi_a`` are already dilated."""
    overlap = torch.zeros(
        (lo_a.shape[0], lo_b.shape[0]), dtype=torch.bool, device=lo_a.device
    )
    for a in range(lo_a.shape[1]):
        for c in range(lo_b.shape[1]):
            overlap |= torch.all(
                (lo_a[:, None, a, :] <= hi_b[None, :, c, :])
                & (hi_a[:, None, a, :] >= lo_b[None, :, c, :]),
                dim=-1,
            )
    return overlap


def _compact_with_self(others: torch.Tensor, self_index: torch.Tensor, cap: int):
    """Slot 0 = the own index, then the set columns of ``others`` in
    ascending order, truncated to ``cap`` slots; slots past the count
    hold 0 (the scatter-into-zeros table of tiles.py:189-195).
    Returns (table (R, cap) int32, count (R,) int32, row_count (R,))."""
    r, c = others.shape
    cols = torch.arange(c, dtype=torch.int32, device=others.device)
    keys = torch.where(others, cols[None, :], c)
    first = torch.sort(keys, dim=1).values[:, : cap - 1]
    row_count = others.sum(dim=1, dtype=torch.int32) + 1
    table = torch.cat([self_index[:, None].to(torch.int32), first], dim=1)
    if table.shape[1] < cap:
        table = torch.cat(
            [table, torch.zeros((r, cap - table.shape[1]), dtype=torch.int32,
                                device=others.device)], dim=1)
    count = torch.clamp(row_count, max=cap)
    slot = torch.arange(cap, device=others.device)[None, :]
    table = torch.where(slot < count[:, None], table, 0)
    return table, count.to(torch.int32), row_count


def candidate_blocks(bmin: torch.Tensor, bmax: torch.Tensor, h: float,
                     max_candidates: int, cand_bmin=None, cand_bmax=None,
                     self_index=None):
    """Padded candidate-block lists from dilated split-AABB overlap
    (tiles.py:138-195). The candidate side defaults to the query set; a
    sharded substep passes its exchanged table as ``cand_bmin`` /
    ``cand_bmax`` (nc, S, 3) and each query block's own index in it as
    ``self_index`` (nb,) (the identity by default). The own block always
    sits in slot 0, so a truncated list never drops a self-interaction.
    Returns (cand (nb, M) int32, count (nb,) int32, overflowed () bool)."""
    if cand_bmin is None:
        cand_bmin, cand_bmax = bmin, bmax
    nb, nc = bmin.shape[0], cand_bmin.shape[0]
    if self_index is None:
        self_index = torch.arange(nb, dtype=torch.int32, device=bmin.device)
    overlap = _box_overlap(bmin - h, bmax + h, cand_bmin, cand_bmax)
    cols = torch.arange(nc, device=bmin.device)
    is_self = cols[None, :] == self_index[:, None]
    cand, count, row_count = _compact_with_self(overlap & ~is_self, self_index,
                                                max_candidates)
    return cand, count, torch.any(row_count > max_candidates)


def compact_mask(mask: torch.Tensor, cap: int):
    """Indices of the True entries of ``mask`` (n,), in order, in ``cap``
    slots (0 past the last; sharded_step.py:62-77, the halo and ring
    exchanges' surface sets). Returns (idx (cap,) int32, valid (cap,)
    bool, overflowed () bool)."""
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    total = pos[-1] + 1
    slot = torch.where(mask & (pos < cap), pos, cap).to(torch.int64)
    idx = torch.zeros(cap + 1, dtype=torch.int32, device=mask.device)
    idx.scatter_(0, slot, torch.arange(mask.shape[0], dtype=torch.int32,
                                       device=mask.device))
    valid = torch.arange(cap, device=mask.device) < total
    return idx[:cap], valid, total > cap


def superblock_candidates(bmin: torch.Tensor, bmax: torch.Tensor, h: float,
                          super_cand: int):
    """Level 1 of :func:`candidate_blocks_hierarchical`: superblocks of
    SUPER consecutive blocks, each with 4 boxes split at the largest
    member-centre gaps, against each other, own superblock in slot 0.
    Returns (shortlists (nsb, min(super_cand, nsb)) int32, their counts,
    the untruncated counts (nsb,), and the member boxes (nsb, SUPER, 3)
    twice)."""
    nb = bmin.shape[0]
    if nb % SUPER:
        raise ValueError(f"nb={nb} not a multiple of SUPER={SUPER}")
    nsb = nb // SUPER
    n_boxes = bmin.shape[1]

    mb_min = bmin.reshape(nsb, SUPER, n_boxes, 3)
    mb_max = bmax.reshape(nsb, SUPER, n_boxes, 3)
    mem_lo = torch.amin(mb_min, dim=2)  # (nsb, SUPER, 3) member boxes
    mem_hi = torch.amax(mb_max, dim=2)
    centers = 0.5 * (mem_lo + mem_hi)
    sb_split = 4
    seg = _split_segments(_jump(centers), sb_split, SUPER)
    all_members = torch.ones_like(seg, dtype=torch.bool)
    sb_min, sb_max = _segment_boxes(mem_lo, mem_hi, all_members, seg, sb_split)

    ov1 = _box_overlap(sb_min - h, sb_max + h, sb_min, sb_max)
    sb_ids = torch.arange(nsb, dtype=torch.int32, device=bmin.device)
    eye = torch.eye(nsb, dtype=torch.bool, device=bmin.device)
    sb_cand, sb_count, row_count = _compact_with_self(ov1 & ~eye, sb_ids,
                                                      min(super_cand, nsb))
    return sb_cand, sb_count, row_count, mem_lo, mem_hi


def super_cand_for(nb: int, max_candidates: int) -> int:
    """The level-1 cap that :func:`candidate_blocks_auto` gives the
    hierarchical search: it scales with max_candidates and with nsb / 3."""
    return max(SUPER_CAND, max_candidates, -(-(nb // SUPER) // 3))


def candidate_blocks_hierarchical(bmin: torch.Tensor, bmax: torch.Tensor, h: float,
                                  max_candidates: int, super_cand: int = SUPER_CAND):
    """Two-level candidate search for large block counts
    (tiles.py:198-299): query blocks against superblocks of SUPER
    consecutive blocks (4 boxes split at the largest member-centre gaps),
    then the superblock shortlists refined to blocks with
    :func:`refine_candidates`."""
    nb = bmin.shape[0]
    sb_cand_sb, sb_count_sb, row_count1, mem_lo, mem_hi = superblock_candidates(
        bmin, bmax, h, super_cand)
    sb_overflow = torch.any(row_count1 > min(super_cand, nb // SUPER))

    # level 2: refine superblock shortlists to blocks (member union boxes)
    cand_rep = torch.repeat_interleave(sb_cand_sb, SUPER, dim=0)
    count_rep = torch.repeat_interleave(sb_count_sb, SUPER, dim=0)
    cand, count, overflow = refine_candidates(
        cand_rep, count_rep, bmin, bmax,
        mem_lo.reshape(-1, 3), mem_hi.reshape(-1, 3),
        h, SUPER, max_candidates,
        self_lo=torch.arange(nb, dtype=torch.int32, device=bmin.device),
        self_width=1,
    )
    return cand, count, overflow | sb_overflow


def candidate_blocks_auto(bmin, bmax, h: float, max_candidates: int):
    """Dense search up to HIERARCHICAL_THRESHOLD blocks, hierarchical
    above (tiles.py:685-704); the level-1 cap scales with
    max_candidates and with nsb/3."""
    nb = bmin.shape[0]
    if nb > HIERARCHICAL_THRESHOLD and nb % SUPER == 0:
        return candidate_blocks_hierarchical(
            bmin, bmax, h, max_candidates, super_cand=super_cand_for(nb, max_candidates)
        )
    return candidate_blocks(bmin, bmax, h, max_candidates)


def _self_priority_sort(keys: torch.Tensor, self_lo, self_width: int, max_out: int):
    """Compact live ids (dead = REFINE_SENTINEL) to the first
    ``max_out`` slots, ids in [self_lo, self_lo + self_width) first
    (tiles.py:328-378), in the form ``LIBCLSPH_TPU_COMPACT`` names, read
    at each call: ``sort`` (the default), an ascending row sort with the
    self ids biased first; ``scatter``, each live id's destination from
    two row cumsums (self ids first, then the others in encounter order)
    and one scatter, whose truncated and dead ids all land in a trash
    column."""
    if os.environ.get("LIBCLSPH_TPU_COMPACT", "sort") == "scatter":
        live = keys != REFINE_SENTINEL
        if self_lo is not None:
            lo = self_lo[:, None]
            is_self = live & (keys >= lo) & (keys < lo + self_width)
        else:
            is_self = torch.zeros_like(live)
        c_self = torch.cumsum(is_self, dim=1, dtype=torch.int32)
        c_other = torch.cumsum(live & ~is_self, dim=1, dtype=torch.int32)
        dest = torch.where(is_self, c_self - 1, c_self[:, -1:] + c_other - 1)
        ok = live & (dest < max_out)
        dest = torch.where(ok, dest, max_out).to(torch.int64)
        vals = torch.where(ok, keys, REFINE_SENTINEL)
        out = torch.full((keys.shape[0], max_out + 1), REFINE_SENTINEL, dtype=keys.dtype,
                         device=keys.device)
        return out.scatter_(1, dest, vals)[:, :max_out]
    if self_lo is not None:
        lo = self_lo[:, None]
        is_self = (keys >= lo) & (keys < lo + self_width)
        keys = torch.where(is_self, keys - SELF_BIAS, keys)
    out = torch.sort(keys, dim=1).values[:, :max_out]
    if self_lo is not None:
        out = torch.where(out < 0, out + SELF_BIAS, out)
    return out


def _row_chunks(nb: int, per_row: int):
    rows = max(1, min(nb, REFINE_CHUNK_ELEMS // max(per_row, 1)))
    return range(0, nb, rows), rows


def refine_candidates(cand, count, qmin, qmax, sub_lo, sub_hi, h: float, sub: int,
                      max_sub: int, self_lo=None, self_width: int = 1):
    """Refine block lists to subblock lists by box overlap
    (tiles.py:389-506): subblock ``cand*sub + s`` survives iff its box
    overlaps some dilated query box. ``cand`` (nb, M), ``qmin``/``qmax``
    (nb, S, 3), ``sub_lo``/``sub_hi`` (nc*sub, 3).
    Returns (cand_sub (nb, max_sub) int32, count_sub (nb,), overflowed)."""
    nb, m = cand.shape
    s_split = qmin.shape[1]
    nc = sub_lo.shape[0] // sub
    boxes_lo = sub_lo.reshape(nc, sub, 3)
    boxes_hi = sub_hi.reshape(nc, sub, 3)
    qlo_d = qmin - h  # hi lanes need qmin - h <= sub_hi
    qhi_d = qmax + h  # lo lanes need sub_lo <= qmax + h
    live = torch.arange(m, device=cand.device)[None, :] < count[:, None]
    candc = torch.where(live, cand, 0).to(torch.int64)
    ids_sub = torch.arange(sub, dtype=torch.int32, device=cand.device)

    keys_out, counts = [], []
    starts, rows = _row_chunks(nb, m * sub * 6)
    for r0 in starts:
        cc = candc[r0 : r0 + rows]
        glo = boxes_lo[cc]  # (r, m, sub, 3)
        ghi = boxes_hi[cc]
        ok = torch.zeros(glo.shape[:3], dtype=torch.bool, device=cand.device)
        for s in range(s_split):
            qh = qhi_d[r0 : r0 + rows, s][:, None, None, :]
            ql = qlo_d[r0 : r0 + rows, s][:, None, None, :]
            ok |= torch.all((glo <= qh) & (ghi >= ql), dim=-1)
        ok &= live[r0 : r0 + rows, :, None]
        ids = cand[r0 : r0 + rows, :, None] * sub + ids_sub[None, None, :]
        # subblock-major columns (s * M + k), JAX's plane order, which the
        # scatter compaction keeps
        keys_out.append(torch.where(ok, ids, REFINE_SENTINEL).transpose(1, 2).reshape(
            ok.shape[0], -1))
        counts.append(ok.sum(dim=(1, 2), dtype=torch.int32))
    keys = torch.cat(keys_out)
    count_sub = torch.cat(counts)
    cand_sub = _self_priority_sort(keys, self_lo, self_width, max_sub)
    overflow = torch.any(count_sub > max_sub)
    return cand_sub.to(torch.int32), torch.clamp(count_sub, max=max_sub), overflow


def refine_exact_chunks(cand: torch.Tensor, b: int) -> list:
    """The query-row ranges (slices) that the exact refine runs one at a
    time: each chunk's gathered stream holds about REFINE_CHUNK_ELEMS
    elements."""
    nb, m = cand.shape
    starts, rows = _row_chunks(nb, m * b * 3)
    return [slice(r0, r0 + rows) for r0 in starts]


def refine_exact_gather(cand, count, pos_blocked, rows: slice) -> torch.Tensor:
    """The exact refine's gathered position stream for the query rows
    ``rows``: (r, M, B, 3), each live candidate block's particles (dead
    slots read block 0)."""
    m = cand.shape[1]
    live = torch.arange(m, device=cand.device)[None, :] < count[rows, None]
    return pos_blocked[torch.where(live, cand[rows], 0).to(torch.int64)]


def refine_exact_test(g, cand, count, qlo, qhi, h: float, sub: int, rows: slice):
    """The exact refine's distance test on a gathered chunk ``g`` (r, M,
    B, 3) of the query rows ``rows``: a candidate subblock survives iff
    one of its particles lies within h of one of the rows' query boxes,
    ``sum_axis max(lo-p, p-hi, 0)^2 <= 1.01 h^2``. Returns the chunk's
    sort keys (r, sub * M) int32 (column s * M + k: subblock s of slot
    k), the surviving ids with dead slots = REFINE_SENTINEL, and its
    counts (r,) int32."""
    r, m, b = g.shape[:3]
    h2_cut = grid_ops.device_scalar(float(h) * float(h) * 1.01, cand.device)
    inside = torch.zeros(g.shape[:3], dtype=torch.bool, device=cand.device)
    for s in range(qlo.shape[1]):
        lo = qlo[rows, s][:, None, None, :]
        hi = qhi[rows, s][:, None, None, :]
        deficit = torch.clamp(torch.maximum(lo - g, g - hi), min=0.0)
        deficit = torch.clamp(deficit, max=1.0e6)  # far sentinels
        d2 = deficit * deficit
        d2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
        inside |= d2 <= h2_cut
    inside &= (torch.arange(m, device=cand.device)[None, :] < count[rows, None])[:, :, None]
    ok = torch.any(inside.reshape(r, m, sub, b // sub), dim=-1)  # (r, m, sub)
    ids_sub = torch.arange(sub, dtype=torch.int32, device=cand.device)
    ids = cand[rows, :, None] * sub + ids_sub[None, None, :]
    # subblock-major columns (s * M + k), as refine_candidates lays them
    return (torch.where(ok, ids, REFINE_SENTINEL).transpose(1, 2).reshape(r, -1),
            ok.sum(dim=(1, 2), dtype=torch.int32))


def refine_candidates_exact(cand, count, qlo, qhi, pos_blocked, h: float, sub: int,
                            max_sub: int, self_lo=None, self_width: int = 1):
    """Exact-position subblock refinement (tiles.py:509-628): a
    candidate subblock survives iff one of its particles lies within h
    of a query box — ``sum_axis max(lo-p, p-hi, 0)^2 <= h^2``. The
    threshold keeps the JAX package's 1.01 inflation (tiles.py:575) so
    the tables stay equal to its. ``cand`` (nb, M), ``qlo``/``qhi``
    (nb, S, 3), ``pos_blocked`` (nbc, B, 3) in sorted order (sentinels
    sit far outside every box). Three parts, chunk by chunk of query
    rows: the gathered stream (:func:`refine_exact_gather`), the distance
    test (:func:`refine_exact_test`), then one row sort of the whole
    table (:func:`_self_priority_sort`).
    Returns (cand_sub (nb, max_sub) int32 with dead slots =
    REFINE_SENTINEL, count_sub (nb,) int32, overflowed () bool)."""
    keys_out, counts = [], []
    for rows in refine_exact_chunks(cand, pos_blocked.shape[1]):
        g = refine_exact_gather(cand, count, pos_blocked, rows)
        keys, n = refine_exact_test(g, cand, count, qlo, qhi, h, sub, rows)
        keys_out.append(keys)
        counts.append(n)
    keys = torch.cat(keys_out)
    count_sub = torch.cat(counts)
    cand_sub = _self_priority_sort(keys, self_lo, self_width, max_sub)
    overflow = torch.any(count_sub > max_sub)
    return cand_sub.to(torch.int32), torch.clamp(count_sub, max=max_sub), overflow


def subblock_bounds(pos_blocked: torch.Tensor, real_blocked: torch.Tensor, sub: int):
    """Per-subblock AABBs (tiles.py:302-313): each block split into
    ``sub`` consecutive runs of B/sub particles. pos (nb, B, 3) ->
    (nb*sub, 3) twice; empty subblocks give inverted boxes."""
    nb, b, _ = pos_blocked.shape
    p = pos_blocked.reshape(nb * sub, b // sub, 3)
    m = real_blocked.reshape(nb * sub, b // sub, 1)
    return (torch.amin(torch.where(m, p, _BIG), dim=1),
            torch.amax(torch.where(m, p, -_BIG), dim=1))


def route_overflow(count: torch.Tensor, c1: int, nb2: int):
    """Two-tier capacity routing (tiles.py:631-658): rows whose count
    exceeds the base capacity ``c1`` go to a pool of ``nb2`` tier-2
    slots, heaviest first, ties to the lowest row (``lax.top_k``).
    Returns (idx (nb2,) int32 distinct routed rows, used (nb2,) bool,
    count1 (nb,) with routed rows zeroed, pool_overflow () bool). Unused
    slots point at arbitrary rows and must be masked with ``used``."""
    heavy = count > c1
    vals = torch.where(heavy, count, -1)
    idx = _topk_lowest_index(vals, nb2)
    used = vals[idx] > 0
    count1 = torch.where(heavy, 0, count)
    pool_overflow = heavy.sum() > nb2
    return idx.to(torch.int32), used, count1.to(count.dtype), pool_overflow


def compact_hits(cand_sub: torch.Tensor, hits: torch.Tensor, max_hit: int,
                 self_lo=None, self_width: int = 1):
    """Compact a candidate list to its true-hit entries (tiles.py:661-682):
    ``hits`` (R, M) counts, slot j > 0 iff entry cand_sub[i, j] holds a
    pair inside the support radius. Dropping the rest from the force pass
    is exact: every force term carries the hard r < h cutoff.
    Returns (cand_hit (R, max_hit), count_hit (R,), overflowed)."""
    live = hits > 0
    ids = torch.where(live, cand_sub, REFINE_SENTINEL)
    cand_hit = _self_priority_sort(ids, self_lo, self_width, max_hit)
    count_hit = live.sum(dim=1, dtype=torch.int32)
    overflow = torch.any(count_hit > max_hit)
    return cand_hit.to(torch.int32), torch.clamp(count_hit, max=max_hit), overflow


# ----------------------------------------------------------------------
# the ``tiles`` impl: dense (B, B) pair tiles over whole candidate blocks
# ----------------------------------------------------------------------

# pair elements (block rows x candidate slots x B x B) per chunk of the
# tile passes: the 1M-particle temporaries stay near a few hundred MB each,
# and a small cloud takes all its slots in one chunk
TILE_CHUNK_ELEMS = 1 << 25


class BlockedFields(NamedTuple):
    """Morton-sorted per-particle fields reshaped to (nb, B, ...)."""

    position: torch.Tensor  # (nb, B, 3)
    velocity: torch.Tensor  # (nb, B, 3)
    density: torch.Tensor  # (nb, B)
    pressure: torch.Tensor  # (nb, B)
    real: torch.Tensor  # (nb, B) bool
    gid: torch.Tensor  # (nb, B) int32 sorted index


def make_blocked(position, velocity, density, pressure, real,
                 block_size: int, gid_offset: int = 0) -> BlockedFields:
    """The fields cut into blocks of ``block_size`` sorted particles;
    ``gid`` is the sorted index plus ``gid_offset`` (tiles.py:718-735): a
    sharded substep passes the offset of its queries in the exchanged
    table, so that the self test holds against that table."""
    n = position.shape[0]
    nb = n // block_size
    gid = torch.arange(n, dtype=torch.int32, device=position.device) + gid_offset

    def rs(a):
        return a.reshape((nb, block_size) + tuple(a.shape[1:]))

    return BlockedFields(position=rs(position), velocity=rs(velocity), density=rs(density),
                         pressure=rs(pressure), real=rs(real), gid=rs(gid))


def _tile_chunks(cand: torch.Tensor, count: torch.Tensor, b: int):
    """(block rows, candidate slots) of each chunk of the tile passes, up
    to the deepest live slot (the slots past every count add nothing; the
    JAX scan masks them): whole slots over 2^25 / B^2 block rows, or, for
    fewer blocks, every row over as many slots as fit."""
    nb = cand.shape[0]
    live = min(cand.shape[1], int(count.max())) if count.numel() else 0
    per_chunk = max(1, TILE_CHUNK_ELEMS // (b * b))  # (block, slot) tiles
    rows = min(nb, per_chunk)
    slots = max(1, per_chunk // rows)
    for m0 in range(0, live, slots):
        for r0 in range(0, nb, rows):
            yield slice(r0, r0 + rows), slice(m0, min(live, m0 + slots))


def _chunk_ids(cf: BlockedFields, cand, count, sl, ms):
    """The chunk's candidate block ids (r, S) into ``cf``, clamped so that
    a dead slot's REFINE_SENTINEL gathers a real block (a NaN row would
    poison the sums even masked), and its live mask (r, S)."""
    last = cf.position.shape[0] - 1
    c = torch.clamp(cand[sl, ms], max=last).to(torch.int64)
    slot = torch.arange(ms.start, ms.stop, device=cand.device)
    return c, slot[None, :] < count[sl, None]


def _pair_r2_mxu(qp: torch.Tensor, cp: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """r^2 of the ``mxu`` tile mode (tiles.py:743-756): (|q|^2 + |c|^2) -
    2 q.c with both sides less ``center`` (the query block's first
    particle, which keeps the cancellation at block scale), clamped at 0.
    Elementwise in float32, each sum over the axes spelt out as (x + y) +
    z, so no TF32 matmul setting reaches it and every device rounds it
    alike."""
    qx, qy, qz = (qp - center).unbind(-1)
    cx, cy, cz = (cp - center).unbind(-1)
    qq = (qx * qx + qy * qy) + qz * qz
    cc = (cx * cx + cy * cy) + cz * cz
    qc = (qx * cx + qy * cy) + qz * cz
    return torch.clamp((qq + cc) - 2.0 * qc, min=0.0)


def density_pass(blocked: BlockedFields, cand: torch.Tensor, count: torch.Tensor,
                 params: SimulationParameters, cand_fields=None,
                 mode: str = "direct") -> torch.Tensor:
    """Poly6 density of every query against all particles of its live
    candidate blocks (tiles.py:760-803; forces.cl:14-42), one (B, B) tile
    per candidate slot, r^2 taken directly or (``mode="mxu"``) by
    :func:`_pair_r2_mxu`. ``cand_fields``: the block table the candidate
    ids index (default ``blocked``; a sharded substep's exchanged table,
    of which only position and real are read). Returns (n,) over the
    sorted order, rest density on padding rows."""
    cf = blocked if cand_fields is None else cand_fields
    terms = params.precomputed()
    h = float(params.h)
    nb, b = blocked.real.shape
    acc = torch.zeros((nb, b), dtype=torch.float32, device=cand.device)
    for sl, ms in _tile_chunks(cand, count, b):
        c, live = _chunk_ids(cf, cand, count, sl, ms)
        qp = blocked.position[sl][:, None, :, None, :]
        if mode == "mxu":
            r2 = _pair_r2_mxu(qp, cf.position[c][:, :, None], qp[:, :, :1])
        else:
            rvec = qp - cf.position[c][:, :, None]
            r2 = torch.sum(rvec * rvec, dim=-1)
        r = torch.sqrt(r2)  # (r, S, B, B)
        w = smoothing.poly_6(r, h, terms)
        ok = live[:, :, None, None] & cf.real[c][:, :, None, :]
        acc[sl] += torch.sum(torch.where(ok, w, 0.0), dim=(1, 3))
    density = torch.where(blocked.real, params.particle_mass * acc, params.fluid_density)
    return density.reshape(-1)


def force_pass(blocked: BlockedFields, cand: torch.Tensor, count: torch.Tensor,
               params: SimulationParameters, cand_fields=None,
               mode: str = "direct") -> torch.Tensor:
    """Internal forces and gravity over whole candidate blocks
    (tiles.py:806-922; forces.cl:44-126): the symmetrised spiky pressure
    with its r -> 0 branch, viscosity, and the colour field, self
    excluded from the first two by ``gid``. The direction sums are taken
    directly as sum_j a_ij (x_i - x_j), as the port's kernels take them,
    so no block centring is needed; ``mode="mxu"`` takes r^2 (and so r,
    the cutoff and every term but the directions) by :func:`_pair_r2_mxu`.
    ``cand_fields`` as in :func:`density_pass`, every field read. Returns
    (n, 3) over the sorted order (padding rows included; the caller drops
    them)."""
    cf = blocked if cand_fields is None else cand_fields
    terms = params.precomputed()
    h = float(params.h)
    mass = float(params.particle_mass)
    nb, b = blocked.real.shape
    dev = cand.device
    press = torch.zeros((nb, b, 3), dtype=torch.float32, device=dev)
    visc = torch.zeros_like(press)
    norm = torch.zeros_like(press)
    lap = torch.zeros((nb, b), dtype=torch.float32, device=dev)
    self_coeff = blocked.pressure / blocked.density ** 2  # p_i / rho_i^2
    pair_sum = (1, 3)  # over (slot, candidate particle) of (r, S, B, B, ...)
    for sl, ms in _tile_chunks(cand, count, b):
        c, live = _chunk_ids(cf, cand, count, sl, ms)

        def q(a):  # query side, (r, 1, B, 1, ...)
            return a[sl][:, None, :, None]

        def k(name):  # candidate side, (r, S, 1, B, ...)
            return getattr(cf, name)[c][:, :, None, :]

        rvec = q(blocked.position) - k("position")  # (r, S, B, B, 3)
        if mode == "mxu":
            r2 = _pair_r2_mxu(q(blocked.position), k("position"),
                              blocked.position[sl][:, None, None, :1])
        else:
            r2 = torch.sum(rvec * rvec, dim=-1)
        r = torch.sqrt(r2)
        ok = live[:, :, None, None] & k("real")
        not_self = ok & (q(blocked.gid) != k("gid"))
        cut = smoothing.support_mask(r, h)
        near0 = r < smoothing.EPSILON
        safe_r = torch.where(near0, 1.0, r)
        crho = k("density")
        mr = mass / crho
        # pressure (Kelager 4.11, forces.cl:69-76) and its coincident
        # pair branch (smoothing.cl:23-25) on every component
        p_coeff = mass * (k("pressure") / crho ** 2 + q(self_coeff))
        a = torch.where(not_self & ~near0,
                        p_coeff * (cut * terms.spiky * (h - r) ** 2 / safe_r), 0.0)
        sing = torch.where(not_self & near0, p_coeff * terms.spiky, 0.0)
        press[sl] += (torch.sum(a[..., None] * rvec, dim=pair_sum)
                      + torch.sum(sing, dim=pair_sum)[..., None])
        # viscosity (forces.cl:78-84)
        bm = torch.where(not_self, mr * cut * terms.viscosity * (h - r), 0.0)
        visc[sl] += torch.sum(bm[..., None] * (k("velocity") - q(blocked.velocity)),
                              dim=pair_sum)
        # colour field normal and Laplacian, self included (forces.cl:87-96)
        t = h * h - r2
        g = torch.where(ok, mr * cut * terms.poly_6_gradient * t ** 2, 0.0)
        norm[sl] += torch.sum(g[..., None] * rvec, dim=pair_sum)
        lp = torch.where(ok, mr * cut * terms.poly_6_laplacian * t * (3.0 * h * h - 7.0 * r2),
                         0.0)
        lap[sl] += torch.sum(lp, dim=pair_sum)

    qrho = blocked.density[:, :, None]
    total = -qrho * press + visc * params.dynamic_viscosity
    nlen = torch.linalg.vector_norm(norm, dim=-1, keepdim=True)
    apply_st = nlen > params.surface_tension_threshold
    st = -params.surface_tension * lap[:, :, None] * norm / torch.where(apply_st, nlen, 1.0)
    total = total + torch.where(apply_st, st, 0.0)
    accel = total / qrho + params.gravity(dev)
    return accel.reshape(-1, 3)
