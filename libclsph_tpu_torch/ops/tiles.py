"""Block candidate machinery of the main path.

PyTorch counterpart of the main-path subset of
``libclsph_tpu/ops/tiles.py``. After the Morton sort, consecutive
particles are spatially coherent; the sorted array is cut into blocks
of ``B`` particles, each block gets up to 4 AABBs split at its largest
internal position jumps, and blocks whose dilated boxes overlap become
candidates. The candidate lists are then refined to 16-particle
subblocks against the exact point-to-box distance, and after the
density pass compacted to the subblock halves that hold a true pair.

Every integer table here equals the JAX package's, slot for slot:
lists are compacted by the same ascending sort with the query's own
ids biased first (:func:`_self_priority_sort`), and top-k ties go to
the lowest index as ``lax.top_k`` breaks them. Large intermediates are
computed in chunks of query rows so that the 1M-particle tables fit
the card.
"""

from __future__ import annotations

import torch

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
                     max_candidates: int):
    """Padded candidate-block lists from dilated split-AABB overlap
    (tiles.py:138-195). The own block always sits in slot 0.
    Returns (cand (nb, M) int32, count (nb,) int32, overflowed () bool)."""
    nb = bmin.shape[0]
    overlap = _box_overlap(bmin - h, bmax + h, bmin, bmax)
    eye = torch.eye(nb, dtype=torch.bool, device=bmin.device)
    self_index = torch.arange(nb, dtype=torch.int32, device=bmin.device)
    cand, count, row_count = _compact_with_self(overlap & ~eye, self_index,
                                                max_candidates)
    return cand, count, torch.any(row_count > max_candidates)


def candidate_blocks_hierarchical(bmin: torch.Tensor, bmax: torch.Tensor, h: float,
                                  max_candidates: int, super_cand: int = SUPER_CAND):
    """Two-level candidate search for large block counts
    (tiles.py:198-299): query blocks against superblocks of SUPER
    consecutive blocks (4 boxes split at the largest member-centre gaps),
    then the superblock shortlists refined to blocks with
    :func:`refine_candidates`."""
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

    # level 1: superblock x superblock, own superblock in slot 0
    ov1 = _box_overlap(sb_min - h, sb_max + h, sb_min, sb_max)
    super_cand = min(super_cand, nsb)
    sb_ids = torch.arange(nsb, dtype=torch.int32, device=bmin.device)
    eye = torch.eye(nsb, dtype=torch.bool, device=bmin.device)
    sb_cand_sb, sb_count_sb, row_count1 = _compact_with_self(
        ov1 & ~eye, sb_ids, super_cand
    )
    sb_overflow = torch.any(row_count1 > super_cand)

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
        nsb = nb // SUPER
        super_cand = max(SUPER_CAND, max_candidates, -(-nsb // 3))
        return candidate_blocks_hierarchical(
            bmin, bmax, h, max_candidates, super_cand=super_cand
        )
    return candidate_blocks(bmin, bmax, h, max_candidates)


def _self_priority_sort(keys: torch.Tensor, self_lo, self_width: int, max_out: int):
    """Compact live ids (dead = REFINE_SENTINEL) to the first
    ``max_out`` slots by an ascending row sort, ids in
    [self_lo, self_lo + self_width) first (tiles.py:328-378, ``sort``
    mode)."""
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
        keys_out.append(torch.where(ok, ids, REFINE_SENTINEL).reshape(ok.shape[0], -1))
        counts.append(ok.sum(dim=(1, 2), dtype=torch.int32))
    keys = torch.cat(keys_out)
    count_sub = torch.cat(counts)
    cand_sub = _self_priority_sort(keys, self_lo, self_width, max_sub)
    overflow = torch.any(count_sub > max_sub)
    return cand_sub.to(torch.int32), torch.clamp(count_sub, max=max_sub), overflow


def refine_candidates_exact(cand, count, qlo, qhi, pos_blocked, h: float, sub: int,
                            max_sub: int, self_lo=None, self_width: int = 1):
    """Exact-position subblock refinement (tiles.py:509-628): a
    candidate subblock survives iff one of its particles lies within h
    of a query box — ``sum_axis max(lo-p, p-hi, 0)^2 <= h^2``. The
    threshold keeps the JAX package's 1.01 inflation (tiles.py:575) so
    the tables stay equal to its. ``cand`` (nb, M), ``qlo``/``qhi``
    (nb, S, 3), ``pos_blocked`` (nbc, B, 3) in sorted order (sentinels
    sit far outside every box).
    Returns (cand_sub (nb, max_sub) int32 with dead slots =
    REFINE_SENTINEL, count_sub (nb,) int32, overflowed () bool)."""
    nb, m = cand.shape
    s_boxes = qlo.shape[1]
    b = pos_blocked.shape[1]
    h2_cut = torch.tensor(float(h) * float(h) * 1.01, dtype=torch.float32,
                          device=cand.device)
    live = torch.arange(m, device=cand.device)[None, :] < count[:, None]
    candc = torch.where(live, cand, 0).to(torch.int64)
    ids_sub = torch.arange(sub, dtype=torch.int32, device=cand.device)

    keys_out, counts = [], []
    starts, rows = _row_chunks(nb, m * b * 3)
    for r0 in starts:
        g = pos_blocked[candc[r0 : r0 + rows]]  # (r, m, B, 3)
        inside = torch.zeros(g.shape[:3], dtype=torch.bool, device=cand.device)
        for s in range(s_boxes):
            lo = qlo[r0 : r0 + rows, s][:, None, None, :]
            hi = qhi[r0 : r0 + rows, s][:, None, None, :]
            deficit = torch.clamp(torch.maximum(lo - g, g - hi), min=0.0)
            deficit = torch.clamp(deficit, max=1.0e6)  # far sentinels
            d2 = deficit * deficit
            d2 = (d2[..., 0] + d2[..., 1]) + d2[..., 2]
            inside |= d2 <= h2_cut
        inside &= live[r0 : r0 + rows, :, None]
        r = inside.shape[0]
        ok = torch.any(inside.reshape(r, m, sub, b // sub), dim=-1)  # (r, m, sub)
        ids = cand[r0 : r0 + rows, :, None] * sub + ids_sub[None, None, :]
        keys_out.append(torch.where(ok, ids, REFINE_SENTINEL).reshape(r, -1))
        counts.append(ok.sum(dim=(1, 2), dtype=torch.int32))
    keys = torch.cat(keys_out)
    count_sub = torch.cat(counts)
    cand_sub = _self_priority_sort(keys, self_lo, self_width, max_sub)
    overflow = torch.any(count_sub > max_sub)
    return cand_sub.to(torch.int32), torch.clamp(count_sub, max=max_sub), overflow


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
