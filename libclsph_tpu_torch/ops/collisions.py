"""Mesh collisions via per-face signed distance fields.

PyTorch counterpart of ``libclsph_tpu/ops/collisions.py``
(``libclsph/kernels/collisionsv2.cl``):

* :func:`bake_distance_field` — the one-time DF bake
  (computeDistanceField, collisionsv2.cl:57-138), with the same host
  shortlist of faces per chunk of gridpoints and the same
  first-strict-minimum sign rule;
* :func:`build_corner_table` — the (G, 8) trilinear corner table, so
  the per-substep lookup is one row gather;
* :func:`handle_collisions` — the per-substep response
  (collisionsv2.cl:249-336): the *last* face AABB holding the particle,
  trilinear DF interpolation, and a restitution-scaled reflection below
  the 0.02 contact distance.

A ``None`` scene is free flight, as the reference with face_count 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.scene import Scene

CONTACT_DISTANCE = 0.02  # collision threshold (collisionsv2.cl:205/294)
DF_FAR = 20.0  # "no surface nearby" DF initialiser (collisionsv2.cl:63)


class DeviceScene(NamedTuple):
    """Device mirror of :class:`Scene` plus the baked DF."""

    bb_min: torch.Tensor  # (F, 3) f32
    bb_max: torch.Tensor  # (F, 3) f32
    bb_size: torch.Tensor  # (F, 3) i32
    bb_offset: torch.Tensor  # (F,)  i32
    rotations: torch.Tensor  # (F, 3, 3) f32
    translations: torch.Tensor  # (F, 3) f32
    rvertices: torch.Tensor  # (F, 4) f32
    df: torch.Tensor  # (G,) f32 baked signed distance field
    corner8: torch.Tensor  # (G, 8) corners d000..d111 of the cell at g

    @property
    def face_count(self) -> int:
        return self.bb_min.shape[0]


def device_scene_arrays(scene: Scene, device) -> dict:
    if scene.total_gridpoints >= np.iinfo(np.int32).max:
        raise ValueError(
            f"distance field too large for int32 indexing: {scene.total_gridpoints}"
        )

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(
        bb_min=t(scene.bb_min),
        bb_max=t(scene.bb_max),
        bb_size=t(scene.bb_size, torch.int32),
        bb_offset=t(scene.bb_offset, torch.int32),
        rotations=t(scene.rotations),
        translations=t(scene.translations),
        rvertices=t(scene.rvertices),
    )


def _point_segment_dist(rpx, rpy, rpz, x1, y1, x2, y2):
    """distPointDroite (collisionsv2.cl:26-55): distance from the
    face-local point to a 2-D segment in the face plane."""
    a = rpy - x1
    b = rpz - y1
    c = x2 - x1
    d = y2 - y1
    dot = a * c + b * d
    len_sq = c * c + d * d
    nz = len_sq != 0.0
    param = torch.where(nz, dot / torch.where(nz, len_sq, 1.0), -1.0)
    xx = torch.where(param < 0.0, x1, torch.where(param > 1.0, x2, x1 + param * c))
    yy = torch.where(param < 0.0, y1, torch.where(param > 1.0, y2, y1 + param * d))
    dy = rpy - xx
    dz = rpz - yy
    return torch.sqrt(rpx * rpx + dz * dz + dy * dy)


def _face_local(p, rot, trans):
    """p_local = R @ (p + t) (collisionsv2.cl:92-102), rounded as the
    JAX package's float32 dot rounds it on the CPU: fused multiply-adds
    in index order into an accumulator that starts at +0.0, emulated in
    float64 (a float32 product is exact there). The DF's sign at a
    gridpoint in a face's plane is the sign of this coordinate (+0.0 or
    -0.0), so only the same rounding gives the same field."""
    tp = p + trans
    acc = torch.zeros(torch.broadcast_shapes(rot.shape[:-1], tp.shape[:-1] + (1,)),
                      dtype=torch.float64, device=p.device)
    for k in range(3):
        acc = (rot[..., k].double() * tp[..., None, k].double() + acc).float().double()
    return acc.float()


def _signed_face_distance(p, rot, trans, rv):
    """Signed point-to-triangle distance in the face frame
    (collisionsv2.cl:92-131). Returns (d, rpx): the unsigned distance
    and the plane coordinate whose sign signs the DF."""
    rp = _face_local(p, rot, trans)
    rpx, rpy, rpz = rp[..., 0], rp[..., 1], rp[..., 2]
    v1x, v1y = rv[..., 0], rv[..., 1]
    v2x, v2y = rv[..., 2], rv[..., 3]

    def det(x1, y1, x2, y2):
        return x1 * y2 - y1 * x2

    denom = det(v2x, v2y, 0.0, v1y)
    safe_denom = torch.where(denom != 0.0, denom, 1.0)
    a = det(rpy, rpz, torch.zeros_like(v1y), v1y) / safe_denom
    b = -det(rpy, rpz, v2x, v2y) / safe_denom
    inside = (a > 0.0) & (b > 0.0) & (a + b < 1.0) & (denom != 0.0)

    zero = torch.zeros_like(v1x)
    d_edge = _point_segment_dist(rpx, rpy, rpz, zero, zero, v1x, v1y)
    d_edge = torch.minimum(d_edge, _point_segment_dist(rpx, rpy, rpz, v1x, v1y, v2x, v2y))
    d_edge = torch.minimum(d_edge, _point_segment_dist(rpx, rpy, rpz, zero, zero, v2x, v2y))

    d = torch.where(inside, torch.abs(rpx), d_edge)
    return d, rpx


def _gridpoint_positions(scene: Scene) -> np.ndarray:
    """World positions of all DF gridpoints (host), in the reference's
    y-major / z / x-minor flat layout per face grid (collisionsv2.cl:61-87)."""
    total = scene.total_gridpoints
    idx = np.arange(total, dtype=np.int64)
    owner = np.searchsorted(scene.bb_offset, idx, side="right") - 1
    owner = np.clip(owner, 0, scene.face_count - 1)
    size = scene.bb_size[owner]
    li = idx - scene.bb_offset[owner]
    sx = size[:, 0]
    plane = sx * size[:, 2]
    x = (li % plane) % sx
    z = (li % plane) // sx
    y = li // plane
    o_min = scene.bb_min[owner]
    o_max = scene.bb_max[owner]
    coords = np.stack([x, y, z], axis=1).astype(np.float64)
    denom = np.maximum(size.astype(np.float64) - 1.0, 1.0)
    return (coords * (o_max - o_min) / denom + o_min).astype(np.float32)


def bake_distance_field(
    scene: Scene, device, *, point_chunk: int = 4096, face_chunk: int = 8,
    chunks_per_batch: int = 64,
) -> torch.Tensor:
    """Bake the flat (G,) signed distance field on ``device``.

    Per ``point_chunk`` consecutive gridpoints a host prefilter lists the
    faces whose AABB overlaps the chunk's AABB (ascending face order, so
    argmin's first minimum reproduces the reference's strict-< update);
    the device evaluates only (chunk x shortlist) distances, in batches
    of ``chunks_per_batch`` chunks."""
    f_total = scene.face_count
    total = scene.total_gridpoints
    pos = _gridpoint_positions(scene)

    n_chunks = -(-total // point_chunk)
    pad = n_chunks * point_chunk - total
    pos_p = np.concatenate([pos, np.tile(pos[:1], (pad, 1))]) if pad else pos
    pos_c = pos_p.reshape(n_chunks, point_chunk, 3)
    cmin = pos_c.min(axis=1)
    cmax = pos_c.max(axis=1)
    ov = np.all(
        (cmin[:, None, :] <= scene.bb_max[None, :, :])
        & (cmax[:, None, :] >= scene.bb_min[None, :, :]),
        axis=-1,
    )
    counts = ov.sum(axis=1)
    k = max(int(counts.max()), 1)
    k = -(-k // face_chunk) * face_chunk
    short = np.full((n_chunks, k), f_total, np.int64)  # pad = sentinel face
    for i in range(n_chunks):
        ids = np.nonzero(ov[i])[0]
        short[i, : ids.size] = ids

    arrs = device_scene_arrays(scene, device)
    f32 = dict(dtype=torch.float32, device=device)
    inf = float("inf")
    bb_min = torch.cat([arrs["bb_min"], torch.full((1, 3), inf, **f32)])
    bb_max = torch.cat([arrs["bb_max"], torch.full((1, 3), -inf, **f32)])
    rot = torch.cat([arrs["rotations"], torch.zeros((1, 3, 3), **f32)])
    trans = torch.cat([arrs["translations"], torch.zeros((1, 3), **f32)])
    rv = torch.cat([arrs["rvertices"], torch.zeros((1, 4), **f32)])

    pos_t = torch.from_numpy(pos_c).to(device)
    short_t = torch.from_numpy(short).to(device)
    out = []
    for s in range(0, n_chunks, chunks_per_batch):
        p = pos_t[s : s + chunks_per_batch]  # (B, C, 3)
        ids = short_t[s : s + chunks_per_batch]  # (B, K)
        fb_min = bb_min[ids][:, None]  # (B, 1, K, 3)
        fb_max = bb_max[ids][:, None]
        in_box = torch.all(
            (p[:, :, None, :] <= fb_max) & (p[:, :, None, :] >= fb_min), dim=-1
        )  # (B, C, K)
        d, rpx = _signed_face_distance(
            p[:, :, None, :], rot[ids][:, None], trans[ids][:, None], rv[ids][:, None]
        )
        cand = torch.where(in_box & (d < DF_FAR), d, inf)
        j = torch.argmin(cand, dim=2, keepdim=True)
        dmin = torch.gather(cand, 2, j)[..., 0]
        sgn = torch.gather(rpx, 2, j)[..., 0]
        out.append(
            torch.where(dmin < DF_FAR, torch.copysign(dmin, sgn), DF_FAR)
        )
    return torch.cat(out).reshape(-1)[:total]


def build_corner_table(df: torch.Tensor, bb_size: torch.Tensor,
                       bb_offset: torch.Tensor) -> torch.Tensor:
    """(G, 8) table: for every gridpoint g, the DF at the 8 corners of the
    cell whose low corner is g, in d000..d111 order (digits = x, y, z;
    flat strides 1 / sx*sz / sx, getDFindex, collisionsv2.cl:152-156).
    Out-of-grid +1 corners are clamped; handle_collisions never reads
    those rows (it clips cells to [0, size-2])."""
    total = df.shape[0]
    g = torch.arange(total, dtype=torch.int64, device=df.device)
    owner = torch.searchsorted(bb_offset.to(torch.int64), g, right=True) - 1
    owner = torch.clamp(owner, 0, bb_size.shape[0] - 1)
    size = bb_size[owner].to(torch.int64)
    sx, sz = size[:, 0], size[:, 2]
    plane = sx * sz
    cols = []
    for a in (0, 1):  # x
        for b in (0, 1):  # y
            for c in (0, 1):  # z
                idx = torch.clamp(g + a + plane * b + sx * c, 0, total - 1)
                cols.append(df[idx])
    return torch.stack(cols, dim=1)


def build_device_scene(scene: Scene | None, device, **bake_kwargs) -> DeviceScene | None:
    """Scene -> DeviceScene with the baked DF (sph_simulation.cpp:311-326)."""
    if scene is None or scene.face_count == 0:
        return None
    arrs = device_scene_arrays(scene, device)
    df = bake_distance_field(scene, device, **bake_kwargs)
    corner8 = build_corner_table(df, arrs["bb_size"], arrs["bb_offset"])
    return DeviceScene(df=df, corner8=corner8, **arrs)


class CollisionResponse(NamedTuple):
    position: torch.Tensor
    next_velocity: torch.Tensor
    collision_happened: torch.Tensor


def handle_collisions(
    scene: DeviceScene | None,
    old_position: torch.Tensor,
    position: torch.Tensor,
    next_velocity: torch.Tensor,
    restitution: float,
    time_elapsed: torch.Tensor,
    *,
    face_chunk: int = 256,
) -> CollisionResponse:
    """Vectorised handle_collisions (collisionsv2.cl:249-336), with the
    JAX package's two intentional differences: DF cells are clipped to
    [0, size-2], and |next_velocity| is floored at 1e-12 in the
    restitution term."""
    if scene is None:
        return CollisionResponse(
            position, next_velocity,
            torch.zeros(position.shape[0], dtype=torch.bool, device=position.device),
        )

    n = position.shape[0]
    f_total = scene.face_count
    # the LAST containing face AABB (collisionsv2.cl:253-261)
    indice = torch.full((n,), -1, dtype=torch.int32, device=position.device)
    for base in range(0, f_total, face_chunk):
        c_min = scene.bb_min[base : base + face_chunk]
        c_max = scene.bb_max[base : base + face_chunk]
        in_box = torch.all(
            (position[:, None, :] <= c_max[None]) & (position[:, None, :] >= c_min[None]),
            dim=-1,
        )
        ids = torch.arange(
            base, base + c_min.shape[0], dtype=torch.int32, device=position.device
        )
        best = torch.amax(torch.where(in_box, ids[None, :], -1), dim=1)
        indice = torch.maximum(indice, best.to(torch.int32))
    found = indice >= 0
    safe_f = torch.clamp(indice, 0, f_total - 1).to(torch.int64)

    bmin = scene.bb_min[safe_f]
    bmax = scene.bb_max[safe_f]
    size = scene.bb_size[safe_f]
    offset = scene.bb_offset[safe_f]
    side = (bmax - bmin) / torch.clamp(size.to(torch.float32) - 1.0, min=1.0)

    cell = ((position - bmin) / side).to(torch.int32)
    # cells clipped to [0, size-2]: the +1 corners stay in this face's grid
    cell = torch.minimum(torch.clamp(cell, min=0), size - 2)
    x, y, z = cell[:, 0], cell[:, 1], cell[:, 2]
    sx, sz = size[:, 0], size[:, 2]
    base = cell.to(torch.float32) * side + bmin

    idx0 = (offset + y * sx * sz + sx * z + x).to(torch.int64)
    corners = scene.corner8[idx0]
    d000, d001, d010, d011 = (corners[:, k] for k in range(4))
    d100, d101, d110, d111 = (corners[:, k] for k in range(4, 8))

    def wavg(xq, x1, x2, f1, f2):
        # weigthedAverage (collisionsv2.cl:140-142)
        return ((x2 - xq) / (x2 - x1)) * f1 + ((xq - x1) / (x2 - x1)) * f2

    def bilerp(xq, yq, xmin, ymin, xmax, ymax, f00, f01, f10, f11):
        r1 = wavg(xq, xmin, xmax, f00, f10)
        r2 = wavg(xq, xmin, xmax, f01, f11)
        return wavg(yq, ymin, ymax, r1, r2)

    px, py, pz = position[:, 0], position[:, 1], position[:, 2]
    bx, by, bz = base[:, 0], base[:, 1], base[:, 2]
    sxs, sys_, szs = side[:, 0], side[:, 1], side[:, 2]

    facedown = bilerp(px, pz, bx, bz, bx + sxs, bz + szs, d000, d001, d100, d101)
    faceup = bilerp(px, pz, bx, bz, bx + sxs, bz + szs, d010, d011, d110, d111)
    d = wavg(py, by, by + sys_, facedown, faceup)

    colliding = found & (d < CONTACT_DISTANCE)

    faceright = bilerp(py, pz, by, bz, by + sys_, bz + szs, d100, d101, d110, d111)
    faceleft = bilerp(py, pz, by, bz, by + sys_, bz + szs, d000, d001, d010, d011)
    faceback = bilerp(px, py, bx, by, bx + sxs, by + sys_, d000, d010, d100, d110)
    facefront = bilerp(px, py, bx, by, bx + sxs, by + sys_, d001, d011, d101, d111)

    normal = torch.stack(
        [faceright - faceleft, faceup - facedown, facefront - faceback], dim=1
    )
    nlen = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    normal = normal / torch.where(nlen > 0.0, nlen, 1.0)

    # respond (collisionsv2.cl:9-22)
    absd = torch.abs(d)[:, None]
    new_position = position + absd * normal
    speed = torch.linalg.vector_norm(next_velocity, dim=1, keepdim=True)
    coef = 1.0 + restitution * absd / (time_elapsed * torch.clamp(speed, min=1e-12))
    vdotn = torch.sum(next_velocity * normal, dim=1, keepdim=True)
    new_velocity = next_velocity - coef * vdotn * normal

    cmask = colliding[:, None]
    return CollisionResponse(
        position=torch.where(cmask, new_position, position),
        next_velocity=torch.where(cmask, new_velocity, next_velocity),
        collision_happened=colliding,
    )
