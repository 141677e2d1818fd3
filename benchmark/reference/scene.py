"""Plain reference of upstream's mesh collisions: the per-face distance
field baked from a Wavefront ``.obj`` and the response that reads it.

Upstream (``scene.cpp:9-153``, ``collisionsv2.cl``) gives every triangle
a box around it, dilated by 2h, with a grid of gridpoints ~h apart; the
field at a gridpoint is the signed distance to the nearest face whose box
holds it (the first of equal ones, in face order), signed by the side of
that face's plane. A particle reads the grid of the last face whose box
holds it, by trilinear interpolation, and below the contact distance
0.02 is pushed out along the field's gradient and its velocity reflected
with the restitution.

A gridpoint that lies in a face's plane takes the sign of a coordinate
that is zero but for rounding, so the bake fixes the rounding of that
coordinate as the definition: the face-local point is R (p + t) formed by
fused multiply-adds in index order into an accumulator that starts at
+0.0, in float32, and the point-to-segment distances are taken in float32
in the order of collisionsv2.cl:26-131. Everything else is plain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CONTACT = 0.02  # collisionsv2.cl:205/294
FAR = 20.0  # "no surface nearby" (collisionsv2.cl:63)
# band (in metres) around the contact distance and the boxes' faces
# inside which both outcomes of the decision are accepted
DECISION_BAND = 1e-5


def load_obj(path: str):
    """Vertices (V, 3) float32 and triangles (F, 3) of a Wavefront file:
    ``v`` records, ``f`` records (1-based, ``v/vt/vn`` syntax, polygons
    split into fans)."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                ids = []
                for spec in parts[1:]:
                    k = int(spec.split("/")[0])
                    ids.append(k - 1 if k > 0 else len(verts) + k)
                for a in range(1, len(ids) - 1):
                    tris.append([ids[0], ids[a], ids[a + 1]])
    return np.asarray(verts, dtype=np.float32), np.asarray(tris, dtype=np.int64)


class Field(NamedTuple):
    bb_min: torch.Tensor  # (F, 3) float32
    bb_max: torch.Tensor
    size: torch.Tensor  # (F, 3) int64 gridpoints a side
    offset: torch.Tensor  # (F,) int64 first gridpoint of each face
    df: torch.Tensor  # (G,) float32


def _faces(verts, tris, thresh: float):
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    u, v = v1 - v0, v2 - v0
    n = np.cross(u, v)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    uu = u / np.linalg.norm(u, axis=1, keepdims=True)
    uv = np.cross(uu, n)
    tri = np.stack([v0, v1, v2], axis=1)
    bb_min = tri.min(axis=1) - thresh
    bb_max = tri.max(axis=1) + thresh
    size = (np.ceil((bb_max - bb_min) / thresh * 2) + 1).astype(np.int64)
    rot = np.stack([n, uv, uu], axis=1).astype(np.float32)
    rv = np.stack([(u * uv).sum(1), (u * uu).sum(1), (v * uv).sum(1), (v * uu).sum(1)],
                  axis=1).astype(np.float32)
    return (bb_min.astype(np.float32), bb_max.astype(np.float32), size, rot,
            (-v0).astype(np.float32), rv)


def _local(p, rot, trans):
    """R (p + t) by fused multiply-adds in index order from +0.0 (float32,
    each step rounded once: a float32 product is exact in float64)."""
    tp = (p + trans).double()
    acc = torch.zeros(p.shape, dtype=torch.float64, device=p.device)
    for k in range(3):
        acc = (rot[..., k].double() * tp[..., k, None] + acc).float().double()
    return acc.float()


def _seg(px, py, pz, x1, y1, x2, y2):
    a, b = py - x1, pz - y1
    c, d = x2 - x1, y2 - y1
    dot = a * c + b * d
    len_sq = c * c + d * d
    nz = len_sq != 0.0
    t = torch.where(nz, dot / torch.where(nz, len_sq, 1.0), -1.0)
    xx = torch.where(t < 0.0, x1, torch.where(t > 1.0, x2, x1 + t * c))
    yy = torch.where(t < 0.0, y1, torch.where(t > 1.0, y2, y1 + t * d))
    dy, dz = py - xx, pz - yy
    return torch.sqrt(px * px + dz * dz + dy * dy)


def _face_distance(p, rot, trans, rv):
    """(unsigned distance, plane coordinate) of points p (..., 3) to the
    faces (broadcast), in the face frame."""
    lp = _local(p, rot, trans)
    px, py, pz = lp[..., 0], lp[..., 1], lp[..., 2]
    v1x, v1y, v2x, v2y = rv[..., 0], rv[..., 1], rv[..., 2], rv[..., 3]
    denom = v2x * v1y - v2y * 0.0
    safe = torch.where(denom != 0.0, denom, 1.0)
    a = (py * v1y - pz * 0.0) / safe
    b = -(py * v2y - pz * v2x) / safe
    inside = (a > 0.0) & (b > 0.0) & (a + b < 1.0) & (denom != 0.0)
    z = torch.zeros_like(v1x)
    d = torch.minimum(_seg(px, py, pz, z, z, v1x, v1y), _seg(px, py, pz, v1x, v1y, v2x, v2y))
    d = torch.minimum(d, _seg(px, py, pz, z, z, v2x, v2y))
    return torch.where(inside, px.abs(), d), px


def bake(obj_path: str, h: float, device, face_chunk: int = 64,
         point_chunk: int = 1 << 16) -> Field:
    """The distance field of the ``.obj`` at ``obj_path`` with the box
    dilation 2h (particles.cpp:67)."""
    verts, tris = load_obj(obj_path)
    bb_min, bb_max, size, rot, trans, rv = _faces(verts, tris, 2.0 * h)
    counts = size.prod(axis=1)
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    total = int(counts.sum())
    g = np.arange(total, dtype=np.int64)
    owner = np.searchsorted(offset, g, side="right") - 1
    sz = size[owner]
    li = g - offset[owner]
    plane = sz[:, 0] * sz[:, 2]
    coords = np.stack([(li % plane) % sz[:, 0], li // plane, (li % plane) // sz[:, 0]],
                      axis=1).astype(np.float64)
    pts = (coords * (bb_max[owner] - bb_min[owner]).astype(np.float64)
           / np.maximum(sz - 1.0, 1.0) + bb_min[owner]).astype(np.float32)

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    bmin, bmax, rot_t, tr_t, rv_t = t(bb_min), t(bb_max), t(rot), t(trans), t(rv)
    nf = bb_min.shape[0]
    out = []
    for s in range(0, total, point_chunk):
        p = t(pts[s:s + point_chunk])
        best = torch.full((p.shape[0],), float("inf"), device=device)
        sign = torch.zeros_like(best)
        for f in range(0, nf, face_chunk):
            sl = slice(f, f + face_chunk)
            inb = ((p[:, None] <= bmax[None, sl]) & (p[:, None] >= bmin[None, sl])).all(-1)
            d, px = _face_distance(p[:, None, :], rot_t[None, sl], tr_t[None, sl],
                                   rv_t[None, sl])
            d = torch.where(inb & (d < FAR), d, float("inf"))
            k = torch.argmin(d, dim=1, keepdim=True)  # first of equal minima
            dk = torch.gather(d, 1, k)[:, 0]
            better = dk < best  # strict: an earlier face keeps a tie
            best = torch.where(better, dk, best)
            sign = torch.where(better, torch.gather(px, 1, k)[:, 0], sign)
        out.append(torch.where(best < FAR, torch.copysign(best, sign), FAR))
    return Field(bmin, bmax, t(size), t(offset), torch.cat(out))


def _lookup(field: Field, x: torch.Tensor, face: torch.Tensor):
    """(d, unit normal) at x from ``face``'s grid by trilinear
    interpolation (collisionsv2.cl:140-336); cells clipped to [0, size-2]."""
    dt = x.dtype
    f = torch.clamp(face, min=0)
    bmin, bmax = field.bb_min[f].to(dt), field.bb_max[f].to(dt)
    size = field.size[f]
    side = (bmax - bmin) / torch.clamp(size.to(dt) - 1.0, min=1.0)
    cell = torch.minimum(torch.clamp(((x - bmin) / side).to(torch.int64), min=0), size - 2)
    base = cell.to(dt) * side + bmin
    sx, sz = size[:, 0], size[:, 2]

    def corner(a, b, c):
        idx = field.offset[f] + (cell[:, 1] + b) * sx * sz + sx * (cell[:, 2] + c) + cell[:, 0] + a
        return field.df[idx].to(dt)

    c = {(a, b, cc): corner(a, b, cc) for a in (0, 1) for b in (0, 1) for cc in (0, 1)}
    t = (x - base) / side  # fractions along x, y, z

    def lerp(f0, f1, s):
        return (1.0 - s) * f0 + s * f1

    tx, ty, tz = t[:, 0], t[:, 1], t[:, 2]

    def plane_xz(b):
        return lerp(lerp(c[0, b, 0], c[1, b, 0], tx), lerp(c[0, b, 1], c[1, b, 1], tx), tz)

    def plane_yz(a):
        return lerp(lerp(c[a, 0, 0], c[a, 1, 0], ty), lerp(c[a, 0, 1], c[a, 1, 1], ty), tz)

    def plane_xy(cc):
        return lerp(lerp(c[0, 0, cc], c[1, 0, cc], tx), lerp(c[0, 1, cc], c[1, 1, cc], tx), ty)

    down, up = plane_xz(0), plane_xz(1)
    d = lerp(down, up, ty)
    normal = torch.stack([plane_yz(1) - plane_yz(0), up - down, plane_xy(1) - plane_xy(0)], 1)
    nlen = torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    return d, normal / torch.where(nlen > 0, nlen, 1.0)


def _last_face(field: Field, x: torch.Tensor, grow: float) -> torch.Tensor:
    """Index of the last face whose box, grown by ``grow``, holds x; -1
    where none does."""
    dt = x.dtype
    nf = field.bb_min.shape[0]
    out = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    for f in range(0, nf, 256):
        lo = field.bb_min[f:f + 256].to(dt) - grow
        hi = field.bb_max[f:f + 256].to(dt) + grow
        inb = ((x[:, None] <= hi[None]) & (x[:, None] >= lo[None])).all(-1)
        ids = torch.arange(f, f + lo.shape[0], device=x.device)
        out = torch.maximum(out, torch.where(inb, ids[None], -1).amax(1))
    return out


def respond(field, x, v_next, restitution: float, dt: float):
    """The outcomes of the collision response at the advected positions
    ``x``: the reference's own, then each other outcome that a decision
    inside DECISION_BAND allows (another last box, the contact taken or
    not). Yields (position, next_velocity)."""
    if field is None:
        yield x, v_next
        return
    faces = [_last_face(field, x, -DECISION_BAND), _last_face(field, x, DECISION_BAND)]
    if torch.equal(faces[0], faces[1]):
        faces = faces[:1]
    for face in faces:
        d, normal = _lookup(field, x, face)
        found = face >= 0
        hit = found & (d < CONTACT)
        ambiguous = found & ((d - CONTACT).abs() < DECISION_BAND)
        ad = d.abs()[:, None]
        speed = torch.linalg.vector_norm(v_next, dim=1, keepdim=True)
        coef = 1.0 + restitution * ad / (dt * torch.clamp(speed, min=1e-12))
        vdotn = (v_next * normal).sum(1, keepdim=True)
        x_hit = x + ad * normal
        v_hit = v_next - coef * vdotn * normal
        for decision in ([hit, hit ^ ambiguous] if bool(ambiguous.any()) else [hit]):
            m = decision[:, None]
            yield torch.where(m, x_hit, x), torch.where(m, v_hit, v_next)
