"""Minimal classic Houdini binary ``.bgeo`` writer (big-endian V5).

Optional fast binary export path, standing in for the reference's
partio branch (``houdini_file_saver.cpp:78-88`` under ``USE_PARTIO``,
adapter ``util/partio/PartioFunctions.h:5-65``). Same attribute set:
velocity(3), color(3), id(1 int), mass(1), pscale(1) — position is
implicit. (The reference's adapter has a copy-paste bug that leaves
vel[1]/vel[2] unset; we write all three components.)

Writes a points-only geometry (NPrims 0): Houdini and partio load this
as a point cloud. Layout follows the public classic-bgeo structure:
big-endian, 'BgeoV' magic + int32 version, counts header, attribute
dictionaries ([int16 namelen][name][uint16 size][int32 type][defaults]),
then per-point homogeneous position + attribute payload, then
"extra" end markers for point/prim groups.
"""

from __future__ import annotations

import struct
from typing import IO

import numpy as np

_BE = ">"


# classic-geo attribute type codes (partio BGEO.cpp: FLOAT=0, INT=1,
# VECTOR=5)
_TCODE = {"float": 0, "int": 1, "vector": 5}


def _write_attrib_def(out: IO[bytes], name: str, size: int, dtype: str) -> None:
    nb = name.encode()
    out.write(struct.pack(_BE + "H", len(nb)))
    out.write(nb)
    out.write(struct.pack(_BE + "Hi", size, _TCODE[dtype]))
    for _ in range(size):
        # defaults are written as 4-byte words regardless of type
        out.write(struct.pack(_BE + "i", 0))


def dump_bgeo(
    out: IO[bytes],
    position: np.ndarray,
    velocity: np.ndarray,
    color: np.ndarray,
    mass: float,
    pscale: float,
) -> None:
    n = int(position.shape[0])
    out.write(b"Bgeo")
    out.write(b"V")
    out.write(struct.pack(_BE + "i", 5))
    # npoints nprims npointgroups nprimgroups
    out.write(struct.pack(_BE + "4i", n, 0, 0, 0))
    # npointattrib nvertexattrib nprimattrib nattrib
    out.write(struct.pack(_BE + "4i", 5, 0, 0, 0))

    # the reference adapter's attribute set and types
    # (PartioFunctions.h:8-13; position rides the homogeneous slot)
    _write_attrib_def(out, "velocity", 3, "vector")
    _write_attrib_def(out, "color", 3, "vector")
    _write_attrib_def(out, "id", 1, "int")
    _write_attrib_def(out, "mass", 1, "float")
    _write_attrib_def(out, "pscale", 1, "float")

    # Per-point payload: [x y z 1] v color id mass pscale — build as one
    # big-endian f32 matrix (ids bit-cast into the float lanes).
    payload = np.empty((n, 13), dtype=_BE + "f4")
    payload[:, 0:3] = position
    payload[:, 3] = 1.0
    payload[:, 4:7] = velocity
    payload[:, 7:10] = color
    ids = np.arange(n, dtype=_BE + "i4")
    payload[:, 10] = ids.view(_BE + "f4")
    payload[:, 11] = mass
    payload[:, 12] = pscale
    out.write(payload.tobytes())

    # trailer: beginExtra/endExtra equivalent for binary = two 0x00
    # chunk markers (no point/prim groups, no details)
    out.write(b"\x00\xff")
