"""Minimal Wavefront OBJ loader (triangle meshes).

Replaces the vendored tinyobjloader used by the reference
(``libclsph/scene.cpp:16``). Supports ``v`` and ``f`` records (with
``v/vt/vn`` face syntax), groups multiple ``o``/``g`` shapes, and
fan-triangulates polygonal faces (a superset of the reference, which
rejects non-triangle faces, scene.cpp:30-33).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjShape:
    name: str
    vertices: list = field(default_factory=list)  # flat [x,y,z,...]
    indices: list = field(default_factory=list)  # flat triangle indices


@dataclass
class ObjMesh:
    vertices: np.ndarray  # (V, 3) float32
    triangles: np.ndarray  # (F, 3) int32


def load_obj(path: str | os.PathLike) -> ObjMesh:
    """Parse an OBJ file into a single combined triangle mesh."""
    vertices: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int]] = []

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f":
                # Each vertex spec is v, v/vt, v//vn or v/vt/vn; OBJ
                # indices are 1-based (negative = relative to end).
                idx = []
                for spec in parts[1:]:
                    v = spec.split("/")[0]
                    i = int(v)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    triangles.append((idx[0], idx[k], idx[k + 1]))
            # mtllib/usemtl/o/g/s/vn/vt: irrelevant to collision geometry.

    if not triangles:
        raise ValueError(f"no faces found in {path}")
    return ObjMesh(
        vertices=np.asarray(vertices, dtype=np.float32),
        triangles=np.asarray(triangles, dtype=np.int32),
    )
