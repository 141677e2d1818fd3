"""Scene: triangle mesh -> per-face collision precompute.

Re-implements scene::load (``libclsph/scene.cpp:9-153``) with NumPy
vectorisation. For every triangle face the reference precomputes:

* the unit normal ``n`` from the edge cross product (scene.cpp:41-77);
* an AABB over the 3 vertices dilated by ``distFieldThreshold`` (= 2h)
  on every side (scene.cpp:82-107);
* a per-face distance-field grid sized
  ``ceil((max-min)/threshold * 2) + 1`` per axis — i.e. ~h spacing —
  flattened into one big buffer via running ``offset``
  (scene.cpp:109-118);
* a world -> face-local rotation whose rows are
  (n, uu x n, uu) with uu = normalize(v1 - v0), plus translation -v0,
  stored row-major 3x4 (scene.cpp:122-143);
* ``rvertices``: the 2-D coordinates of the two edge vectors in the
  face plane (scene.cpp:145-149).

Arrays here are the SoA equivalents of ``std::vector<BB>`` etc.
(scene.h:8-20) ready to ship to device for the DF bake
(ops/collisions.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .obj_loader import ObjMesh, load_obj


@dataclass
class Scene:
    """Per-face collision data (SoA over faces F)."""

    face_count: int
    face_normals: np.ndarray  # (F, 3) f32
    vertices: np.ndarray  # (V, 3) f32 raw mesh vertices
    triangles: np.ndarray  # (F, 3) i32
    bb_min: np.ndarray  # (F, 3) f32 dilated AABB
    bb_max: np.ndarray  # (F, 3) f32
    bb_size: np.ndarray  # (F, 3) i64 DF gridpoints per axis
    bb_offset: np.ndarray  # (F,)  i64 flat offset into df buffer
    rotations: np.ndarray  # (F, 3, 3) f32 rows = (n, uv, uu)
    translations: np.ndarray  # (F, 3) f32 = -v0
    rvertices: np.ndarray  # (F, 4) f32 (u.uv, u.uu, v.uv, v.uu)
    total_gridpoints: int

    @staticmethod
    def from_mesh(mesh: ObjMesh, dist_field_threshold: float) -> "Scene":
        v0 = mesh.vertices[mesh.triangles[:, 0]]  # (F,3)
        v1 = mesh.vertices[mesh.triangles[:, 1]]
        v2 = mesh.vertices[mesh.triangles[:, 2]]
        u = v1 - v0
        v = v2 - v0

        n = np.cross(u, v)
        n_len = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / n_len
        uu = u / np.linalg.norm(u, axis=1, keepdims=True)
        uv = np.cross(uu, n)  # (uu x n), scene.cpp:126-128

        thresh = float(dist_field_threshold)
        tri = np.stack([v0, v1, v2], axis=1)  # (F,3,3)
        bb_min = tri.min(axis=1) - thresh
        bb_max = tri.max(axis=1) + thresh
        # ceil((max-min)/thresh * 2) + 1 (scene.cpp:109-114) -> ~h spacing.
        bb_size = (np.ceil((bb_max - bb_min) / thresh * 2) + 1).astype(np.int64)

        gridpoints = bb_size.prod(axis=1)
        bb_offset = np.concatenate([[0], np.cumsum(gridpoints)[:-1]]).astype(np.int64)
        total = int(gridpoints.sum())

        rotations = np.stack([n, uv, uu], axis=1).astype(np.float32)  # (F,3,3)
        rvertices = np.stack(
            [
                (u * uv).sum(axis=1),
                (u * uu).sum(axis=1),
                (v * uv).sum(axis=1),
                (v * uu).sum(axis=1),
            ],
            axis=1,
        ).astype(np.float32)

        return Scene(
            face_count=int(mesh.triangles.shape[0]),
            face_normals=n.astype(np.float32),
            vertices=mesh.vertices,
            triangles=mesh.triangles,
            bb_min=bb_min.astype(np.float32),
            bb_max=bb_max.astype(np.float32),
            bb_size=bb_size,
            bb_offset=bb_offset,
            rotations=rotations,
            translations=(-v0).astype(np.float32),
            rvertices=rvertices,
            total_gridpoints=total,
        )

    @staticmethod
    def load(
        filename: str | os.PathLike,
        dist_field_threshold: float,
        scenes_dir: str | os.PathLike | None = "scenes",
    ) -> "Scene":
        """Load ``scenes/<filename>`` like scene::load (scene.cpp:16-17).

        Absolute paths and paths to existing files are used as-is.
        """
        path = str(filename)
        if scenes_dir is not None and not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(str(scenes_dir), path)
        return Scene.from_mesh(load_obj(path), dist_field_threshold)
