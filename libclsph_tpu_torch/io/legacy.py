"""Interop with the reference's binary particle dumps.

The reference checkpoints by streaming the raw AoS ``particle`` array
to ``last_frame.bin`` with cereal's saveBinary (example/particles.cpp:
35-40) and resumes by size-checked loadBinary (sph_simulation.cpp:
63-71, particles.cpp:74-95). The struct (structures.h:40-44) uses
``cl_float3`` fields, which are 16-byte (float4) aligned:

    position, velocity, intermediate_velocity, acceleration : 4 x 16 B
    density, pressure : 2 x 4 B
    grid_index : 4 B
    + 4 B tail padding -> 80 bytes per particle

This module reads/writes that exact layout so users can migrate
existing reference checkpoints into the port (and export back for
side-by-side comparison runs). It is NumPy only, the port's own copy of
``libclsph_tpu/io/legacy.py``: the files it writes are byte-for-byte
those of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

LEGACY_PARTICLE_DTYPE = np.dtype(
    {
        "names": [
            "position",
            "velocity",
            "intermediate_velocity",
            "acceleration",
            "density",
            "pressure",
            "grid_index",
        ],
        "formats": [
            ("<f4", (4,)),  # cl_float3 occupies 4 floats
            ("<f4", (4,)),
            ("<f4", (4,)),
            ("<f4", (4,)),
            "<f4",
            "<f4",
            "<u4",
        ],
        "offsets": [0, 16, 32, 48, 64, 68, 72],
        "itemsize": 80,
    }
)


def read_legacy_checkpoint(path: str | os.PathLike, particles_count: int) -> dict:
    """Parse a reference ``last_frame.bin`` into SoA arrays.

    Applies the reference's size validation (particles.cpp:85-92):
    raises ValueError when the file does not hold exactly
    ``particles_count`` 80-byte records.
    """
    size = os.path.getsize(path)
    expected = particles_count * LEGACY_PARTICLE_DTYPE.itemsize
    if size != expected:
        raise ValueError(
            f"Serialized frame of incorrect size found: {size} bytes, "
            f"expected {expected} for {particles_count} particles"
        )
    raw = np.fromfile(path, dtype=LEGACY_PARTICLE_DTYPE, count=particles_count)
    return {
        "position": np.ascontiguousarray(raw["position"][:, :3]),
        "velocity": np.ascontiguousarray(raw["velocity"][:, :3]),
        "intermediate_velocity": np.ascontiguousarray(
            raw["intermediate_velocity"][:, :3]
        ),
        "acceleration": np.ascontiguousarray(raw["acceleration"][:, :3]),
        "density": np.ascontiguousarray(raw["density"]),
        "pressure": np.ascontiguousarray(raw["pressure"]),
        "grid_index": np.ascontiguousarray(raw["grid_index"]),
    }


def write_legacy_checkpoint(path: str | os.PathLike, arrays: dict) -> None:
    """Write SoA arrays as a reference-layout ``last_frame.bin``."""
    n = arrays["position"].shape[0]
    raw = np.zeros(n, dtype=LEGACY_PARTICLE_DTYPE)
    for key in ("position", "velocity", "intermediate_velocity", "acceleration"):
        raw[key][:, :3] = arrays[key]
    raw["density"] = arrays["density"]
    raw["pressure"] = arrays["pressure"]
    raw["grid_index"] = arrays.get("grid_index", np.zeros(n, np.uint32))
    raw.tofile(path)
