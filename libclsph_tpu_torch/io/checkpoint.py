"""Checkpoint / resume of the particle state.

PyTorch counterpart of ``libclsph_tpu/io/checkpoint.py``: one ``.npz``
with the state's arrays plus a fingerprint of the parameters, so a
checkpoint written with other parameters is refused (the reference only
checks the file size, particles.cpp:74-95). The file format is the JAX
package's: float32 fields and a uint32 ``grid_index``.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.params import SimulationParameters
from ..core.state import FIELDS, ParticleState

DEFAULT_CHECKPOINT = "last_frame.npz"

_FINGERPRINT_FIELDS = (
    "particles_count",
    "fluid_density",
    "particle_mass",
    "dynamic_viscosity",
    "h",
    "K",
    "restitution",
    "surface_tension",
    "surface_tension_threshold",
)


def params_fingerprint(params: SimulationParameters) -> str:
    data = {k: getattr(params, k) for k in _FINGERPRINT_FIELDS}
    return hashlib.sha256(json.dumps(data, sort_keys=True).encode()).hexdigest()[:16]


def save_checkpoint(path: str, state_arrays: dict, params: SimulationParameters) -> None:
    """``state_arrays``: field name -> host NumPy array. Written to a
    temporary file first and renamed, so a reader never sees half a file."""
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        fingerprint=np.frombuffer(params_fingerprint(params).encode(), dtype=np.uint8),
        **state_arrays,
    )
    os.replace(tmp, path)


def load_checkpoint(path: str, params: SimulationParameters) -> Optional[dict]:
    """Field dict, or None when there is no checkpoint. Raises ValueError
    on a fingerprint or size mismatch."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != params_fingerprint(params):
            raise ValueError(
                f"checkpoint {path} was written with different simulation "
                "parameters; delete it to start fresh"
            )
        arrays = {k: z[k] for k in z.files if k != "fingerprint"}
    n = params.particles_count
    for k, v in arrays.items():
        if v.shape[0] != n:
            raise ValueError(
                f"checkpoint field {k} has {v.shape[0]} particles, expected {n}"
            )
    return arrays


def state_to_arrays(state: ParticleState) -> dict:
    """Host copies of every field (callbacks may mutate them in place)."""
    out = {k: getattr(state, k).detach().cpu().numpy().copy() for k in FIELDS}
    out["grid_index"] = out["grid_index"].astype(np.uint32)
    return out


def arrays_to_state(arrays: dict, device) -> ParticleState:
    """Host arrays (as written by :func:`state_to_arrays`) -> state."""
    fields = {
        k: torch.as_tensor(np.array(arrays[k], dtype=np.float32), device=device)
        for k in FIELDS if k != "grid_index"
    }
    fields["grid_index"] = torch.as_tensor(
        np.asarray(arrays["grid_index"]).astype(np.int64).astype(np.int32), device=device
    )
    return ParticleState(**fields)
