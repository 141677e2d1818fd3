"""Particle state as a structure of tensors.

PyTorch counterpart of ``libclsph_tpu/core/state.py``: one contiguous
tensor per field of the reference's ``particle`` struct
(``libclsph/common/structures.h:40-44``). ``grid_index`` holds the
30-bit Morton code as ``int32``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import SimulationParameters

FIELDS = (
    "position",
    "velocity",
    "intermediate_velocity",
    "acceleration",
    "density",
    "pressure",
    "grid_index",
)


@dataclasses.dataclass
class ParticleState:
    """position / velocity / intermediate_velocity / acceleration (N,3)
    float32, density / pressure (N,) float32, grid_index (N,) int32."""

    position: torch.Tensor
    velocity: torch.Tensor
    intermediate_velocity: torch.Tensor
    acceleration: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor
    grid_index: torch.Tensor

    @property
    def n(self) -> int:
        return self.position.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ParticleState":
        """Apply ``fn`` to every field tensor."""
        return ParticleState(**{k: fn(getattr(self, k)) for k in FIELDS})

    @staticmethod
    def zeros(n: int, device) -> "ParticleState":
        f = dict(dtype=torch.float32, device=device)
        return ParticleState(
            position=torch.zeros((n, 3), **f),
            velocity=torch.zeros((n, 3), **f),
            intermediate_velocity=torch.zeros((n, 3), **f),
            acceleration=torch.zeros((n, 3), **f),
            density=torch.zeros((n,), **f),
            pressure=torch.zeros((n,), **f),
            grid_index=torch.zeros((n,), dtype=torch.int32, device=device),
        )


def init_lattice_positions(params: SimulationParameters) -> np.ndarray:
    """Cube-lattice placement (init_particles, sph_simulation.cpp:52-98):
    a cube of side ``cbrt(initial_volume)`` centred in x/z, resting on
    y=0, index-ordered x-fastest then y then z."""
    n = params.particles_count
    per_side = int(np.ceil(np.cbrt(n)))
    side_length = float(np.cbrt(params.initial_volume))
    spacing = side_length / per_side

    i = np.arange(n)
    x = (i % per_side).astype(np.float32) * spacing - side_length / 2.0
    y = ((i // per_side) % per_side).astype(np.float32) * spacing
    z = (i // (per_side * per_side)).astype(np.float32) * spacing - side_length / 2.0
    return np.stack([x, y, z], axis=1).astype(np.float32)


def init_state(params: SimulationParameters, device) -> ParticleState:
    """Fresh state on the cube lattice with zero velocities."""
    state = ParticleState.zeros(params.particles_count, device)
    pos = torch.from_numpy(init_lattice_positions(params)).to(device)
    return state.replace(position=pos)
