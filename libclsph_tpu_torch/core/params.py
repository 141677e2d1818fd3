"""Simulation parameters and precomputed smoothing-kernel coefficients.

PyTorch counterpart of ``libclsph_tpu/core/params.py``: the same
two-JSON schema (a *fluid properties* file and a *simulation
properties* file, reference ``libclsph/sph_simulation.cpp:434-532``),
the same derived support radius ``h`` and the same five kernel
coefficients. Parameters are plain Python floats in a frozen
dataclass; tensors are made from them where a device is known.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Tuple

import torch

# Grid cells have side 2h (the smoothing support diameter).
GRID_CELL_SIDE_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class PrecomputedKernelValues:
    """Smoothing-kernel normalisation coefficients
    (``precomputed_kernel_values``, structures.h:46-52)."""

    poly_6: float
    poly_6_gradient: float
    poly_6_laplacian: float
    spiky: float
    viscosity: float

    @staticmethod
    def from_h(h: float) -> "PrecomputedKernelValues":
        h = float(h)
        return PrecomputedKernelValues(
            poly_6=315.0 / (64.0 * math.pi * h**9),
            poly_6_gradient=-945.0 / (32.0 * math.pi * h**9),
            poly_6_laplacian=-945.0 / (32.0 * math.pi * h**9),
            spiky=-45.0 / (math.pi * h**6),
            viscosity=45.0 / (math.pi * h**6),
        )


@dataclasses.dataclass(frozen=True)
class SimulationParameters:
    """Static simulation parameters (``simulation_parameters``,
    structures.h:16-38, minus the per-substep grid fields, which
    ops/grid.py recomputes on the device)."""

    particles_count: int
    fluid_density: float
    total_mass: float
    particle_mass: float
    dynamic_viscosity: float
    simulation_time: float
    h: float
    simulation_scale: float
    target_fps: float
    surface_tension_threshold: float
    surface_tension: float
    restitution: float
    K: float
    constant_acceleration: Tuple[float, float, float]
    initial_volume: float
    write_all_frames: bool = False
    serialize: bool = False

    @property
    def cell_side(self) -> float:
        return GRID_CELL_SIDE_FACTOR * self.h

    @property
    def frame_time(self) -> float:
        return 1.0 / self.target_fps

    @property
    def max_dt(self) -> float:
        # dt clamp upper bound (sph_simulation.cpp:601-602)
        return self.frame_time * self.simulation_scale

    def precomputed(self) -> PrecomputedKernelValues:
        return PrecomputedKernelValues.from_h(self.h)

    def gravity(self, device) -> torch.Tensor:
        return torch.tensor(
            self.constant_acceleration, dtype=torch.float32, device=device
        )


def _req(obj: dict, key: str, path: str) -> Any:
    if key not in obj:
        raise KeyError(f"missing key {key!r} in {path}")
    return obj[key]


def derive_parameters(
    fluid: dict, sim: dict, *, fluid_path: str = "<fluid>", sim_path: str = "<sim>"
) -> SimulationParameters:
    """Combine the two config dicts (sph_simulation.cpp:519-531):
    total_mass = N * m, V = total_mass / rho0,
    h = cbrt(3 * n_inside * (V/N) / (4*pi))."""
    restitution = float(_req(fluid, "restitution", fluid_path))
    if restitution < 0.0 or restitution > 1.0:
        raise ValueError("Restitution has an invalid value!")

    n = int(_req(sim, "particles_count", sim_path))
    particle_mass = float(_req(sim, "particle_mass", sim_path))
    fluid_density = float(_req(fluid, "fluid_density", fluid_path))
    n_inside = float(_req(fluid, "particles_inside_influence_radius", fluid_path))

    total_mass = n * particle_mass
    initial_volume = total_mass / fluid_density
    h = (3.0 * n_inside * (initial_volume / n) / (4.0 * math.pi)) ** (1.0 / 3.0)

    accel = _req(sim, "constant_acceleration", sim_path)
    return SimulationParameters(
        particles_count=n,
        fluid_density=fluid_density,
        total_mass=total_mass,
        particle_mass=particle_mass,
        dynamic_viscosity=float(_req(fluid, "dynamic_viscosity", fluid_path)),
        simulation_time=float(_req(sim, "simulation_time", sim_path)),
        h=h,
        simulation_scale=float(_req(sim, "simulation_scale", sim_path)),
        target_fps=float(_req(sim, "target_fps", sim_path)),
        surface_tension_threshold=float(
            _req(fluid, "surface_tension_threshold", fluid_path)
        ),
        surface_tension=float(_req(fluid, "surface_tension", fluid_path)),
        restitution=restitution,
        K=float(_req(fluid, "k", fluid_path)),
        constant_acceleration=(
            float(accel["x"]),
            float(accel["y"]),
            float(accel["z"]),
        ),
        initial_volume=initial_volume,
        write_all_frames=bool(sim.get("write_all_frames", False)),
        serialize=bool(sim.get("serialize", False)),
    )


def _load_lenient_json(path: str | os.PathLike) -> dict:
    """Parse a JSON object, tolerating trailing garbage: the reference's
    shipped configs end with ``};``."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        obj, _ = json.JSONDecoder().raw_decode(text.lstrip())
        return obj


def load_parameters(
    fluid_file_name: str | os.PathLike, parameters_file_name: str | os.PathLike
) -> SimulationParameters:
    """Load parameters from the two JSON files (sph_simulation.cpp:434-532)."""
    fluid = _load_lenient_json(fluid_file_name)
    sim = _load_lenient_json(parameters_file_name)
    return derive_parameters(
        fluid, sim, fluid_path=str(fluid_file_name), sim_path=str(parameters_file_name)
    )
