"""Named simulation presets — the framework's "model zoo".

A copy of ``libclsph_tpu/models/presets.py`` over the port's
``core.params`` (the JAX package is not imported).

The reference ships two fluid property sets (water/mucus,
fluid_properties/*.json) and one simulation config
(simulation_properties/default.json); its benchmark-relevant workloads
are the scene x fluid combinations enumerated in BASELINE.md. This
registry packages those as one-call presets so a user can run any
headline workload without hand-assembling configs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.params import SimulationParameters, derive_parameters

WATER = dict(
    fluid_density=998.29,
    dynamic_viscosity=3.5,
    restitution=0.0,
    k=100,
    surface_tension_threshold=7.065,
    surface_tension=0.0728,
    particles_inside_influence_radius=20,
)

MUCUS = dict(
    fluid_density=1000,
    dynamic_viscosity=36,
    restitution=0.5,
    k=5,
    surface_tension_threshold=5,
    surface_tension=6,
    particles_inside_influence_radius=40,
)

FLUIDS = {"water": WATER, "mucus": MUCUS}


def simulation_config(
    particles_count: int = 64000,
    particle_mass: float = 0.05,
    simulation_time: float = 3.0,
    target_fps: float = 60.0,
    simulation_scale: float = 0.1,
    gravity: tuple = (0.0, -9.8, 0.0),
    write_all_frames: bool = False,
    serialize: bool = False,
) -> dict:
    """simulation_properties/default.json schema."""
    return dict(
        particles_count=particles_count,
        particle_mass=particle_mass,
        simulation_time=simulation_time,
        target_fps=target_fps,
        simulation_scale=simulation_scale,
        write_all_frames=write_all_frames,
        serialize=serialize,
        constant_acceleration=dict(x=gravity[0], y=gravity[1], z=gravity[2]),
    )


@dataclass(frozen=True)
class Preset:
    """A runnable workload: fluid + sim config + scene."""

    name: str
    fluid: dict
    sim: dict
    scene: Optional[str]  # scenes/<name>.obj or None (free space)
    description: str = ""

    def parameters(self) -> SimulationParameters:
        return derive_parameters(dict(self.fluid), dict(self.sim))


# The benchmark matrix of BASELINE.md.
PRESETS = {
    "dam-break-cube": Preset(
        "dam-break-cube",
        WATER,
        simulation_config(particles_count=8192),
        "cube.obj",
        "water dam-break into the unit cube (correctness anchor)",
    ),
    "water-box-64k": Preset(
        "water-box-64k",
        WATER,
        simulation_config(particles_count=64000),
        "box.obj",
        "64k water in an open box, viscosity + surface tension",
    ),
    "mucus-cone": Preset(
        "mucus-cone",
        MUCUS,
        simulation_config(particles_count=64000),
        "cone.obj",
        "high-viscosity mucus in a cone (stiff EOS stress test)",
    ),
    "shower-monkey-256k": Preset(
        "shower-monkey-256k",
        WATER,
        simulation_config(particles_count=262144),
        "monkey.obj",
        "256k shower.obj-emitter onto the monkey.obj obstacle "
        "(BASELINE matrix #4). The emitter is USER CODE via the "
        "pre_frame write-back hook, exactly like the reference "
        "(sph_simulation.cpp:730-748) — run it with "
        "experiments/emitter_run.py; the bare preset (no emitter) "
        "rains the initial lattice past the obstacle once.",
    ),
    "monkeybox-256k": Preset(
        "monkeybox-256k",
        WATER,
        simulation_config(particles_count=262144),
        "monkeybox.obj",
        "256k water onto an obstacle in a box (mesh-collision heavy, "
        "no emitter — the CLI-only stand-in)",
    ),
    "river-1m": Preset(
        "river-1m",
        WATER,
        simulation_config(particles_count=1048576),
        "river.obj",
        "1M+ particle flow-through channel",
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]
