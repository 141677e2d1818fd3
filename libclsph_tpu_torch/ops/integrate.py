"""Leapfrog advection and the adaptive time step.

PyTorch counterpart of ``libclsph_tpu/ops/integrate.py``: ``advect``
(advection.cl:6-18), the half-step velocity reconstruction
(sphb.cl:214-218) and the CFL rule of computeTimeStep
(sph_simulation.cpp:536-605). The time step stays a device scalar.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.params import SimulationParameters

DT_MIN = 1e-5  # clamp floor (sph_simulation.cpp:600)
DT_RETRY_EPS = 1e-5  # retry threshold (sph_simulation.cpp:260)


class AdvectionResult(NamedTuple):
    old_position: torch.Tensor
    new_position: torch.Tensor
    next_velocity: torch.Tensor


def advect(position, intermediate_velocity, acceleration, dt) -> AdvectionResult:
    """v+ = v_inter + a dt; x+ = x + v+ dt (advection.cl:6-18)."""
    next_velocity = intermediate_velocity + acceleration * dt
    new_position = position + next_velocity * dt
    return AdvectionResult(position, new_position, next_velocity)


def reconstruct_velocities(intermediate_velocity_before, next_velocity):
    """Full-step velocity = mean of the half-step velocities.
    Returns (velocity, new_intermediate_velocity)."""
    velocity = (intermediate_velocity_before + next_velocity) * 0.5
    return velocity, next_velocity


def compute_time_step(
    velocity: torch.Tensor, acceleration: torch.Tensor, params: SimulationParameters
) -> torch.Tensor:
    """dt = (sqrt(2 a_max h + v_max^2) - v_max) / (2 a_max), clamped to
    [DT_MIN, frame_time * simulation_scale]; a 0-d float32 tensor."""
    max_vel2 = torch.amax(torch.sum(velocity * velocity, dim=-1))
    max_accel = torch.sqrt(torch.amax(torch.sum(acceleration * acceleration, dim=-1)))
    max_vel = torch.sqrt(max_vel2)
    safe_accel = torch.clamp(max_accel, min=1e-12)
    dt = (torch.sqrt(2.0 * safe_accel * params.h + max_vel2) - max_vel) / (
        2.0 * safe_accel
    )
    return torch.clamp(dt, DT_MIN, params.max_dt)
