"""Pairwise SPH interaction sums over padded candidate sets.

PyTorch counterpart of ``libclsph_tpu/ops/interactions.py``: the
numerics of compute_density_with_grid and
compute_internal_forces_with_grid (``libclsph/kernels/forces.cl:
14-111``). The main path computes density and forces in the hand
kernels (ops/kernels/); ``density_sum`` and ``force_sums`` stay as the
O(N*K) physics reference the tests hold those kernels against, and
``tait_pressure`` is the equation of state the main path uses.

Shapes: query fields (..., ) / (..., 3); candidate fields add a K axis.
``valid`` masks padding; ``is_self`` marks the query among its
candidates (the i != j exclusion, forces.cl:67/77).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import smoothing
from ..core.params import PrecomputedKernelValues, SimulationParameters


class ForceTerms(NamedTuple):
    pressure_term: torch.Tensor  # (..., 3)
    viscosity_term: torch.Tensor  # (..., 3)
    normal: torch.Tensor  # (..., 3) colour-field gradient
    color_field_laplacian: torch.Tensor  # (...,)


def density_sum(q_pos, c_pos, valid, params: SimulationParameters,
                terms: PrecomputedKernelValues) -> torch.Tensor:
    """mass * sum_j W_poly6(|xi-xj|), self included (forces.cl:31-36)."""
    r = torch.linalg.vector_norm(q_pos[..., None, :] - c_pos, dim=-1)
    w = smoothing.poly_6(r, params.h, terms)
    return params.particle_mass * torch.sum(torch.where(valid, w, 0.0), dim=-1)


def tait_pressure(density: torch.Tensor, params: SimulationParameters) -> torch.Tensor:
    """Tait EOS p = K ((rho/rho0)^7 - 1) (sphb.cl:31-35)."""
    return params.K * ((density / params.fluid_density) ** 7 - 1.0)


def force_sums(q_pos, q_vel, q_density, q_pressure, c_pos, c_vel, c_density,
               c_pressure, valid, is_self, params: SimulationParameters,
               terms: PrecomputedKernelValues) -> ForceTerms:
    """The four neighbour sums of forces.cl:49-105: symmetrised spiky
    pressure (Kelager 4.11), viscosity Laplacian, colour-field normal
    and Laplacian."""
    rvec = q_pos[..., None, :] - c_pos
    r = torch.linalg.vector_norm(rvec, dim=-1)

    not_self = valid & ~is_self
    vmask = valid[..., None]
    nsmask = not_self[..., None]

    spiky = smoothing.spiky_gradient(rvec, params.h, terms)
    p_coeff = (
        c_pressure / c_density**2 + (q_pressure / q_density**2)[..., None]
    ) * params.particle_mass
    pressure_term = torch.sum(
        torch.where(nsmask, p_coeff[..., None] * spiky, 0.0), dim=-2
    )

    visc_w = smoothing.viscosity_laplacian(r, params.h, terms)
    visc = (
        (c_vel - q_vel[..., None, :])
        * (params.particle_mass / c_density)[..., None]
        * visc_w[..., None]
    )
    viscosity_term = torch.sum(torch.where(nsmask, visc, 0.0), dim=-2)

    inv_rho = (params.particle_mass / c_density)[..., None]
    grad6 = smoothing.poly_6_gradient(rvec, params.h, terms)
    normal = torch.sum(torch.where(vmask, inv_rho * grad6, 0.0), dim=-2)
    lap6 = smoothing.poly_6_laplacian(r, params.h, terms)
    color_field_laplacian = torch.sum(
        torch.where(valid, (params.particle_mass / c_density) * lap6, 0.0), dim=-1
    )
    return ForceTerms(pressure_term, viscosity_term, normal, color_field_laplacian)


def combine_forces(f: ForceTerms, q_density: torch.Tensor,
                   params: SimulationParameters) -> torch.Tensor:
    """a = (-rho_i P + mu V + ST)/rho_i + g, surface tension only where
    |normal| > threshold (forces.cl:110-122)."""
    total = (
        -q_density[..., None] * f.pressure_term
        + f.viscosity_term * params.dynamic_viscosity
    )
    nlen = torch.linalg.vector_norm(f.normal, dim=-1, keepdim=True)
    apply_st = nlen > params.surface_tension_threshold
    safe_nlen = torch.where(apply_st, nlen, torch.ones_like(nlen))
    st = (
        -params.surface_tension
        * f.color_field_laplacian[..., None]
        * f.normal
        / safe_nlen
    )
    total = total + torch.where(apply_st, st, 0.0)
    accel = total / q_density[..., None]
    return accel + params.gravity(accel.device)
