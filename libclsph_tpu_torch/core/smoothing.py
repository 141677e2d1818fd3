"""SPH smoothing kernels (Mueller poly6 / spiky / viscosity family).

PyTorch counterpart of ``libclsph_tpu/core/smoothing.py``, with the
reference's idioms kept (``libclsph/kernels/smoothing.cl:1-33``):

* compact support by the multiplicative mask
  ``1 - clamp(floor(r/h), 0, 1)`` rather than a branch, and
* the spiky-gradient r -> 0 guard that returns the scalar
  ``-45/(pi h^6)`` broadcast to all three components
  (smoothing.cl:21-29).

Coefficients are plain Python floats; ``r`` is a distance tensor or a
``(..., 3)`` displacement as noted per function.
"""

from __future__ import annotations

import torch

from .params import PrecomputedKernelValues

EPSILON = 1e-7  # spiky guard (smoothing.cl:19)


def support_mask(r: torch.Tensor, h: float) -> torch.Tensor:
    """``1 - clamp(floor(r/h), 0, 1)``: 1.0 for r < h, else 0.0."""
    return 1.0 - torch.clamp(torch.floor(r / h), 0.0, 1.0)


def poly_6(r: torch.Tensor, h: float, terms: PrecomputedKernelValues) -> torch.Tensor:
    """W_poly6(r) = 315/(64 pi h^9) (h^2 - r^2)^3 for r<h (smoothing.cl:1-4)."""
    return support_mask(r, h) * terms.poly_6 * (h * h - r * r) ** 3


def poly_6_gradient(
    rvec: torch.Tensor, h: float, terms: PrecomputedKernelValues
) -> torch.Tensor:
    """Gradient of poly6 on the displacement ``(..., 3)`` (smoothing.cl:6-10)."""
    r = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    return (
        support_mask(r, h)
        * terms.poly_6_gradient
        * rvec
        * (h * h - r * r) ** 2
    )


def poly_6_laplacian(
    r: torch.Tensor, h: float, terms: PrecomputedKernelValues
) -> torch.Tensor:
    """Laplacian of poly6 on the distance (smoothing.cl:12-17)."""
    return (
        support_mask(r, h)
        * terms.poly_6_laplacian
        * (h * h - r * r)
        * (3.0 * h * h - 7.0 * r * r)
    )


def spiky_gradient(
    rvec: torch.Tensor, h: float, terms: PrecomputedKernelValues
) -> torch.Tensor:
    """Spiky gradient with the r->0 guard (smoothing.cl:21-29): within
    EPSILON of zero the scalar ``-45/(pi h^6)`` is splatted to all three
    components."""
    r = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    near_zero = torch.abs(r) < EPSILON
    safe_r = torch.where(near_zero, torch.ones_like(r), r)
    regular = support_mask(r, h) * terms.spiky * (rvec / safe_r) * (h - r) ** 2
    singular = torch.full_like(rvec, terms.spiky)
    return torch.where(near_zero, singular, regular)


def viscosity_laplacian(
    r: torch.Tensor, h: float, terms: PrecomputedKernelValues
) -> torch.Tensor:
    """Viscosity Laplacian 45/(pi h^6) (h - r) for r<h (smoothing.cl:31-33)."""
    return support_mask(r, h) * terms.viscosity * (h - r)
