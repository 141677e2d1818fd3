"""Force pass over per-subgroup 8-particle hit lists with the combine
fused in: the CUDA kernel, its plain PyTorch version and the wrapper
that picks between them by device.

Replaces ``libclsph_tpu/ops/pallas/neighbor_nl.py``
``fused_forces_nl32_c8`` together with its ``_combine_forces``. See
``csrc/forces_q32_c8.cu`` for the kernel.

Inputs, for ``np`` particles in ``nb = np / 128`` Morton blocks:

* ``f8`` (np, 8) float32 [x, y, z, vx, vy, vz, pm, mr] from
  :func:`force_pack`, pm = m p / rho^2 and mr = m / rho (rho guarded to
  1 where it is 0; both 0 on padding particles);
* ``density`` (np,) float32 and ``real`` (np,) bool;
* ``cand8`` (nb*4, cap) int32: 8-particle run ids per query subgroup
  (row b*4 + g), dead slots after ``count8``; ``count8`` (nb*4,) int32.

Output: the acceleration (np, 3) float32, 0 on padding rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import smoothing
from ...core.params import SimulationParameters
from . import build

BLOCK = 128  # queries per block
GROUPS = 4  # query subgroups per block
QROWS = BLOCK // GROUPS  # queries per subgroup
SUB = 8  # particles per candidate run
CHUNK_PAIRS = 1 << 23  # pair elements per chunk of the plain version


def force_pack(position, velocity, density, pressure, real, mass: float) -> torch.Tensor:
    """(np, 8) float32 [x, y, z, vx, vy, vz, pm, mr] with the
    ``safe_rho`` and real-mask rules of make_c8_force_pack
    (neighbor_nl.py:1576-1578)."""
    safe_rho = torch.where(density > 0, density, 1.0)
    pm = torch.where(real, mass * pressure / (safe_rho * safe_rho), 0.0)
    mr = torch.where(real, mass / safe_rho, 0.0)
    return torch.cat([position, velocity, pm[:, None], mr[:, None]], dim=1).contiguous()


def _consts(params: SimulationParameters) -> dict:
    """The kernel's float32 constants, each rounded once from double as
    the JAX kernel's Python-float closures are."""
    t = params.precomputed()
    h = float(params.h)
    vals = dict(
        h=h,
        h2=h * h,
        eps2=smoothing.EPSILON * smoothing.EPSILON,
        spiky=t.spiky,
        visc=t.viscosity,
        pgrad=t.poly_6_gradient,
        lap7=7.0 * t.poly_6_laplacian / t.poly_6_gradient,
        lap4=4.0 * h * h * t.poly_6_laplacian,
        mu=params.dynamic_viscosity,
        st_threshold=params.surface_tension_threshold,
        sigma=params.surface_tension,
        gx=params.constant_acceleration[0],
        gy=params.constant_acceleration[1],
        gz=params.constant_acceleration[2],
    )
    return {k: float(np.float32(v)) for k, v in vals.items()}


def combine(press, visc, normal, lap, density, real, c: dict) -> torch.Tensor:
    """The kernel's epilogue (_combine_forces, neighbor_nl.py:764-790):
    a = (-rho P + mu V + ST)/rho + g, rho guarded, 0 on padding rows."""
    rho = torch.where(density > 0, density, 1.0)[:, None]
    total = -rho * press + visc * c["mu"]
    nlen = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    apply_st = nlen > c["st_threshold"]
    st = -c["sigma"] * lap[:, None] * normal / torch.where(apply_st, nlen, 1.0)
    total = total + torch.where(apply_st, st, 0.0)
    g = torch.tensor([c["gx"], c["gy"], c["gz"]], dtype=torch.float32, device=rho.device)
    return torch.where(real[:, None], total / rho + g, 0.0)


def forces_q32_c8_torch(f8, density, real, cand8, count8, params: SimulationParameters):
    """Plain PyTorch version, chunked over query subgroups."""
    c = _consts(params)
    npart = f8.shape[0]
    nrows, cap = cand8.shape
    dev = f8.device
    press = torch.empty((npart, 3), dtype=torch.float32, device=dev)
    visc = torch.empty((npart, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((npart, 3), dtype=torch.float32, device=dev)
    lap = torch.empty(npart, dtype=torch.float32, device=dev)
    slot = torch.arange(cap, device=dev)
    lane = torch.arange(SUB, device=dev)
    rows = max(1, CHUNK_PAIRS // (QROWS * cap * SUB))
    for r0 in range(0, nrows, rows):
        r1 = min(nrows, r0 + rows)
        r = r1 - r0
        live = slot[None, :] < count8[r0:r1, None]
        jid = (torch.where(live, cand8[r0:r1], 0).to(torch.int64)[:, :, None] * SUB
               + lane).reshape(r, cap * SUB)
        live = live[:, :, None].expand(r, cap, SUB).reshape(r, 1, cap * SUB)
        cj = f8[jid][:, None]  # (r, 1, K, 8)
        qid = torch.arange(r0 * QROWS, r1 * QROWS, device=dev).reshape(r, QROWS, 1)
        qi = f8[qid]  # (r, 32, 1, 8)
        dx = qi[..., 0] - cj[..., 0]
        dy = qi[..., 1] - cj[..., 1]
        dz = qi[..., 2] - cj[..., 2]
        r2 = (dx * dx + dy * dy) + dz * dz  # (r, 32, K)
        inside = (r2 < c["h2"]) & live
        near0 = r2 < c["eps2"]
        inv_r = torch.where(near0, 0.0, torch.rsqrt(r2))
        dist = r2 * inv_r
        hr = torch.clamp(c["h"] - dist, min=0.0)
        t = torch.clamp(c["h2"] - r2, min=0.0)
        mr = cj[..., 7]
        b = (c["visc"] * mr) * hr
        u = mr * t
        pc = cj[..., 6] + qi[..., 6]
        a = pc * ((c["spiky"] * (hr * hr)) * inv_r)
        g = (c["pgrad"] * u) * t
        lp = c["lap7"] * g - c["lap4"] * u
        a, b, g, lp = (torch.where(inside, x, 0.0) for x in (a, b, g, lp))
        sing = torch.where(inside & near0 & (jid[:, None, :] != qid), pc * c["spiky"], 0.0)
        sing = sing.sum(dim=-1)
        sl = slice(r0 * QROWS, r1 * QROWS)
        press[sl] = torch.stack(
            [(a * d).sum(dim=-1) + sing for d in (dx, dy, dz)], dim=-1
        ).reshape(-1, 3)
        visc[sl] = torch.stack(
            [(b * (cj[..., k] - qi[..., k])).sum(dim=-1) for k in (3, 4, 5)], dim=-1
        ).reshape(-1, 3)
        normal[sl] = torch.stack(
            [(g * d).sum(dim=-1) for d in (dx, dy, dz)], dim=-1
        ).reshape(-1, 3)
        lap[sl] = lp.sum(dim=-1).reshape(-1)
    return combine(press, visc, normal, lap, density, real, c)


def _check(f8, density, real, cand8, count8):
    if f8.dtype != torch.float32 or f8.dim() != 2 or f8.shape[1] != 8:
        raise ValueError("f8 must be (np, 8) float32")
    npart = f8.shape[0]
    if npart % BLOCK:
        raise ValueError(f"particle count {npart} is not a multiple of {BLOCK}")
    rows = npart // BLOCK * GROUPS
    if density.dtype != torch.float32 or density.shape != (npart,):
        raise ValueError("density must be (np,) float32")
    if real.dtype != torch.bool or real.shape != (npart,):
        raise ValueError("real must be (np,) bool")
    if cand8.dtype != torch.int32 or cand8.dim() != 2 or cand8.shape[0] != rows:
        raise ValueError("cand8 must be (np/128*4, cap) int32")
    if count8.dtype != torch.int32 or count8.shape != (rows,):
        raise ValueError("count8 must be (np/128*4,) int32")
    for name, t in (("density", density), ("real", real), ("cand8", cand8),
                    ("count8", count8), ("f8", f8)):
        if t.device != f8.device:
            raise ValueError(f"{name} is on {t.device}, f8 on {f8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def forces_q32_c8(f8, density, real, cand8, count8, params: SimulationParameters):
    """Accelerations. CPU tensors take the plain version; CUDA tensors
    launch the kernel (building it at first use) or raise."""
    _check(f8, density, real, cand8, count8)
    if f8.device.type == "cpu":
        return forces_q32_c8_torch(f8, density, real, cand8, count8, params)
    if f8.device.type != "cuda":
        raise ValueError(f"forces_q32_c8: unsupported device {f8.device}")
    lib = build.load_library()
    c = _consts(params)
    accel = torch.empty((f8.shape[0], 3), dtype=torch.float32, device=f8.device)
    stream = torch.cuda.current_stream(f8.device).cuda_stream
    status = lib.forces_q32_c8_launch(
        f8.data_ptr(), density.data_ptr(), real.data_ptr(), cand8.data_ptr(),
        count8.data_ptr(), f8.shape[0] // BLOCK, cand8.shape[1],
        c["h"], c["h2"], c["eps2"], c["spiky"], c["visc"], c["pgrad"],
        c["lap7"], c["lap4"], c["mu"], c["st_threshold"], c["sigma"],
        c["gx"], c["gy"], c["gz"], accel.data_ptr(), stream,
    )
    build.check(status, "forces_q32_c8")
    forces_q32_c8.launches += 1
    return accel


forces_q32_c8.launches = 0
