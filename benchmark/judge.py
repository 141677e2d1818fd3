"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (:mod:`benchmark.reference`).

Substep cells: for a sample of the segment's substeps drawn from the
seed, the reference takes the program's state before the substep and
its dt, and works the substep out again: the sort order (Morton codes of
the grid), the density, the forces, the leapfrog, the collision response
and the next dt. The reference follows the program substep by substep
from its own state; the segment's start is the benchmark's own input,
and the warm-up before it is checked the same way.

Frame cells: the reference follows every frame of the last segment from
the program's exported state of the frame before, with its own dt carried
from frame to frame, and each particle of the program's frame is held
against the nearest particle of the reference's; every exported ``.geo``
file of a sample is read back against the state it was written from.

Each number compared is a maximum or a 99th percentile over the
particles and the checked substeps or frames; its limit is in
``limits/<cell>.json``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import geo as geo_ref
from .reference import sph

# share of the particles above the percentile that a frame's numbers read
FRAME_QUANTILE = 0.99
# the dropped-shell fault: the reference in the program's place with the
# pairs beyond this share of h left out (the outer 7 % of the support)
SHELL_CUT = 0.93
# the export's control: the writer at one significant digit fewer
CONTROL_DIGITS = geo_ref.SIGNIFICANT - 1


def _interleave(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(10):
        out |= ((v >> b) & 1) << (3 * b)
    return out


def morton(pos32: torch.Tensor, h: float):
    """(codes, stable order by code) of float32 positions on a grid of
    side 2h padded by two cells below the least position: the order the
    program sorts by (grid.cl:40-64)."""
    cell = torch.tensor(2.0 * h, dtype=torch.float32, device=pos32.device)
    lo = pos32.amin(dim=0) - 2.0 * cell
    c = ((pos32 - lo) * (1.0 / cell)).to(torch.int64)
    code = _interleave(c[:, 0]) | (_interleave(c[:, 1]) << 1) | (_interleave(c[:, 2]) << 2)
    return code, torch.sort(code, stable=True)[1]


def _rel(err, scale):
    return float(err.max() / scale) if err.numel() else 0.0


def _errors(prm, sums, adv, after: dict, perm) -> dict:
    """The program's ``after`` against the reference's outcomes
    ``(sums, adv)`` taken in the order ``perm`` (the program's row k is
    the reference's particle perm[k])."""
    d = lambda t: t.to(torch.float64)  # noqa: E731
    rho = sums.density[perm]
    acc = torch.stack([sums.accel[perm], sums.accel_flip[perm]])
    a_scale = float(torch.linalg.vector_norm(sums.accel, dim=1).max())
    v_scale = max(float(torch.linalg.vector_norm(adv.velocity[0], dim=1).max()), 1e-6)

    def err(got, outs):
        return torch.linalg.vector_norm(d(got)[None] - outs, dim=-1).amin(0)

    return dict(
        nonfinite=int(sum((~torch.isfinite(after[k])).sum() for k in (
            "position", "velocity", "density", "acceleration"))),
        density_rel=_rel((d(after["density"]) - rho).abs() / rho, 1.0),
        accel_rel=_rel(err(after["acceleration"], acc), a_scale),
        position_h=_rel(err(after["position"], adv.position[:, perm]), prm.h),
        velocity_rel=_rel(err(after["velocity"], adv.velocity[:, perm]), v_scale),
        pairs=sums.pairs,
    )


def _control(prm, field, before: dict, dt_in: float, cut=None) -> dict:
    """The reference in the program's place, as its ``after`` in the
    reference's own order: computed in TF32, or with ``cut`` in float64
    with the pairs beyond cut * h left out."""
    sums, adv = sph.substep(before["position"].to(torch.float32), before["velocity"],
                            before["intermediate_velocity"], dt_in, prm, field,
                            tf32=cut is None, cut=cut or 1.0)
    return dict(position=adv.position[0], velocity=adv.velocity[0],
                intermediate_velocity=adv.intermediate[0], density=sums.density,
                acceleration=sums.accel)


def substep_numbers(prm, field, before: dict, after: dict, dt_in: float, sorted_: bool,
                    tf32: bool = False, cut=None) -> dict:
    """The numbers of one substep: ``before`` the program's input state
    (position, velocity, intermediate_velocity), ``after`` what the
    program returned (those, density, acceleration, grid_index). With
    ``tf32`` the control stands in the program's place: ``after`` is
    ignored and the reference computed in TF32 is judged instead; with
    ``cut`` the reference that leaves out the pairs beyond cut * h."""
    pos = before["position"].to(torch.float32)
    codes, order = morton(pos, prm.h)
    perm = order if sorted_ else torch.arange(pos.shape[0], device=pos.device)
    sums, adv = sph.substep(pos, before["velocity"], before["intermediate_velocity"], dt_in,
                            prm, field)
    if tf32 or cut:
        after = {k: v[perm] for k, v in _control(prm, field, before, dt_in, cut).items()}
        after["grid_index"] = codes[perm]
    out = _errors(prm, sums, adv, after, perm)
    out["codes_mismatch"] = int((after["grid_index"].to(torch.int64) != codes[perm]).sum())
    return out


def matched_numbers(prm, field, before: dict, after: dict, dt_in: float,
                    tf32: bool = False, cut=None) -> dict:
    """:func:`substep_numbers` for a program whose rows come back in an
    order of its own (a mesh's ranks): each row of ``after`` is held
    against the reference's particle nearest to it, within h / 4;
    ``unmatched`` counts the rows with none, or with one another row
    took."""
    pos = before["position"].to(torch.float32)
    sums, adv = sph.substep(pos, before["velocity"], before["intermediate_velocity"], dt_in,
                            prm, field)
    if tf32 or cut:
        after = _control(prm, field, before, dt_in, cut)
    idx, _ = sph.nearest(adv.position[0], after["position"].to(torch.float64), 0.25 * prm.h)
    perm = torch.clamp(idx, min=0)
    out = _errors(prm, sums, adv, after, perm)
    hit = idx[idx >= 0]
    out["unmatched"] = (int((idx < 0).sum()) + int(hit.numel() - torch.unique(hit).numel())
                        + abs(pos.shape[0] - after["position"].shape[0]))
    return out


def worst(readings: list) -> dict:
    """The largest of each number over several checks (counts summed)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k in ("codes_mismatch", "nonfinite", "pairs", "frames_missing",
                     "export_layout", "start_mismatch", "unmatched"):
                out[k] = out.get(k, 0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


# ---- frames -----------------------------------------------------------------


def follow_frame(prm, field, pos, vel, vinter, dt_carry: np.float32, tf32: bool = False):
    """One frame of the frame loop from (pos, vel, vinter): substeps while
    the frame's time is left, dt clamped to it, as sph_simulation.cpp:
    384-409 keeps it in float32 (the time left falls by each substep's
    next dt; the next dt is the time left where that is smaller). Returns
    (position, velocity, intermediate, density, dt carried, substeps)."""
    tl = np.float32(prm.frame_time)
    dt = np.float32(dt_carry)
    substeps = 0
    rho = None
    while tl > 0:
        sums, adv = sph.substep(pos, vel, vinter, float(dt), prm, field, tf32=tf32)
        pos, vel, vinter = adv.position[0], adv.velocity[0], adv.intermediate[0]
        rho = sums.density
        dt_next = np.float32(adv.dt_next[0])
        tl = np.float32(tl - dt_next)
        dt = tl if tl < dt_next else dt_next
        substeps += 1
    return pos, vel, vinter, rho, dt, substeps


def _quantile(x: torch.Tensor) -> float:
    k = max(0, math.ceil(FRAME_QUANTILE * x.numel()) - 1)
    return float(torch.sort(x.flatten())[0][k])


def frame_numbers(prm, field, frames: list, device):
    """Follow each frame of ``frames`` (the exported host arrays of a
    segment, the initial state first) from the one before. Returns (the
    numbers, substeps the reference ran a frame)."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    dt = np.float32(prm.max_dt)
    pos_err, vel_err, rho_err, counts = [], [], [], []
    for prev, cur in zip(frames[:-1], frames[1:]):
        p, v, _, rho, dt, k = follow_frame(prm, field, t(prev["position"]), t(prev["velocity"]),
                                           t(prev["intermediate_velocity"]), dt)
        counts.append(k)
        idx, dist = sph.nearest(p.double(), t(cur["position"]).double(), 0.5 * prm.h)
        ok = idx >= 0
        j = torch.clamp(idx, min=0)
        v_scale = max(float(torch.linalg.vector_norm(v, dim=1).max()), 1e-6)
        pos_err.append(torch.where(ok, dist / prm.h, math.inf))
        vel_err.append(torch.where(ok, torch.linalg.vector_norm(
            t(cur["velocity"]).double() - v.double()[j], dim=1) / v_scale, math.inf))
        r = rho.double()[j]
        rho_err.append(torch.where(ok, (t(cur["density"]).double() - r).abs() / r, math.inf))
    return dict(frame_position_q99_h=_quantile(torch.cat(pos_err)),
                frame_velocity_q99_rel=_quantile(torch.cat(vel_err)),
                frame_density_q99_rel=_quantile(torch.cat(rho_err))), counts


def control_frames(prm, field, start: dict, frames: int, device) -> list:
    """The control in the program's place: ``frames`` frames from the
    state ``start``, each followed by the reference computed in TF32."""
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    out = [start]
    p, v, vi = t(start["position"]), t(start["velocity"]), t(start["intermediate_velocity"])
    dt = np.float32(prm.max_dt)
    for _ in range(frames):
        p, v, vi, rho, dt, _ = follow_frame(prm, field, p, v, vi, dt, tf32=True)
        out.append({k: x.float().cpu().numpy() for k, x in (
            ("position", p), ("velocity", v), ("intermediate_velocity", vi), ("density", rho))})
    return out


def export_numbers(path: str, arrays: dict, mass: float) -> dict:
    """A ``.geo`` file read back against the host arrays it was written
    from: positions and velocities relative to their value (the format
    keeps 6 significant digits), the colour ramp of the density absolute,
    and the layout (point count, the Part primitive's indices, the
    homogeneous w and the mass) exact."""
    pts, part, n = geo_ref.read(path)
    pv = np.concatenate([arrays["position"], arrays["velocity"]], axis=1).astype(np.float64)
    got = np.concatenate([pts[:, 0:3], pts[:, 4:7]], axis=1)
    rel = np.abs(got - pv) / np.maximum(np.abs(pv), np.finfo(np.float32).tiny)
    color = geo_ref.color_ramp(arrays["density"])
    layout = int(n != pv.shape[0]) + int(part is None or not np.array_equal(
        part, np.arange(n))) + int((pts[:, 3] != 0).sum()) + int(
        (np.abs(pts[:, 10] - mass) > 0.5e-5 * mass).sum())
    return dict(export_pv_rel=float(rel.max()),
                export_color_abs=float(np.abs(pts[:, 7:10] - color).max()),
                export_layout=layout)
