#!/usr/bin/env python3
"""Fidelity of the port's production path at bench scale, in free space.

    python3 experiments/torch_fidelity_64k.py [--device cuda|cpu] [--n 65536]
                                              [--settle 20] [--rows 512]

A water dam-break of N particles (bench_torch's parameters, no scene)
settles for ``--settle`` substeps on the main path (bench_torch's
schedule and warm-up, capacity grown by the engine's rule). One more
substep, without the sort so its rows stay those of its input, gives the
production path's density and acceleration, which are compared with a
float64 oracle of the same equations (Mueller-03 poly6 density, Tait
pressure, spiky pressure gradient, viscosity Laplacian, colour-field
surface tension): the density over every particle, from a KD-tree pair
list (``scipy.spatial.cKDTree``), the acceleration over a seeded sample
of rows. Prints one JSON line of RMS and max relative errors; exits 1
when the density or the acceleration RMS relative error reaches
``BAR``. The oracle and the comparison take ``(state, output, params)``,
so the tests run them at a small n on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import bench_torch  # noqa: E402

N = 65_536
SETTLE = 20
ROWS = 512
SEED = 7
BAR = 1e-4  # RMS relative error of density and acceleration (BASELINE.md rows 5-6)


def kernel_constants(h: float) -> dict:
    return dict(poly6=315.0 / (64.0 * np.pi * h**9), grad=-945.0 / (32.0 * np.pi * h**9),
                lap=-945.0 / (32.0 * np.pi * h**9), spiky=-45.0 / (np.pi * h**6),
                visc=45.0 / (np.pi * h**6))


def density_oracle(pos: np.ndarray, params) -> np.ndarray:
    """float64 poly6 density of every particle, self term included, over
    the pairs within h of a KD-tree."""
    from scipy.spatial import cKDTree

    h, mass = float(params.h), float(params.particle_mass)
    c = kernel_constants(h)["poly6"]
    pairs = cKDTree(pos).query_pairs(h, output_type="ndarray")
    pi, pj = pairs[:, 0], pairs[:, 1]
    t = np.maximum(h * h - ((pos[pi] - pos[pj]) ** 2).sum(axis=1), 0.0) ** 3
    rho = np.full(pos.shape[0], mass * c * h**6)
    np.add.at(rho, pi, mass * c * t)
    np.add.at(rho, pj, mass * c * t)
    return rho


def accel_oracle(pos, vel, rho, params, rows) -> np.ndarray:
    """float64 acceleration of ``rows``: pressure, viscosity, surface
    tension above its threshold, and gravity, summed over every particle
    within h (a coincident pair's pressure gradient takes the kernel's
    limit, as the kernels do)."""
    h, mass = float(params.h), float(params.particle_mass)
    c = kernel_constants(h)
    press = params.K * ((rho / params.fluid_density) ** 7 - 1.0)
    n = pos.shape[0]
    acc = np.zeros((len(rows), 3))
    for k, i in enumerate(rows):
        rv = pos[i] - pos
        r2 = np.einsum("ij,ij->i", rv, rv)
        r = np.sqrt(r2)
        incl = r < h
        sel = incl & (np.arange(n) != i)
        near0 = (r < 1e-7)[sel, None]
        coeff = press[sel] / rho[sel] ** 2 + press[i] / rho[i] ** 2
        rr = r[sel]
        sg = np.where(near0, c["spiky"],
                      c["spiky"] * rv[sel] / np.where(near0, 1.0, rr[:, None])
                      * (h - rr[:, None]) ** 2)
        pr = (coeff[:, None] * mass * sg).sum(axis=0)
        vi = ((vel[sel] - vel[i]) * (mass / rho[sel])[:, None] * c["visc"]
              * (h - rr)[:, None]).sum(axis=0)
        t = (h * h - r2)[incl]
        normal = ((mass / rho[incl])[:, None] * c["grad"] * rv[incl]
                  * (t**2)[:, None]).sum(axis=0)
        lap = (mass / rho[incl] * c["lap"] * t * (3 * h * h - 7 * r2[incl])).sum()
        total = -rho[i] * pr + params.dynamic_viscosity * vi
        nlen = np.linalg.norm(normal)
        if nlen > params.surface_tension_threshold:
            total += -params.surface_tension * lap * normal / nlen
        acc[k] = total / rho[i] + np.asarray(params.constant_acceleration)
    return acc


def sample_rows(n: int, rows: int = ROWS, seed: int = SEED) -> np.ndarray:
    """The seeded row sample of the acceleration comparison."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, min(rows, n), replace=False))


def host(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def oracle(state, params, rows):
    """The float64 density of every particle of ``state`` and the
    acceleration of ``rows``."""
    pos = host(state.position)
    rho = density_oracle(pos, params)
    return rho, accel_oracle(pos, host(state.velocity), rho, params, rows)


def pair_errors(state, out, params, rows, reference=None) -> dict:
    """The production path's density (every particle) and acceleration
    (``rows``) in ``out``, a substep from ``state`` on the same rows,
    against the oracle (``reference``: its (density, acceleration) when
    already computed): RMS and max relative errors, the acceleration's
    relative to its largest component over ``rows``."""
    rho, acc = reference if reference is not None else oracle(state, params, rows)
    rho_dev = host(out.density)
    rel = (rho_dev - rho) / rho
    scale = float(np.abs(acc).max())
    err = np.abs(host(out.acceleration)[rows] - acc)
    return dict(density_rms_rel=float(np.sqrt(np.mean(rel**2))),
                density_max_rel=float(np.abs(rel).max()),
                accel_rms_rel=float(np.sqrt(np.mean(err**2))) / scale,
                accel_max_rel=float(err.max()) / scale, accel_scale=scale, rows=len(rows))


def passes(errors: dict, bar: float = BAR) -> bool:
    return errors["density_rms_rel"] < bar and errors["accel_rms_rel"] < bar


def probe(state, dt, params, scene, engine, **overrides):
    """One substep of ``engine.step_config`` (with ``overrides``) from
    ``state`` without the sort, so the output's rows are the input's,
    grown by the engine's rule until it raises no flag."""
    import dataclasses

    from libclsph_tpu_torch.engine import step

    for _ in range(6):
        cfg = dataclasses.replace(engine.step_config, **overrides)
        out, _, flags, _ = step.substep(state, dt, params, scene, cfg, do_sort=False)
        if not engine._needs_rerun(flags):
            return out
    raise RuntimeError("the probe substep kept raising capacity flags")


def measure(dev, n=N, settle=SETTLE, rows=ROWS) -> dict:
    """The whole comparison on ``dev``: ``n`` particles settled ``settle``
    substeps, the probe substep, and :func:`pair_errors` over ``rows``
    sampled rows. Returns the errors with the settle's and the oracle's
    seconds and the config that ran."""
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    params = bench_torch.build_params(n)
    engine = SPHSimulation(device=dev, pretune=False)
    t0 = time.perf_counter()
    state, dt = bench_torch.warm_up(init_state(params, dev), params, None, engine, settle)
    out = probe(state, dt, params, None, engine)
    bench_torch.sync(dev)
    settle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    errors = pair_errors(state, out, params, sample_rows(n, rows))
    return dict(errors, settle_s=settle_s, oracle_s=time.perf_counter() - t0,
                config=str(engine.step_config))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--settle", type=int, default=SETTLE, help="substeps before the probe")
    ap.add_argument("--rows", type=int, default=ROWS, help="rows of the acceleration sample")
    args = ap.parse_args(argv)

    from libclsph_tpu_torch.engine.simulation import configure_device

    dev = configure_device(args.device)
    r = measure(dev, args.n, args.settle, args.rows)
    print(json.dumps(dict(
        metric=f"fidelity against a float64 oracle, {args.n} water particles, free space",
        n=args.n, settle_substeps=args.settle, **r, bar=BAR, passed=passes(r),
        device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None,
        host_cpu=bench_torch.host_cpu())))
    return 0 if passes(r) else 1


if __name__ == "__main__":
    sys.exit(main())
