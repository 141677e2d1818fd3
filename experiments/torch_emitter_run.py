#!/usr/bin/env python3
"""The emitter row of the round-5 matrix (``BASELINE.md:437``) on the
port's engine: a shower from ``scenes/shower.obj``'s tray onto
``scenes/monkey.obj`` at 262,144 particles (the JAX package's
experiments/emitter_run.py).

    python3 experiments/torch_emitter_run.py [--n 262144] [--frames 20]
        [--device cuda|cpu] [--out PREFIX]

The reference's emitter mechanism is the pre_frame write-back hook
(sph_simulation.cpp:730-748): a callback that edits the host copy of the
particles and returns true re-uploads them. Each frame, particles that
fell below the recycling plane (y < -1.4, past the obstacle) go back to
rest-spacing sites under the tray footprint with the nozzle's downward
jet velocity, at most ``--recycle-frac`` of the particles a frame. The
run starts as a shower already in progress: a falling column around the
monkey's box whose bottom already lies below the plane, so recycling
engages on the first frame after the start.

Prints one JSON line: s/frame of every frame (host clock between
pre_frame calls) with the median and mean from frame 2 on, the first
frame, the substeps the engine ran in each frame (counted at
``engine.step.substep``, re-runs after a capacity flag included, the
substeps that the frame loop ran ahead and discarded not),
particle-steps/s over frames 2 on, the particles recycled in each frame,
and the config after the run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

N = 262_144
RECYCLE_Y = -1.4  # the recycling plane below the obstacle
EMIT_Y = 0.75  # re-injection height, just under the tray plane
JET = (0.0, -1.5, 0.0)  # the nozzle's velocity
MONKEY_LO = np.array([-0.75, -1.25, -0.64])  # monkey.obj's box + 0.1
MONKEY_HI = np.array([0.75, 0.05, 0.64])


def nozzle_sites(root: str) -> np.ndarray:
    """The shower tray's emission points: the band of its vertices at
    y ~ 0.81, deduplicated on a 2 cm grid, lowered to EMIT_Y."""
    from libclsph_tpu_torch.scene.obj_loader import load_obj

    v = np.asarray(load_obj(os.path.join(root, "scenes", "shower.obj")).vertices)
    tray = v[np.abs(v[:, 1] - 0.81) < 0.03]
    key = np.round(tray[:, [0, 2]] / 0.02).astype(np.int64)
    _, first = np.unique(key, axis=0, return_index=True)
    sites = tray[np.sort(first)].copy()
    sites[:, 1] = EMIT_Y
    return sites


def shower_column(n: int, spacing: float) -> np.ndarray:
    """A column of rest-spacing layers from y = -1.55 upward over the
    tray's footprint, the monkey's dilated box carved out."""
    xs = np.arange(-1.2, 1.2, spacing)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
    pts, total, y = [], 0, -1.55
    while total < n:
        layer = np.stack([xx.ravel(), np.full(xx.size, y), zz.ravel()], axis=1)
        kept = layer[~np.all((layer > MONKEY_LO) & (layer < MONKEY_HI), axis=1)]
        pts.append(kept)
        total += len(kept)
        y += spacing
    return np.concatenate(pts)[:n].astype(np.float32)


def run(n: int = N, frames: int = 20, device: str = "cuda", recycle_frac: float = 0.05,
        out: str | None = None, seed: int = 0, obstacle: str = "monkey.obj") -> dict:
    """The emitter run; returns the JSON record. ``obstacle``: the scene
    the shower falls onto (the row's monkey.obj; a box bakes its distance
    field in a fraction of the monkey's time on a CPU)."""
    import torch

    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.core.state import ParticleState
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.models.presets import WATER, simulation_config

    sites = nozzle_sites(ROOT)
    sim = SPHSimulation(step.StepConfig(), device=device)  # the main path
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=n, simulation_time=frames / 60.0))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene(obstacle, scenes_dir=os.path.join(ROOT, "scenes"))
    p = sim.parameters
    spacing = (p.initial_volume / n) ** (1.0 / 3.0)
    pos = shower_column(n, spacing)
    jet = np.tile(np.float32(JET), (n, 1))

    def initial():
        dev = sim.device
        return ParticleState.zeros(n, dev).replace(
            position=torch.as_tensor(pos, device=dev),
            velocity=torch.as_tensor(jet, device=dev),
            intermediate_velocity=torch.as_tensor(jet, device=dev))

    sim.init_particles = initial

    # re-injection sites: a rest-spacing grid over the tray footprint
    # (point nozzles would stack hundreds of particles inside one
    # smoothing radius, and the Tait pressure would blow them apart)
    gx = np.arange(-1.0, 1.0, spacing)
    tray_grid = np.stack([a.ravel() for a in np.meshgrid(gx, gx, indexing="ij")], axis=1)
    per_layer = len(tray_grid)
    budget = max(1, int(n * recycle_frac))
    rng = np.random.default_rng(seed)
    substeps = [0]
    marks, recycled, frame_s = [], [], []
    last = [time.perf_counter()]

    def emitter(arrays, params, is_full_frame):
        now = time.perf_counter()
        frame_s.append(now - last[0])
        last[0] = now
        marks.append(committed())
        pos_, vel = arrays["position"], arrays["velocity"]
        idx = np.where(pos_[:, 1] < RECYCLE_Y)[0][:budget]
        recycled.append(int(len(idx)))
        if len(idx) == 0:
            return False
        k = len(idx)
        cells = np.concatenate([rng.permutation(per_layer)
                                for _ in range(-(-k // per_layer))])[:k]
        xz = tray_grid[cells] + rng.uniform(-0.2 * spacing, 0.2 * spacing, (k, 2))
        pos_[idx, 0], pos_[idx, 2] = xz[:, 0], xz[:, 1]
        pos_[idx, 1] = EMIT_Y + (np.arange(k) // per_layer) * spacing
        vel[idx] = JET
        arrays["intermediate_velocity"][idx] = vel[idx]
        return True  # write the edits back to the device

    sim.pre_frame = emitter
    if out:
        from libclsph_tpu_torch.io.houdini import HoudiniFileSaver

        saver = HoudiniFileSaver(out)
        sim.save_frame = lambda arrays, params: saver.write_frame_to_file(arrays, params)

    count_from = step.substep

    def committed():
        # the frame loop's dispatch runs some substeps ahead and discards
        # them where a predicate held (engine.step.dispatch): not counted
        return substeps[0] - sim.dispatch_stats["wasted"]

    def counted(*args, **kw):
        substeps[0] += 1
        return count_from(*args, **kw)

    step.substep = counted  # frame() calls it through the module
    try:
        t0 = time.perf_counter()
        sim.simulate()
        wall = time.perf_counter() - t0
    finally:
        step.substep = count_from
    frame_s.append(time.perf_counter() - last[0])
    marks.append(committed())
    # frame k runs between pre_frame calls k and k+1 (the last ends with
    # the run); the time before the first call is set-up, not a frame
    per_frame = [b - a for a, b in zip(marks, marks[1:])]
    ft = frame_s[1:]
    steady = ft[1:]
    return {
        "metric": f"s/frame, shower.obj emitter onto {obstacle}",
        "n": n,
        "device": str(sim.device),
        "nozzle_sites": int(len(sites)),
        "frames": len(ft),
        "s_per_frame": [round(t, 4) for t in ft],
        "first_frame_s": round(ft[0], 4) if ft else None,
        "median_s_per_frame": statistics.median(steady) if steady else None,
        "mean_s_per_frame": statistics.fmean(steady) if steady else None,
        "substeps_per_frame": per_frame,
        "substeps": int(sum(per_frame)),
        "particle_steps_per_s": (n * sum(per_frame[1:]) / sum(steady)) if steady else None,
        "recycled_per_frame": recycled,
        "recycled": int(sum(recycled)),
        "wall_s": wall,
        "config": str(sim.step_config),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--recycle-frac", type=float, default=0.05,
                    help="most particles recycled a frame, as a fraction of --n")
    ap.add_argument("--out", default=None, help="frame prefix (.geo export)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.frames, args.device, args.recycle_frac, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
