#!/usr/bin/env python3
"""Flow-through scenes on the port's engine, the lattice placed inside
the scene (the JAX package's experiments/scene_run.py).

    python3 experiments/torch_scene_run.py river [--n 1048576] [--frames 5]
        [--device cuda|cpu] [--out PREFIX | --no-export]
    python3 experiments/torch_scene_run.py labyrinth --n 1048576 --frames 5

The default cube lattice is sized for dam-breaks and overflows long
channels, so the particles are stacked at rest spacing on the scene's
support surface instead: under each (x, z) column of a footprint (a
fraction of the scene's x/z extent) a vertical ray-cast finds the highest
face, and the column fills upward from there, so no particle starts
inside the geometry (a flat slab embeds in sloped floors, and the
distance field ejects embedded particles at O(100 m/s)). The run is the
production engine: ``SPHSimulation(pretune="auto")`` (the init-state
probe picks the tables of deep columns before the first frame), capacity
growth, and ``.geo`` export on the saver thread with the native writer.

Prints one JSON line: s/frame of every frame (host clock around each
frame's substeps, synchronised), the first frame, the median and mean
from frame 2 on, the pretune's time and statistics, the config it chose,
the config after the frames (grown by the autotune), whether tier 2 ran,
and the kernels' launches during the frames.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import bench_torch  # noqa: E402

# lattice footprint (fraction of the scene's x/z extent) and particle
# mass of each scene. The river's sloped channel holds about 1.2 m of
# fluid: at 0.05 kg a particle, 1M particles are 52.5 m^3 and overflow
# its walls; 0.025 kg keeps the free surface below them.
PLACEMENTS = {
    "river": dict(frac=(0.92, 0.8), mass=0.025),
    "labyrinth": dict(frac=(0.9, 0.9)),
    "box": dict(frac=(0.8, 0.8)),
    "monkeybox": dict(frac=(0.8, 0.8)),
}
CLEARANCE = 0.04  # gap between the support surface and the first layer
N = 1_048_576
FRAMES = 5
KERNELS = ("density_c16", "density_c32", "density_gated16", "forces_q32_c8",
           "forces_q32_c16", "forces_q32_c32", "forces_q128_c32")


def load_tris(path):
    vs, fs = [], []
    for line in open(path):
        if line.startswith("v "):
            vs.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("f "):
            fs.append([int(t.split("/")[0]) - 1 for t in line.split()[1:4]])
    v = np.array(vs, np.float32)
    return v, v[np.array(fs, np.int32)]  # (F, 3, 3)


def support_height(tris, xs, zs, default):
    """Highest mesh surface under each (x, z) column (vertical ray-cast,
    vectorised over columns); ``default`` where nothing is hit."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    v0 = (b - a)[:, [0, 2]]
    v1 = (c - a)[:, [0, 2]]
    den = v0[:, 0] * v1[:, 1] - v0[:, 1] * v1[:, 0]
    ok_f = np.abs(den) > 1e-9  # skip vertical faces
    sup = np.full((len(xs),), default, np.float32)
    p = np.stack([xs, zs], axis=1)
    for f in np.nonzero(ok_f)[0]:
        d = p - a[f, [0, 2]]
        u = (d[:, 0] * v1[f, 1] - d[:, 1] * v1[f, 0]) / den[f]
        w = (v0[f, 0] * d[:, 1] - v0[f, 1] * d[:, 0]) / den[f]
        inside = (u >= -1e-6) & (w >= -1e-6) & (u + w <= 1 + 1e-6)
        y = a[f, 1] + u * (b[f, 1] - a[f, 1]) + w * (c[f, 1] - a[f, 1])
        sup = np.where(inside & (y > sup), y, sup)
    return sup


def terrain_lattice(n, volume, scene_path, frac):
    """n particles at rest spacing stacked on the scene's support
    surface: per-(x, z) column base from a vertical ray-cast, filled
    bottom-up layer by layer."""
    dx = float(np.cbrt(volume / n))  # rest spacing
    verts, tris = load_tris(scene_path)
    lo, hi = verts.min(0), verts.max(0)
    fx, fz = frac
    cx, cz = (lo[0] + hi[0]) / 2, (lo[2] + hi[2]) / 2
    x0, x1 = cx - fx * (hi[0] - lo[0]) / 2, cx + fx * (hi[0] - lo[0]) / 2
    z0, z1 = cz - fz * (hi[2] - lo[2]) / 2, cz + fz * (hi[2] - lo[2]) / 2
    nx = max(1, int((x1 - x0) / dx))
    nz = max(1, int((z1 - z0) / dx))
    cols_x = np.repeat(x0 + np.arange(nx) * dx, nz)
    cols_z = np.tile(z0 + np.arange(nz) * dx, nx)
    base = support_height(tris, cols_x, cols_z, lo[1]) + CLEARANCE
    layers = -(-n // (nx * nz))
    y = base[None, :] + np.arange(layers)[:, None] * dx
    x = np.broadcast_to(cols_x, y.shape)
    z = np.broadcast_to(cols_z, y.shape)
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)[:n].astype(np.float32)


def launches() -> dict:
    """Each table-driven kernel's launch count so far."""
    from libclsph_tpu_torch.ops.kernels import density, forces

    return {k: getattr(density if hasattr(density, k) else forces, k).launches
            for k in KERNELS}


def run_scene(scene, n, frames, device, out_prefix=None, fluid="water") -> dict:
    """``frames`` frames of ``n`` particles on ``scenes/<scene>.obj``
    through ``SPHSimulation(pretune="auto")``, exporting ``.geo`` frames
    under ``out_prefix`` (none when None). Returns the run's record:
    ``frame_s`` (each frame's substeps, synchronised), ``pretune_s``,
    ``setup_s`` (scene and lattice), ``total_s`` (``simulate()``, bake,
    pretune and export included), ``chosen`` and ``final`` configs,
    ``launches`` during ``simulate()``, the lattice ``pos`` and the
    engine ``sim``."""
    import torch

    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.core.state import ParticleState
    from libclsph_tpu_torch.engine import pretune
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.io.houdini import HoudiniFileSaver
    from libclsph_tpu_torch.models.presets import FLUIDS, simulation_config

    placement = PLACEMENTS[scene]
    # half a frame short of ``frames`` frames, so float accumulation of
    # the frame time cannot add one
    p = derive_parameters(dict(FLUIDS[fluid]), simulation_config(
        particles_count=n, particle_mass=placement.get("mass", 0.05),
        simulation_time=(frames - 0.5) / 60.0))
    sim = SPHSimulation(device=device, pretune="auto")
    sim.parameters = p
    sim.precomputed_terms = p.precomputed()
    sim.initial_volume = p.initial_volume
    t0 = time.perf_counter()
    sim.load_scene(scene + ".obj", scenes_dir=os.path.join(ROOT, "scenes"))
    pos = terrain_lattice(n, p.initial_volume, os.path.join(ROOT, "scenes", scene + ".obj"),
                          placement["frac"])
    state0 = ParticleState.zeros(n, sim.device).replace(
        position=torch.as_tensor(pos, device=sim.device))
    sim.init_particles = lambda: state0
    if out_prefix is not None:
        saver = HoudiniFileSaver(out_prefix)
        sim.save_frame = lambda arrays, params: saver.write_frame_to_file(arrays, params)
    setup_s = time.perf_counter() - t0

    frame_s, configs, pretune_s = [], [], []
    run_frame, probe = sim._run_frame, pretune.pretune_config

    def timed_frame(state, dt):
        configs.append(sim.step_config)
        t = time.perf_counter()
        out = run_frame(state, dt)
        bench_torch.sync(sim.device)
        frame_s.append(time.perf_counter() - t)
        return out

    def timed_probe(*args, **kw):
        t = time.perf_counter()
        out = probe(*args, **kw)
        bench_torch.sync(sim.device)
        pretune_s.append(time.perf_counter() - t)
        return out

    sim._run_frame = timed_frame
    pretune.pretune_config = timed_probe
    before = launches()
    try:
        total = sim.simulate()
    finally:
        pretune.pretune_config = probe
    after = launches()
    return dict(frame_s=frame_s, pretune_s=pretune_s[0] if pretune_s else None,
                setup_s=setup_s, total_s=total, chosen=configs[0], final=sim.step_config,
                launches={k: after[k] - before[k] for k in after}, pos=pos, sim=sim)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", choices=sorted(PLACEMENTS))
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--fluid", default="water", choices=["water", "mucus"])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="frames prefix to keep (default: a temporary directory)")
    ap.add_argument("--no-export", action="store_true")
    args = ap.parse_args(argv)

    from libclsph_tpu_torch.engine.simulation import configure_device
    from libclsph_tpu_torch.io import geo_format

    dev = configure_device(args.device)
    if not args.no_export:
        try:
            geo_format.native_writer(required=True)
        except RuntimeError as e:
            sys.exit(f"torch_scene_run: {e}")
    with tempfile.TemporaryDirectory() as tmp:
        prefix = None if args.no_export else (args.out or os.path.join(tmp, "scene_"))
        r = run_scene(args.scene, args.n, args.frames, dev, prefix, args.fluid)
    steady = r["frame_s"][1:] or r["frame_s"]
    print(json.dumps(dict(
        metric=f"{args.fluid} {args.scene} flow-through @ {args.n} (s/frame)",
        n=args.n, frames=len(r["frame_s"]), export=not args.no_export,
        s_per_frame=r["frame_s"], first_frame_s=r["frame_s"][0],
        median_s_per_frame=statistics.median(steady), mean_s_per_frame=statistics.mean(steady),
        pretune_s=r["pretune_s"], pretune_stats=r["sim"].pretune_stats,
        setup_s=r["setup_s"], total_s=r["total_s"], config_chosen=str(r["chosen"]),
        config_final=str(r["final"]),
        tier2=bool(r["chosen"].tier2_frac or r["final"].tier2_frac),
        launches=r["launches"], device=str(dev),
        card=bench_torch.card_line() if dev.type == "cuda" else None,
        host_cpu=bench_torch.host_cpu()), default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
