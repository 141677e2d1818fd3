#!/usr/bin/env python3
"""The river's frames dispatch by dispatch, on the port (the JAX
package's experiments/river_frame_diag.py).

    python3 experiments/torch_river_frame_diag.py [--n 1048576] [--frames 5]
        [--cap 64] [--scene river] [--no-device-time] [--device cuda|cpu]

Drives ``engine.step.frame`` directly, as the engine's fast path does
(``SPHSimulation._run_frame``): each frame's time is spent in dispatches
of up to ``--cap`` substeps; a dispatch that raises a capacity or
staleness flag grows the config by the engine's rule
(``SPHSimulation._needs_rerun``) and the frame re-runs from its start.
The particles are placed as ``torch_scene_run.py river`` places them
(stacked on the channel, 0.025 kg a particle), from the config the
pretune picks there, as that run (``PERF.md`` row 7) starts. That is
not river_frame_diag.py:34-44's lattice (rest spacing in the box
[-5.52, 5.52] x [-1.45, 1.7] x [-1.2, 1.2], filled from the bottom, at
0.05 kg on the main path's config): that lattice's lower layers lie
inside the sloped channel, whose distance field ejects them, and at 1M
its first frame overflows its tables past the engine's six re-runs.

For each dispatch: its substeps, rebuilds and reuses (counted in the
loop, ``frame``'s ``stats``; no result changes), flags, dt and the time
left, its host reads, the substeps it ran and discarded and the chunks
that stopped on each predicate (``frame``'s ``host``: time, stale,
retry), its wall time (the host clock, the device synchronised around it)
and its device time (``utils.profiling.trace``, which the wall time then
includes; none on the CPU or with ``--no-device-time``). Prints one JSON
line a dispatch and one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "experiments")):
    if path not in sys.path:
        sys.path.insert(0, path)

import bench_torch  # noqa: E402

N = 1_048_576
FRAMES = 5
CAP = 64

@contextlib.contextmanager
def device_clock(on: bool):
    """Yields a list that receives the device time (s) of the body: the
    kernels and copies that ``utils.profiling.trace`` records; None when
    ``on`` is False."""
    if not on:
        yield [None]
        return
    from torch.autograd import DeviceType

    from libclsph_tpu_torch.utils import profiling

    out = [None]
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            yield out
    out[0] = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6


def run(n: int = N, frames: int = FRAMES, cap: int = CAP, scene: str = "river",
        device="cuda", device_time: bool = True,
        log=lambda line: None) -> dict:
    """The probe's record: ``dispatches`` (one a dispatch, re-runs
    included) and ``frames`` (the dispatches that stood: substeps,
    rebuilds, reuses, wall and device seconds, re-runs)."""
    import torch

    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.core.state import ParticleState
    from libclsph_tpu_torch.engine import pretune, step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.models.presets import FLUIDS, simulation_config
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    import torch_scene_run

    dev = configure_device(device)
    place = torch_scene_run.PLACEMENTS[scene]
    p = derive_parameters(dict(FLUIDS["water"]),
                          simulation_config(particles_count=n,
                                            particle_mass=place.get("mass", 0.05)))
    obj = os.path.join(ROOT, "scenes", scene + ".obj")
    t0 = time.perf_counter()
    sdev = collisions.build_device_scene(Scene.load(scene + ".obj", p.h * 2,
                                                    scenes_dir=os.path.dirname(obj)), dev)
    pos = torch_scene_run.terrain_lattice(n, p.initial_volume, obj, place["frac"])
    state = ParticleState.zeros(n, dev).replace(position=torch.as_tensor(pos, device=dev))
    sim = SPHSimulation(step.StepConfig(substeps_per_dispatch=cap), device=dev,
                        pretune=False)
    sim.parameters = p
    sim.step_config, pretune_stats = pretune.pretune_config(state, p, sim.step_config)
    setup_s = time.perf_counter() - t0
    chosen = str(sim.step_config)
    on_card = dev.type == "cuda" and device_time

    dt = torch.tensor(p.frame_time * p.simulation_scale, dtype=torch.float32, device=dev)
    dispatches, frame_recs = [], []
    for f in range(frames):
        attempt = 0
        while True:
            st, d = state, dt
            timeleft = torch.tensor(p.frame_time, dtype=torch.float32, device=dev)
            mine, rerun = [], False
            more = True
            while more:
                stats, host = {}, {}
                bench_torch.sync(dev)
                t = time.perf_counter()
                with device_clock(on_card) as dev_s:
                    st, d, timeleft, flags = step.frame(st, d, timeleft, p, sdev,
                                                        sim.step_config, stats, host)
                    bench_torch.sync(dev)
                wall = time.perf_counter() - t
                more = host["more"]
                rec = dict(frame=f, attempt=attempt, dispatch=len(mine),
                           substeps=stats.get("substeps", 0),
                           rebuilds=stats.get("rebuilds", 0), reuses=stats.get("reuses", 0),
                           flags=int(flags), dt=float(d), timeleft=float(timeleft),
                           host_reads=host["reads"], stops=host["stops"],
                           wasted=host["wasted"],
                           wall_s=wall, device_s=dev_s[0])
                mine.append(rec)
                dispatches.append(rec)
                log(json.dumps(rec))
                if sim._needs_rerun(flags):
                    rerun = True
                    log(json.dumps(dict(frame=f, rerun_with=str(sim.step_config))))
                    break
            if not rerun:
                state, dt = st, d
                break
            attempt += 1
        frame_recs.append(dict(
            frame=f, reruns=attempt, dispatches=len(mine),
            substeps=sum(r["substeps"] for r in mine),
            rebuilds=sum(r["rebuilds"] for r in mine), reuses=sum(r["reuses"] for r in mine),
            wall_s=sum(r["wall_s"] for r in mine),
            device_s=sum(r["device_s"] for r in mine) if on_card else None,
            max_speed=float(torch.linalg.vector_norm(state.velocity, dim=1).max())))
        log(json.dumps(frame_recs[-1]))
    finite = bool(torch.isfinite(state.position).all() and torch.isfinite(state.density).all())
    return dict(metric=f"{scene} frames by dispatch @ {n} particles", n=n, cap=cap,
                scene=scene, setup_s=setup_s, config_chosen=chosen,
                pretune_stats=pretune_stats, config_final=str(sim.step_config),
                frames=frame_recs, dispatches=dispatches, finite=finite, device=str(dev),
                card=bench_torch.card_line() if dev.type == "cuda" else None,
                host_cpu=bench_torch.host_cpu())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--scene", default="river")
    ap.add_argument("--no-device-time", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.frames, args.cap, args.scene, args.device,
                  not args.no_device_time, log=lambda line: print(line, flush=True))
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_river_frame_diag: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
