#!/usr/bin/env python3
"""End-to-end s/frame of the 64k water dam-break onto ``scenes/cube.obj``
on the port (the JAX package's experiments/e2e_64k.py): the reference's
demo size (``simulation_properties/default.json``).

    python3 experiments/torch_e2e_64k.py [--device cuda|cpu] [--n 65536]
                                         [--frames 30] [--no-export] [--out PREFIX]

The production engine as the CLI runs it: ``SPHSimulation`` at the
``StepConfig`` defaults (the main path), adaptive substepping, the
device frame loop, and ``.geo`` export on the saver thread with the
native writer (without it the run exits, as the NumPy writer would set
the frame time). A frame's time is the host clock between two
``post_frame`` callbacks. Prints one JSON line: the first frame, and the
median, p90 and mean s/frame from frame 2 on (the mean carries the
impact frames, where the CFL dt shrinks).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import bench_torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--no-export", action="store_true")
    ap.add_argument("--out", default=None,
                    help="frames prefix to keep (default: a temporary directory)")
    args = ap.parse_args(argv)

    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.io import geo_format
    from libclsph_tpu_torch.io.houdini import HoudiniFileSaver
    from libclsph_tpu_torch.models.presets import WATER, simulation_config

    dev = configure_device(args.device)
    if not args.no_export:
        try:
            geo_format.native_writer(required=True)
        except RuntimeError as e:
            sys.exit(f"torch_e2e_64k: {e}")

    sim = SPHSimulation(device=dev)
    sim.parameters = derive_parameters(dict(WATER), simulation_config(
        particles_count=args.n, simulation_time=args.frames / 60.0))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene("cube.obj", scenes_dir=os.path.join(ROOT, "scenes"))

    frame_times = []
    last = [time.perf_counter()]

    def post(arrays, params, is_full):
        now = time.perf_counter()
        frame_times.append(now - last[0])
        last[0] = now
        return False

    sim.post_frame = post
    with tempfile.TemporaryDirectory() as tmp:
        sim.checkpoint_path = os.path.join(tmp, "no_checkpoint.npz")  # never resume
        if not args.no_export:
            saver = HoudiniFileSaver(args.out or os.path.join(tmp, "e2e64k_"))
            sim.save_frame = lambda arrays, p: saver.write_frame_to_file(arrays, p)
        t0 = time.perf_counter()
        last[0] = t0
        sim.simulate()
        wall = time.perf_counter() - t0

    steady = np.asarray(frame_times[1:] if len(frame_times) > 1 else frame_times)
    print(json.dumps({
        "metric": "s/frame 64k water dam-break onto cube.obj (end-to-end)",
        "n": args.n,
        "frames": len(frame_times),
        "export": not args.no_export,
        "native_writer": geo_format.have_native(),
        "first_frame_s": frame_times[0] if frame_times else None,
        "median_s_per_frame": float(np.median(steady)),
        "p90_s_per_frame": float(np.percentile(steady, 90)),
        "mean_s_per_frame": float(steady.mean()),
        "fps_median": 1.0 / float(np.median(steady)),
        "wall_s": wall,
        "config": str(sim.step_config),
        "device": str(dev),
        "card": bench_torch.card_line() if dev.type == "cuda" else None,
        "host_cpu": bench_torch.host_cpu(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
