#!/usr/bin/env python3
"""End-to-end s/frame of the 64k water dam-break onto ``scenes/cube.obj``
on the port (the JAX package's experiments/e2e_64k.py): the reference's
demo size (``simulation_properties/default.json``).

    python3 experiments/torch_e2e_64k.py [--device cuda|cpu] [--n 65536]
                                         [--frames 30] [--no-export] [--out PREFIX]
                                         [--fetch saver|inline] [--loop dispatch|reads]

The production engine as the CLI runs it: ``SPHSimulation`` at the
``StepConfig`` defaults (the main path), adaptive substepping, the
device frame loop, and ``.geo`` export on the saver thread with the
native writer (without it the run exits, as the NumPy writer would set
the frame time). A frame's time is the host clock between two
``post_frame`` callbacks. Prints one JSON line: the first frame, and the
median, p90 and mean s/frame from frame 2 on (the mean carries the
impact frames, where the CFL dt shrinks), and the engine's dispatches
with their host reads and the chunks that stopped on each predicate.

Two switches take one of the engine's two host-side parts back to the
form it had before the frame loop's dispatch layer, to split a change of
s/frame between them: ``--fetch inline`` makes the host copy of the
state on the loop thread (the saver thread only writes), and ``--loop
reads`` runs the frame with a host read before each predicate
(``tests/torch_frame_ref.py``'s loop).
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


def inline_host(self, saver, state, save, callbacks):
    """``SPHSimulation._host`` as the engine made its host copy before:
    fetched on the loop thread, saved on the saver thread."""
    from concurrent.futures import Future

    from libclsph_tpu_torch.io import checkpoint

    arrays = self._fetch(self._gathered(state))
    p, save_cb = self.parameters, self.save_frame if save else None
    ckpt = self.checkpoint_path if self.serialize else None

    def run():
        save_cb(arrays, p)
        if ckpt:
            checkpoint.save_checkpoint(ckpt, arrays, p)

    if save_cb is not None:
        saver.submit(run)
    done = Future()
    done.set_result(arrays)
    return done


def frame_with_reads(state, dt, timeleft, params, scene, config, stats=None, host=None):
    """``engine.step.frame`` as a loop that reads the host before each
    predicate (``tests/torch_frame_ref.py``), with the engine's ``host``
    values read after it."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_frame_ref

    state, dt, timeleft, flags = torch_frame_ref.frame(state, dt, timeleft, params, scene,
                                                       config, stats)
    host.update(more=bool(timeleft > 0.0), flags=int(flags), reads=0, wasted=0,
                stops=dict(time=0, stale=0, retry=0), events=[])
    return state, dt, timeleft, flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--no-export", action="store_true")
    ap.add_argument("--out", default=None,
                    help="frames prefix to keep (default: a temporary directory)")
    ap.add_argument("--fetch", choices=("saver", "inline"), default="saver",
                    help="where the host copy is made (inline: on the loop thread)")
    ap.add_argument("--loop", choices=("dispatch", "reads"), default="dispatch",
                    help="the frame loop (reads: a host read before each predicate)")
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

    if args.fetch == "inline":
        SPHSimulation._host = inline_host
    if args.loop == "reads":
        from libclsph_tpu_torch.engine import simulation

        simulation.frame = frame_with_reads
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
        "fetch": args.fetch,
        "loop": args.loop,
        "config": str(sim.step_config),
        "dispatch_stats": sim.dispatch_stats,
        "device": str(dev),
        "card": bench_torch.card_line() if dev.type == "cuda" else None,
        "host_cpu": bench_torch.host_cpu(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
