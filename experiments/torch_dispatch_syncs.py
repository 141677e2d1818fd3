#!/usr/bin/env python3
"""The synchronising calls of the frame loop's dispatch layer on the card.

    python3 experiments/torch_dispatch_syncs.py [--n 1000000] [--steps 8]
        [--device cuda|cpu]

bench_torch's dam-break at N particles, warmed up as bench_torch warms it
(``bench_torch.warm_up``), then, from the warm state, each run once and
then once more under
``torch.cuda.set_sync_debug_mode("warn")`` (``bench_torch.sync_calls``):
one dispatch of ``engine.step.frame`` of ``--steps`` substeps with time
to spare (the engine's fast path), and ``--steps`` substeps of
bench_torch's fixed cadence (``bench_torch.run_substeps``). For each: the
synchronising calls and where they were made, the dispatch layer's host
reads (``engine.step.host_read``), the chunks that stopped, and the
calls a substep. On the CPU nothing synchronises and the calls are 0.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

N = 1_000_000
STEPS = 8
WARMUP = 3


def run(n: int = N, steps: int = STEPS, device="cuda") -> dict:
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    dev = configure_device(device)
    params = bench_torch.build_params(n)
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2, scenes_dir=os.path.join(ROOT, "scenes")), dev)
    engine = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
    state, dt = bench_torch.warm_up(init_state(params, dev), params, scene, engine, WARMUP,
                                    window=steps)
    cfg = dataclasses.replace(engine.step_config, substeps_per_dispatch=steps)
    timeleft = torch.tensor(3.0e38, dtype=torch.float32, device=dev)
    bench_torch.sync(dev)
    out = {}
    runs = {
        "frame": lambda host: step.frame(state, dt, timeleft, params, scene, cfg, None, host),
        "run_substeps": lambda host: bench_torch.run_substeps(state, dt, params, scene, cfg,
                                                              steps, host=host),
    }
    for name, fn in runs.items():
        fn({})  # once before counting: what a process does once is no cost a substep
        bench_torch.sync(dev)
        host = {}
        _, calls = bench_torch.sync_calls(lambda: fn(host))
        bench_torch.sync(dev)
        out[name] = dict(sync_calls=len(calls), per_substep=len(calls) / steps,
                         where=dict(collections.Counter(calls)), host_reads=host["reads"],
                         stops=host["stops"], flags=host["flags"])
    return dict(metric=f"synchronising calls of a dispatch @ {n} particles", n=n,
                steps=steps, cand_interval=cfg.cand_interval, config=str(cfg), **out,
                device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.steps, args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_dispatch_syncs: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
