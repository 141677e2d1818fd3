#!/usr/bin/env python3
"""Where a sharded substep's time goes, beside the single-device substep on
the same 16-wide tables.

    python3 experiments/torch_mesh_split.py [--n 1000000] [--world 1]
        [--exchange halo] [--warmup 3] [--steps 8] [--device cuda|cpu]

Two runs on bench_torch's dam-break at ``--n``, in each rank's process:

* ``mesh``: the rank's sharded frame loop as ``bench_torch.py --mesh``
  runs it (``parallel/bench.py``: the warm-up and the rehearsed window,
  grown by bench.py's mesh rule, then ``--steps`` substeps);
* ``single``: the single-device substeps of ``chip_smoke.py`` phase 4b
  (the 16-wide force path, ``force_sub8`` off, hit16 128), warmed up by
  ``bench_torch.warm_up`` with the window rehearsed.

Each run's ``--steps`` substeps are timed once without the profiler (the
device synchronised around them) and once under ``utils.profiling.trace``,
with named ranges put around the package's functions for that run only
(nothing else changes; in the trace as ``split:<name>``, apart from the
program's own spans): ``substep``, ``sort`` (``grid.sort_by_cell`` on
the mesh; on one device ``step.pad_and_sort``: bounds, padding, sort),
``exchange`` (``sharded_step.exchange_tables``: the surface set, the
exchange and the block search), ``block_search``
(``tiles.candidate_blocks`` and ``candidate_blocks_hierarchical``),
``refine`` (``kernels.refine.refine_candidates_exact`` and
``tiles.refine_candidates``),
``passes`` (``sharded_step.nl_passes`` or ``step._density_forces_nl``),
``collective`` (the mesh's all_gather, all_reduce and ring) and
``advance`` (``step._advect_collide``). For each range, per substep: its
calls, its host time (the range's span) and its device time (the kernels
and copies launched inside it). Then the device total, the hand kernels',
the copies' by kind and the top entries by device time, beside the traced
wall time. Prints one JSON line a rank's run and one JSON line last.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

N = 1_000_000
WARMUP = 3
STEPS = 8
TOP = 12
SINGLE = dict(force_sub8=False, max_candidates_hit16=128)  # chip_smoke.py's SUB16
HAND = re.compile(r"\b(density|forces|radix)_\w*")
# the ranges' names in the trace, apart from the program's own spans,
# some of which share a label (substep, sort, refine, passes)
PREFIX = "split:"


def _targets():
    """(label, owner, attribute) of every function that gets a range."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import grid, tiles
    from libclsph_tpu_torch.ops.kernels import refine
    from libclsph_tpu_torch.parallel import sharded_step
    from libclsph_tpu_torch.parallel.mesh import Mesh

    return [("substep", sharded_step, "local_substep"), ("substep", step, "substep"),
            ("sort", grid, "sort_by_cell"), ("sort", step, "pad_and_sort"),
            ("exchange", sharded_step, "exchange_tables"),
            ("block_search", tiles, "candidate_blocks"),
            ("block_search", tiles, "candidate_blocks_hierarchical"),
            ("refine", refine, "refine_candidates_exact"),
            ("refine", tiles, "refine_candidates"),
            ("passes", sharded_step, "nl_passes"), ("passes", step, "_density_forces_nl"),
            ("collective", Mesh, "all_gather_many"), ("collective", Mesh, "all_reduce_max"),
            ("collective", Mesh, "ring"), ("advance", step, "_advect_collide")]


@contextlib.contextmanager
def ranges():
    """Every target function inside a named range (an inner call of the
    same label gets none), for the body only."""
    from libclsph_tpu_torch.utils import profiling

    depth: dict = {}

    def wrap(label, fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if depth.get(label):
                return fn(*args, **kw)
            depth[label] = 1
            try:
                with profiling.annotate(PREFIX + label):
                    return fn(*args, **kw)
            finally:
                depth[label] = 0
        return inner

    saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in _targets()]
    try:
        for label, owner, attr in _targets():
            setattr(owner, attr, wrap(label, getattr(owner, attr)))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def split(prof, steps: int, cuda: bool) -> dict:
    """The trace's ranges and device entries, per substep."""
    from torch.autograd import DeviceType

    labels = {PREFIX + label for label, _, _ in _targets()}
    spans = {}
    for e in prof.events():
        if e.name in labels and e.device_type == DeviceType.CPU:
            r = spans.setdefault(e.name[len(PREFIX):],
                                 dict(calls=0, host_ms=0.0, device_ms=0.0))
            r["calls"] += 1
            r["host_ms"] += e.cpu_time_total / 1e3
            r["device_ms"] += e.device_time_total / 1e3
    for r in spans.values():
        r.update(calls=r["calls"] / steps, host_ms=r["host_ms"] / steps,
                 device_ms=r["device_ms"] / steps if cuda else None)
    out = dict(ranges=spans, device_ms=None, hand_kernels_ms=None, copies_ms=None, top=None)
    if not cuda:
        return out
    entries = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in labels
               and not getattr(e, "is_user_annotation", False)]
    ms = {e.key: e.self_device_time_total / 1e3 / steps for e in entries}
    copies = {}
    for k, v in ms.items():
        if k.startswith(("Memcpy", "Memset")):
            kind = k.split()[1] if len(k.split()) > 1 else k
            copies[kind] = copies.get(kind, 0.0) + v
    out.update(device_ms=sum(ms.values()),
               hand_kernels_ms=sum(v for k, v in ms.items()
                                   if HAND.search(k) and "at::" not in k),
               copies_ms=copies,
               top=[[k[:100], v] for k, v in sorted(ms.items(), key=lambda kv: -kv[1])[:TOP]])
    return out


def measured(run, steps: int, device) -> dict:
    """``run()`` (``steps`` substeps from the same state) timed once
    without the profiler and once under it with the ranges."""
    from libclsph_tpu_torch.utils import profiling

    bench_torch.sync(device)
    t0 = time.perf_counter()
    flags = int(run())
    plain_ms = 1e3 * (time.perf_counter() - t0) / steps
    with tempfile.TemporaryDirectory() as tmp, profiling.trace(tmp) as prof, ranges():
        t0 = time.perf_counter()
        flags |= int(run())
        bench_torch.sync(device)
        traced_ms = 1e3 * (time.perf_counter() - t0) / steps
    out = dict(ms_per_substep=plain_ms, traced_ms_per_substep=traced_ms, flags=flags,
               **split(prof, steps, device.type == "cuda"))
    if out["device_ms"] is not None:
        out["busy"] = out["device_ms"] / traced_ms
    return out


def split_rank(mesh, params, exchange: str, warmup: int, steps: int) -> dict:
    """A rank's two runs (the module's docstring)."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.engine.step import StepConfig
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.parallel import bench, sharded_step
    from libclsph_tpu_torch.scene.scene import Scene

    dev = mesh.device
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes")), dev)
    cfg = StepConfig(force_sub8=False)
    halo_max = (0 if exchange == "all_gather" else
                sharded_step.default_halo_max(params.particles_count, mesh.world,
                                              cfg.block_size))
    grown = dict(config=sharded_step.mesh_config(cfg), params=params, scene=scene,
                 exchange=exchange, halo_max=halo_max, halo_hops=1)
    state = sharded_step.local_rows(
        sharded_step.pad_for_mesh(init_state(params, dev), params, mesh.world, cfg),
        mesh.rank, mesh.world)
    dt0 = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)
    state, dt = bench._grown(mesh, grown, state, dt0, warmup)
    bench._grown(mesh, grown, state, dt, steps)  # the window, rehearsed
    mesh.barrier()
    out = dict(rank=mesh.rank, world=mesh.world, exchange=exchange, halo_max=halo_max)
    out["mesh"] = dict(
        tables=bench.table_shape(grown["config"]),
        **measured(lambda: bench._frame_substeps(mesh, grown, state, dt, steps)[2], steps,
                   dev))

    engine = SPHSimulation(StepConfig(**SINGLE), device=dev, pretune=False)
    s1, d1 = bench_torch.warm_up(init_state(params, dev), params, scene, engine, warmup,
                                 window=steps)
    out["single"] = dict(
        tables=bench.table_shape(engine.step_config),
        **measured(lambda: bench_torch.run_substeps(s1, d1, params, scene,
                                                    engine.step_config, steps)[2],
                   steps, dev))
    return out


def run(n: int = N, world: int = 1, exchange: str = "halo", warmup: int = WARMUP,
        steps: int = STEPS, device="cuda", log=lambda line: None) -> dict:
    """The ranks' splits and the card they ran on."""
    import torch

    from libclsph_tpu_torch.parallel import mesh

    params = bench_torch.build_params(n)
    ranks = mesh.launch(split_rank, world, device=str(device), log=log,
                        args=(params, exchange, warmup, steps))
    for r in ranks:
        log(json.dumps(r))
    cuda = torch.device(device).type == "cuda"
    return dict(metric=f"sharded substep split @ {n} particles x {world} ranks "
                f"(exchange={exchange}) beside the single-device 16-wide path",
                n=n, world=world, steps=steps, ranks=ranks,
                card=bench_torch.card_line() if cuda else None,
                host_cpu=bench_torch.host_cpu())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--exchange", default="halo", choices=("all_gather", "halo", "ring"))
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.world, args.exchange, args.warmup, args.steps, args.device,
                  log=lambda line: print(line, flush=True))
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_mesh_split: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
