#!/usr/bin/env python3
"""Benchmark harness of libclsph-tpu's PyTorch port: particle-steps/s on
one GPU.

    python3 bench_torch.py [--n N] [--steps K] [--warmup W] [--scene cube|none]
                           [--device cuda|cpu] [bench.py's StepConfig flags]

The counterpart of ``bench.py``'s single-chip run. A water (or mucus)
dam-break of N particles (1,000,000 on the card, 32,768 with
``--device cpu``) falls onto ``scenes/cube.obj``. W warm-up substeps run
first; a flag raised there grows the flagged table by the engine's own
rule (``SPHSimulation._needs_rerun``) and the warm-up runs again from the
start. The K substeps of the timed window then run once, untimed, from
the warm state, growing the tables the same way, so that a window the
fall deepens raises no flag. Then the K substeps are timed from the warm
state on bench.py's schedule: a re-sort every ``--sort-interval``
substeps, a candidate rebuild every ``--cand-interval``, the carried
tables reused in between. The device is synchronised before and after
the timed window, which is not re-run.

Prints ONE JSON line with bench.py's keys; the number stands only with
``detail.timed_flags == 0``. Where it differs from bench.py:

* the warm-up grows capacity through the engine's rule
  (``SPHSimulation._grow_capacity``), not bench.py:359-381's. Both double
  ``max_candidates`` on a block overflow, turn two-tier routing on at the
  first subblock overflow and double ``tier2_mult`` after it, halve
  ``tier2_frac`` on a pool overflow, double ``max_candidates_hit`` on the
  q-granular tables and double ``cand_slack`` on a stale-reuse flag
  (bench.py:380-381). They differ on a hit overflow: the engine adds 32
  to the 8-wide hit capacity only up to 160 and then moves to the
  q-granular tables, and on the 16-wide force path's tables it moves to
  them at once, where bench.py adds 32 without a ceiling (bench.py:
  371-375) and doubles ``max_candidates_hit16`` (:376-377). The warm-up
  also rehearses the timed window (bench.py warms up on its W substeps
  only);
* ``vs_baseline`` is null: bench.py's north star is a TPU v5e-8 target,
  and the port has no H100 baseline yet;
* ``detail`` adds ``card`` (``nvidia-smi`` name and power limit),
  ``host_cpu`` and ``config`` (the grown ``StepConfig``); ``platform`` is
  ``cuda`` or ``cpu``.

``--mesh N`` (with ``--exchange``, ``--halo-max``, ``--halo-hops``) times
the sharded frame loop over N ranks instead (bench.py's ``bench_mesh``;
:mod:`libclsph_tpu_torch.parallel.bench` on each rank): the same warm-up,
rehearsal and window of the frame loop on every rank, grown by
bench.py's mesh rule (bench.py:115-140: the flagged capacities and the
slack doubled in place, so the 16-wide tables stay; plus the engine's
``halo_hops`` growth on ``FLAG_EXCHANGE``), and bench.py's mesh JSON
line with the collectives and their bytes per substep (those staged
through host buffers apart), whether the ranks shared a card and, in
``detail.tables``, the grown table shape. As in bench.py, the 8-wide
force pass is off under the mesh. Ranks that share a card measure no
multi-GPU scaling.

Without a GPU it refuses to run unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform as _platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# particles a run holds by default, on the card and on the CPU (bench.py)
N_CARD = 1_000_000
N_CPU = 32_768


def build_params(n: int, fluid_name: str = "water"):
    """The dam-break's parameters at ``n`` particles (bench.py:30-42)."""
    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.models.presets import FLUIDS

    sim = dict(
        particles_count=n,
        particle_mass=0.05,
        simulation_time=3,
        target_fps=60,
        simulation_scale=0.1,
        constant_acceleration=dict(x=0, y=-9.8, z=0),
    )
    return derive_parameters(dict(FLUIDS[fluid_name]), sim)


def build_arg_parser() -> argparse.ArgumentParser:
    """bench.py's flags, whose defaults are the port's ``StepConfig()``,
    and ``--device``."""
    from libclsph_tpu_torch.engine.step import IMPLS, VARIANTS, StepConfig

    d = StepConfig()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help=f"particle count ({N_CARD} on the card, {N_CPU} on the CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--scene", default="cube",
                    help="scenes/<name>.obj collision mesh, or 'none' (free space)")
    ap.add_argument("--fluid", default="water", choices=["water", "mucus"])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; refuses to run without a GPU) or 'cpu'")
    ap.add_argument("--impl", default=d.neighbor_impl, choices=list(IMPLS))
    ap.add_argument("--block-size", type=int, default=d.block_size)
    ap.add_argument("--max-candidates", type=int, default=d.max_candidates)
    ap.add_argument("--tile-mode", default="direct", choices=["direct", "mxu"])
    ap.add_argument("--pallas-variant", default=d.pallas_variant, choices=list(VARIANTS))
    ap.add_argument("--nl-query-rows", type=int, default=d.nl_query_rows)
    ap.add_argument("--max-candidates-sub", type=int, default=d.max_candidates_sub)
    ap.add_argument("--max-candidates-hit", type=int, default=d.max_candidates_hit)
    ap.add_argument("--no-hit-compact", action="store_true")
    ap.add_argument("--force-query-rows", type=int, default=d.force_query_rows,
                    choices=[32, 128])
    ap.add_argument("--force-sub16", action=argparse.BooleanOptionalAction,
                    default=d.force_sub16)
    ap.add_argument("--max-candidates-hit16", type=int, default=d.max_candidates_hit16)
    ap.add_argument("--force-sub8", action=argparse.BooleanOptionalAction,
                    default=d.force_sub8)
    ap.add_argument("--max-candidates-hit8", type=int, default=d.max_candidates_hit8)
    ap.add_argument("--density-sub16", action=argparse.BooleanOptionalAction,
                    default=d.density_sub16)
    ap.add_argument("--tier2-frac", type=int, default=d.tier2_frac)
    ap.add_argument("--tier2-mult", type=int, default=d.tier2_mult)
    ap.add_argument("--sort-interval", type=int, default=d.sort_interval,
                    help="re-sort every k-th substep (1 = every substep)")
    ap.add_argument("--cand-interval", type=int, default=d.cand_interval,
                    help="rebuild candidate lists every k-th substep")
    ap.add_argument("--cand-slack", type=float, default=d.cand_slack,
                    help="refine dilation as a fraction of h for reuse")
    ap.add_argument("--density-gate", action=argparse.BooleanOptionalAction,
                    default=d.density_gate)
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="time the sharded frame loop over N ranks, one process each")
    ap.add_argument("--exchange", default="all_gather",
                    choices=["all_gather", "halo", "ring"])
    ap.add_argument("--halo-max", type=int, default=0,
                    help="surface blocks a rank sends under halo and ring (0: all)")
    ap.add_argument("--halo-hops", type=int, default=1,
                    help="ring hops a direction (the warm-up doubles them on "
                    "FLAG_EXCHANGE, up to (N + 1) // 2)")
    return ap


def config_from_args(args):
    """The ``StepConfig`` of a parsed command line (bench.py:254-295).
    Exits with a message on a negative ``--mesh`` or
    ``--halo-max``, ``--halo-hops`` below 1, the exchange flags without
    ``--mesh`` (they would do nothing), a ``--cand-interval`` that does not divide
    ``--sort-interval`` and any combination ``StepConfig`` refuses; off
    the nl shape the candidate tables are rebuilt every substep, as in
    bench.py, and under ``--mesh`` the 8-wide force pass is off."""
    from libclsph_tpu_torch.engine.step import StepConfig

    if min(args.mesh, args.halo_max) < 0 or args.halo_hops < 1:
        sys.exit("bench_torch: --mesh and --halo-max must be >= 0, --halo-hops >= 1")
    if not args.mesh and (args.exchange != "all_gather" or args.halo_max
                          or args.halo_hops != 1):
        sys.exit("bench_torch: --exchange, --halo-max and --halo-hops need --mesh N")
    if args.cand_interval > 1 and args.sort_interval % args.cand_interval:
        # reuse substeps must not re-sort (ids index the sorted order)
        sys.exit("--cand-interval must divide --sort-interval")
    fields = dict(
        neighbor_impl=args.impl,
        pallas_variant=args.pallas_variant,
        block_size=args.block_size,
        nl_query_rows=args.nl_query_rows,
        max_candidates=args.max_candidates,
        tile_mode=args.tile_mode,
        max_candidates_sub=args.max_candidates_sub,
        max_candidates_hit=args.max_candidates_hit,
        hit_compact=not args.no_hit_compact,
        force_query_rows=args.force_query_rows,
        force_sub16=args.force_sub16,
        max_candidates_hit16=args.max_candidates_hit16,
        density_sub16=args.density_sub16,
        force_sub8=args.force_sub8 and not args.mesh,
        max_candidates_hit8=args.max_candidates_hit8,
        tier2_frac=args.tier2_frac,
        tier2_mult=args.tier2_mult,
        sort_interval=args.sort_interval,
        cand_interval=args.cand_interval,
        cand_slack=args.cand_slack,
        density_gate=args.density_gate,
    )
    if args.cand_interval > 1 and (args.impl != "pallas" or args.pallas_variant != "nl"
                                   or args.nl_query_rows < args.block_size):
        # candidate reuse is a feature of the nl shape; rebuild every
        # substep on the others
        fields["cand_interval"] = 1
    if args.density_sub16 and min(args.block_size, args.nl_query_rows) < 128:
        # the 16-granular tables need whole-128 query rows; fall back
        # quietly at smaller blocks, as bench.py:288-292 does
        fields.update(density_sub16=False, force_sub8=False)
    try:
        return StepConfig(**fields)
    except ValueError as e:
        sys.exit(f"bench_torch: {e}")


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_substep(state, dt, i, tables, params, scene, cfg):
    """Substep ``i`` of bench.py's schedule (bench.py:325-335) alone:
    re-sort when i % sort_interval == 0, rebuild the candidate tables
    when i % cand_interval == 0, else reuse ``tables``. Returns (state,
    dt, flags, tables)."""
    from libclsph_tpu_torch.engine import step

    if i % cfg.cand_interval == 0:
        return step.substep(state, dt, params, scene, cfg,
                            do_sort=i % cfg.sort_interval == 0)
    return step.substep(state, dt, params, scene, cfg, do_sort=False, cand_in=tables)


def run_substeps(state, dt, params, scene, cfg, steps, on_substep=None, host=None):
    """``steps`` substeps of bench.py's schedule (bench.py:325-335) from
    ``state``: substep i re-sorts when i % sort_interval == 0 and rebuilds
    the candidate tables when i % cand_interval == 0, else reuses them
    (substep 0 rebuilds). They run through the frame loop's dispatch
    layer (:func:`engine.step.dispatch`) with no time kept and no
    staleness check, one host read a candidate period, as the engine
    runs them. ``on_substep(i, before, after, dt, flags, cfg)``, where
    given, sees each substep's input and output state (a substep changes
    no tensor of its input). ``host``: a dict that receives the
    dispatch's host values (``reads``, ``flags``, ``stops``). Returns
    (state, dt, flags ORed over the substeps)."""
    from libclsph_tpu_torch.engine import step

    def run(st, d, i, tables, rebuild):
        if rebuild:
            return step.substep(st, d, params, scene, cfg, do_sort=i % cfg.sort_interval == 0,
                                speculative=True)
        return step.substep(st, d, params, scene, cfg, do_sort=False, cand_in=tables,
                            speculative=True)

    def on_commit(i, rebuild, before, after, dt_next, flags, tables):
        on_substep(i, before, after, dt_next, flags, cfg)

    state, dt, _, flags = step.dispatch(state, dt, None, steps, cfg.cand_interval, run,
                                        on_commit=on_commit if on_substep else None,
                                        host=host)
    return state, dt, flags


def warm_up(state, params, scene, engine, steps, dt=None, window=0, on_substep=None,
            on_rerun=None):
    """``steps`` substeps from ``state`` at ``dt`` (a 0-d tensor; max_dt
    when None), re-run from the start with the engine's capacity growth
    (``engine._needs_rerun``) until no flag is raised. Then, with
    ``window``, that many substeps once more from the warm state, grown
    the same way and discarded: the timed window's own substeps, so that
    the capacities cover them too (the dam's fall deepens the tables past
    what the first substeps need). ``on_substep`` goes to
    :func:`run_substeps`; ``on_rerun(flags)`` is called after each run
    that grew the tables, with ``engine.step_config`` already grown.
    Returns the warm (state, dt); ``engine.step_config`` holds the grown
    capacities."""
    import torch

    dt0 = dt if dt is not None else torch.tensor(params.max_dt, dtype=torch.float32,
                                                 device=state.device)
    for _ in range(6):
        st, dt, flags = run_substeps(state, dt0, params, scene, engine.step_config, steps,
                                     on_substep)
        if not engine._needs_rerun(flags):
            break
        if on_rerun is not None:
            on_rerun(flags)
    else:
        raise RuntimeError("capacity growth did not converge")
    if window:
        warm_up(st, params, scene, engine, window, dt, on_substep=on_substep,
                on_rerun=on_rerun)
    return st, dt


def timed_run(state, dt, params, scene, cfg, steps, host=None):
    """``steps`` substeps from (state, dt), the device synchronised before
    and after; ``host`` as :func:`run_substeps`'s. Returns (state, dt,
    elapsed seconds, flags ORed)."""
    sync(state.device)
    t0 = time.perf_counter()
    st, dt, flags = run_substeps(state, dt, params, scene, cfg, steps, host=host)
    sync(state.device)
    return st, dt, time.perf_counter() - t0, flags


def timed_window(label, state, dt, params, scene, engine, steps, counts=None):
    """A :func:`timed_run` on ``engine.step_config`` that is re-run from the
    same state, with the flagged table grown, until it raises no flag (as
    the engine re-runs a frame); its state must be finite. ``counts``: a
    function returning a dict of counters, read around the window that
    stands. Returns (state, dt, ms/substep, the counters' increase or
    None)."""
    import torch

    for _ in range(6):
        before = counts() if counts else None
        st, dt_t, elapsed, flags = timed_run(state, dt, params, scene, engine.step_config,
                                             steps)
        if not engine._needs_rerun(flags):
            break
        print(f"{label}: timed window raised flags {int(flags)} -> grown to "
              f"{engine.step_config}; re-running it", flush=True)
    else:
        raise RuntimeError(f"{label}: timed window kept raising capacity flags")
    if not (torch.isfinite(st.position).all() and torch.isfinite(st.density).all()):
        raise RuntimeError(f"{label}: non-finite state after the timed window")
    grown = None
    if counts:
        after = counts()
        grown = {k: after[k] - before[k] for k in after}
    return st, dt_t, 1000.0 * elapsed / steps, grown


def sync_calls(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: returns
    (its result, the synchronising calls it made, each as the "file:line"
    of the Python frame that made it). On the CPU there is nothing to
    count: the list is empty."""
    import warnings

    import torch

    if not torch.cuda.is_available():
        return fn(), []
    if not getattr(sync_calls, "primed", False):
        # the first switch to "warn" in a process reports a synchronising
        # call of torch's own, which no later switch does
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode("default")
        sync_calls.primed = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    calls = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return out, calls


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_cpu(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The host CPU's model name from ``cpuinfo`` (its vendor, family and
    model numbers where a virtual machine hides the name) and the logical
    CPU count."""
    fields = {}
    try:
        with open(cpuinfo) as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name")
    if not model or model == "unknown":
        model = " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
                         if k in fields) or _platform.machine() or "unknown"
    return f"{model}, {os.cpu_count()} logical CPUs"


def bench_result(n, steps, elapsed, flags, final_dt, fluid, impl, scene, device, cfg,
                 card, host_reads=None) -> dict:
    """bench.py's JSON record (bench.py:400-420) for a timed window, with
    the port's additions in ``detail``; ``host_reads``: the window's
    host reads (:func:`engine.step.host_read`)."""
    platform = "cuda" if str(device).startswith("cuda") else "cpu"
    psteps = n * steps / elapsed
    return {
        "metric": f"particle-steps/sec {fluid} dam-break @ {n} particles ({platform})",
        "value": round(psteps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": None,
        "detail": {
            "n": n,
            "steps": steps,
            "elapsed_s": round(elapsed, 4),
            "ms_per_step": round(1000 * elapsed / steps, 3),
            "impl": impl,
            "scene": scene,
            "platform": platform,
            "final_dt": float(final_dt),
            # the status bits ORed over the timed substeps: the number
            # stands only at 0 (no truncated table, no stale reuse)
            "timed_flags": int(flags),
            "host_reads_per_substep": None if host_reads is None else host_reads / steps,
            "card": card,
            "host_cpu": host_cpu(),
            "config": dataclasses.asdict(cfg),
        },
    }


def bench_mesh(n, steps, warmup, fluid, scene, device, cfg, world, exchange="all_gather",
               halo_max=0, halo_hops=1, log=print) -> tuple[dict, list]:
    """``--mesh``: bench.py's ``bench_mesh`` over ``world`` ranks (each
    :func:`libclsph_tpu_torch.parallel.bench.bench_rank`). Returns
    (bench.py's mesh JSON record, the ranks' results)."""
    import torch

    from libclsph_tpu_torch.parallel import bench, mesh

    params = build_params(n, fluid)
    scene_file = None if scene == "none" else os.path.join(ROOT, "scenes", scene + ".obj")
    ranks = mesh.launch(bench.bench_rank, world, device=str(device), log=log, args=(
        params, cfg, scene_file, exchange, halo_max, halo_hops, warmup, steps))
    cuda = torch.device(device).type == "cuda"
    card = card_line() if cuda else None
    return bench_mesh_record(ranks, n, steps, world, exchange, cuda, card), ranks


def bench_mesh_record(ranks, n, steps, world, exchange, cuda, card) -> dict:
    """bench.py's mesh JSON record (bench.py:152-169) from the ranks'
    :func:`bench_rank` results: the slowest rank's window, the flags OR'd
    over the ranks, rank 0's collectives per substep."""
    import torch

    elapsed = max(r["elapsed_s"] for r in ranks)
    flags = 0
    for r in ranks:
        flags |= r["timed_flags"]
    stats = ranks[0]["stats"]
    psteps = n * steps / elapsed
    return {
        "metric": (f"sharded particle-steps/sec @ {n} x {world} ranks "
                   f"({'cuda' if cuda else 'cpu'}, exchange={exchange})"),
        "value": round(psteps, 1),
        "unit": "particle-steps/s",
        "vs_baseline": None,
        "detail": {
            "n": n, "mesh": world, "exchange": exchange, "halo_hops": ranks[0]["halo_hops"],
            "halo_max": ranks[0]["halo_max"], "steps": steps,
            "elapsed_s": round(elapsed, 4),
            "ms_per_step": round(1000 * elapsed / steps, 3),
            "platform": "cuda" if cuda else "cpu",
            "timed_flags": flags,
            # rank 0's collectives per substep: calls, bytes arriving on
            # the rank, and bytes staged through host buffers
            "collectives_per_substep": {k: v / steps for k, v in stats["calls"].items()},
            "collective_bytes_per_substep": {k: v / steps for k, v in stats["bytes"].items()},
            "staged_bytes_per_substep": stats["staged_bytes"] / steps,
            "ranks_share_card": cuda and world > torch.cuda.device_count(),
            "card": card,
            "host_cpu": host_cpu(),
            # the grown tables: (density_sub16, force_sub16, force_sub8),
            # force_query_rows, the capacities and tier2_frac
            "tables": ranks[0]["tables"],
            "config": ranks[0]["config"],
        },
    }


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    cfg = config_from_args(args)

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    try:
        dev = configure_device(args.device)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"bench_torch: {e}; pass --device cpu for a run on the CPU")

    def log(msg):
        if not args.json_only:
            print(msg, file=sys.stderr, flush=True)

    n = args.n or (N_CARD if dev.type == "cuda" else N_CPU)
    if args.mesh:
        record, ranks = bench_mesh(n, args.steps, args.warmup, args.fluid, args.scene, dev,
                                   cfg, args.mesh, args.exchange, args.halo_max,
                                   args.halo_hops, log=log)
        if record["detail"]["timed_flags"]:
            log(f"WARNING: flags {record['detail']['timed_flags']} raised during the "
                "timed run")
        log(f"warm-up: {ranks[0]['warm_s']:.1f}s on rank 0")
        print(json.dumps(record))
        return 0
    params = build_params(n, args.fluid)
    scene = None
    if args.scene != "none":
        scene = collisions.build_device_scene(
            Scene.load(args.scene + ".obj", params.h * 2, scenes_dir=os.path.join(ROOT, "scenes")),
            dev)
    engine = SPHSimulation(cfg, device=dev, pretune=False)
    log(f"device={dev} n={n} impl={args.impl} scene={args.scene}")

    t0 = time.perf_counter()
    state, dt = warm_up(init_state(params, dev), params, scene, engine, args.warmup,
                        window=args.steps)
    sync(dev)
    log(f"warm-up: {time.perf_counter() - t0:.1f}s, config {engine.step_config}")

    host = {}
    state, dt, elapsed, flags = timed_run(state, dt, params, scene, engine.step_config,
                                          args.steps, host)
    if int(flags):
        log(f"WARNING: flags {int(flags)} raised during the timed run")
    card = card_line() if dev.type == "cuda" else None
    print(json.dumps(bench_result(n, args.steps, elapsed, flags, dt, args.fluid, args.impl,
                                  args.scene, dev, engine.step_config, card, host["reads"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
