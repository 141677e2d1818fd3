#!/usr/bin/env python3
"""Smoke run of libclsph-tpu's PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases (each prints its own numbers; any failure raises and exits
non-zero):

0. the card: ``nvidia-smi`` name and power limit, the torch device name;
1. build the CUDA kernels from ``libclsph_tpu_torch/csrc/`` (seconds);
2. each kernel against its plain PyTorch version on main-path tables
   built by the port's candidate machinery: the 65,536-particle cube
   lattice (``simulation_properties/bench64k.json``), the same after 10
   substeps of fall, and the 1M cube lattice. Density rtol 1e-5, hit
   counts equal, acceleration atol 1e-5 * max|a|; kernel and plain times
   (CUDA events, median of 7);
3. the CLI main path: ``sph-torch water default cube`` at 64,000
   particles for 3 frames, checking the .geo frames, that no particle
   left the fluid's column above the cube obstacle, and the densities;
4. the 1M-particle cube dam-break the way ``bench.py`` runs it: warm-up
   with the engine's capacity growth, then 20 timed substeps that must
   raise no flag (a flagged window grows the table and is re-run, as the
   engine re-runs a frame); ms/substep and particle-steps/s.

The line before last holds the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``. Needs one CUDA device; refuses to run
without one. ``--profile DIR`` adds a torch.profiler table of four 1M
substeps to DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_BENCH = 1_000_000
TIMED_STEPS = 20
WARMUP_STEPS = 3
REPS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def water_params(n: int):
    """The 64k bench configuration (simulation_properties/bench64k.json)
    with water, at ``n`` particles (bench.py builds its 1M cube so)."""
    from libclsph_tpu_torch.core.params import derive_parameters

    fluid = json.load(open(os.path.join(ROOT, "fluid_properties", "water.json")))
    sim = json.load(open(os.path.join(ROOT, "simulation_properties", "bench64k.json")))
    return derive_parameters(fluid, dict(sim, particles_count=n))


def main_path_tables(state, params, engine):
    """The kernels' inputs on the main path for ``state``: padded and
    sorted, candidate tables (capacities grown by the engine's rules
    until nothing is truncated), and, from the plain density, the hit
    lists and force fields."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.interactions import tait_pressure
    from libclsph_tpu_torch.ops.kernels import density, forces

    st, real, _ = step.pad_and_sort(state, params, True)
    for _ in range(6):
        cfg = engine.step_config
        cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
        pos4 = density.pos_pack(st.position, real)
        dens, hits = density.density_c16_hit8_torch(pos4, cand_sub, count_sub, params)
        cand8, count8, hflags = step.hit_lists(cand_sub, hits, cfg)
        if not engine._needs_rerun(flags | hflags):
            break
    else:
        raise RuntimeError("capacity growth did not converge on the test tables")
    pres = torch.where(real, tait_pressure(dens, params), 0.0)
    f8 = forces.force_pack(st.position, st.velocity, dens, pres, real,
                           params.particle_mass)
    return dict(density_args=(pos4, cand_sub, count_sub, params),
                force_args=(f8, dens, real, cand8, count8, params),
                dens_plain=dens, hits_plain=hits)


def compare_kernels(tag, t, stats, time_it):
    """Kernel vs plain on one set of tables; records the worst errors."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density, forces

    d, hits = density.density_c16_hit8(*t["density_args"])
    torch.cuda.synchronize()
    d0, hits0 = t["dens_plain"], t["hits_plain"]
    derr = float((d - d0).abs().max())
    drel = float(((d - d0).abs() / d0.abs()).max())
    hit_diff = int((hits != hits0).sum())
    if drel > 1e-5 or hit_diff:
        raise RuntimeError(f"{tag}: density rel err {drel:.3g}, {hit_diff} hit counts differ")
    a = forces.forces_q32_c8(*t["force_args"])
    a0 = forces.forces_q32_c8_torch(*t["force_args"])
    torch.cuda.synchronize()
    aerr = float((a - a0).abs().max())
    amax = float(a0.abs().max())
    if not aerr <= 1e-5 * amax:
        raise RuntimeError(f"{tag}: accel err {aerr:.3g} > 1e-5 * {amax:.3g}")
    s = stats["density_c16_hit8"]
    s["max_abs_err"] = max(s.get("max_abs_err", 0.0), derr)
    s = stats["forces_q32_c8"]
    s["max_abs_err"] = max(s.get("max_abs_err", 0.0), aerr)
    line = (f"phase 2 {tag}: density max_abs_err {derr:.6g} (rel {drel:.3g}), "
            f"hits equal ({hits.numel()} counts, {int(hits.sum())} pairs); "
            f"accel max_abs_err {aerr:.6g} (max|a| {amax:.6g})")
    if time_it:
        times = {
            "density_c16_hit8": (
                cuda_ms(lambda: density.density_c16_hit8(*t["density_args"])),
                cuda_ms(lambda: density.density_c16_hit8_torch(*t["density_args"])),
            ),
            "forces_q32_c8": (
                cuda_ms(lambda: forces.forces_q32_c8(*t["force_args"])),
                cuda_ms(lambda: forces.forces_q32_c8_torch(*t["force_args"])),
            ),
        }
        for name, (ms, plain_ms) in times.items():
            stats[name].setdefault("times", {})[tag] = (ms, plain_ms)
            line += f"; {name} {ms:.4f} ms (plain {plain_ms:.4f} ms)"
    log(line)


def run_substeps(state, dt, params, scene, cfg, steps):
    """bench.py's schedule: sort and rebuild every sort_interval /
    cand_interval substeps, reuse the carried tables in between.
    Returns (state, dt, flags ORed)."""
    import torch

    from libclsph_tpu_torch.engine import step

    flags = torch.zeros((), dtype=torch.int32, device=state.device)
    tables = None
    for i in range(steps):
        if i % cfg.cand_interval == 0:
            state, dt, f, tables = step.substep(
                state, dt, params, scene, cfg, do_sort=i % cfg.sort_interval == 0
            )
        else:
            state, dt, f, _ = step.substep(state, dt, params, scene, cfg,
                                           do_sort=False, cand_in=tables)
        flags = flags | f
    return state, dt, flags


def run_with_growth(state, params, scene, engine, steps):
    """``steps`` substeps from ``state``, re-run from the start with the
    engine's capacity growth (SPHSimulation._needs_rerun) until no flag
    is raised. Returns (state, dt); ``engine.step_config`` holds the
    grown capacities."""
    import torch

    dt0 = torch.tensor(params.max_dt, dtype=torch.float32, device=state.device)
    for _ in range(6):
        st, dt, flags = run_substeps(state, dt0, params, scene, engine.step_config, steps)
        if not engine._needs_rerun(flags):
            return st, dt
        log(f"  flags {int(flags)} -> grown to {engine.step_config}")
    raise RuntimeError("capacity growth did not converge")


def phase3_cli(tmp):
    """sph-torch water default cube <tmp>/out_ at 64,000 particles."""
    import numpy as np

    from libclsph_tpu_torch import cli

    root = os.path.join(tmp, "root")
    for d in ("fluid_properties", "simulation_properties", "scenes"):
        os.makedirs(os.path.join(root, d))
    shutil.copy(os.path.join(ROOT, "fluid_properties", "water.json"),
                os.path.join(root, "fluid_properties"))
    shutil.copy(os.path.join(ROOT, "scenes", "cube.obj"), os.path.join(root, "scenes"))
    sim = json.load(open(os.path.join(ROOT, "simulation_properties", "default.json")))
    frames = 3
    sim["simulation_time"] = frames / sim["target_fps"]
    sim["serialize"] = True  # the checkpoint carries the densities checked below
    json.dump(sim, open(os.path.join(root, "simulation_properties", "default.json"), "w"))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["water", "default", "cube", os.path.join(tmp, "out_"),
                       "--root", root])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"sph-torch exited {rc}")
    out = os.path.join(tmp, "out_frames")
    names = sorted(os.listdir(out))
    if len(names) != frames + 1:
        raise RuntimeError(f"expected {frames + 1} frames, found {names}")
    for name in names:
        with open(os.path.join(out, name)) as f:
            head = [f.readline().strip() for _ in range(2)]
        if head[0] != "PGEOMETRY V5" or not head[1].startswith("NPoints 64000 "):
            raise RuntimeError(f"{name}: bad header {head}")
    rho0 = json.load(open(os.path.join(ROOT, "fluid_properties", "water.json")))[
        "fluid_density"]
    ck = np.load(os.path.join(tmp, "last_frame.npz"))
    pos, dens = ck["position"], ck["density"]
    if not (np.isfinite(pos).all() and np.isfinite(dens).all()):
        raise RuntimeError("non-finite state after the CLI run")
    # the fluid starts as a lattice cube of side cbrt(V) centred in x/z
    # above scenes/cube.obj (x, z in [-0.5, 0.5], y in [-1.5, -0.5]);
    # in 3 frames nothing may leave that column by more than 5 cm or
    # fall through the obstacle's bottom (the |x|,|z| < 0.7 bound of the
    # 2048-particle check does not hold for the 64k lattice, whose
    # half-width is 0.735 at t = 0)
    half = 0.5 * (sim["particles_count"] * sim["particle_mass"] / rho0) ** (1.0 / 3.0)
    ymin, xzmax = float(pos[:, 1].min()), float(np.abs(pos[:, [0, 2]]).max())
    if not (ymin > -1.6 and xzmax < half + 0.05):
        raise RuntimeError(f"particles left the column: min y {ymin}, max |x|,|z| {xzmax}")
    med = float(np.median(dens))
    if not (0.5 * rho0 < med < 2.0 * rho0 and float(dens.max()) < 10 * rho0):
        raise RuntimeError(f"densities off: median {med}, max {float(dens.max())}")
    log(f"phase 3 cli: {len(names)} frames of 64000 points in {seconds:.2f} s "
        f"(scene bake, 3 frames and export included); min y {ymin:.4f}, "
        f"max |x|,|z| {xzmax:.4f} (bound {half + 0.05:.4f}); "
        f"density median {med:.2f} max {float(dens.max()):.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler table of four 1M substeps to DIR")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.ops.kernels import build, density, forces
    from libclsph_tpu_torch.scene.scene import Scene

    dev = configure_device("cuda")
    # phase 0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 0 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {kind}; count {torch.cuda.device_count()}")

    # phase 1
    t0 = time.perf_counter()
    fresh = not build.library_path().exists()
    lib_path = build.build()
    build.load_library()
    log(f"phase 1 build: {'compiled' if fresh else 'found'} "
        f"{os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 2
    stats = {"density_c16_hit8": {}, "forces_q32_c8": {}}
    cfg = step.StepConfig()
    p64 = water_params(65536)
    scene64 = collisions.build_device_scene(
        Scene.load("cube.obj", p64.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes")), dev)
    s64 = init_state(p64, dev)
    engine64 = SPHSimulation(cfg, device=dev)  # the engine's capacity growth
    compare_kernels("64k lattice", main_path_tables(s64, p64, engine64), stats, True)
    s64, _ = run_with_growth(s64, p64, scene64, engine64, 10)
    compare_kernels("64k after 10 substeps", main_path_tables(s64, p64, engine64),
                    stats, True)
    p1m = water_params(N_BENCH)
    s1m = init_state(p1m, dev)
    engine = SPHSimulation(cfg, device=dev)
    compare_kernels("1M lattice", main_path_tables(s1m, p1m, engine), stats, True)
    del s64

    # phases 3 and 4 drive the main path; count the kernels' launches there
    density.density_c16_hit8.launches = 0
    forces.forces_q32_c8.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        phase3_cli(tmp)
    cli_launches = (density.density_c16_hit8.launches, forces.forces_q32_c8.launches)
    if min(cli_launches) <= 0:
        raise RuntimeError(f"CLI run launched the kernels {cli_launches} times")

    # phase 4: bench.py's 1M cube dam-break
    scene1m = collisions.build_device_scene(
        Scene.load("cube.obj", p1m.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes")), dev)
    t0 = time.perf_counter()
    st, dt = run_with_growth(s1m, p1m, scene1m, engine, WARMUP_STEPS)
    torch.cuda.synchronize()
    log(f"phase 4 warm-up: {time.perf_counter() - t0:.2f} s")
    # a flag in the timed window grows the flagged table and re-runs the
    # window from the warm-up state, as the engine re-runs a frame; the
    # number stands only for a window that raised no flag
    for _ in range(6):
        bench_before = (density.density_c16_hit8.launches, forces.forces_q32_c8.launches)
        t0 = time.perf_counter()
        st_t, dt_t, timed_flags = run_substeps(st, dt, p1m, scene1m, engine.step_config,
                                               TIMED_STEPS)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        if not engine._needs_rerun(timed_flags):
            break
        log(f"phase 4 timed window raised flags {int(timed_flags)} -> grown to "
            f"{engine.step_config}; re-running it")
    else:
        raise RuntimeError("timed window kept raising capacity flags")
    st, dt = st_t, dt_t
    bench_launches = (density.density_c16_hit8.launches - bench_before[0],
                      forces.forces_q32_c8.launches - bench_before[1])
    if min(bench_launches) < TIMED_STEPS:
        raise RuntimeError(f"timed run launched the kernels {bench_launches} times")
    if not (torch.isfinite(st.position).all() and torch.isfinite(st.density).all()):
        raise RuntimeError("non-finite state in the 1M run")
    ms = 1000.0 * elapsed / TIMED_STEPS
    log(f"phase 4 bench: {N_BENCH} particles, {TIMED_STEPS} substeps, "
        f"{ms:.3f} ms/substep, {N_BENCH * TIMED_STEPS / elapsed:.6g} particle-steps/s, "
        f"timed_flags 0, final dt {float(dt):.6g}, config {engine.step_config}; "
        f"card {card}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_substeps(st, dt, p1m, scene1m, engine.step_config, 4)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_1m.txt"), "w") as f:
            f.write(f"card {card}\n{table}\n")
        log(f"profile: {os.path.join(args.profile, 'profile_1m.txt')}")

    launches = {
        "density_c16_hit8": density.density_c16_hit8.launches,
        "forces_q32_c8": forces.forces_q32_c8.launches,
    }
    sources = {
        "density_c16_hit8": ("libclsph_tpu_torch/csrc/density_c16_hit8.cu",
                             "libclsph_tpu/ops/pallas/neighbor_nl.py:394"),
        "forces_q32_c8": ("libclsph_tpu_torch/csrc/forces_q32_c8.cu",
                          "libclsph_tpu/ops/pallas/neighbor_nl.py:1768"),
    }
    record = []
    for name, (src, replaces) in sources.items():
        ms_k, ms_p = stats[name]["times"]["1M lattice"]
        record.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                           launches=launches[name],
                           max_abs_err=stats[name]["max_abs_err"],
                           ms=ms_k, plain_ms=ms_p))
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
