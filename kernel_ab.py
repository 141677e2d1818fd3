#!/usr/bin/env python3
"""The density and force kernels of the port, timed in turns against
another build of the same C interface, on one NVIDIA GPU.

    python3 kernel_ab.py --base DIR [--variant NAME=DIR ...] [--out DIR] [--sass]
                         [--sort-tree TREE] [--only stream]
    python3 kernel_ab.py --only advect [--out DIR]
    python3 kernel_ab.py --only refine [--out DIR]

``DIR`` holds another tree of ``libclsph_tpu_torch/csrc/`` sources (for
example an earlier commit's, unpacked under ``build/``). Each tree is
compiled with the package's ``nvcc`` flags into ``build/kernel_ab/``
and loaded in place of the package's library while its turn runs.

First the stream kernels (``gather_stream`` in both layouts, every mode
of ``forces_c32_stream``) on the stream probes' lists, the 1M cube after
three substeps (the bisect's hit lists and the variants probe's aabb
lists): bits against the base build and the plain versions, then times
in turns (:func:`stream_ab`; ``--only stream`` stops there). Then the
advection kernel at 64k and 1M against its plain chain, which no base
build has (:func:`advect_ab`; ``--only advect`` runs it alone, with no
base), and the exact refine's kernel at 64k and 1M against its plain
path, which no base build has either (:func:`refine_ab`; ``--only
refine`` runs it alone, with no base).

On the tables of the 1M cube lattice (those of ``chip_smoke.py``'s phase
2: the main path's, the 16-wide force path's, the q-granular ones, the
asm variant's and the row variant's block table expanded to 32-wide
subblocks, and ``density_gated16``'s carried table and mask three reuse
substeps after a gated build) every case is first run once per library
and held against the base build (densities, hit and tile counts bit for
bit; accelerations by their largest difference and the share of equal
bits) and against its plain PyTorch version (chip_smoke's tolerances).
``forces_q128_c32`` runs on the q128 lists, asm's lists and the block
table; the fine case runs the package's route (``forces_q128_c32`` over
the block table) against the base build's ``forces_q32_c32`` over the
table repeated per subgroup. The finer query blocks' modes (64- and
32-row lists of the nl and asm tables at ``nl_query_rows`` 64 and 32)
have no counterpart in earlier builds: their densities run on the
package (and variants) only, and their forces against the base build's
``forces_q32_c32`` over each list repeated for its 32-row subgroups,
which gives the same bits. Then each case is timed in turns (base,
package, variants, variants, package, base): CUDA events (median of 7
calls; the window also holds the wrapper's host work) and the kernel's
device time from torch.profiler (mean of 5 calls); ``density_gated16``
has the ungated ``density_c16`` at hit_sub 16 on the same inputs timed
beside it in each turn. ptxas's register and spill report of every
build is printed; ``--sass`` also writes each library's SASS
(``cuobjdump -sass``) into the out dir. The tables' statistics are
printed first: the (subgroup, 8 candidates) panels that hold a pair
within h and that pass the kernels' box test, on the density tables and
on the q128 and asm force lists (the block table is both a density and
a force list); on the gated inputs also the live tiles whose
mask nibble is 0, the panels the mask flags and those that pass both
mask and box; and on the q32 force lists the pairs inside the support
against what the per-lane bit walk of ``forces_q32`` pays a warp at
rounds of 32, 64 and 128 candidates. Last, the row variant's substep
on the 1M cube (20 substeps from one warm state, host clock, ending in a
synchronize) is timed with each library in three rounds of the same
turns: the end-to-end effect of the block variants' kernels.

The last line is one JSON object with every number; it is also written
to ``OUT/kernel_ab.json`` (default ``build/kernel_ab/``). Needs a CUDA device
and exits 2 without one.

The radix sort's C interface is not the one of earlier trees, so
``--sort-tree TREE`` (a whole checkout, for example the parent commit's
``git archive`` unpacked under ``build/``) times that tree's sort in a
process of its own, in turns with the package's and ``torch.sort``, on
``chip_smoke.py``'s sort keys (1M and 4M, lattice Morton codes and
uniform random 30-bit keys).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import bench_torch
import chip_smoke as cs
from kernel_bounds import refine_exact_work

ROOT = Path(__file__).resolve().parent
AB_BUILD = ROOT / "build" / "kernel_ab"
PROFILE_CALLS = 5
ROW_SUBSTEPS = 20  # substeps a timed window of row_substeps
ROW_ROUNDS = 3  # rounds of (base, package, variants, variants, package, base)
# cases with no base-build counterpart, timed on the package and variants only
PACKAGE_ONLY = set()
# the profiler's name of forces_q128_c32's kernel in every build
# (forces_q128_c32_kernel before the rows template, forces_rows_c32_kernel<128>)
Q128_KEY = "c32_kernel"


def device_ms(fn, kernel: str) -> float:
    """Device time (ms) of one call of ``fn``: the summed self device time
    of the kernels whose name holds ``kernel`` over PROFILE_CALLS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if kernel in e.key)
    return total / PROFILE_CALLS / 1e3 if total > 0 else float("nan")


def ptxas_report(lib: Path) -> list[str]:
    log = lib.with_suffix(".log").read_text().splitlines()
    return [ln.strip() for ln in log
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def build_all(trees: dict) -> dict:
    from libclsph_tpu_torch.ops.kernels import build

    libs = {"package": build.load_library()}
    paths = {"package": build.library_path()}
    for name, src in trees.items():
        paths[name] = build.build(Path(src), AB_BUILD / name)
        libs[name] = build.open_library(paths[name])
    return libs, paths


def cases_1m(dev, libs):
    """The tables' statistics (:func:`panel_stats`, :func:`lane_stats`)
    and the cases (name, profiler key, call, plain call, work, kind,
    beside) on the 1M lattice's tables; kind is "density", or for a force
    case a function that describes the rows of an acceleration that
    differ; beside is None or (label, profiler key, call): another call
    timed in the same turns."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.ops.kernels import build, density, forces

    def engine(**over):
        return SPHSimulation(step.StepConfig(**over), device=dev, pretune=False)

    params = cs.water_params(cs.N_BENCH)
    state = init_state(params, dev)
    tm = cs.main_path_tables(state, params, engine())
    e16 = engine(**cs.SUB16)
    t16 = cs.sub16_tables(state, params, e16, 16)
    dg, moved = cs.gated_inputs("kernel_ab", state, params, cs.cube_scene(params, dev), e16)
    tq = cs.q_path_tables(state, params, engine(**cs.Q_PATH))
    tb = cs.block_tables(state, params, engine(pallas_variant="row", cand_interval=1))
    ta = cs.asm_tables(state, params, engine(pallas_variant="asm", cand_interval=1,
                                             **cs.Q_PATH))
    trows = {rows: cs.rows_tables(state, params, engine(**cs.Q_PATH_ROWS, nl_query_rows=rows))
             for rows in (64, 32)}
    tasm32 = cs.rows_tables(state, params, engine(**cs.Q_PATH_ROWS, pallas_variant="asm",
                                                  nl_query_rows=32))
    tfull = cs.rows_tables(state, params, engine(**cs.Q_PATH_ROWS, nl_query_rows=32,
                                                 hit_compact=False), compact=False)
    del state
    torch.cuda.empty_cache()
    hit2_h = params.h * 1.25
    da, d16 = tm["density_args"], t16["density_args"]
    fm, f16 = tm["force_args"], t16["force_args"]
    fq = (tq["f8"], tq["dens_plain"], tq["real"])
    q32 = fq + tq["q32"] + (params,)
    q128 = fq + tq["q128"] + (params,)
    blk = (tb["f8"], tb["dens"], tb["real"], tb["ids"], tb["counts"], params)
    fine = blk[:3] + (tb["ids"].repeat_interleave(4, dim=0),
                      tb["counts"].repeat_interleave(4), params)
    fasm = ta["force_args"]
    pairs_m = int(tm["hits_plain"].sum())
    pairs_16 = int(t16["hits_plain"].sum())
    pairs_q = int(tq["hits4"].sum())

    def dens(args, **kw):
        return (lambda: density.density_c16(*args, **kw),
                lambda: density.density_c16_torch(*args, **kw))

    def dens32(args, pairs, groups, hit_sub=32):
        """density_c32 on 32-wide tables (groups 0: densities only)."""
        def call():
            return density.density_c32(*args, groups=groups, hit_sub=hit_sub)

        def plain():
            return density.density_c32_torch(*args, groups=groups, hit_sub=hit_sub)
        return call, plain, cs.density_work(args, plain(), pairs)

    def force(name, args):
        return (lambda: getattr(forces, name)(*args),
                lambda: getattr(forces, name + "_torch")(*args))

    def fine_route():
        """forces_blocks fine: forces_q128_c32 over the block table; the
        base build's route, forces_q32_c32 over the table repeated for the
        four subgroups (both plain versions give the same bits)."""
        def call():
            if build._library is libs["base"]:
                return forces.forces_q32_c32(*fine)
            return forces.forces_q128_c32(*blk)
        return call, lambda: forces.forces_q128_c32_torch(*blk)

    def rows_info(args):
        """For rows of an acceleration that differ: the query's position,
        whether it is real, and how many other particles lie within the
        spiky guard (1e-7) and within h."""
        f8, real = args[0], args[2]

        def info(rows):
            out = []
            for o in rows:
                d = (f8[:, :3] - f8[o, :3]).norm(dim=1)
                out.append(dict(row=o, pos=f8[o, :3].tolist(), real=bool(real[o]),
                                near0=int((d < 1e-7).sum()) - 1,
                                within_h=int((d < params.h).sum())))
            return out
        return info

    def rows_density(t):
        args, rows, groups = t["density_args"], t["rows"], t["groups"]

        def call():
            return density.density_c32(*args, groups=groups, rows=rows)

        def plain():
            return density.density_c32_torch(*args, groups=groups, rows=rows)
        return call, plain, cs.density_work(args, plain(), t["pairs_in"])

    def rows_force(t):
        """forces_q128_c32 at the table's rows; the base build's route,
        forces_q32_c32 over each list repeated for its 32-row subgroups
        (the same bits)."""
        fa, rows = t["force_args"], t["rows"]
        rep_ = rows // 32
        q32 = fa[:3] + (fa[3].repeat_interleave(rep_, dim=0).contiguous(),
                        fa[4].repeat_interleave(rep_).contiguous(), fa[5])

        def call():
            if build._library is libs["base"]:
                return forces.forces_q32_c32(*q32)
            return forces.forces_q128_c32(*fa, rows=rows)
        return (call, lambda: forces.forces_q128_c32_torch(*fa, rows=rows),
                cs.force_work(fa, rows, t["pairs_in"]), rows_info(fa))

    def dwork(args, **kw):
        outs = density.density_c16_torch(*args, **kw)
        return cs.density_work(args, outs, int(outs[1].sum()),
                               int(outs[2].sum()) if "hit2_h" in kw else 0)

    dq, dasm = tq["density_args"], ta["density_args"]
    dblk = (tb["pos4"], tb["ids"], tb["counts"], params)
    stats = dict(density_panels=panel_stats(*da[:3], params, 16),
                 density_panels_q32=panel_stats(*dq[:3], params, 32),
                 density_panels_asm=panel_stats(*dasm[:3], params, 32),
                 density_panels_blocks=panel_stats(*dblk[:3], params, 32),
                 gated_panels=dict(panel_stats(*dg[:3], params, 16, mask=dg[3]),
                                   largest_move_h=moved),
                 force_panels_q128=panel_stats(dq[0], *tq["q128"], params, 32),
                 force_panels_asm=panel_stats(dasm[0], *fasm[3:5], params, 32),
                 lanes_c8=lane_stats(fm, 8), lanes_c16=lane_stats(f16, 16),
                 lanes_c32=lane_stats(q32, 32))
    pairs_g = int(density.density_c16_torch(*dg[:3], params, hit_sub=16)[1].sum())
    rows_cases = [
        ("density_c32 groups 1, rows 64 (row 1f)", "density_", *rows_density(trows[64]),
         "density"),
        ("density_c32 groups 1, rows 32 (row 1g)", "density_", *rows_density(trows[32]),
         "density"),
        ("density_c32 densities only, rows 32, full lists (row 1h)", "density_",
         *rows_density(tfull), "density"),
        ("density_c32 groups 1, rows 32, asm tables (row 7a)", "density_",
         *rows_density(tasm32), "density"),
        ("forces_q128_c32 rows 64; base forces_q32_c32 over the lists repeated (row 5a)",
         "forces_", *rows_force(trows[64])),
        ("forces_q128_c32 rows 32; base forces_q32_c32 over the same lists (row 5b)",
         "forces_", *rows_force(trows[32])),
        ("forces_q128_c32 rows 32, asm tables; base forces_q32_c32 (row 7a)", "forces_",
         *rows_force(tasm32)),
    ]
    PACKAGE_ONLY.update(c[0] for c in rows_cases if c[0].startswith("density"))
    return stats, rows_cases + [
        ("density_c16 hit_sub 8 (row 1)", "density_", *dens(da), dwork(da), "density"),
        ("density_c16 hit_sub 16 (row 1a)", "density_", *dens(d16, hit_sub=16),
         dwork(d16, hit_sub=16), "density"),
        ("density_c16 hit_sub 16, hit2_h (row 1b)", "density_",
         *dens(d16, hit_sub=16, hit2_h=hit2_h), dwork(d16, hit_sub=16, hit2_h=hit2_h),
         "density"),
        ("density_c32 groups 4 (row 1c)", "density_", *dens32(dq, pairs_q, 4), "density"),
        ("density_c32 groups 1 (row 1d)", "density_", *dens32(dq, pairs_q, 1), "density"),
        ("density_c32 hit_sub 16 (row 1e)", "density_", *dens32(dq, pairs_q, 4, 16),
         "density"),
        ("density_c32 groups 1, asm tables (row 7)", "density_",
         *dens32(dasm, ta["pairs_in"], 1), "density"),
        ("density_blocks: density_c32 densities only, block table (row 8)", "density_",
         *dens32(dblk, tb["pairs_in"], 0), "density"),
        ("forces_q32_c8 (row 2)", "forces_q32_kernel", *force("forces_q32_c8", fm),
         cs.force_work(fm, 32, pairs_m), rows_info(fm)),
        ("forces_q32_c16 (row 6)", "forces_q32_kernel", *force("forces_q32_c16", f16),
         cs.force_work(f16, 32, pairs_16), rows_info(f16)),
        ("forces_q32_c32 (row 4)", "forces_q32_kernel", *force("forces_q32_c32", q32),
         cs.force_work(q32, 32, pairs_q), rows_info(q32)),
        ("forces_q128_c32 (row 5)", Q128_KEY, *force("forces_q128_c32", q128),
         cs.force_work(q128, 128, pairs_q), rows_info(q128)),
        ("forces_q128_c32, asm tables (row 7)", Q128_KEY,
         *force("forces_q128_c32", fasm), cs.force_work(fasm, 128, ta["pairs_in"]),
         rows_info(fasm)),
        ("forces_blocks row: forces_q128_c32, block table (row 8a)", Q128_KEY,
         *force("forces_q128_c32", blk), cs.force_work(blk, 128, tb["pairs_in"]),
         rows_info(blk)),
        ("forces_blocks fine: forces_q128_c32, block table; base forces_q32_c32 over "
         "the repeated list (row 8a)", "forces_", *fine_route(),
         cs.force_work(blk, 128, tb["pairs_in"]), rows_info(blk)),
        ("density_gated16, three reuse substeps after a gated build (row 3)", "density_",
         lambda: density.density_gated16(*dg), lambda: density.density_gated16_torch(*dg),
         cs.density_work(dg, (dg[3],) + density.density_gated16_torch(*dg), pairs_g),
         "density", ("density_c16 hit_sub 16 on the same inputs", "density_",
                     lambda: density.density_c16(*dg[:3], params, hit_sub=16))),
    ]


ADVECT_SIZES = (65_536, 1_000_000)  # particles of the advection kernel's cases
ADVECT_WARMUP = 3  # substeps into the dam-break of its inputs


def advect_ab(dev) -> list:
    """The advection kernel (``ops/kernels/advect.py``) alone at 64k and
    1M particles, on the cube ADVECT_WARMUP substeps into the dam-break
    (``bench_torch.warm_up``): its advance bit for bit against the plain
    chain's, then the two timed in turns (kernel, plain, plain, kernel),
    by CUDA events (the window also holds the host's launch work, about
    280 launches for the chain) and by profiler device time (the chain's
    summed over its launches), with the kernel's bound by bytes
    (``kernel_bounds.advect_work``). No earlier build has the kernel: the
    chain is what the parent runs for the stage. Returns the records."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.ops.kernels import advect

    records = []
    for n in ADVECT_SIZES:
        params = cs.water_params(n)
        scene = cs.cube_scene(params, dev)
        engine = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
        st, dt = bench_torch.warm_up(init_state(params, dev), params, scene, engine,
                                     ADVECT_WARMUP)
        args, work, in_box, colliding = cs.advect_case(st, dt, params, scene)
        cs.check_advect(f"advect_collide at {n}", args)
        calls = {"kernel": (lambda: advect.advect_collide(*args), "advect_collide"),
                 "plain": (lambda: advect.advect_collide_torch(*args), "")}
        seq = [(name, cs.cuda_ms(calls[name][0]), device_ms(*calls[name]))
               for name in ("kernel", "plain", "plain", "kernel")]
        rec = dict(name="advect_collide", n=n, in_box=in_box, colliding=colliding,
                   bytes=work[0], ops=work[1], bit_equal_plain=True, turns=seq)
        rec["bound_ms"], rec["bound_by"] = cs.bound(*work)
        for name in calls:
            rec[name + "_ms"] = statistics.mean(t for k, t, _ in seq if k == name)
            rec[name + "_device_ms"] = statistics.mean(d for k, _, d in seq if k == name)
        rec["share_device"] = rec["bound_ms"] / rec["kernel_device_ms"]
        print(f"advect_collide at {n} particles ({in_box} in a face box, {colliding} "
              f"colliding): bit for bit against the plain chain; kernel "
              f"{rec['kernel_ms']:.4f} ms, device {rec['kernel_device_ms']:.4f}; plain chain "
              f"{rec['plain_ms']:.4f} ms, device {rec['plain_device_ms']:.4f}; bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"({100 * rec['share_device']:.1f} % of the kernel's device time); turns {seq}",
              flush=True)
        records.append(rec)
        del st, args, engine
        torch.cuda.empty_cache()
    return records


def refine_ab(dev) -> list:
    """The exact refine's kernel (``ops/kernels/refine.py``) alone at 64k
    and 1M particles, on the cube ADVECT_WARMUP substeps into the
    dam-break with the engine's grown capacities, on the inputs of a
    rebuild (``chip_smoke.refine_case``): its keys and counts id for id
    against the plain path's, and the sorted tables of the engine's stage
    (``refine.refine_candidates_exact``) against the plain path's
    (``tiles.refine_candidates_exact``); then both timed in turns (kernel,
    plain, plain, kernel), the keys alone and the whole stage with its row
    sort, by CUDA events and by profiler device time (the plain path's
    summed over its launches), with the kernel's bound
    (``kernel_bounds.refine_exact_work``). Returns the records."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.ops import tiles
    from libclsph_tpu_torch.ops.kernels import refine

    records = []
    for n in ADVECT_SIZES:
        params = cs.water_params(n)
        scene = cs.cube_scene(params, dev)
        engine = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
        st, _ = bench_torch.warm_up(init_state(params, dev), params, scene, engine,
                                    ADVECT_WARMUP)
        args, cap, self_lo = cs.refine_case(st, params, engine.step_config)
        sub = args[6]

        calls = {
            "kernel": (lambda: refine.refine_exact_keys(*args), "refine_exact"),
            "plain": (lambda: refine.refine_exact_keys_torch(*args), ""),
            "stage": (lambda: refine.refine_candidates_exact(*args, cap, self_lo=self_lo,
                                                             self_width=sub), ""),
            "plain_stage": (lambda: tiles.refine_candidates_exact(
                *args, cap, self_lo=self_lo, self_width=sub), ""),
        }
        for got_fn, want_fn in (("kernel", "plain"), ("stage", "plain_stage")):
            got, want = calls[got_fn][0](), calls[want_fn][0]()
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise RuntimeError(f"refine_exact at {n}: {got_fn} differs from "
                                       f"{want_fn} in {int((g != w).sum())} of {w.numel()}")
        keys, count_sub = calls["plain"][0]()
        live = int(torch.clamp(args[1], 0, args[0].shape[1]).sum())
        work = refine_exact_work(*args[:5], sub, live)
        seq = [(name, cs.cuda_ms(calls[name][0]), device_ms(*calls[name]))
               for pair in (("kernel", "plain"), ("stage", "plain_stage"))
               for name in pair + pair[::-1]]
        rec = dict(name="refine_exact", n=n, rows=args[0].shape[0], m=args[0].shape[1],
                   sub=sub, cap=cap, live_slots=live, survivors=int(count_sub.sum()),
                   overflow=bool((count_sub > cap).any()), bytes=work[0], ops=work[1],
                   bit_equal_plain=True, turns=seq)
        rec["bound_ms"], rec["bound_by"] = cs.bound(*work)
        for name in calls:
            rec[name + "_ms"] = statistics.mean(t for k, t, _ in seq if k == name)
            rec[name + "_device_ms"] = statistics.mean(d for k, _, d in seq if k == name)
        rec["share_device"] = rec["bound_ms"] / rec["kernel_device_ms"]
        print(f"refine_exact at {n} particles ({rec['rows']} rows of {rec['m']} slots, "
              f"{live} live, {rec['survivors']} subblocks kept): id for id against the "
              f"plain path; kernel {rec['kernel_ms']:.4f} ms, device "
              f"{rec['kernel_device_ms']:.4f}; plain {rec['plain_ms']:.4f} ms, device "
              f"{rec['plain_device_ms']:.4f}; the stage with its sort {rec['stage_ms']:.4f} "
              f"ms, device {rec['stage_device_ms']:.4f} (plain {rec['plain_stage_ms']:.4f}, "
              f"device {rec['plain_stage_device_ms']:.4f}); bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']} ({100 * rec['share_device']:.1f} % of the kernel's device "
              f"time); turns {seq}", flush=True)
        records.append(rec)
        del st, args, keys, count_sub, engine
        torch.cuda.empty_cache()
    return records


STREAM_KEYS = {"gather": "gather_stream", "forces": "forces_stream"}
# the stream probes' lists: the bisect's hit-compacted q128 lists and the
# variants probe's aabb lists at 192 slots, not compacted
STREAM_LISTS = {"bisect": {}, "variants": dict(refine="aabb", max_sub=192, compact=False)}


def stream_ab(dev, run_with, order) -> list:
    """``gather_stream`` (both layouts) and every mode of
    ``forces_c32_stream`` on the stream probes' lists (the 1M cube after
    three substeps): each library's output held bit for bit against the
    base build's and against the plain version (streams bit for bit, sums
    ``stream.sums_error`` at 1e-5, the test counts exactly, accel within
    1e-5 of max|a| and bit for bit against ``forces_q128_c32`` on the same
    lists, the zero-count control all zeros), then timed in turns as the
    other cases are. Returns the records."""
    import torch

    sys.path.insert(0, str(ROOT / "experiments"))
    import torch_force_kernel_bisect as bisect

    import kernel_bounds
    from libclsph_tpu_torch.ops import kernels
    from libclsph_tpu_torch.ops.kernels import stream

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    records = []
    for lists, kw in STREAM_LISTS.items():
        s = bisect.setup(cs.N_BENCH, dev, **kw)
        f8, dens, real, params = s["f8"], s["dens"], s["real"], s["params"]
        cand, count, s_pos4 = s["cand_f"], s["count_f"], s["pos4"]
        del s
        visc = stream.stream_visc(params)
        live = int(count.sum()) * bisect.SUB
        streams = {layout: stream.gather_stream(f8, cand, count, bisect.SUB, visc, layout)
                   for layout in stream.LAYOUTS}
        pairs_in = int(stream.forces_c32_stream(f8, dens, real, streams["staged"], count,
                                                params, out="test").sum())
        work = kernel_bounds.stream_works(f8, dens, real, cand, count, live, pairs_in)
        fused = kernels.forces_q128_c32(f8, dens, real, cand, count, params)
        zero = torch.zeros_like(count)
        panels = panel_stats(s_pos4, cand, count, params, bisect.SUB)
        print(f"stream lists ({lists}): {live // bisect.SUB} live slots, {pairs_in} pairs "
              f"inside the support, (subgroup, run of 8) panels {json.dumps(panels)}",
              flush=True)

        def gather(layout):
            return lambda: stream.gather_stream(f8, cand, count, bisect.SUB, visc, layout)

        def plain_gather(layout):
            return lambda: stream.gather_stream_torch(f8, cand, count, bisect.SUB, visc, layout)

        def sums(layout="staged", cnt=count, **mode):
            return lambda: stream.forces_c32_stream(f8, dens, real, streams[layout], cnt,
                                                    params, layout=layout, **mode)

        def plain_sums(layout="staged", **mode):
            return lambda: stream.forces_c32_stream_torch(f8, dens, real, streams[layout],
                                                          count, params, layout=layout, **mode)

        cases = [("gather_stream", "gather", gather("staged"), plain_gather("staged"),
                  "stream"),
                 ("gather_stream planes", "gather", gather("planes"), plain_gather("planes"),
                  "stream"),
                 ("forces_c32_stream sums", "forces", sums(), plain_sums(), "sums"),
                 ("forces_c32_stream accel", "forces", sums(out="accel"),
                  plain_sums(out="accel"), "accel"),
                 ("forces_c32_stream planes", "forces", sums("planes"), plain_sums("planes"),
                  "sums"),
                 ("forces_c32_stream no cull", "forces", sums(cull=False),
                  plain_sums(cull=False), "sums"),
                 ("forces_c32_stream test", "forces", sums(out="test"),
                  plain_sums(out="test"), "exact"),
                 ("forces_c32_stream count=0", "forces", sums(cnt=zero), None, "zero")]
        for name, key, call, plain, kind in cases:
            outs = {lib: run_with(lib, call) for lib in ["base"] + order}
            ref = plain() if plain is not None else None
            rec = dict(name=f"{name} ({lists} lists)", lists=lists, bytes=work[name][0],
                       ops=work[name][1], checks={})
            rec["bound_ms"], rec["bound_by"] = kernel_bounds.bound(*work[name])
            for lib in order:
                got = outs[lib]
                check = dict(bit_equal_base=bool(torch.equal(bits(got), bits(outs["base"]))))
                if kind == "stream":
                    check["bit_equal_plain"] = bool(torch.equal(bits(got), bits(ref)))
                    ok = check["bit_equal_plain"]
                elif kind == "sums":
                    check["max_abs"], bad = stream.sums_error(got, ref)
                    ok = bad < 0
                elif kind == "accel":
                    check["max_abs"] = float((got - ref).abs().max())
                    check["bit_equal_forces_q128_c32"] = bool(torch.equal(bits(got),
                                                                          bits(fused)))
                    ok = (check["max_abs"] <= 1e-5 * float(ref.abs().max())
                          and check["bit_equal_forces_q128_c32"])
                elif kind == "exact":
                    ok = check["equal_plain"] = bool(torch.equal(got, ref))
                else:
                    ok = check["all_zero"] = not bool(got.any())
                if not ok:
                    raise RuntimeError(f"{rec['name']} {lib}: {check}")
                rec["checks"][lib] = check
            del outs, ref
            turns = ["base"] + order + order[::-1] + ["base"]
            seq = [(lib, run_with(lib, lambda: cs.cuda_ms(call)),
                    run_with(lib, lambda: device_ms(call, STREAM_KEYS[key]))) for lib in turns]
            rec["turns"] = seq
            rec["ms"] = {lib: statistics.mean(t for other, t, _ in seq if other == lib)
                         for lib in dict.fromkeys(turns)}
            rec["device_ms"] = {lib: statistics.mean(d for other, _, d in seq if other == lib)
                                for lib in dict.fromkeys(turns)}
            print(f"{rec['name']}: bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}; "
                  + "; ".join(f"{lib} {rec['ms'][lib]:.4f} ms, device {rec['device_ms'][lib]:.4f}"
                              for lib in rec["ms"]) + f"; {json.dumps(rec['checks'])}",
                  flush=True)
            rec["panels"] = panels
            records.append(rec)
        del streams, fused, s_pos4
        torch.cuda.empty_cache()
    return records


def row_substeps(dev, turns, run_with) -> dict:
    """ms per substep of the row variant on the 1M cube (the host clock
    over ROW_SUBSTEPS substeps that end in a synchronize, from one warm
    state), each library in ``turns``: the end-to-end effect of the
    kernels a row substep launches (density_blocks and forces_blocks)."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    params = cs.water_params(cs.N_BENCH)
    scene = cs.cube_scene(params, dev)
    row = SPHSimulation(step.StepConfig(pallas_variant="row", cand_interval=1,
                                        sort_interval=4), device=dev, pretune=False)
    st, dt = bench_torch.warm_up(init_state(params, dev), params, scene, row, cs.WARMUP_STEPS)
    torch.cuda.synchronize()
    ms = {}
    for lib in turns:
        got = run_with(lib, lambda: bench_torch.timed_window("kernel_ab row", st, dt, params,
                                                            scene, row, ROW_SUBSTEPS)[2])
        ms.setdefault(lib, []).append(got)
    print("row substeps (ms, in turns): " + ", ".join(
        f"{lib} {statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for lib, v in ms.items()), flush=True)
    return dict(turns=ms, median_ms={lib: statistics.median(v) for lib, v in ms.items()})


def panel_stats(pos4, cand, count, params, sub, mask=None) -> dict:
    """On tables of ``sub``-particle slots (list row b = query block b):
    the (subgroup, run of 8 candidates) panels of the live slots, how many
    hold a pair within h and how many pass the kernels' box test (the
    subgroup's box and the run's box less than h apart, with its 1e-4
    margin). With a gate ``mask`` (16-wide slots, density_gated16's) also
    the live tiles of 8 slots whose nibble is 0, the panels it flags and
    those that pass both the mask and the box test."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density

    nb, cap = cand.shape
    runs = cap * sub // 8
    h2 = float(params.h) ** 2
    q = pos4[:, :3].reshape(nb, 4, 32, 3)
    qlo, qhi = q.amin(dim=2), q.amax(dim=2)  # (nb, 4, 3)
    live = (torch.arange(runs, device=cand.device)[None] * 8 // sub) < count[:, None]
    passed = hit = flagged = both = 0
    if mask is not None:
        flags = density.mask_panels(mask, cap).repeat_interleave(sub // 8, dim=2)
    rows = max(1, (1 << 24) // (128 * cap * sub))
    for b0 in range(0, nb, rows):
        b1 = min(nb, b0 + rows)
        ids = torch.where(torch.arange(cap, device=cand.device)[None] < count[b0:b1, None],
                          cand[b0:b1], 0).long()
        c = pos4[(ids[..., None] * sub + torch.arange(sub, device=ids.device)), :3]
        c = c.reshape(b1 - b0, runs, 8, 3)
        clo, chi = c.amin(dim=2), c.amax(dim=2)  # (r, runs, 3)
        gap = torch.clamp(torch.maximum(clo[:, None] - qhi[b0:b1, :, None],
                                        qlo[b0:b1, :, None] - chi[:, None]), min=0.0)
        near = (gap * gap).sum(dim=-1) < h2 * 1.0001  # (r, 4, runs)
        on = live[b0:b1, None]
        passed += int((near & on).sum())
        if mask is not None:
            flag = flags[b0:b1] & on
            flagged += int(flag.sum())
            both += int((flag & near).sum())
        d = q[b0:b1, :, :, None, None, :] - c[:, None, None]  # (r, 4, 32, runs, 8, 3)
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        hit += int(((r2 < h2).any(dim=(2, 4)) & on).sum())
    out = dict(live_panels=int(live.sum()) * 4, box_pass=passed, with_hit=hit)
    if mask is not None:
        nt = (count.long() + 7) // 8  # live tiles of each row
        tile = torch.arange(-(-cap // 8), device=cand.device)
        nib = density.mask_panels(mask, cap)[:, :, ::8].any(dim=1)  # (nb, tiles)
        out.update(live_tiles=int(nt.sum()),
                   zero_tiles=int(((tile[None] < nt[:, None]) & ~nib).sum()),
                   flagged=flagged, flagged_box_pass=both)
    return out


def lane_stats(args, width, rounds=(32, 64, 128)) -> dict:
    """On q32 force lists of ``width``-wide entries: the pairs of live
    entries, those inside the support, and for rounds of W candidates the
    sum over (list, round) of the largest per-lane count of pairs inside
    the support (what forces_q32's bit walk costs a warp)."""
    import torch

    f8, _, _, cand, count, params = args
    rows, cap = cand.shape
    h2 = float(params.h) ** 2
    pos = f8[:, :3]
    out = dict(pairs=int(count.sum()) * width * 32, inside=0)
    out.update({f"max_sum_{w}": 0 for w in rounds})
    k = cap * width
    for r0 in range(0, rows, 1024):
        r1 = min(rows, r0 + 1024)
        live = (torch.arange(cap, device=cand.device)[None] < count[r0:r1, None])
        ids = (torch.where(live, cand[r0:r1], 0).long()[..., None] * width
               + torch.arange(width, device=cand.device)).reshape(r1 - r0, k)
        qi = (torch.arange(r0, r1, device=cand.device)[:, None] * 32
              + torch.arange(32, device=cand.device))  # list row b*4+g holds queries b*128+g*32+l
        d = pos[qi][:, :, None, :] - pos[ids][:, None]
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        inside = (r2 < h2) & live.repeat_interleave(width, dim=1)[:, None]
        out["inside"] += int(inside.sum())
        pad = -k % max(rounds)  # dead candidates past the last entry
        inside = torch.nn.functional.pad(inside, (0, pad))
        k_pad = k + pad
        for w in rounds:
            per = inside.reshape(r1 - r0, 32, k_pad // w, w).sum(dim=-1)  # (r, lanes, rounds)
            out[f"max_sum_{w}"] += int(per.amax(dim=1).sum())
    return out


# run in another tree's root (``--sort-tree``): its radix sort of the
# keys saved at each path in argv, checked against torch.sort and timed
OTHER_SORT = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from libclsph_tpu_torch.ops import radix_sort
out = {}
for path in sys.argv[1:]:
    keys = torch.load(path).cuda()
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    k, v = radix_sort.radix_sort_key_val(keys, iota)
    sk, order = torch.sort(keys, stable=True)
    if not (torch.equal(k, sk) and torch.equal(v, order.to(torch.int32))):
        raise SystemExit(f"the sort differs from torch.sort on {path}")
    out[path] = cs.cuda_ms(lambda: radix_sort.radix_sort_key_val(keys, iota))
print(json.dumps(out))
"""


def sort_ab(tree: Path, dev) -> dict:
    """The package's radix sort against the one of another tree (a whole
    checkout, e.g. the parent commit's, whose sort has another C
    interface), run in its own process in that tree, and torch.sort, on
    chip_smoke's sort keys: in turns (other, package, package, other),
    each turn the median of 7 calls (CUDA events)."""
    import torch

    from libclsph_tpu_torch.ops import radix_sort

    paths = {}
    AB_BUILD.mkdir(parents=True, exist_ok=True)
    for n in cs.SORT_KEYS:
        for kind in ("Morton", "random"):
            path = (AB_BUILD / f"sort_keys_{kind}_{n}.pt").resolve()
            torch.save(cs.sort_keys(kind, n, dev).cpu(), path)
            paths[f"{n} {kind}"] = str(path)

    def other():
        proc = subprocess.run([sys.executable, "-c", OTHER_SORT, *paths.values()], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"the other tree's sort failed:\n{proc.stderr[-4000:]}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        return {name: dict(other=ms[path]) for name, path in paths.items()}

    def package():
        out = {}
        for name, path in paths.items():
            keys = torch.load(path).to(dev)
            iota = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)
            out[name] = dict(
                package=cs.cuda_ms(lambda: radix_sort.radix_sort_key_val(keys, iota)),
                torch=cs.cuda_ms(lambda: torch.sort(keys, stable=True)))
        return out

    turns = [other(), package(), package(), other()]
    res = {}
    for name in paths:
        seq = {}
        for turn in turns:
            for k, v in turn[name].items():
                seq.setdefault(k, []).append(v)
        res[name] = dict(turns=seq, ms={k: statistics.mean(v) for k, v in seq.items()})
        print(f"sort {name}: " + ", ".join(
            f"{k} {statistics.mean(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)})"
            for k, v in seq.items()), flush=True)
    return res


def compare(kind, out, ref, rows=0) -> dict:
    """The package's (or a variant's) output against another library's
    (or the plain version's) output; for accelerations, up to ``rows``
    differing rows with both values, described by ``kind``."""
    import torch

    if kind == "density":
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        rel = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
        counts = all(torch.equal(a, b) for a, b in zip(out[1:], ref[1:]))
        return dict(bit_equal=same, density_rel=rel, counts_equal=counts)
    diff = (out - ref).abs()
    res = dict(bit_equal=bool(torch.equal(out, ref)), max_abs=float(diff.max()),
               amax=float(ref.abs().max()), equal_share=float((out == ref).float().mean()))
    if rows:
        bad = torch.nonzero((out != ref).any(dim=1)).flatten()[:rows].tolist()
        res["differing"] = [dict(info, out=out[o].tolist(), ref=ref[o].tolist())
                            for o, info in zip(bad, kind(bad))]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", default=None,
                    help="csrc tree of the base build (needed but with --only advect "
                    "or refine)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="another csrc tree, timed between the package and the base")
    ap.add_argument("--out", default=str(AB_BUILD))
    ap.add_argument("--sass", action="store_true", help="write each library's SASS")
    ap.add_argument("--sort-tree", default=None, metavar="DIR",
                    help="a whole checkout whose radix sort is timed against the package's")
    ap.add_argument("--only", choices=("stream", "advect", "refine"), default=None,
                    help="run only the stream kernels' cases, or only the advection or "
                    "the refine kernel's (no base build)")
    args = ap.parse_args(argv)
    if args.base is None and args.only not in ("advect", "refine"):
        ap.error("--base is needed but with --only advect or refine")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from libclsph_tpu_torch.engine.simulation import configure_device
    from libclsph_tpu_torch.ops.kernels import build

    dev = configure_device("cuda")
    card = bench_torch.card_line()
    print(f"card: {card}; device {torch.cuda.get_device_name(0)}", flush=True)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.only in ("advect", "refine"):
        result = {"card": card, args.only: {"advect": advect_ab, "refine": refine_ab}[
            args.only](dev)}
        (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    trees = {"base": args.base}
    trees.update(v.split("=", 1) for v in args.variant)
    libs, paths = build_all(trees)
    order = ["package"] + [n for n in trees if n != "base"]
    result = dict(card=card, builds={}, cases=[])
    for name, path in paths.items():
        result["builds"][name] = ptxas_report(path)
        for line in result["builds"][name]:
            print(f"ptxas {name}: {line}")
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if args.sass and Path(tool).exists():
            sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
            (out_dir / f"sass_{name}.txt").write_text(sass.stdout + sass.stderr)

    def run_with(lib_name, fn):
        build._library = libs[lib_name]
        try:
            return fn()
        finally:
            build._library = libs["package"]

    result["stream"] = stream_ab(dev, run_with, order)
    result["advect"] = advect_ab(dev)
    result["refine"] = refine_ab(dev)
    if args.only == "stream":
        (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
        print(json.dumps(result))
        return 0
    stats, cases = cases_1m(dev, libs)
    result["table_stats"] = stats
    print(f"table statistics: {json.dumps(stats)}", flush=True)
    for name, key, call, plain, work, kind, *beside in cases:
        first = [] if name in PACKAGE_ONLY else ["base"]
        outs = {lib: run_with(lib, call) for lib in first + order}
        torch.cuda.synchronize()
        ref = plain()
        rec = dict(name=name, bound_ms=cs.bound(*work)[0], bound_by=cs.bound(*work)[1],
                   checks={})
        for lib in order:
            vs_base = compare(kind, outs[lib], outs["base"], rows=4) if first else None
            vs_plain = compare(kind, outs[lib], ref)
            ok = (vs_plain["density_rel"] <= 1e-5 and vs_plain["counts_equal"]
                  if kind == "density" else vs_plain["max_abs"] <= 1e-5 * vs_plain["amax"])
            if not ok:
                raise RuntimeError(f"{name} {lib}: disagrees with the plain version {vs_plain}")
            rec["checks"][lib] = dict(vs_base=vs_base, vs_plain=vs_plain)
        del outs, ref
        turns = first + order + order[::-1] + first
        # each turn times the case's call, then the call beside it if any
        calls = [(name, key, call)] + [b for b in beside if b]
        seq = [(lib, label, run_with(lib, lambda: cs.cuda_ms(fn)),
                run_with(lib, lambda: device_ms(fn, k)))
               for lib in turns for label, k, fn in calls]
        rec["turns"] = seq
        line = f"{name}: bound {rec['bound_ms']:.4f} ms by {rec['bound_by']};"
        for label, _, _ in calls:
            times = {lib: [(t, d) for other, lb, t, d in seq if other == lib and lb == label]
                     for lib in dict.fromkeys(turns)}
            ms = {lib: statistics.mean(t for t, _ in v) for lib, v in times.items()}
            dev_ms = {lib: statistics.mean(d for _, d in v) for lib, v in times.items()}
            if label == name:
                rec["ms"], rec["device_ms"] = ms, dev_ms
            else:
                rec.setdefault("beside", {})[label] = dict(ms=ms, device_ms=dev_ms)
                line += f" beside, {label}:"
            for lib in first + order:
                ev = ", ".join(f"{t:.4f}" for t, _ in times[lib])
                dv = ", ".join(f"{d:.4f}" for _, d in times[lib])
                line += f" {lib} {ms[lib]:.4f} ms ({ev}; device {dev_ms[lib]:.4f}: {dv})"
                if lib != "base" and label == name:
                    line += f" {json.dumps(rec['checks'][lib]['vs_base'])};"
        print(line, flush=True)
        result["cases"].append(rec)
        torch.cuda.empty_cache()
    turns = (["base"] + order + order[::-1] + ["base"]) * ROW_ROUNDS
    result["row_substeps"] = row_substeps(dev, turns, run_with)
    if args.sort_tree:
        result["sort"] = sort_ab(Path(args.sort_tree), dev)
    (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
