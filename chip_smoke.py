#!/usr/bin/env python3
"""Smoke run of libclsph-tpu's PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--river-frames K] [--parent DIR]

Phases (each prints its own numbers; any failure raises and exits
non-zero):

0. the card: ``nvidia-smi`` name and power limit, the torch device name;
1. build the CUDA kernels from ``libclsph_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all at once; seconds);
2. each kernel against its plain PyTorch version on tables built by the
   port's candidate machinery: the 65,536-particle cube lattice
   (``simulation_properties/bench64k.json``), the same after 10
   substeps of fall, and the 1M cube lattice; the main path's tables
   for ``density_c16`` (hit_sub 8) / ``forces_q32_c8``, the q-granular
   tables (the autotune's downgraded config) for ``density_c32`` at 4
   and 1 hit rows per block, ``forces_q32_c32`` and ``forces_q128_c32``,
   the 16-wide force path's tables ((density_sub16, force_sub16,
   force_sub8) = (True, True, False) and (False, True, False)) for
   ``density_c16`` at hit_sub 16 with and without the dilated tile
   counts, ``density_c32`` at hit_sub 16 and ``forces_q32_c16``,
   ``density_gated16`` against the ungated kernel (bit for bit) on a
   state three reuse substeps from its anchor, and every kernel through
   the query-block map on a tier-2 pool (every 8th block of the 1M
   lattice). Density rtol 1e-5, hit and tile counts equal, acceleration
   atol 1e-5 * max|a|; kernel and plain times (CUDA events, median of 7
   and of 3)
   and the bound (bytes or fp32 operations at the H100's peaks) at 1M;
3. the CLI main path: ``sph-torch water default cube`` at 64,000
   particles for 3 frames with the native ``.geo`` writer (built in
   phase 1), checking the .geo frames, that no particle left the fluid's
   column above the cube obstacle, and the densities; then the CLI round
   trip through ``--import-legacy``: the run's last checkpoint, moved
   0.3 m in x, written as a reference-format ``last_frame.bin``,
   imported and run for one frame (its centroid must carry the move);
   3b. the same with ``--no-force-sub8`` (the 16-wide force path);
   3c. fidelity in free space (``experiments/torch_fidelity_64k.py``):
   65,536 particles settled 20 substeps, then the production path's
   density (every particle) and acceleration (512 rows) against a
   float64 oracle; the density or acceleration RMS relative error at
   1e-4 or more fails the phase;
4. the 1M-particle cube dam-break through ``bench_torch.py``'s functions
   (no pretune): its warm-up with the engine's capacity growth (3
   substeps, then the window's 20 once, untimed), then 20 timed substeps
   that must raise no flag (a flagged window grows the table and is
   re-run, as the engine re-runs a frame); ms/substep and
   particle-steps/s, and bench_torch's JSON line for the window; then a
   ``torch.profiler`` breakdown (``utils/profiling``) of one rebuild and
   one reuse substep from the window's last state: the top 15 entries by
   device time, the device total and the host wall time of each, beside
   the median of 5 unprofiled runs; before it, the warm-up's first
   substeps again with the frame loop's dispatch layer's stops, and the
   synchronising calls (``torch.cuda.set_sync_debug_mode``) of 8
   substeps from the warm state, on bench_torch's cadence and in one
   frame dispatch: more than one a candidate period, plus the
   dispatch's own read, fails the phase;
   4c. the parent commit against this tree, in turns (parent, change,
   change, parent), each run a process of its own: ``bench_torch.py``'s
   1M cube (ms/substep, host reads a substep) and
   ``experiments/torch_e2e_64k.py`` for 12 frames with export (s/frame,
   the engine's dispatches, reads and stops). The parent is a checkout
   given by ``--parent DIR``, or ``build/parent`` where it exists
   (``git archive <commit> | tar -x -C build/parent``); with one, also
   phase 4's profiler breakdown run in each checkout; without one, this
   tree's two runs alone, once. Recorded, not gated;
   4b. the same on the 16-wide force path (True, True, False), then with
   ``density_gate``: ``forces_q32_c16`` on every timed substep,
   ``density_gated16`` on every reuse substep, positions bit-equal to the
   ungated run after 8 substeps from one state, and the rebuild and
   reuse substeps timed alone; a growth rule that leaves the 16-wide
   tables fails the phase;
5. two-tier equivalence at the 1M cube, for the main, the two 16-wide
   and the q-granular configs: a single-tier substep at full subblock
   capacity against a two-tier substep whose base capacity lies below
   the heavy blocks; density equal (the kernels sum each list in a fixed
   order), acceleration atol 1e-5 * max|a|; ``forces_q128_c32`` must
   launch in the 32-wide tables' tier 2 and ``forces_q32_c16`` in both
   tiers of the 16-granular one;
6. the river: 1,048,576 water particles (mass 0.025) stacked on
   ``scenes/river.obj`` through ``SPHSimulation(pretune="auto")`` for 3
   frames with ``.geo`` export by the native writer
   (``experiments/torch_scene_run.py``); prints the probe statistics, the
   config the pretune chose and s/frame; the q-granular config must be
   taken and ``density_c32`` / ``forces_q32_c32`` must launch during the
   frames;
7. the block-granular 1M cube dam-break (the ``row``, ``fine`` and
   ``asym`` variants: whole candidate blocks through the 32-wide kernels,
   rebuilt every substep, sort every 4th): ``row`` warm-up with capacity
   growth then 20 timed substeps, ``fine`` and ``asym`` 8 timed
   substeps each from the same warm state, ``asm`` one substep (it must
   launch ``density_c32`` at 1 group and ``forces_q128_c32``), and one
   ``row`` substep against one ``neighbor_impl="tiles"`` substep from the
   same state (density rtol 1e-5, acceleration atol 1e-4 * max|a|, the
   JAX package's tolerance for this pair);
8. the ``exact`` impl: ``sph-torch water default cube --neighbor-impl
   exact --sort-interval 1`` at 64,000 particles for 3 frames, sorting
   with the radix sort (``LIBCLSPH_TPU_SORT=radix-fused``, set by this
   script before the package is imported), checked as phase 3; the
   sort's kernels must launch; then one exact substep from the run's last
   state with its peak device memory, against a main-path substep from
   the same state at phase 7's tolerances;
9. the shapes: ``bench_torch``'s functions at 1M, one warm-up and one
   timed window of 20 substeps each, for ``--nl-query-rows 64``,
   ``--nl-query-rows 32``, ``--block-size 64``, ``--block-size 256``
   (on the q-granular tables, ``--no-density-sub16 --no-force-sub16
   --no-force-sub8``: the 16-granular ones need 128-row query blocks, and
   at 1M the 16-wide hit lists of 256-particle blocks overflow into the
   engine's downgrade to them), ``--pallas-variant asm --nl-query-rows
   32``, ``refine_mode="aabb"``, ``--block-size 64 --pallas-variant row``
   and ``--nl-query-rows 32 --no-hit-compact``: ``timed_flags`` 0, the
   shape's kernels launched on every timed substep, ms/substep, and one
   substep against the main path's substep from the same warm state
   (density rtol 1e-5, acceleration atol 1e-4 * max|a|);
10. the view: 3 frames of the 1M cube through ``SPHSimulation`` with
    ``io/render.PointRenderer.view`` as ``device_view``; the hook must
    receive CUDA tensors, and each image must equal the CPU render of the
    same state on at least 99.9 % of its pixels; the render ms a frame;
11. the emitter (``experiments/torch_emitter_run.py``, the round-5
    matrix's row 9): 262,144 particles from ``shower.obj``'s tray onto
    ``monkey.obj`` for 5 frames; every frame after the first must
    recycle particles;
12. the mesh, 4 ranks sharing the card over gloo (staged through host
    buffers): 12a one sharded substep per exchange and table shape from
    the settled 64k cube against the single-chip substep, then 8
    substeps of the sharded frame loop with two-tier routing and
    candidate reuse (``cand_interval`` 4) under halo and all_gather
    against the single-chip frame from the same state (positions atol
    1e-5, density rtol 1e-5, acceleration atol 5e-4 * max|a|, the same
    rebuilds and reuses, tier 2 receiving blocks); 12b ``density_c16``
    hit_sub 16 and ``forces_q32_c16`` against their plain versions on
    each rank's exchanged tables at 1M; 12c ``bench_torch``'s ``--mesh
    4`` function at 1M for halo and all_gather, and ``--mesh 1 --exchange
    halo`` against phase 4b (the grown table shape printed for each);
    12d ``sph-torch ... --mesh 4 --exchange halo`` at 64,000 particles;
13. the probes: ``experiments/torch_refine_probe.py`` at 1M (the
    refine's split at 128, 64 and 32 query rows), ``torch_scale_diag.py``
    at 2M (warm-up with growth and 10 substeps),
    ``torch_river_frame_diag.py`` on the 1M river for 5 frames (host
    clock only, with the dispatch layer's host reads, discarded substeps
    and stops a frame), and the
    stream probes at 1M, ``torch_force_kernel_bisect.py`` (the q128 force
    kernel split into feed, support test and pair terms on a stream
    gathered beforehand) and ``torch_nl_kernel_variants.py`` (the sums on
    the aabb lists' stream in both layouts, and the asm route), each in a
    process of its own, each printing its JSON line; a probe that exits
    non-zero fails the run. The stream probes' launch counts are the
    ``probe`` path's.
14. the identity mode (``StepConfig.pair_r2="mxu"``, r^2 by |q|^2 +
    |c|^2 - 2 q.c on packs centred on the domain), run after phase 9: the 1M
    cube through ``bench_torch``'s warm-up and timed window in the mode
    (ms/substep beside phase 4's, bench_torch's JSON line), one substep
    against the direct one from the window's last state (density rtol
    and acceleration atol / max|a| of ``identity_tolerance``: the JAX
    package's 5e-4 for the mode, or twice the identity's worst rounding
    of r^2 at the state's largest centred |p| where that is larger);
    each of ``MXU_CONFIGS`` (the gated 16-wide path, whose reuse
    substeps run the gated density in the direct form; the 16-wide,
    q32, q128, 64- and 32-row and asm tables) warmed up for 3 substeps
    at 64k, each launching its kernels' identity mode; and one 64k tiles
    substep in ``tile_mode="mxu"`` against the direct tile mode (the
    same ``identity_tolerance``).

Phase 2 also holds, at the 1M lattice, ``density_blocks`` and
``forces_blocks`` of the three block variants on the block search's
table expanded to 32-wide subblocks, ``density_c32`` at 1 group and
``forces_q128_c32`` on the ``asm`` variant's tables, and the radix sort
(``csrc/radix_sort.cu``, 30-bit keys at 5 bits a pass) bit for bit
against ``torch.sort(stable=True)`` and its plain version on the Morton
codes of the 1M and 4M cube lattices and on as many uniform random keys,
timed in turns beside ``torch.sort`` with each kernel's device time.
At the 64k and 1M lattices it also holds the finer query blocks' modes
on the port's own tables at those shapes: ``density_c32`` with block
counts and ``forces_q128_c32`` on 64- and 32-row lists (nl and asm),
``density_c32`` densities only on the full 32-row lists, and the row
variant's passes at ``block_size`` 64.
At the 1M lattice phase 2 also holds each kernel mode's identity mode
(``r2_mxu=True``: ``density_c16`` at hit_sub 8, 16 and 16 with the tile
counts, ``density_c32`` at 4 and 1 groups, hit_sub 16 and 64 and 32
rows, ``forces_q32_c8``, ``_c16``, ``_c32`` and ``forces_q128_c32`` at
128, 64 and 32 rows) against its plain version in the mode on the same
tables with centred packs (densities rtol 1e-5, every hit and tile count
equal, accelerations atol 1e-5 * max|a|), and times it by CUDA events
with the direct mode on the same inputs before and after it; the
records named with " mxu" take those times and the launches of phase 14.
Phase 2 also holds, at 64k and 1M, the stream kernels
(``ops/kernels/stream.py``): ``gather_stream`` in both layouts bit for
bit against its plain version at 8, 16 and 32 particles a slot (the main
path's hit lists, the 16-wide lists, the q128 lists), and
``forces_c32_stream`` on the q128 lists' stream: its sums (staged,
planes, no cull) each within rtol 1e-5 and atol 1e-5 of the sum's
largest |value|, its accel mode bit for bit against ``forces_q128_c32``
(else within 1e-5 * max|a|, the difference printed), its test mode's
counts equal, and the zero-count control all zeros. These kernels are
not timed in phase 2: their record's times, plain times, bounds,
``torch.index_select``'s time (``library_ms`` of the gathers) and
launches are those of phase 13's bisect probe, which times them at 1M.
The block variants' plain versions are timed
over 2 repetitions after a warm-up (about a second each at 1M), the other
plain versions over 3, the kernels over 7.

Each path (main: phases 3, 3c and 4 (4c's runs are processes of their
own, with their own counts); 16-wide: 3b-4b; deep columns: 5-6; row,
fine, asym and asm: 7; exact: 8; each shape of phase 9; the stream probes
of 13; the identity mode: 14) runs with the
launch counts set to 0 just before it and read just after; each record
counts the launches of the paths it belongs to. Every phase prints its
wall time, and one line before the card's holds them all and the total.
The line before last holds the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``. Needs one CUDA
device; refuses to run without one. ``--profile DIR`` keeps phase 4's
profiler traces and full tables in DIR (``rebuild/`` and ``reuse/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

from bench_torch import (bench_mesh, bench_mesh_record, bench_result, card_line,
                         run_substeps, sync, sync_calls, timed_window, warm_up)
from kernel_bounds import DENSITY_OPS, FORCE_OPS, bound, nbytes, stream_works

ROOT = os.path.dirname(os.path.abspath(__file__))
EXPERIMENTS = os.path.join(ROOT, "experiments")
N_BENCH = 1_000_000
TIMED_STEPS = 20
WARMUP_STEPS = 3
REPS = 7
N_RIVER = 1_048_576
RIVER_FRAMES = 3
N_FIDELITY = 65_536
PROFILE_TOP = 15  # entries of the profiler breakdown by device time
Q_PATH = dict(density_sub16=False, force_sub16=False, force_sub8=False)
# the finer query blocks' tables: 32-wide, rebuilt every substep (no
# reuse below whole-block query rows)
Q_PATH_ROWS = dict(Q_PATH, cand_interval=1)
# the 16-wide force path, with the hit capacity set as bench.py's
# --max-candidates-hit16 can (a shortfall would downgrade to Q_PATH)
SUB16 = dict(force_sub8=False, max_candidates_hit16=128)
FTF = dict(SUB16, density_sub16=False)
NL = "libclsph_tpu/ops/pallas/neighbor_nl.py"
ROW = "libclsph_tpu/ops/pallas/neighbor.py"
ASYM = "libclsph_tpu/ops/pallas/neighbor_asym.py"
CSRC = "libclsph_tpu_torch/csrc/"
LAYOUT_TEST = "tests/test_nl_layout.py:52"
BISECT = "experiments/force_kernel_bisect.py:153"
VARIANTS = "experiments/nl_kernel_variants.py"
NL_PATHS = ("main", "16-wide", "deep")
BLOCK_VARIANTS = ("row", "fine", "asym")
# record name: (wrapper, launch variant or None, source, TPU kernel it
# replaces, the paths whose launches it counts)
KERNELS = {
    "density_c16": ("density_c16", "hit_sub 8", CSRC + "density_c16.cu", NL + ":394",
                    NL_PATHS),
    "density_c16 hit_sub 16": ("density_c16", "hit_sub 16", CSRC + "density_c16.cu",
                               NL + ":394", NL_PATHS + ("mesh",)),
    "density_c16 hit_sub 16, hit2_h": ("density_c16", "hit_sub 16, hit2_h",
                                       CSRC + "density_c16.cu", NL + ":394", NL_PATHS),
    "density_gated16": ("density_gated16", None, CSRC + "density_gated16.cu", NL + ":612",
                        NL_PATHS),
    "density_c32": ("density_c32", "groups 4, hit_sub 32", CSRC + "density_c32.cu",
                    NL + ":394", NL_PATHS + ("mesh",)),
    "density_c32 groups 1": ("density_c32", "groups 1, hit_sub 32", CSRC + "density_c32.cu",
                             NL + ":394", NL_PATHS + ("mesh",)),
    "density_c32 hit_sub 16": ("density_c32", "groups 4, hit_sub 16",
                               CSRC + "density_c32.cu", NL + ":394", NL_PATHS),
    "forces_q32_c8": ("forces_q32_c8", None, CSRC + "forces_q32.cu", NL + ":1768", NL_PATHS),
    "forces_q32_c16": ("forces_q32_c16", None, CSRC + "forces_q32.cu", NL + ":1471",
                       NL_PATHS + ("mesh",)),
    "forces_q32_c32": ("forces_q32_c32", None, CSRC + "forces_q32.cu", NL + ":1083",
                       NL_PATHS + ("mesh",)),
    "forces_q128_c32": ("forces_q128_c32", None, CSRC + "forces_c32.cu", NL + ":730",
                        NL_PATHS + ("mesh",)),
    # the asm variant: the 32-wide kernels at whole-block query rows
    "density_c32 groups 1 (asm)": ("density_c32", "groups 1, hit_sub 32",
                                   CSRC + "density_c32.cu", NL + ":2048", ("asm",)),
    "forces_q128_c32 (asm)": ("forces_q128_c32", None, CSRC + "forces_c32.cu",
                              NL + ":2079", ("asm",)),
    # finer query blocks (phase 9): the 32-wide kernels on lists that
    # serve 64 or 32 query rows
    "density_c32 groups 1, rows 64": ("density_c32", "groups 1, rows 64",
                                      CSRC + "density_c32.cu", NL + ":394", ("q64", "b64")),
    "density_c32 groups 1, rows 32": ("density_c32", "groups 1, rows 32",
                                      CSRC + "density_c32.cu", NL + ":394", ("q32",)),
    "density_c32 densities only, rows 32": ("density_c32", "densities only, rows 32",
                                            CSRC + "density_c32.cu", NL + ":394",
                                            ("q32-full",)),
    "forces_q128_c32 rows 64": ("forces_q128_c32", "rows 64", CSRC + "forces_c32.cu",
                                NL + ":730", ("q64", "b64")),
    "forces_q128_c32 rows 32": ("forces_q128_c32", "rows 32", CSRC + "forces_c32.cu",
                                NL + ":730", ("q32", "q32-full")),
    "density_c32 groups 1, rows 32 (asm)": ("density_c32", "groups 1, rows 32",
                                            CSRC + "density_c32.cu", NL + ":2048",
                                            ("asm32",)),
    "forces_q128_c32 rows 32 (asm)": ("forces_q128_c32", "rows 32", CSRC + "forces_c32.cu",
                                      NL + ":2079", ("asm32",)),
    "density_blocks row, block 64": ("density_c32", "densities only, rows 64",
                                     CSRC + "density_c32.cu", ROW + ":319", ("b64-row",)),
    "forces_blocks row, block 64": ("forces_q128_c32", "rows 64", CSRC + "forces_c32.cu",
                                    ROW + ":821", ("b64-row",)),
    # whole candidate blocks, expanded to 32-wide subblocks
    # (ops/kernels/blocks.py): the 32-wide kernels on the variant's path
    "density_blocks row": ("density_c32", "densities only", CSRC + "density_c32.cu",
                           ROW + ":319", ("row",)),
    "density_blocks fine": ("density_c32", "densities only", CSRC + "density_c32.cu",
                            ROW + ":319", ("fine",)),
    "density_blocks asym": ("density_c32", "densities only", CSRC + "density_c32.cu",
                            ASYM + ":156", ("asym",)),
    "forces_blocks row": ("forces_q128_c32", None, CSRC + "forces_c32.cu", ROW + ":821",
                          ("row",)),
    "forces_blocks fine": ("forces_q128_c32", None, CSRC + "forces_c32.cu", ROW + ":821",
                           ("fine",)),
    "forces_blocks asym": ("forces_q128_c32", None, CSRC + "forces_c32.cu", ASYM + ":294",
                           ("asym",)),
    # the whole sort; its count is of passes
    "radix_sort": ("radix_sort", None, CSRC + "radix_sort.cu",
                   "libclsph_tpu/ops/radix_sort.py:87", ("exact", "mesh")),
    # the candidate stream and the sums over it (ops/kernels/stream.py):
    # no engine path runs them; the probes of phase 13 do
    "gather_stream": ("gather_stream", "staged", CSRC + "gather_stream.cu", LAYOUT_TEST,
                      ("probe",)),
    "gather_stream planes": ("gather_stream", "planes", CSRC + "gather_stream.cu",
                             LAYOUT_TEST, ("probe",)),
    "forces_c32_stream sums": ("forces_c32_stream", "sums", CSRC + "forces_stream.cu",
                               BISECT, ("probe",)),
    "forces_c32_stream accel": ("forces_c32_stream", "accel", CSRC + "forces_stream.cu",
                                BISECT, ("probe",)),
    "forces_c32_stream planes": ("forces_c32_stream", "planes", CSRC + "forces_stream.cu",
                                 VARIANTS + ":163", ("probe",)),
    "forces_c32_stream no cull": ("forces_c32_stream", "no cull", CSRC + "forces_stream.cu",
                                  BISECT, ("probe",)),
    "forces_c32_stream test": ("forces_c32_stream", "test", CSRC + "forces_stream.cu",
                               BISECT, ("probe",)),
}
# the identity mode (StepConfig.pair_r2 = "mxu"): each kernel mode's twin,
# counted under its variant with ", mxu" (the force kernels without
# another variant under "mxu"), launched on phase 14's runs
MXU_RECS = (
    ("density_c16", "hit_sub 8"), ("density_c16 hit_sub 16", "hit_sub 16"),
    ("density_c16 hit_sub 16, hit2_h", "hit_sub 16, hit2_h"),
    ("density_c32", "groups 4, hit_sub 32"), ("density_c32 groups 1", "groups 1, hit_sub 32"),
    ("density_c32 hit_sub 16", "groups 4, hit_sub 16"),
    ("density_c32 groups 1, rows 64", "groups 1, rows 64"),
    ("density_c32 groups 1, rows 32", "groups 1, rows 32"),
    ("forces_q32_c8", None), ("forces_q32_c16", None), ("forces_q32_c32", None),
    ("forces_q128_c32", "rows 128"), ("forces_q128_c32 rows 64", "rows 64"),
    ("forces_q128_c32 rows 32", "rows 32"),
)
for _rec, _variant in MXU_RECS:
    _fn, _, _src, _replaces, _ = KERNELS[_rec]
    KERNELS[_rec + " mxu"] = (_fn, "mxu" if _variant is None else _variant + ", mxu", _src,
                              _replaces, ("mxu",))
BENCH_TAG = "1M lattice"  # the phase-2 tables whose times and bounds are recorded
# the radix sort's least traffic: every pass reads and writes each key
# and value once
SORT_BYTES_PER_KEY_PASS = 16
SORT_KEYS = (N_BENCH, 4_000_000)  # keys of the timed sorts (phase 2)
# the plain block-granular passes take about a second each at 1M
BLOCK_PLAIN_REPS = 2
PLAIN_REPS = 3  # timed calls of the other plain versions (0.2-0.7 s each at 1M)
FEW_STEPS = 8  # timed substeps of the fine and asym variants (phase 7)
N_EXACT = 64_000
VIEW_FRAMES = 3  # frames of the rendered 1M cube (phase 10)
EMITTER_FRAMES = 5  # frames of the 256k emitter (phase 11)
MESH_RANKS = 4  # phase 12: ranks that share the one card
MESH_STEPS = 10  # timed substeps of phase 12c
MESH_FRAMES = 2  # frames of the mesh CLI run (phase 12d)
# phase 12a's tier-2 reuse case: substeps of the sharded frame loop (a
# rebuild at substeps 0 and 4 on the 4/4 cadence), and its exchanges
REUSE_SUBSTEPS = 8
REUSE_EXCHANGES = ("halo", "all_gather")
N_SCALE = 2_000_000  # phase 13: the scale probe's dam-break
SCALE_STEPS = 10
RIVER_PROBE_FRAMES = 5
E2E_FRAMES = 12  # phase 4c: frames of each 64k end-to-end run
# phase 12a: (label, exchange, halo_hops, StepConfig fields) of each
# sharded substep held against the single-chip substep; ring at 2 hops
# covers 4 ranks
MESH_CASES = (
    ("all_gather", "all_gather", 1, {}),
    ("halo", "halo", 1, {}),
    ("ring, 2 hops", "ring", 2, {}),
    ("all_gather, q-granular tables", "all_gather", 1, Q_PATH),
    ("halo, q-granular tables at 128 force rows", "halo", 1,
     dict(Q_PATH, force_query_rows=128)),
)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def density_work(args, outs, pairs, dilated=0):
    """(bytes, operations) of a density call: each input read once and
    each output written once; DENSITY_OPS for each of the ``pairs`` inside
    the support, one more for each of the ``dilated`` pairs within the
    tile counts' radius."""
    pos4, cand, count = args[:3]
    return nbytes(pos4, cand, count, *outs), pairs * DENSITY_OPS + dilated


def force_work(args, qrows, pairs_in):
    """(bytes, operations) of a force call over lists shared by ``qrows``
    queries: FORCE_OPS for each of the ``pairs_in`` pairs inside the
    support."""
    f8, dens, real, cand, count = args[:5]
    out = cand.shape[0] * qrows * 3 * 4
    return nbytes(f8, dens, real, cand, count) + out, pairs_in * FORCE_OPS


def time_kernel(stats, rec, tag, fn, plain, work, plain_reps=PLAIN_REPS) -> str:
    """Kernel and plain times of one call; at BENCH_TAG also its work for
    the bound. Returns the log fragment."""
    ms, plain_ms = cuda_ms(fn), cuda_ms(plain, plain_reps)
    if tag == BENCH_TAG:
        stats[rec]["bench"] = (ms, plain_ms) + tuple(work)
    b_ms, b_by = bound(*work)
    return (f" {rec} {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
            f"{b_by});")


def cube_scene(params, dev):
    """``scenes/cube.obj`` baked for ``params`` on ``dev``."""
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    return collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2.0, scenes_dir=os.path.join(ROOT, "scenes")), dev)


def grown_tables(state, params, engine, plain_density, lists, fixed=None):
    """Pad and sort ``state``, build the candidate tables at
    ``engine.step_config`` and run ``plain_density`` on them, growing the
    capacities by the engine's rules until nothing is truncated;
    ``lists(cand_sub, hits, cfg)`` gives the force lists and their flags.
    ``fixed``: a predicate the config must keep (the growth rules may not
    leave these tables). Returns (st, real, density args, density out,
    lists)."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    st, real, _ = step.pad_and_sort(state, params, True,
                                    block_size=engine.step_config.block_size)
    for _ in range(6):
        cfg = engine.step_config
        if fixed is not None and not fixed(cfg):
            raise RuntimeError(f"the engine's growth rules left the tables: {cfg}")
        cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
        args = (density.pos_pack(st.position, real), cand_sub, count_sub, params)
        out = plain_density(*args)
        made = lists(cand_sub, out, cfg)
        if not engine._needs_rerun(flags | made[-1]):
            return st, real, args, out, made[:-1]
    raise RuntimeError("capacity growth did not converge on the test tables")


def force_pack_of(st, real, dens, params):
    import torch

    from libclsph_tpu_torch.ops.interactions import tait_pressure
    from libclsph_tpu_torch.ops.kernels import forces

    pres = torch.where(real, tait_pressure(dens, params), 0.0)
    return forces.force_pack(st.position, st.velocity, dens, pres, real,
                             params.particle_mass)


def main_path_tables(state, params, engine):
    """The kernels' inputs on the main path for ``state``: padded and
    sorted, candidate tables (capacities grown by the engine's rules
    until nothing is truncated), and, from the plain density, the hit
    lists and force fields."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    st, real, args, (dens, hits), (cand8, count8) = grown_tables(
        state, params, engine, density.density_c16_torch,
        lambda cand, out, cfg: step.hit_lists(cand, out[1], cfg))
    f8 = force_pack_of(st, real, dens, params)
    return dict(density_args=args, force_args=(f8, dens, real, cand8, count8, params),
                dens_plain=dens, hits_plain=hits)


def compare_kernels(tag, t, stats, time_it):
    """Kernel vs plain on one set of main-path tables."""
    from libclsph_tpu_torch.ops.kernels import density, forces

    d, hits = density.density_c16(*t["density_args"])
    drel = check_density(tag, "density_c16", d, hits, t["dens_plain"], t["hits_plain"],
                         stats)
    a = forces.forces_q32_c8(*t["force_args"])
    aerr = check_accel(tag, "forces_q32_c8", a, forces.forces_q32_c8_torch(*t["force_args"]),
                       stats)
    line = (f"phase 2 {tag}: density rel err {drel:.3g}, hits equal ({hits.numel()} "
            f"counts, {int(hits.sum())} pairs); accel err {aerr:.3g};")
    if time_it:
        pairs_in = int(t["hits_plain"].sum())
        line += time_kernel(stats, "density_c16", tag,
                            lambda: density.density_c16(*t["density_args"]),
                            lambda: density.density_c16_torch(*t["density_args"]),
                            density_work(t["density_args"], (d, hits),
                                         int(t["hits_plain"].sum())))
        line += time_kernel(stats, "forces_q32_c8", tag,
                            lambda: forces.forces_q32_c8(*t["force_args"]),
                            lambda: forces.forces_q32_c8_torch(*t["force_args"]),
                            force_work(t["force_args"], 32, pairs_in))
    log(line)


def kernel_fn(name):
    from libclsph_tpu_torch.ops.kernels import density, forces, radix, stream

    for mod in (density, forces, radix, stream):
        if callable(getattr(mod, name, None)):
            return getattr(mod, name)
    raise KeyError(name)


def reset_launches() -> None:
    from libclsph_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def read_launches() -> dict:
    from libclsph_tpu_torch.ops import kernels

    return records_from_raw(kernels.launch_counts())


def restore_launches(saved) -> None:
    for fn_name, (launches, variants) in saved.items():
        fn = kernel_fn(fn_name)
        fn.launches = launches
        if hasattr(fn, "variants"):
            fn.variants = variants


def save_launches() -> dict:
    """The raw counters, for runs made only to compare (they do not
    count)."""
    from libclsph_tpu_torch.ops import kernels

    return kernels.launch_counts()


def record_err(stats, name, err) -> None:
    s = stats[name]
    s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err)


def check_accel(tag, name, a, a0, stats) -> float:
    import torch

    torch.cuda.synchronize()
    aerr = float((a - a0).abs().max())
    amax = float(a0.abs().max())
    if not aerr <= 1e-5 * amax:
        raise RuntimeError(f"{tag} {name}: accel err {aerr:.3g} > 1e-5 * {amax:.3g}")
    record_err(stats, name, aerr)
    return aerr


def check_density(tag, name, d, hits, d0, hits0, stats) -> float:
    import torch

    torch.cuda.synchronize()
    drel = float(((d - d0).abs() / d0.abs()).max())
    hit_diff = int((hits != hits0).sum()) if hits.shape == hits0.shape else -1
    if drel > 1e-5 or hit_diff:
        raise RuntimeError(f"{tag} {name}: density rel err {drel:.3g}, "
                           f"{hit_diff} hit counts differ (-1: shapes differ)")
    record_err(stats, name, float((d - d0).abs().max()))
    return drel


def q_path_tables(state, params, engine):
    """The q-granular kernels' inputs for ``state`` (the tables the
    autotune's c16 -> q downgrade runs on): 32-particle subblocks, hits
    per subgroup and per block from the plain density, the q32 and q128
    force lists (capacities grown by the engine's rules until nothing
    is truncated) and the force pack."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    def plain(*args):
        d, h4 = density.density_c32_torch(*args, groups=4)
        return d, h4, density.density_c32_torch(*args, groups=1)[1]

    def lists(cand, out, cfg):
        q32 = step.hit_lists(cand, out[1], cfg, 4)
        q128 = step.hit_lists(cand, out[2], cfg, 1)
        return q32[:2], q128[:2], q32[2] | q128[2]

    st, real, args, (dens, hits4, hits1), (q32, q128) = grown_tables(
        state, params, engine, plain, lists)
    return dict(density_args=args, dens_plain=dens, hits4=hits4, hits1=hits1,
                f8=force_pack_of(st, real, dens, params), real=real, q32=q32, q128=q128,
                params=params)


def compare_q_kernels(tag, t, stats, time_it):
    """The q-granular kernels against their plain versions on one set of
    tables."""
    from libclsph_tpu_torch.ops.kernels import density, forces

    d0 = t["dens_plain"]
    line = f"phase 2 {tag} (q-granular tables):"
    outs = {}
    for groups, rec in ((4, "density_c32"), (1, "density_c32 groups 1")):
        d, hits = density.density_c32(*t["density_args"], groups=groups)
        drel = check_density(tag, rec, d, hits, d0, t[f"hits{groups}"], stats)
        outs[rec] = (d, hits)
        line += f" {rec} rel err {drel:.3g}, hits equal ({hits.numel()} counts);"
    fargs = (t["f8"], d0, t["real"])
    for name, lists in (("forces_q32_c32", "q32"), ("forces_q128_c32", "q128")):
        args = fargs + t[lists] + (t["params"],)
        a = kernel_fn(name)(*args)
        aerr = check_accel(tag, name, a, getattr(forces, name + "_torch")(*args), stats)
        line += f" {name} accel err {aerr:.3g};"
    if time_it:
        pairs_in = int(t["hits4"].sum())
        for groups, rec in ((4, "density_c32"), (1, "density_c32 groups 1")):
            line += time_kernel(
                stats, rec, tag,
                lambda g=groups: density.density_c32(*t["density_args"], groups=g),
                lambda g=groups: density.density_c32_torch(*t["density_args"], groups=g),
                density_work(t["density_args"], outs[rec], int(t["hits4"].sum())))
        for name, lists, qrows in (("forces_q32_c32", "q32", 32),
                                   ("forces_q128_c32", "q128", 128)):
            args = fargs + t[lists] + (t["params"],)
            line += time_kernel(stats, name, tag, lambda a=args, n=name: kernel_fn(n)(*a),
                                lambda a=args, n=name: getattr(forces, n + "_torch")(*a),
                                force_work(args, qrows, pairs_in))
    log(line)


def sub16_tables(state, params, engine, width):
    """The 16-wide force path's inputs for ``state``: (True, True, False)
    tables (``width`` 16) or (False, True, False) ones (32), hits at
    hit_sub 16 from the plain density, the 16-wide lists (capacities grown
    by the engine's rules, which must keep these tables) and the force
    pack."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    if width == 16:
        def plain(*args):
            return density.density_c16_torch(*args, hit_sub=16)
    else:
        def plain(*args):
            return density.density_c32_torch(*args, hit_sub=16)

    st, real, args, (dens, hits), (cand16, count16) = grown_tables(
        state, params, engine, plain, lambda cand, out, cfg: step.hit_lists(cand, out[1], cfg),
        fixed=lambda cfg: (cfg.density_sub16 == (width == 16) and cfg.force_sub16
                           and not cfg.force_sub8))
    f8 = force_pack_of(st, real, dens, params)
    return dict(density_args=args, dens_plain=dens, hits_plain=hits,
                force_args=(f8, dens, real, cand16, count16, params))


def compare_sub16_kernels(tag, t16, t32, stats, time_it):
    """The 16-wide force path's kernels against their plain versions:
    ``density_c16`` at hit_sub 16 with and without the dilated tile
    counts and ``forces_q32_c16`` on the (True, True, False) tables,
    ``density_c32`` at hit_sub 16 and ``forces_q32_c16`` on the (False,
    True, False) ones."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density, forces

    args16, args32 = t16["density_args"], t32["density_args"]
    params = args16[3]
    hit2_h = params.h * 1.25  # the build substep's (1 + cand_slack) h
    line = f"phase 2 {tag} (16-wide force path):"
    d, hits = density.density_c16(*args16, hit_sub=16)
    out16 = (d, hits)
    drel = check_density(tag, "density_c16 hit_sub 16", d, hits, t16["dens_plain"],
                         t16["hits_plain"], stats)
    line += f" density_c16 hit_sub 16 rel err {drel:.3g}, hits equal;"
    d, hits, tiles = density.density_c16(*args16, hit_sub=16, hit2_h=hit2_h)
    out_t = (d, hits, tiles)
    d0, hits0, tiles0 = density.density_c16_torch(*args16, hit_sub=16, hit2_h=hit2_h)
    drel = check_density(tag, "density_c16 hit_sub 16, hit2_h", d, hits, d0, hits0, stats)
    if not torch.equal(tiles, tiles0):
        raise RuntimeError(f"{tag}: {int((tiles != tiles0).sum())} tile counts differ")
    line += (f" with hit2_h rel err {drel:.3g}, hits and {tiles.numel()} tile counts equal "
             f"({int((tiles > 0).sum())} flagged);")
    d, hits = density.density_c32(*args32, hit_sub=16)
    out32 = (d, hits)
    drel = check_density(tag, "density_c32 hit_sub 16", d, hits, t32["dens_plain"],
                         t32["hits_plain"], stats)
    line += f" density_c32 hit_sub 16 rel err {drel:.3g}, hits equal;"
    for name, t in (("c16 tables", t16), ("c32 tables", t32)):
        a = forces.forces_q32_c16(*t["force_args"])
        aerr = check_accel(tag, "forces_q32_c16", a,
                           forces.forces_q32_c16_torch(*t["force_args"]), stats)
        line += f" forces_q32_c16 on {name} accel err {aerr:.3g};"
    if time_it:
        line += time_kernel(stats, "density_c16 hit_sub 16", tag,
                            lambda: density.density_c16(*args16, hit_sub=16),
                            lambda: density.density_c16_torch(*args16, hit_sub=16),
                            density_work(args16, out16, int(t16["hits_plain"].sum())))
        line += time_kernel(
            stats, "density_c16 hit_sub 16, hit2_h", tag,
            lambda: density.density_c16(*args16, hit_sub=16, hit2_h=hit2_h),
            lambda: density.density_c16_torch(*args16, hit_sub=16, hit2_h=hit2_h),
            density_work(args16, out_t, int(t16["hits_plain"].sum()), int(tiles0.sum())))
        line += time_kernel(stats, "density_c32 hit_sub 16", tag,
                            lambda: density.density_c32(*args32, hit_sub=16),
                            lambda: density.density_c32_torch(*args32, hit_sub=16),
                            density_work(args32, out32, int(t32["hits_plain"].sum())))
        fa = t16["force_args"]
        line += time_kernel(stats, "forces_q32_c16", tag,
                            lambda: forces.forces_q32_c16(*fa),
                            lambda: forces.forces_q32_c16_torch(*fa),
                            force_work(fa, 32, int(t16["hits_plain"].sum())))
    log(line)


def gated_inputs(tag, state, params, scene, engine):
    """``density_gated16``'s inputs three reuse substeps after a gated
    rebuild substep from ``state`` (inside the staleness guard): (pos4,
    carried table, counts, mask, params), and the largest move since the
    build in units of h."""
    import dataclasses

    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    cfg = dataclasses.replace(engine.step_config, density_gate=True)
    dt = torch.tensor(params.max_dt, dtype=torch.float32, device=state.device)
    s, dt, flags, tab = step.substep(state, dt, params, scene, cfg)
    for _ in range(3):
        s, dt, f, _ = step.substep(s, dt, params, scene, cfg, do_sort=False, cand_in=tab)
        flags = flags | f
    if int(flags):
        raise RuntimeError(f"{tag}: gated substeps raised flags {int(flags)}")
    st, real, _ = step.pad_and_sort(s, params, False)
    moved = torch.sqrt(torch.amax(torch.sum((st.position - tab[2]) ** 2, dim=1)[real]))
    if not 2.0 * float(moved) <= cfg.cand_slack * params.h:
        raise RuntimeError(f"{tag}: the state left the staleness guard")
    pos4 = density.pos_pack(st.position, real)
    return (pos4, tab[0].contiguous(), tab[1].contiguous(), tab[3], params), \
        float(moved) / params.h


def compare_gated(tag, state, params, scene, engine, stats, time_it):
    """``density_gated16`` against the ungated ``density_c16`` (hit_sub
    16) on the carried table and mask of a gated rebuild substep, three
    reuse substeps later (inside the staleness guard): density and hits
    bit for bit, and the plain gated version within tolerance."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density

    args, moved = gated_inputs(tag, state, params, scene, engine)
    pos4 = args[0]
    d, hits = density.density_gated16(*args)
    d0, hits0 = density.density_c16(*args[:3], params, hit_sub=16)
    torch.cuda.synchronize()
    if not (torch.equal(d, d0) and torch.equal(hits, hits0)):
        raise RuntimeError(f"{tag}: gated density differs from the ungated kernel's: "
                           f"{int((d != d0).sum())} densities, "
                           f"{int((hits != hits0).sum())} hit counts")
    dp, hp = density.density_gated16_torch(*args)
    drel = check_density(tag, "density_gated16", d, hits, dp, hp, stats)
    cap = args[1].shape[1]
    live = (torch.arange(cap, device=pos4.device)[None, None, :]
            < args[2][:, None, None]).expand(-1, 4, -1)
    panels = density.mask_panels(args[3], cap) & live
    share = float(panels.sum()) / float(live.sum())
    line = (f"phase 2 {tag}: density_gated16 three reuse substeps after its build "
            f"(largest move {moved:.4f} h): density and hits bit-equal "
            f"to density_c16 hit_sub 16; plain rel err {drel:.3g}; {share:.4f} of the "
            f"live (subgroup, slot) panels flagged;")
    if time_it:
        line += time_kernel(stats, "density_gated16", tag, lambda: density.density_gated16(*args),
                            lambda: density.density_gated16_torch(*args),
                            density_work(args, (args[3], d, hits), int(hits.sum())))
        ungated = cuda_ms(lambda: density.density_c16(*args[:3], params, hit_sub=16))
        line += f" ungated density_c16 hit_sub 16 on the same inputs {ungated:.4f} ms;"
    log(line)


def compare_qblock(tag, t_main, t_q, t16, t32, stats):
    """Every table-driven kernel through the query-block map on a tier-2
    pool (every 8th block, in reverse order) against its plain
    version."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density, forces

    pos4, cand16, count16, params = t_main["density_args"]
    nb = cand16.shape[0]
    pool = torch.arange(0, nb, 8, dtype=torch.int32, device=pos4.device).flip(0)
    li = pool.long()

    def rows(a, lists):
        r = (li[:, None] * lists + torch.arange(lists, device=a.device)).reshape(-1)
        return a[r].contiguous()

    def dargs(t):
        return (pos4, rows(t["density_args"][1], 1), rows(t["density_args"][2], 1), params)

    hit2_h = params.h * 1.25
    cases = [("density_c16", "density_c16", dargs(t_main), {}),
             ("density_c16 hit_sub 16", "density_c16", dargs(t16), dict(hit_sub=16)),
             ("density_c16 hit_sub 16, hit2_h", "density_c16", dargs(t16),
              dict(hit_sub=16, hit2_h=hit2_h)),
             ("density_c32", "density_c32", dargs(t_q), dict(groups=4)),
             ("density_c32 groups 1", "density_c32", dargs(t_q), dict(groups=1)),
             ("density_c32 hit_sub 16", "density_c32", dargs(t32), dict(hit_sub=16))]
    for rec, name, args, kw in cases:
        out = kernel_fn(name)(*args, qblock=pool, **kw)
        ref = getattr(density, name + "_torch")(*args, qblock=pool, **kw)
        check_density(tag, rec, out[0], out[1], ref[0], ref[1], stats)
        if len(out) > 2 and not torch.equal(out[2], ref[2]):
            raise RuntimeError(f"{tag} {rec}: tile counts differ through the map")

    def fargs(t, lists):
        f8, dens, real, cand, count = t[:5]
        return (f8, dens, real, rows(cand, lists), rows(count, lists))

    fcases = [("forces_q32_c8", fargs(t_main["force_args"], 4)),
              ("forces_q32_c16", fargs(t16["force_args"], 4)),
              ("forces_q32_c16", fargs(t32["force_args"], 4)),
              ("forces_q32_c32", fargs((t_q["f8"], t_q["dens_plain"], t_q["real"])
                                       + t_q["q32"], 4)),
              ("forces_q128_c32", fargs((t_q["f8"], t_q["dens_plain"], t_q["real"])
                                        + t_q["q128"], 1))]
    for name, args in fcases:
        a = kernel_fn(name)(*args, params, qblock=pool)
        check_accel(tag, name, a, getattr(forces, name + "_torch")(*args, params,
                                                                   qblock=pool), stats)
    log(f"phase 2 {tag}: every table-driven kernel and mode ({len(cases)} density, "
        f"{len(fcases)} force cases) through the query-block map on a pool of {len(li)} "
        f"of {nb} blocks matches its plain version")


def check_sums(tag, rec, got, want, stats) -> float:
    """Each of the ten raw force sums within rtol 1e-5 and atol 1e-5 of
    that sum's largest |value| (``stream.sums_error``); returns the
    largest difference."""
    import torch

    from libclsph_tpu_torch.ops.kernels import stream

    torch.cuda.synchronize()
    err, bad = stream.sums_error(got, want)
    if bad >= 0:
        raise RuntimeError(f"{tag} {rec}: sum {bad} off by more than 1e-5 of its scale "
                           f"(largest difference {err:.3g})")
    record_err(stats, rec, err)
    return err


def compare_stream(tag, t_main, t_q, t16, stats):
    """The stream kernels against their plain versions: ``gather_stream``
    in both layouts at 8 particles a slot (the main path's hit lists), 16
    (the 16-wide lists) and 32 (the q128 lists), bit for bit; then, on the
    q128 lists' stream, ``forces_c32_stream``'s sums (staged, planes, no
    cull) at :func:`check_sums`' tolerance, its accel mode bit for bit
    against ``forces_q128_c32`` on the same lists (else within 1e-5 *
    max|a|, the difference printed), its test mode's counts equal, and the
    zero-count control all zeros. No time is taken here: phase 13's
    bisect probe times these kernels, their plain versions and
    ``torch.index_select`` of the same rows, for the kernel record."""
    import torch

    from libclsph_tpu_torch.ops.kernels import forces, stream

    params = t_q["params"]
    visc = stream.stream_visc(params)
    cand, count = t_q["q128"]
    f8, dens, real = t_q["f8"], t_q["dens_plain"], t_q["real"]
    main, wide = t_main["force_args"], t16["force_args"]  # (f8, dens, real, cand, count, p)
    lists = {8: (main[0], main[3], main[4]), 16: (wide[0], wide[3], wide[4]),
             32: (f8, cand, count)}
    for sub, (f, c, n) in lists.items():
        for layout in stream.LAYOUTS:
            got = stream.gather_stream(f, c, n, sub, visc, layout)
            want = stream.gather_stream_torch(f, c, n, sub, visc, layout)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"{tag} gather_stream sub {sub} {layout}: "
                                   f"{int((got != want).sum())} floats differ")
            record_err(stats, "gather_stream" + ("" if layout == "staged" else " planes"),
                       0.0)
    del got, want
    live = int(count.sum()) * 32
    line = (f"phase 2 {tag} (stream kernels): gather_stream equal to its plain version at "
            f"sub 8, 16 and 32 in both layouts ({live} live records of "
            f"{cand.numel() * 32} on the q128 lists);")
    st = stream.gather_stream(f8, cand, count, 32, visc)
    planes = stream.gather_stream(f8, cand, count, 32, visc, "planes")
    args = (f8, dens, real)
    modes = {"forces_c32_stream sums": (st, {}),
             "forces_c32_stream planes": (planes, dict(layout="planes")),
             "forces_c32_stream no cull": (st, dict(cull=False))}
    for rec, (s_, kw) in modes.items():
        err = check_sums(tag, rec, stream.forces_c32_stream(*args, s_, count, params, **kw),
                         stream.forces_c32_stream_torch(*args, s_, count, params, **kw), stats)
        line += f" {rec} err {err:.3g};"
    del planes
    accel = stream.forces_c32_stream(*args, st, count, params, out="accel")
    fused = forces.forces_q128_c32(*args, cand, count, params)
    torch.cuda.synchronize()
    if torch.equal(accel.view(torch.int32), fused.view(torch.int32)):
        line += " forces_c32_stream accel bit-equal to forces_q128_c32;"
    else:
        d = float((accel - fused).abs().max())
        line += f" forces_c32_stream accel NOT bit-equal to forces_q128_c32: max diff {d:.3g};"
        check_accel(tag, "forces_c32_stream accel", accel, fused, stats)
    aerr = check_accel(tag, "forces_c32_stream accel", accel,
                       stream.forces_c32_stream_torch(*args, st, count, params, out="accel"),
                       stats)
    counts = stream.forces_c32_stream(*args, st, count, params, out="test")
    if not torch.equal(counts, stream.forces_c32_stream_torch(*args, st, count, params,
                                                              out="test")):
        raise RuntimeError(f"{tag} forces_c32_stream test: counts differ")
    record_err(stats, "forces_c32_stream test", 0.0)
    zero = stream.forces_c32_stream(*args, st, torch.zeros_like(count), params)
    if bool(zero.any()):
        raise RuntimeError(f"{tag} forces_c32_stream: the zero-count control summed")
    line += (f" accel err {aerr:.3g} against its plain version; test counts equal "
             f"({int(counts.sum())} pairs inside the support); the zero-count control sums "
             f"nothing")
    log(line)


def block_tables(state, params, engine):
    """The block-granular variants' inputs for ``state``: padded and
    sorted, the block search at h (max_candidates grown by the engine's
    rules until nothing is truncated), the table expanded to 32-wide
    subblocks, the plain density, the pairs inside the support (the
    kernel's hit counts at 4 groups over the expanded table; a launch made
    to count, which does not count) and the force pack."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import tiles
    from libclsph_tpu_torch.ops.kernels import blocks, density

    st, real, _ = step.pad_and_sort(state, params, True)
    nb = st.n // 128
    bmin, bmax = tiles.split_block_bounds(st.position.reshape(nb, 128, 3),
                                          real.reshape(nb, 128))
    for _ in range(6):
        cand, count, ovf = tiles.candidate_blocks_auto(bmin, bmax, params.h,
                                                       engine.step_config.max_candidates)
        if not engine._needs_rerun(ovf.to(torch.int32) * step.FLAG_CAPACITY):
            break
    else:
        raise RuntimeError("block capacity growth did not converge")
    pos4 = density.pos_pack(st.position, real)
    ids, counts = blocks.expand_block_table(cand, count)
    dens = blocks.density_blocks_torch(pos4, cand, count, params)
    saved = save_launches()
    pairs_in = int(density.density_c32(pos4, ids, counts, params, groups=4)[1].sum())
    restore_launches(saved)
    return dict(pos4=pos4, cand=cand, count=count, ids=ids, counts=counts, dens=dens,
                real=real, f8=force_pack_of(st, real, dens, params), pairs_in=pairs_in,
                params=params)


def compare_blocks(tag, t, stats):
    """``density_blocks`` and ``forces_blocks`` of the row, fine and asym
    variants against their plain versions on one block table; times and
    bounds over the expanded table's live slots."""
    import torch

    from libclsph_tpu_torch.ops.kernels import blocks

    p = t["params"]
    dargs = (t["pos4"], t["cand"], t["count"], p)
    fargs = (t["f8"], t["dens"], t["real"], t["cand"], t["count"], p)
    none = torch.zeros(0, dtype=torch.int32, device=t["pos4"].device)
    nb = t["cand"].shape[0]
    line = (f"phase 2 {tag} (block tables: {nb} blocks, {int(t['count'].sum())} live "
            f"candidate blocks, max {int(t['count'].max())}):")
    q_div = {"row": 1, "fine": 4, "asym": 1}  # the engine's choice per variant
    plain_a = blocks.forces_blocks_torch(*fargs)  # one function for every q_div
    for variant in BLOCK_VARIANTS:
        d = blocks.density_blocks(*dargs)
        drel = check_density(tag, f"density_blocks {variant}", d, none, t["dens"], none, stats)
        a = blocks.forces_blocks(*fargs, q_div[variant])
        aerr = check_accel(tag, f"forces_blocks {variant}", a, plain_a, stats)
        line += f" {variant} density rel err {drel:.3g}, accel err {aerr:.3g};"
    del plain_a
    ids, counts = t["ids"], t["counts"]
    for variant in BLOCK_VARIANTS:
        line += time_kernel(
            stats, f"density_blocks {variant}", tag,
            lambda: blocks.density_blocks(*dargs),
            lambda: blocks.density_blocks_torch(*dargs),
            density_work((t["pos4"], ids, counts), (t["dens"],), t["pairs_in"]),
            plain_reps=BLOCK_PLAIN_REPS)
        line += time_kernel(
            stats, f"forces_blocks {variant}", tag,
            lambda q=q_div[variant]: blocks.forces_blocks(*fargs, q),
            lambda q=q_div[variant]: blocks.forces_blocks_torch(*fargs, q),
            force_work(fargs[:3] + (ids, counts), 128, t["pairs_in"]),
            plain_reps=BLOCK_PLAIN_REPS)
    log(line)


def asm_tables(state, params, engine):
    """The asm variant's inputs for ``state``: the 32-wide refined table
    at h, hits per block from the plain density at 1 group, the block
    hit lists at max_candidates_hit (capacities grown by the engine's
    rules) and the force pack."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    def plain(*args):
        return density.density_c32_torch(*args, groups=1)

    st, real, args, (dens, hits1), lists = grown_tables(
        state, params, engine, plain,
        lambda cand, out, cfg: step.hit_lists(cand, out[1], cfg, 1),
        fixed=lambda cfg: cfg.pallas_variant == "asm")
    saved = save_launches()
    pairs_in = int(density.density_c32(*args, groups=4)[1].sum())
    restore_launches(saved)
    return dict(density_args=args, dens=dens, hits1=hits1, pairs_in=pairs_in,
                force_args=(force_pack_of(st, real, dens, params), dens, real) + tuple(lists)
                + (params,))


def compare_asm(tag, t, stats):
    """The asm route's two kernels against their plain versions."""
    from libclsph_tpu_torch.ops.kernels import density, forces

    args, fargs = t["density_args"], t["force_args"]
    d, hits = density.density_c32(*args, groups=1)
    drel = check_density(tag, "density_c32 groups 1 (asm)", d, hits, t["dens"], t["hits1"],
                         stats)
    a = forces.forces_q128_c32(*fargs)
    aerr = check_accel(tag, "forces_q128_c32 (asm)", a, forces.forces_q128_c32_torch(*fargs),
                       stats)
    line = (f"phase 2 {tag} (asm tables): density_c32 groups 1 rel err {drel:.3g}, hits "
            f"equal; forces_q128_c32 accel err {aerr:.3g};")
    line += time_kernel(stats, "density_c32 groups 1 (asm)", tag,
                        lambda: density.density_c32(*args, groups=1),
                        lambda: density.density_c32_torch(*args, groups=1),
                        density_work(args, (d, hits), t["pairs_in"]))
    line += time_kernel(stats, "forces_q128_c32 (asm)", tag,
                        lambda: forces.forces_q128_c32(*fargs),
                        lambda: forces.forces_q128_c32_torch(*fargs),
                        force_work(fargs, 128, t["pairs_in"]))
    log(line)


def pair_count(pos4, cand, count, params, rows) -> int:
    """Pairs with r^2 < h^2 between each list's ``rows`` queries and its
    live candidates (32-particle subblocks): the work the bound counts.
    Chunked over lists."""
    import torch

    h2 = float(params.h) ** 2
    nq, cap = cand.shape
    lane = torch.arange(32, device=pos4.device)
    qlane = torch.arange(rows, device=pos4.device)
    step_rows = max(1, (1 << 24) // (rows * cap * 32))
    total = 0
    for b0 in range(0, nq, step_rows):
        b1 = min(nq, b0 + step_rows)
        live = torch.arange(cap, device=pos4.device)[None, :] < count[b0:b1, None]
        ids = (torch.where(live, cand[b0:b1], 0).long()[..., None] * 32 + lane)
        c = pos4[ids][:, None, :, :, :3]  # (r, 1, cap, 32, 3)
        q = pos4[(torch.arange(b0, b1, device=pos4.device)[:, None] * rows + qlane)][
            :, :, None, None, :3]
        d = q - c
        r2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        total += int(((r2 < h2) & live[:, None, :, None]).sum())
    return total


def rows_tables(state, params, engine, compact=True):
    """The finer query blocks' inputs for ``state`` at
    ``engine.step_config`` (q_rows 64 or 32; the asm variant too): the
    32-wide refined table of lists that serve q_rows queries, the plain
    density with block counts (``compact``) or densities only, the
    compacted force lists (or the full refined lists), the pairs inside
    the support and the force pack."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    rows = engine.step_config.q_rows
    groups = 1 if compact else 0

    def plain(*args):
        return density.density_c32_torch(*args, groups=groups, rows=rows)

    def lists(cand, out, cfg):
        return step.hit_lists(cand, out[1], cfg, 1) if compact else (None, None, 0)

    st, real, args, (dens, hits), made = grown_tables(
        state, params, engine, plain, lists, fixed=lambda cfg: cfg.q_rows == rows)
    cand_f, count_f = made if compact else args[1:3]
    return dict(rows=rows, groups=groups, density_args=args, dens=dens, hits=hits,
                pairs_in=pair_count(*args[:3], params, rows),
                force_args=(force_pack_of(st, real, dens, params), dens, real,
                            cand_f.contiguous(), count_f.contiguous(), params))


def compare_rows(tag, t, stats, drec, frec, time_it=True):
    """``density_c32`` and ``forces_q128_c32`` at the table's rows against
    their plain versions; times and bounds under ``drec`` and ``frec``
    (None: checked, not timed)."""
    from libclsph_tpu_torch.ops.kernels import density, forces

    rows, groups = t["rows"], t["groups"]
    args, fargs = t["density_args"], t["force_args"]
    d, hits = density.density_c32(*args, groups=groups, rows=rows)
    drel = check_density(tag, drec, d, hits, t["dens"], t["hits"], stats)
    line = (f"phase 2 {tag} ({rows}-row lists, {args[1].shape[0]} of them, "
            f"{int(args[2].sum())} live slots): {drec} rel err {drel:.3g}, hits equal;")
    if frec is not None:
        a = forces.forces_q128_c32(*fargs, rows=rows)
        aerr = check_accel(tag, frec, a, forces.forces_q128_c32_torch(*fargs, rows=rows),
                           stats)
        line += f" {frec} accel err {aerr:.3g};"
    if time_it:
        line += time_kernel(stats, drec, tag,
                            lambda: density.density_c32(*args, groups=groups, rows=rows),
                            lambda: density.density_c32_torch(*args, groups=groups,
                                                              rows=rows),
                            density_work(args, (d, hits), t["pairs_in"]))
        if frec is not None:
            line += time_kernel(stats, frec, tag,
                                lambda: forces.forces_q128_c32(*fargs, rows=rows),
                                lambda: forces.forces_q128_c32_torch(*fargs, rows=rows),
                                force_work(fargs, rows, t["pairs_in"]))
    log(line)


def compare_block64(tag, state, params, engine, stats):
    """``density_blocks`` and ``forces_blocks`` of the row variant at
    block_size 64 (64-row lists over the expanded block table) against
    their plain versions, timed."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import tiles
    from libclsph_tpu_torch.ops.kernels import blocks, density

    b = engine.step_config.block_size
    st, real, _ = step.pad_and_sort(state, params, True, block_size=b)
    nb = st.n // b
    bmin, bmax = tiles.split_block_bounds(st.position.reshape(nb, b, 3), real.reshape(nb, b))
    for _ in range(6):
        cand, count, ovf = tiles.candidate_blocks_auto(bmin, bmax, params.h,
                                                       engine.step_config.max_candidates)
        if not engine._needs_rerun(ovf.to(torch.int32) * step.FLAG_CAPACITY):
            break
    else:
        raise RuntimeError("block capacity growth did not converge")
    pos4 = density.pos_pack(st.position, real)
    dargs = (pos4, cand, count, params)
    dens = blocks.density_blocks_torch(*dargs, block=b)
    fargs = (force_pack_of(st, real, dens, params), dens, real, cand, count, params)
    none = torch.zeros(0, dtype=torch.int32, device=pos4.device)
    d = blocks.density_blocks(*dargs, block=b)
    drel = check_density(tag, "density_blocks row, block 64", d, none, dens, none, stats)
    a = blocks.forces_blocks(*fargs, block=b)
    aerr = check_accel(tag, "forces_blocks row, block 64", a,
                       blocks.forces_blocks_torch(*fargs, block=b), stats)
    ids, counts = blocks.expand_block_table(cand, count, b)
    pairs = pair_count(pos4, ids, counts, params, b)
    line = (f"phase 2 {tag} (block_size {b} block table: {nb} blocks, "
            f"{int(count.sum())} live candidate blocks): density rel err {drel:.3g}, "
            f"accel err {aerr:.3g};")
    line += time_kernel(stats, "density_blocks row, block 64", tag,
                        lambda: blocks.density_blocks(*dargs, block=b),
                        lambda: blocks.density_blocks_torch(*dargs, block=b),
                        density_work((pos4, ids, counts), (dens,), pairs),
                        plain_reps=BLOCK_PLAIN_REPS)
    line += time_kernel(stats, "forces_blocks row, block 64", tag,
                        lambda: blocks.forces_blocks(*fargs, block=b),
                        lambda: blocks.forces_blocks_torch(*fargs, block=b),
                        force_work(fargs[:3] + (ids, counts), b, pairs),
                        plain_reps=BLOCK_PLAIN_REPS)
    log(line)


def compare_all_rows(tag, state, params, engine_for, stats):
    """Phase 2's finer-query-block checks on one state: nl at 64 and 32
    rows (block counts and compacted lists), nl at 32 rows without hit
    compaction (densities only, full lists), asm at 32 rows, and the row
    variant at block_size 64."""
    cell = tag.split()[0]
    for rows in (64, 32):
        eng = engine_for(cell, dict(Q_PATH_ROWS, nl_query_rows=rows))
        compare_rows(tag, rows_tables(state, params, eng), stats,
                     f"density_c32 groups 1, rows {rows}", f"forces_q128_c32 rows {rows}")
    full = engine_for(cell, dict(Q_PATH_ROWS, nl_query_rows=32, hit_compact=False))
    compare_rows(tag, rows_tables(state, params, full, compact=False), stats,
                 "density_c32 densities only, rows 32", None)
    asm = engine_for(cell, dict(Q_PATH_ROWS, pallas_variant="asm", nl_query_rows=32))
    compare_rows(tag, rows_tables(state, params, asm), stats,
                 "density_c32 groups 1, rows 32 (asm)", "forces_q128_c32 rows 32 (asm)")
    compare_block64(tag, state, params, engine_for(cell, dict(
        pallas_variant="row", block_size=64, cand_interval=1)), stats)


def centred_pos4(pos4):
    """``pos4`` and its positions less the domain centre of its real rows
    (engine.step.domain_center), the identity mode's pack, and the
    centre."""
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import density

    real = pos4[:, 3] > 0
    center = step.domain_center(pos4[:, :3], real)
    return density.pos_pack(pos4[:, :3], real, center), center


def centred_f8(f8, center):
    import torch

    return torch.cat([f8[:, :3] - center, f8[:, 3:]], dim=1).contiguous()


def mxu_cases(t_main, t_q, t16, t32, t_rows):
    """Phase 2's identity-mode cases on one state's tables, centred:
    (record, kernel name, density args or force args, keyword arguments,
    pairs inside the support (the direct form's count), query rows of a
    force list or None for a density)."""
    cases = []

    def dens(rec, name, args, pairs, **kw):
        pos4, center = centred_pos4(args[0])
        cases.append((rec, name, (pos4,) + tuple(args[1:]), kw, pairs, None))
        return center

    def force(rec, name, fargs, center, qrows, pairs, **kw):
        cases.append((rec, name, (centred_f8(fargs[0], center),) + tuple(fargs[1:]), kw,
                      pairs, qrows))

    pairs = int(t_main["hits_plain"].sum())
    c = dens("density_c16 mxu", "density_c16", t_main["density_args"], pairs)
    force("forces_q32_c8 mxu", "forces_q32_c8", t_main["force_args"], c, 32, pairs)
    pairs = int(t16["hits_plain"].sum())
    c = dens("density_c16 hit_sub 16 mxu", "density_c16", t16["density_args"], pairs,
             hit_sub=16)
    dens("density_c16 hit_sub 16, hit2_h mxu", "density_c16", t16["density_args"], pairs,
         hit_sub=16, hit2_h=t16["density_args"][3].h * 1.25)
    force("forces_q32_c16 mxu", "forces_q32_c16", t16["force_args"], c, 32, pairs)
    dens("density_c32 hit_sub 16 mxu", "density_c32", t32["density_args"],
         int(t32["hits_plain"].sum()), hit_sub=16)
    pairs = int(t_q["hits4"].sum())
    c = dens("density_c32 mxu", "density_c32", t_q["density_args"], pairs, groups=4)
    dens("density_c32 groups 1 mxu", "density_c32", t_q["density_args"], pairs, groups=1)
    qf = (t_q["f8"], t_q["dens_plain"], t_q["real"])
    force("forces_q32_c32 mxu", "forces_q32_c32", qf + t_q["q32"] + (t_q["params"],), c, 32,
          pairs)
    force("forces_q128_c32 mxu", "forces_q128_c32", qf + t_q["q128"] + (t_q["params"],), c,
          128, pairs)
    for rows, t in t_rows.items():
        c = dens(f"density_c32 groups 1, rows {rows} mxu", "density_c32",
                 t["density_args"], t["pairs_in"], groups=1, rows=rows)
        force(f"forces_q128_c32 rows {rows} mxu", "forces_q128_c32", t["force_args"], c,
              rows, t["pairs_in"], rows=rows)
    return cases


def compare_mxu(tag, cases, stats):
    """Each identity-mode case against its plain version in the mode on
    the same centred inputs (densities rtol 1e-5, every hit and tile
    count equal, accelerations atol 1e-5 * max|a|), then timed beside the
    direct mode on the same inputs in turns (direct, identity, direct)
    by CUDA events; the identity mode's record takes its time, plain
    time and bound (the pairs counted as the direct form's: the two
    differ only in the identity's band of h^2, and each pair's r^2 is 8
    operations in both)."""
    import torch

    from libclsph_tpu_torch.ops.kernels import density, forces

    for rec, name, args, kw, pairs, qrows in cases:
        fn = kernel_fn(name)
        plain = getattr(density if qrows is None else forces, name + "_torch")
        out = fn(*args, r2_mxu=True, **kw)
        ref = plain(*args, r2_mxu=True, **kw)
        if qrows is None:
            err = check_density(tag, rec, out[0], out[1], ref[0], ref[1], stats)
            if len(out) > 2 and not torch.equal(out[2], ref[2]):
                raise RuntimeError(f"{tag} {rec}: tile counts differ")
            work = density_work(args, out, pairs)
            what = f"rel err {err:.3g}, {int(out[1].sum())} hits equal"
        else:
            err = check_accel(tag, rec, out, ref, stats)
            work = force_work(args, qrows, pairs)
            what = f"accel err {err:.3g}"
        vpu_a = cuda_ms(lambda: fn(*args, **kw))
        frag = time_kernel(stats, rec, tag, lambda: fn(*args, r2_mxu=True, **kw),
                           lambda: plain(*args, r2_mxu=True, **kw), work)
        vpu_b = cuda_ms(lambda: fn(*args, **kw))
        stats[rec]["vpu_ms"] = (vpu_a + vpu_b) / 2
        log(f"phase 2 {tag} identity mode: {what};{frag} direct mode on the same inputs "
            f"{vpu_a:.4f}, {vpu_b:.4f} ms")


def sort_device_us(keys, vals, sorts=5) -> dict:
    """Device time of each kernel of the radix sort (microseconds a
    launch, by kernel) under torch.profiler over ``sorts`` sorts. The
    CUDA-event time of a sort also holds the wrapper's host work and the
    gaps between the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libclsph_tpu_torch.ops import radix_sort

    radix_sort.radix_sort_key_val(keys, vals)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(sorts):
            radix_sort.radix_sort_key_val(keys, vals)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for name in ("radix_histogram", "radix_pass", "radix_gather"):
            if name in e.key and e.count:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / e.count
    return out


def sort_keys(kind, n, dev):
    """The timed sorts' keys: the Morton codes of the n-particle cube
    lattice (bench64k.json at n) or n uniform random 30-bit keys from a
    fixed seed."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.ops import grid

    if kind == "random":
        gen = torch.Generator(device=dev).manual_seed(n)
        return torch.randint(0, 1 << 30, (n,), generator=gen, device=dev, dtype=torch.int32)
    p = water_params(n)
    pos = init_state(p, dev).position
    return grid.locate_in_grid(pos, grid.compute_bounds(pos, p))


def compare_radix(tag, stats, dev):
    """The radix sort (its kernels) against ``torch.sort(stable=True)``
    and against its plain version, bit for bit, with either apply, on the
    Morton codes of the cube lattice and on uniform random 30-bit keys,
    at each count of SORT_KEYS; times of the sort and ``torch.sort`` in
    turns (torch, radix, radix, torch), the plain version's at 1M, and
    the kernels' device time a launch."""
    import torch

    from libclsph_tpu_torch.ops import radix_sort
    from libclsph_tpu_torch.ops.kernels import radix

    passes = len(radix.passes(radix_sort.MORTON_BITS, 5))
    line = f"phase 2 {tag} (radix sort, 30-bit keys, {passes} passes of 5 bits):"
    for n in SORT_KEYS:
        for kind in ("Morton", "random"):
            keys = sort_keys(kind, n, dev)
            iota = torch.arange(n, dtype=torch.int32, device=dev)
            sk, order = torch.sort(keys, stable=True)
            order = order.to(torch.int32)
            plain = radix.radix_sort_torch(keys, iota, radix_sort.MORTON_BITS, 5, "scatter")
            for apply in radix.APPLY:
                k, v = radix_sort.radix_sort_key_val(keys, iota, apply=apply)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in ((k, sk), (v, order), (k, plain[0]),
                                                          (v, plain[1]))):
                    raise RuntimeError(f"{tag}: the radix sort ({apply}) of {n} {kind} keys "
                                       f"differs from torch.sort or its plain version")
            del plain
            turns = [(name, cuda_ms(fn)) for name, fn in (
                ("torch", lambda: torch.sort(keys, stable=True)),
                ("radix", lambda: radix_sort.radix_sort_key_val(keys, iota)),
                ("radix", lambda: radix_sort.radix_sort_key_val(keys, iota)),
                ("torch", lambda: torch.sort(keys, stable=True)))]
            ms = {name: statistics.mean(t for other, t in turns if other == name)
                  for name in ("radix", "torch")}
            device = sort_device_us(keys, iota)
            line += (f" {n} {kind} keys: radix {ms['radix']:.4f} ms, torch.sort(stable=True) "
                     f"{ms['torch']:.4f} ms (turns {', '.join(f'{t:.4f}' for _, t in turns)}), "
                     f"bit-identical to both and to the plain version, either apply; device us "
                     f"a launch {json.dumps({k: round(v, 3) for k, v in device.items()})};")
            if n == N_BENCH and kind == "Morton":
                plain_ms = cuda_ms(lambda: radix.radix_sort_torch(
                    keys, iota, radix_sort.MORTON_BITS, 5, "scatter"))
                work = (SORT_BYTES_PER_KEY_PASS * n * passes, 0)
                stats["radix_sort"]["bench"] = (ms["radix"], plain_ms) + work
                stats["radix_sort"]["library_ms"] = ms["torch"]
                line += (f" plain {plain_ms:.4f} ms, bound {bound(*work)[0]:.4f} ms by "
                         f"bytes;")
    record_err(stats, "radix_sort", 0.0)
    log(line)


def substep_ms(st, dt, params, scene, cfg, reps=5):
    """Median ms of one rebuild substep and of one reuse substep on its
    tables, from the same state (host clock around synchronised
    substeps)."""
    from libclsph_tpu_torch.engine import step

    def timed(fn):
        times = []
        for _ in range(reps):
            sync(st.device)
            t0 = time.perf_counter()
            fn()
            sync(st.device)
            times.append(1000.0 * (time.perf_counter() - t0))
        return statistics.median(times)

    s1, d1, _, tab = step.substep(st, dt, params, scene, cfg)
    rebuild = timed(lambda: step.substep(st, dt, params, scene, cfg))
    reuse = timed(lambda: step.substep(s1, d1, params, scene, cfg, do_sort=False,
                                       cand_in=tab))
    return rebuild, reuse


def phase4b_sub16(s1m, params, scene, engine, card):
    """The 1M cube dam-break on the 16-wide force path (True, True,
    False) as phase 4 runs it, then with the gated reuse density from the
    same warm state; a growth rule that leaves the 16-wide tables fails
    the phase."""
    import dataclasses

    import torch

    def require_16_wide(cfg):
        if not (cfg.density_sub16 and cfg.force_sub16 and not cfg.force_sub8):
            raise RuntimeError(f"phase 4b: the growth rules left the 16-wide tables: {cfg}")

    t0 = time.perf_counter()
    st, dt = warm_up(s1m, params, scene, engine, WARMUP_STEPS)
    torch.cuda.synchronize()
    require_16_wide(engine.step_config)
    log(f"phase 4b warm-up: {time.perf_counter() - t0:.2f} s, config {engine.step_config}")
    # ungated and gated windows in turns from the same warm state, so the
    # two are compared on one card under the same conditions
    cfg = engine.step_config
    gate = engine_with(engine, dataclasses.replace(cfg, density_gate=True))
    reuse = TIMED_STEPS - -(-TIMED_STEPS // cfg.cand_interval)
    ms = {"ungated": [], "gated": []}
    for which in ("ungated", "gated", "gated", "ungated"):
        eng = engine if which == "ungated" else gate
        _, _, t, got = timed_window(f"phase 4b {which}", st, dt, params, scene, eng,
                                    TIMED_STEPS, read_launches)
        require_16_wide(eng.step_config)
        densities = (got["density_c16 hit_sub 16"] + got["density_c16 hit_sub 16, hit2_h"]
                     + got["density_gated16"])
        if min(got["forces_q32_c16"], densities) < TIMED_STEPS:
            raise RuntimeError(f"phase 4b {which}: the 16-wide kernels launched {got}")
        gated = got["density_gated16"]
        if which == "gated" and (gated != reuse or got["density_c16 hit_sub 16, hit2_h"] < 1):
            raise RuntimeError(f"phase 4b gated: {gated} gated launches for {reuse} reuse "
                               f"substeps ({got})")
        if which == "ungated" and gated:
            raise RuntimeError(f"phase 4b ungated: density_gated16 launched {gated} times")
        ms[which].append(t)
    mean = {k: statistics.mean(v) for k, v in ms.items()}
    log(f"phase 4b bench (16-wide force path): {N_BENCH} particles, {TIMED_STEPS} "
        f"substeps, {mean['ungated']:.3f} ms/substep (windows {ms['ungated'][0]:.3f}, "
        f"{ms['ungated'][1]:.3f}), {N_BENCH * 1e3 / mean['ungated']:.6g} particle-steps/s, "
        f"timed_flags 0, forces_q32_c16 on every substep, config {engine.step_config}; "
        f"card {card}")
    a, _, fa = run_substeps(st, dt, params, scene, engine.step_config, 8)
    b, _, fb = run_substeps(st, dt, params, scene, gate.step_config, 8)
    torch.cuda.synchronize()
    if int(fa) or int(fb):
        raise RuntimeError(f"phase 4b: flags {int(fa)} / {int(fb)} in the 8-substep runs")
    if not (torch.equal(a.position, b.position) and torch.equal(a.density, b.density)):
        raise RuntimeError("phase 4b: the gated run's positions differ from the ungated run's "
                           f"after 8 substeps (max {float((a.position - b.position).abs().max())})")
    times = {name: substep_ms(st, dt, params, scene, c)
             for name, c in (("ungated", engine.step_config), ("gated", gate.step_config))}
    log(f"phase 4b gated: {mean['gated']:.3f} ms/substep (windows {ms['gated'][0]:.3f}, "
        f"{ms['gated'][1]:.3f}; ungated {mean['ungated']:.3f}), timed_flags 0, "
        f"density_gated16 launched on all {reuse} reuse substeps of each window; positions "
        f"and densities bit-equal to the ungated run after 8 substeps; rebuild / reuse "
        f"substep ms (median of 5): ungated {times['ungated'][0]:.3f} / "
        f"{times['ungated'][1]:.3f}, gated {times['gated'][0]:.3f} / {times['gated'][1]:.3f}; "
        f"card {card}")
    return mean["ungated"]


def engine_with(engine, cfg):
    """A second engine on ``engine``'s device with ``cfg`` (its own
    capacity growth)."""
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    return SPHSimulation(cfg, device=engine.device, pretune=False)


def phase5_two_tier(state, params, scene):
    """A single-tier substep at full subblock capacity against a two-tier
    one whose base capacity lies below the heavy blocks, for the main,
    the two 16-wide and the q-granular configs, on ``state``."""
    import dataclasses

    import numpy as np
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops.kernels import forces

    dt = torch.tensor(params.max_dt, dtype=torch.float32, device=state.device)
    st, real, _ = step.pad_and_sort(state, params, True)
    for name, base in (("main", dict(max_candidates_hit8=192)),
                       ("16-wide c16", SUB16),
                       ("16-wide c32", dict(FTF, max_candidates_hit=256)),
                       ("q-granular", dict(Q_PATH, max_candidates_hit=256))):
        cfg = step.StepConfig(**base)
        wide = dataclasses.replace(cfg, max_candidates_sub=1 << 14)
        counts = step.build_candidates(st, real, params, wide)[1].cpu().numpy()
        c1 = int(np.percentile(counts, 75))
        heavy = int((counts > c1).sum())
        if not heavy:
            raise RuntimeError(f"phase 5 {name}: no block above the base capacity {c1}")
        mult = 2
        while c1 * mult < counts.max():
            mult *= 2
        nb = len(counts)
        frac = next(k for k in (8, 4, 2, 1) if -(-nb // k) >= heavy)
        single = dataclasses.replace(cfg, max_candidates_sub=c1 * mult)
        two = dataclasses.replace(cfg, max_candidates_sub=c1, tier2_frac=frac,
                                  tier2_mult=mult)
        s1, _, f1, _ = step.substep(state, dt, params, scene, single)
        before = (forces.forces_q128_c32.launches, forces.forces_q32_c16.launches)
        s2, _, f2, _ = step.substep(state, dt, params, scene, two)
        torch.cuda.synchronize()
        q128 = forces.forces_q128_c32.launches - before[0]
        c16 = forces.forces_q32_c16.launches - before[1]
        if int(f1) or int(f2):
            raise RuntimeError(f"phase 5 {name}: flags {int(f1)} / {int(f2)}")
        same = torch.equal(s1.density, s2.density)
        drel = float(((s1.density - s2.density).abs() / s1.density.abs()).max())
        aerr = float((s1.acceleration - s2.acceleration).abs().max())
        amax = float(s1.acceleration.abs().max())
        if not same or not aerr <= 1e-5 * amax:
            raise RuntimeError(f"phase 5 {name}: density rel err {drel:.3g}, "
                               f"accel err {aerr:.3g} (max|a| {amax:.3g})")
        if not cfg.density_sub16 and q128 <= 0:
            raise RuntimeError(f"phase 5 {name}: forces_q128_c32 did not launch in tier 2")
        if cfg.density_sub16 and not cfg.force_sub8 and c16 < 2:
            raise RuntimeError(f"phase 5 {name}: forces_q32_c16 did not run both tiers")
        hits = two_tier_hits(st, real, params, two)
        log(f"phase 5 two-tier {name}: {nb} blocks, base cap {c1}, {heavy} heavy blocks "
            f"in a pool of {-(-nb // frac)} (tier2_frac {frac}, tier2_mult {mult}); "
            f"density bitwise equal to the single-tier run at cap {c1 * mult}; accel err "
            f"{aerr:.3g} (max|a| {amax:.6g}); two-tier launches forces_q128_c32 {q128}, "
            f"forces_q32_c16 {c16}; {hits}")


def two_tier_hits(st, real, params, cfg):
    """The hit counts of both tiers (route_overflow's split of the
    tier-2-width table, tier 2 through the query-block map) against the
    single-tier kernel over the whole table, each tier at its own hit
    rows and width (the substep's ``_density_pass``): tier-1 rows equal
    its rows on their first c1 slots, routed rows are zero in tier 1,
    and tier 2 equals its routed rows."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import tiles
    from libclsph_tpu_torch.ops.kernels import density

    saved = save_launches()  # launches made to compare do not count
    cand, count, _ = step.build_candidates(st, real, params, cfg)
    pos4 = density.pos_pack(st.position, real)
    nb, c1 = cand.shape[0], cfg.max_candidates_sub
    idx, used, count1, _ = tiles.route_overflow(count, c1, -(-nb // cfg.tier2_frac))
    li = idx.long()
    cand2 = cand[li].contiguous()
    count2 = torch.where(used, count[li], 0).to(torch.int32)
    g1, g2 = step._groups(cfg, 1), step._groups(cfg, 2)

    def run(cand_, count_, g, **kw):
        return step._density_pass(pos4, cand_, count_, params, cfg, g, **kw)[1].reshape(
            cand_.shape[0], g, -1)

    width = c1 * cfg.subblock // cfg.hit_width(g1)  # hit columns of c1 slots
    whole1 = run(cand, count, g1)
    whole2 = run(cand, count, g2)
    tier1 = run(cand[:, :c1], count1, g1)
    tier2 = run(cand2, count2, g2, qblock=idx)
    heavy = count > c1
    ok1 = torch.equal(tier1[~heavy], whole1[~heavy][..., :width]) and not bool(
        tier1[heavy].any())
    ok2 = torch.equal(tier2[used], whole2[li][used])
    restore_launches(saved)
    if not (ok1 and ok2):
        raise RuntimeError(f"phase 5: two-tier hit counts differ (tier 1 {ok1}, tier 2 {ok2})")
    return (f"hits equal: tier 1 on {int((~heavy).sum())} rows, tier 2 on "
            f"{int(used.sum())} routed rows")


def phase3c_fidelity(dev):
    """torch_fidelity_64k's comparison at N_FIDELITY particles: settled
    SETTLE substeps on the main path, then one substep's density and
    acceleration against the float64 oracle; fails at the 1e-4 RMS bar."""
    import torch_fidelity_64k as fid

    r = fid.measure(dev, N_FIDELITY)
    log(f"phase 3c fidelity: {N_FIDELITY} particles settled {fid.SETTLE} substeps; against "
        f"the float64 oracle {json.dumps(r)}; bar {fid.BAR}")
    if not fid.passes(r):
        raise RuntimeError(f"phase 3c: density or accel RMS relative error at or above "
                           f"{fid.BAR}: {r}")


def phase4_syncs(st, dt, params, scene, cfg, steps=8):
    """The synchronising calls (``set_sync_debug_mode``) of ``steps``
    substeps from the warm 1M state: bench_torch's cadence and one frame
    dispatch with time to spare (each run once before it is counted).
    Returns {run: (calls, the layer's host reads)}; the acceptance is at
    most one call a candidate period, plus the dispatch's own read."""
    import torch

    from libclsph_tpu_torch.engine import step

    cfg = dataclasses.replace(cfg, substeps_per_dispatch=steps)
    far = torch.tensor(3.0e38, dtype=torch.float32, device=st.device)
    runs = {"bench cadence": lambda h: run_substeps(st, dt, params, scene, cfg, steps, host=h),
            "frame dispatch": lambda h: step.frame(st, dt, far, params, scene, cfg, None, h)}
    out = {}
    for name, fn in runs.items():
        fn({})
        sync(st.device)
        host = {}
        _, calls = sync_calls(lambda: fn(host))
        sync(st.device)
        if host["events"]:
            raise RuntimeError(f"phase 4 syncs: {name} stopped {host['events']}")
        limit = steps // cfg.cand_interval + (name == "frame dispatch")
        if len(calls) > limit:
            raise RuntimeError(f"phase 4 syncs: {name} made {len(calls)} synchronising calls "
                               f"in {steps} substeps (limit {limit}): {calls}")
        out[name] = (len(calls), host["reads"])
        log(f"phase 4 syncs, {name}: {len(calls)} synchronising calls in {steps} substeps "
            f"({len(calls) / steps:.3f} a substep; {host['reads']} host reads of the dispatch "
            f"layer): {sorted(set(calls))}")
    return out


def run_tree(tree, script, *args, timeout=600) -> dict:
    """``script`` of the checkout ``tree`` in a process of its own on the
    card (cwd ``tree``, so that it builds and loads that tree's kernels);
    its last line of output is its JSON record."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "LIBCLSPH_TPU_SORT"}
    out = subprocess.run([sys.executable, os.path.join(tree, script), *args],
                         capture_output=True, text=True, cwd=tree, env=env, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}/{script} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


# phase 4c: phase 4's profiler breakdown of one 1M rebuild and one reuse
# substep, run in another checkout (cwd) with that checkout's code
PROFILE_SCRIPT = """
import sys, tempfile
sys.path[:0] = ['.', 'experiments']
import bench_torch, chip_smoke as cs
from libclsph_tpu_torch.core.state import init_state
from libclsph_tpu_torch.engine import step
from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
dev = configure_device('cuda')
p = cs.water_params(cs.N_BENCH)
scene = cs.cube_scene(p, dev)
eng = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
st, dt = bench_torch.warm_up(init_state(p, dev), p, scene, eng, cs.WARMUP_STEPS,
                             window=cs.TIMED_STEPS)
with tempfile.TemporaryDirectory() as tmp:
    cs.phase4_profile(tmp, st, dt, p, scene, eng.step_config)
"""


def phase4c_parent(parent, card):
    """Phase 4c: the 1M cube's ms/substep (``bench_torch.py`` at its
    defaults, 20 timed substeps) and the 64k end to end's s/frame with
    export (``experiments/torch_e2e_64k.py``, E2E_FRAMES frames) of the
    parent checkout ``parent`` and of this tree, in turns (parent, change,
    change, parent), each run a process of its own on the card; without a
    parent, this tree's alone, once. Recorded, not gated."""
    trees = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    if parent is None:
        log("phase 4c: no parent checkout (--parent, or build/parent): this tree alone")
        trees = [("change", ROOT)]
    runs = []
    for name, tree in trees:
        bench = run_tree(tree, "bench_torch.py", "--json-only")
        e2e = run_tree(tree, os.path.join("experiments", "torch_e2e_64k.py"), "--frames",
                       str(E2E_FRAMES))
        runs.append(dict(tree=name, ms_per_substep=bench["detail"]["ms_per_step"],
                         host_reads_per_substep=bench["detail"].get("host_reads_per_substep"),
                         timed_flags=bench["detail"]["timed_flags"],
                         e2e_median_s=e2e["median_s_per_frame"], e2e_p90_s=e2e["p90_s_per_frame"],
                         e2e_mean_s=e2e["mean_s_per_frame"], e2e_first_s=e2e["first_frame_s"],
                         dispatch_stats=e2e.get("dispatch_stats")))
        log(f"phase 4c {name}: {json.dumps(runs[-1])}")
    if parent is not None:
        import subprocess

        env = {k: v for k, v in os.environ.items() if k != "LIBCLSPH_TPU_SORT"}
        for name, tree in (("parent", parent), ("change", ROOT)):
            out = subprocess.run([sys.executable, "-c", PROFILE_SCRIPT], capture_output=True,
                                 text=True, cwd=tree, env=env, timeout=600)
            if out.returncode != 0:
                raise RuntimeError(f"phase 4c {name} profile exited {out.returncode}: "
                                   f"{out.stderr[-3000:]}")
            for line in out.stdout.splitlines():
                if line.startswith("phase 4 profile, 1M"):
                    log(f"phase 4c {name}: {line[len('phase 4 '):].split(';')[0]}")
    for name in dict.fromkeys(t for t, _ in trees):
        mine = [r for r in runs if r["tree"] == name]
        log(f"phase 4c {name}: 1M cube {[r['ms_per_substep'] for r in mine]} ms/substep, 64k "
            f"end to end median {[round(r['e2e_median_s'], 4) for r in mine]} s/frame; "
            f"card {card}")
    return runs


def phase4_profile(logdir, st, dt, params, scene, cfg, reps=5):
    """torch.profiler breakdowns (utils/profiling.trace) of one rebuild
    substep from ``st`` and one reuse substep on its tables: for each the
    PROFILE_TOP entries by device time, the device total, the host wall
    time of the profiled run and the median of ``reps`` unprofiled ones;
    traces and full tables in ``logdir``."""
    from torch.autograd import DeviceType

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.utils import profiling

    s1, d1, _, tab = step.substep(st, dt, params, scene, cfg)
    runs = {"rebuild": lambda: step.substep(st, dt, params, scene, cfg),
            "reuse": lambda: step.substep(s1, d1, params, scene, cfg, do_sort=False,
                                          cand_in=tab)}
    unprofiled = substep_ms(st, dt, params, scene, cfg, reps)
    for (name, fn), plain_ms in zip(runs.items(), unprofiled):
        with profiling.trace(os.path.join(logdir, name)) as prof:
            t0 = time.perf_counter()
            with profiling.annotate(f"{name} substep"):
                fn()
            sync(st.device)
            wall_ms = 1000.0 * (time.perf_counter() - t0)
        # the device's own entries (kernels, copies): an op's device time
        # is its kernels' again, and the annotation's range spans them all
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.key != f"{name} substep"]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
        log(f"phase 4 profile, 1M {name} substep: device {device_ms:.3f} ms of a "
            f"{wall_ms:.3f} ms host wall time under the profiler ({device_ms / wall_ms:.1%} "
            f"busy); unprofiled {plain_ms:.3f} ms (median of {reps}); top "
            f"{PROFILE_TOP} kernels and copies by device time:")
        for e in top[:PROFILE_TOP]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    log(f"phase 4 profile: traces and tables in {logdir}")


def phase6_river(tmp, dev, frames):
    """1M water particles on scenes/river.obj through the engine with the
    pretune on, ``frames`` frames with .geo export by the native writer
    (torch_scene_run's river placement). Returns the launch counts of the
    frames."""
    import torch

    import torch_scene_run
    from libclsph_tpu_torch.io import geo_format
    from libclsph_tpu_torch.models.presets import WATER

    before = read_launches()
    r = torch_scene_run.run_scene("river", N_RIVER, frames, dev, os.path.join(tmp, "river_"))
    after = read_launches()
    if not geo_format.have_native():
        raise RuntimeError("phase 6: the .geo frames were not written by the native writer")
    launches = {k: after[k] - before[k] for k in after}
    frame_s, chosen, final, sim, pos = r["frame_s"], r["chosen"], r["final"], r["sim"], r["pos"]
    st = sim.state
    rho0 = WATER["fluid_density"]
    med = float(torch.median(st.density))
    names = sorted(os.listdir(os.path.join(tmp, "river_frames")))
    log(f"phase 6 river: {N_RIVER} particles (mass "
        f"{torch_scene_run.PLACEMENTS['river']['mass']}) on river.obj, "
        f"lattice y [{pos[:, 1].min():.3f}, {pos[:, 1].max():.3f}], scene and lattice "
        f"{r['setup_s']:.2f} s; pretune "
        f"{'did not run' if r['pretune_s'] is None else 'ran'} "
        f"({r['pretune_s'] or 0.0:.3f} s), probe {sim.pretune_stats}")
    log(f"  config chosen by the pretune: {chosen}")
    if final != chosen:
        log(f"  grown by the autotune during the frames to: {final}")
    log(f"  {len(frame_s)} frames, s/frame {[round(x, 4) for x in frame_s]} "
        f"(median {statistics.median(frame_s):.4f}, mean {statistics.mean(frame_s):.4f}) "
        f"with the native .geo writer; simulate() {r['total_s']:.2f} s incl. DF bake, "
        f"pretune and export; {len(names)} .geo frames; density median {med:.2f}; "
        f"launches {launches}")
    if len(frame_s) != frames or len(names) != frames + 1:
        raise RuntimeError(f"river: {len(frame_s)} frames run, {len(names)} written")
    if chosen.density_sub16 and final.density_sub16:
        raise RuntimeError("river: the q-granular config was not taken")
    if launches["density_c32"] <= 0 or launches["forces_q32_c32"] <= 0:
        raise RuntimeError(f"river: q-granular kernels not launched: {launches}")
    if not (torch.isfinite(st.position).all() and torch.isfinite(st.density).all()
            and torch.isfinite(st.velocity).all()):
        raise RuntimeError("river: non-finite state")
    if not 0.5 * rho0 < med < 2.0 * rho0:
        raise RuntimeError(f"river: median density {med} outside 0.5-2 x {rho0}")
    return launches


def phase3_cli(tmp, phase="3", flags=(), frames=3):
    """sph-torch water default cube <tmp>/out_ [flags] at 64,000
    particles for ``frames`` frames."""
    import numpy as np

    from libclsph_tpu_torch import cli
    from libclsph_tpu_torch.io import geo_format

    root = os.path.join(tmp, "root")
    for d in ("fluid_properties", "simulation_properties", "scenes"):
        os.makedirs(os.path.join(root, d))
    shutil.copy(os.path.join(ROOT, "fluid_properties", "water.json"),
                os.path.join(root, "fluid_properties"))
    shutil.copy(os.path.join(ROOT, "scenes", "cube.obj"), os.path.join(root, "scenes"))
    sim = json.load(open(os.path.join(ROOT, "simulation_properties", "default.json")))
    sim["simulation_time"] = frames / sim["target_fps"]
    sim["serialize"] = True  # the checkpoint carries the densities checked below
    json.dump(sim, open(os.path.join(root, "simulation_properties", "default.json"), "w"))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["water", "default", "cube", os.path.join(tmp, "out_"),
                       "--root", root, *flags])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"sph-torch exited {rc}")
    if not geo_format.have_native():
        raise RuntimeError(f"phase {phase}: the .geo frames were not written by the native "
                           f"writer")
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
    # in 2-3 frames nothing may leave that column by more than 5 cm or
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
    log(f"phase {phase} cli {' '.join(flags)}: {len(names)} frames of 64000 points in "
        f"{seconds:.2f} s "
        f"(scene bake, {frames} frames and native .geo export included); min y {ymin:.4f}, "
        f"max |x|,|z| {xzmax:.4f} (bound {half + 0.05:.4f}); "
        f"density median {med:.2f} max {float(dens.max()):.2f}")
    return seconds, {k: ck[k] for k in ck.files}


def one_substep(state, params, scene, engine):
    """One rebuild substep from ``state`` on ``engine.step_config``,
    re-run with the engine's capacity growth until no flag is raised.
    Returns (state, host ms of the last, synchronised run)."""
    import torch

    from libclsph_tpu_torch.engine import step

    dt = torch.tensor(params.max_dt, dtype=torch.float32, device=state.device)
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _, flags, _ = step.substep(state, dt, params, scene, engine.step_config)
        torch.cuda.synchronize()
        ms = 1000.0 * (time.perf_counter() - t0)
        if not engine._needs_rerun(flags):
            return out, ms
        log(f"  flags {int(flags)} -> grown to {engine.step_config}")
    raise RuntimeError("capacity growth did not converge")


def compare_states(tag, a, b, atol_rel=1e-4):
    """Substep outputs of two impls from one state: the same order,
    density rtol 1e-5, acceleration atol ``atol_rel`` * max|a|."""
    import torch

    if not torch.equal(a.grid_index, b.grid_index):
        raise RuntimeError(f"{tag}: the two substeps sorted differently")
    drel = float(((a.density - b.density).abs() / b.density.abs()).max())
    aerr = float((a.acceleration - b.acceleration).abs().max())
    amax = float(b.acceleration.abs().max())
    if drel > 1e-5 or not aerr <= atol_rel * amax:
        raise RuntimeError(f"{tag}: density rel err {drel:.3g}, accel err {aerr:.3g} "
                           f"(max|a| {amax:.6g})")
    return f"density rel err {drel:.3g}, accel err {aerr:.3g} (max|a| {amax:.6g})"


def phase7_blocks(state, params, scene, dev, card, ms_main, paths):
    """The block-granular 1M cube dam-break: row (warm-up with growth,
    TIMED_STEPS timed), fine and asym (FEW_STEPS timed each from the warm
    state), asm (one substep), each path's launches in ``paths``, then
    one row substep against one tiles substep from the warm state."""
    import dataclasses

    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    base = dict(cand_interval=1, sort_interval=4)
    reset_launches()
    row = SPHSimulation(step.StepConfig(pallas_variant="row", **base), device=dev,
                        pretune=False)
    t0 = time.perf_counter()
    st, dt = warm_up(state, params, scene, row, WARMUP_STEPS)
    torch.cuda.synchronize()
    log(f"phase 7 row warm-up: {time.perf_counter() - t0:.2f} s, config {row.step_config}")
    _, _, ms, got = timed_window("phase 7 row", st, dt, params, scene, row, TIMED_STEPS,
                                read_launches)
    if min(got["density_blocks row"], got["forces_blocks row"]) < TIMED_STEPS:
        raise RuntimeError(f"phase 7 row: the block kernels launched {got}")
    paths["row"] = read_launches()
    log(f"phase 7 bench (row): {N_BENCH} particles, {TIMED_STEPS} substeps, {ms:.3f} "
        f"ms/substep ({ms / ms_main:.3f}x the main path's {ms_main:.3f}), "
        f"{N_BENCH * 1e3 / ms:.6g} particle-steps/s, timed_flags 0, density_blocks and "
        f"forces_blocks on every substep; card {card}")
    for variant in ("fine", "asym"):
        reset_launches()
        eng = engine_with(row, dataclasses.replace(row.step_config, pallas_variant=variant))
        _, _, ms_v, got = timed_window(f"phase 7 {variant}", st, dt, params, scene, eng,
                                        FEW_STEPS, read_launches)
        recs = (f"density_blocks {variant}", f"forces_blocks {variant}")
        if min(got[r] for r in recs) < FEW_STEPS:
            raise RuntimeError(f"phase 7 {variant}: the block kernels launched {got}")
        paths[variant] = read_launches()
        log(f"phase 7 {variant}: {FEW_STEPS} substeps, {ms_v:.3f} ms/substep "
            f"({ms_v / ms_main:.3f}x the main path's), timed_flags 0, config "
            f"{eng.step_config}; card {card}")
    reset_launches()
    asm = SPHSimulation(step.StepConfig(
        pallas_variant="asm", density_sub16=False, force_sub16=False, force_sub8=False,
        **base), device=dev, pretune=False)
    _, ms_asm = one_substep(st, params, scene, asm)
    paths["asm"] = got = read_launches()
    if min(got["density_c32 groups 1 (asm)"], got["forces_q128_c32 (asm)"]) < 1:
        raise RuntimeError(f"phase 7 asm: density_c32 at 1 group and forces_q128_c32 "
                           f"launched {got}")
    log(f"phase 7 asm: one substep {ms_asm:.3f} ms (host clock), launches "
        f"density_c32 groups 1 {got['density_c32 groups 1 (asm)']}, forces_q128_c32 "
        f"{got['forces_q128_c32 (asm)']}, config {asm.step_config}; card {card}")
    saved = save_launches()
    s_row, ms_row = one_substep(st, params, scene, row)
    tiles = SPHSimulation(step.StepConfig(neighbor_impl="tiles", **base,
                                          max_candidates=row.step_config.max_candidates),
                          device=dev, pretune=False)
    s_tiles, ms_tiles = one_substep(st, params, scene, tiles)
    restore_launches(saved)
    log(f"phase 7 row vs tiles: one substep each from the warm state, "
        f"{compare_states('phase 7 row vs tiles', s_row, s_tiles)}; row {ms_row:.3f} ms, "
        f"tiles {ms_tiles:.3f} ms (host clock, plain PyTorch pair tiles); card {card}")


def phase8_exact(tmp, dev, card, paths):
    """The exact impl through the CLI at 64,000 particles with the fused
    radix sort, then one exact substep from the run's last state (peak
    device memory) against a main-path substep from it."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.io.checkpoint import arrays_to_state
    from libclsph_tpu_torch.ops import grid

    if grid._SORT_IMPL != "radix-fused":
        raise RuntimeError(f"phase 8: the sort backend is {grid._SORT_IMPL!r}")
    reset_launches()
    seconds, arrays = phase3_cli(tmp, "8", ("--neighbor-impl", "exact", "--sort-interval",
                                            "1"))
    paths["exact"] = got = read_launches()
    if got["radix_sort"] <= 0:
        raise RuntimeError(f"phase 8: the radix sort's kernels did not launch: {got}")
    saved = save_launches()
    params = water_params(N_EXACT)
    scene = cube_scene(params, dev)
    state = arrays_to_state(arrays, dev)
    exact = SPHSimulation(step.StepConfig(neighbor_impl="exact", sort_interval=1,
                                          cand_interval=1), device=dev, pretune=False)
    one_substep(state, params, scene, exact)  # grows cell_capacity if it must
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    s_exact, ms_exact = one_substep(state, params, scene, exact)
    peak = torch.cuda.max_memory_allocated()
    main = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
    s_main, ms_main = one_substep(state, params, scene, main)
    restore_launches(saved)
    log(f"phase 8 exact: CLI {seconds:.2f} s for 3 frames at {N_EXACT} particles "
        f"(LIBCLSPH_TPU_SORT=radix-fused), the radix sort's kernels ran "
        f"{got['radix_sort']} passes; "
        f"one exact substep {ms_exact:.3f} ms (host clock), peak device memory "
        f"{peak / 2**30:.3f} GiB ({(peak - before) / 2**30:.3f} GiB above the "
        f"{before / 2**30:.3f} GiB held before it), cell_capacity "
        f"{exact.step_config.cell_capacity}; main-path substep {ms_main:.3f} ms; exact vs "
        f"main path {compare_states('phase 8 exact vs main', s_exact, s_main)}; card {card}")


# phase 9: (path, bench_torch flags, StepConfig fields set after them,
# the records that must launch on every timed substep)
SHAPES = (
    ("q64", ("--nl-query-rows", "64"), {},
     ("density_c32 groups 1, rows 64", "forces_q128_c32 rows 64")),
    ("q32", ("--nl-query-rows", "32"), {},
     ("density_c32 groups 1, rows 32", "forces_q128_c32 rows 32")),
    ("b64", ("--block-size", "64"), {},
     ("density_c32 groups 1, rows 64", "forces_q128_c32 rows 64")),
    ("b256", ("--block-size", "256", "--no-density-sub16", "--no-force-sub16",
              "--no-force-sub8"), {}, ("density_c32", "forces_q32_c32")),
    ("asm32", ("--pallas-variant", "asm", "--nl-query-rows", "32"), {},
     ("density_c32 groups 1, rows 32 (asm)", "forces_q128_c32 rows 32 (asm)")),
    ("aabb", (), {"refine_mode": "aabb"}, ("density_c16", "forces_q32_c8")),
    ("b64-row", ("--block-size", "64", "--pallas-variant", "row"), {},
     ("density_blocks row, block 64", "forces_blocks row, block 64")),
    ("q32-full", ("--nl-query-rows", "32", "--no-hit-compact"), {},
     ("density_c32 densities only, rows 32", "forces_q128_c32 rows 32")),
)


def phase9_shapes(state, params, scene, dev, card, ms_main, paths, steps=TIMED_STEPS):
    """Each of SHAPES at 1M through bench_torch's functions: its config
    from bench_torch's flags (and clamps), the warm-up with capacity
    growth and the window rehearsed, one timed window that must raise no
    flag and launch the shape's kernels on every substep, then one
    substep against the main path's substep from the same warm state
    (compare_states: the same order, density rtol 1e-5, acceleration
    atol 1e-4 * max|a|)."""
    import dataclasses

    import torch

    import bench_torch
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    main = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
    for name, flags, fields, recs in SHAPES:
        t0 = time.perf_counter()
        cfg = bench_torch.config_from_args(bench_torch.build_arg_parser().parse_args(
            list(flags)))
        cfg = dataclasses.replace(cfg, **fields)
        reset_launches()
        eng = SPHSimulation(cfg, device=dev, pretune=False)
        st, dt = warm_up(state, params, scene, eng, WARMUP_STEPS, window=steps)
        _, _, ms, got = timed_window(f"phase 9 {name}", st, dt, params, scene, eng, steps,
                                     read_launches)
        if min(got[r] for r in recs) < steps:
            raise RuntimeError(f"phase 9 {name}: {recs} launched {got}")
        paths[name] = read_launches()
        saved = save_launches()
        s_shape, ms_one = one_substep(st, params, scene, eng)
        s_main, _ = one_substep(st, params, scene, main)
        restore_launches(saved)
        cmp = compare_states(f"phase 9 {name} vs main", s_shape, s_main)
        del st, s_shape, s_main
        torch.cuda.empty_cache()
        how = " ".join(list(flags) + [f"{k}={v}" for k, v in fields.items()])
        log(f"phase 9 {name} ({how}): {N_BENCH} particles, "
            f"{steps} substeps, {ms:.3f} ms/substep ({ms / ms_main:.3f}x the main path's "
            f"{ms_main:.3f}), timed_flags 0, launches {json.dumps({r: got[r] for r in recs})}; "
            f"one substep {ms_one:.3f} ms, vs the main path's substep from the same state: "
            f"{cmp}; config {eng.step_config}; {time.perf_counter() - t0:.2f} s; card {card}")


# phase 14: the identity mode's configurations at 64k (label, StepConfig
# fields, the records each must launch); the gated one runs its reuse
# substeps' gated density in the direct form
MXU_CONFIGS = (
    ("16-wide, gated", dict(SUB16, density_gate=True),
     ("density_c16 hit_sub 16, hit2_h mxu", "forces_q32_c16 mxu", "density_gated16")),
    ("16-wide", SUB16, ("density_c16 hit_sub 16 mxu", "forces_q32_c16 mxu")),
    ("16-wide over 32-wide tables", FTF, ("density_c32 hit_sub 16 mxu", "forces_q32_c16 mxu")),
    ("q32", Q_PATH, ("density_c32 mxu", "forces_q32_c32 mxu")),
    ("q128", dict(Q_PATH, force_query_rows=128),
     ("density_c32 groups 1 mxu", "forces_q128_c32 mxu")),
    ("nl_query_rows 64", dict(Q_PATH_ROWS, nl_query_rows=64),
     ("density_c32 groups 1, rows 64 mxu", "forces_q128_c32 rows 64 mxu")),
    ("nl_query_rows 32", dict(Q_PATH_ROWS, nl_query_rows=32),
     ("density_c32 groups 1, rows 32 mxu", "forces_q128_c32 rows 32 mxu")),
    ("asm", dict(Q_PATH_ROWS, pallas_variant="asm"),
     ("density_c32 groups 1 mxu", "forces_q128_c32 mxu")),
)


def identity_tolerance(state, params) -> float:
    """The identity mode's relative deviation from the direct form allowed
    at ``state``: the larger of the JAX package's bound for the mode
    (5e-4, tests/test_physics.py:350, set at 1,024 particles) and
    2 x 12 x 2^-24 x (max|p - centre| / h)^2, twice the identity's worst
    rounding of r^2 relative to h^2 (csrc/sph_pair.cuh) at the state's
    largest centred |p|. The rounding grows with that square, and the 1M
    cube's |p| reaches about 50 h, against a few h at 1,024 particles.
    The tiles mode centres each query block on its first particle; the
    domain-centred |p| stands in for the scale of its coordinates too."""
    import torch

    from libclsph_tpu_torch.engine import step

    real = torch.isfinite(state.position).all(dim=1)
    center = step.domain_center(state.position, real)
    ratio = float((state.position[real] - center).norm(dim=1).max()) / params.h
    return max(5e-4, 2 * 12 * 2.0 ** -24 * ratio * ratio)


def compare_modes(tag, a, b, tol):
    """One substep in the identity mode against the direct one from the
    same state: the same order, density rtol ``tol``, acceleration atol
    ``tol`` * max|a| (:func:`identity_tolerance`)."""
    import torch

    if not torch.equal(a.grid_index, b.grid_index):
        raise RuntimeError(f"{tag}: the two substeps sorted differently")
    if not (torch.isfinite(a.density).all() and torch.isfinite(a.acceleration).all()):
        raise RuntimeError(f"{tag}: non-finite identity-mode substep")
    drel = float(((a.density - b.density).abs() / b.density.abs()).max())
    aerr = float((a.acceleration - b.acceleration).abs().max())
    amax = float(b.acceleration.abs().max())
    if drel > tol or not aerr <= tol * amax:
        raise RuntimeError(f"{tag}: density rel err {drel:.3g}, accel err {aerr:.3g} "
                           f"(max|a| {amax:.6g})")
    return f"density rel err {drel:.3g}, accel err {aerr:.3g} (max|a| {amax:.6g})"


def phase14_mxu(s1m, p1m, scene1m, p64, scene64, dev, card, ms_main, paths):
    """The identity mode (``pair_r2="mxu"``, ``tile_mode="mxu"``) as a
    path of its own, its counts set to 0 before it and read after: the 1M
    cube through bench_torch's warm-up and timed window (ms/substep beside
    phase 4's), one substep against the direct one from the window's last
    state; each of MXU_CONFIGS warmed up for WARMUP_STEPS substeps at
    64k; one 64k tiles substep in ``tile_mode="mxu"`` against the direct
    tile mode (both comparisons at ``identity_tolerance``). The comparison
    substeps do not count."""
    import dataclasses

    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation

    t0 = time.perf_counter()
    reset_launches()
    eng = SPHSimulation(step.StepConfig(pair_r2="mxu"), device=dev, pretune=False)
    st, dt = warm_up(s1m, p1m, scene1m, eng, WARMUP_STEPS, window=TIMED_STEPS)
    st, dt, ms, got = timed_window("phase 14", st, dt, p1m, scene1m, eng, TIMED_STEPS,
                                   read_launches)
    recs = ("density_c16 mxu", "forces_q32_c8 mxu")
    if min(got[r] for r in recs) < TIMED_STEPS:
        raise RuntimeError(f"phase 14: the identity mode's window launched {got}")
    saved = save_launches()
    s_id, ms_id = one_substep(st, p1m, scene1m, eng)
    s_direct, ms_direct = one_substep(st, p1m, scene1m, SPHSimulation(
        dataclasses.replace(eng.step_config, pair_r2="vpu"), device=dev, pretune=False))
    restore_launches(saved)
    tol = identity_tolerance(st, p1m)
    cmp = compare_modes("phase 14 1M", s_id, s_direct, tol)
    log(f"phase 14 1M cube, pair_r2=mxu: {N_BENCH} particles, {TIMED_STEPS} substeps, "
        f"{ms:.3f} ms/substep ({ms / ms_main:.3f}x phase 4's {ms_main:.3f}), timed_flags 0, "
        f"launches {json.dumps({r: got[r] for r in recs})}; one substep {ms_id:.3f} ms "
        f"(direct {ms_direct:.3f}), against the direct substep from the same state "
        f"(density rtol and acceleration atol / max|a| {tol:.3g}): {cmp}; "
        f"config {eng.step_config}; card {card}")
    line = bench_result(N_BENCH, TIMED_STEPS, ms * TIMED_STEPS / 1e3, 0, dt, "water",
                        "pallas", "cube", dev, eng.step_config, card)
    log(f"phase 14 bench_torch: {json.dumps(line)}")
    del st, s_id, s_direct
    torch.cuda.empty_cache()
    s64 = init_state(p64, dev)
    for label, fields, recs in MXU_CONFIGS:
        before = read_launches()
        e = SPHSimulation(step.StepConfig(**fields, pair_r2="mxu"), device=dev, pretune=False)
        st, _ = warm_up(s64, p64, scene64, e, WARMUP_STEPS)
        sync(dev)
        after = read_launches()
        ran = {r: after[r] - before[r] for r in recs}
        if min(ran.values()) <= 0:
            raise RuntimeError(f"phase 14 {label}: launched {ran}")
        if not torch.isfinite(st.acceleration).all():
            raise RuntimeError(f"phase 14 {label}: non-finite state")
        log(f"phase 14 64k {label}, pair_r2=mxu: {WARMUP_STEPS} substeps, launches "
            f"{json.dumps(ran)}; config {e.step_config}")
    tiles = dict(neighbor_impl="tiles", cand_interval=1, density_sub16=False,
                 force_sub8=False)
    s_id, ms_id = one_substep(s64, p64, scene64, SPHSimulation(
        step.StepConfig(**tiles, tile_mode="mxu"), device=dev, pretune=False))
    saved = save_launches()
    s_direct, ms_direct = one_substep(s64, p64, scene64, SPHSimulation(
        step.StepConfig(**tiles), device=dev, pretune=False))
    restore_launches(saved)
    tol = identity_tolerance(s64, p64)
    cmp = compare_modes("phase 14 64k tiles", s_id, s_direct, tol)
    log(f"phase 14 64k tiles, tile_mode=mxu: one substep {ms_id:.3f} ms (direct "
        f"{ms_direct:.3f}), against the direct tile mode (density rtol and acceleration "
        f"atol / max|a| {tol:.3g}): {cmp}")
    paths["mxu"] = read_launches()
    log(f"phase 14: {time.perf_counter() - t0:.2f} s; card {card}")


def phase10_view(dev, card, frames):
    """The 1M cube through SPHSimulation for ``frames`` frames with
    PointRenderer.view as device_view, behind a thin wrapper that checks
    that the hook receives CUDA tensors. PointRenderer.on_image compares
    each image with the CPU render of the same state (a second
    PointRenderer with the same camera, on host copies): they must agree
    on at least 99.9 % of the pixels. Prints the render ms of each frame
    (host clock from the call of view to its image's arrival in
    on_image, the one copy to the host included)."""
    import numpy as np
    import torch

    from libclsph_tpu_torch.core.params import derive_parameters
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.io.render import PointRenderer

    fluid = json.load(open(os.path.join(ROOT, "fluid_properties", "water.json")))
    simp = json.load(open(os.path.join(ROOT, "simulation_properties", "bench64k.json")))
    sim = SPHSimulation(step.StepConfig(), device=dev)
    sim.parameters = derive_parameters(fluid, dict(
        simp, particles_count=N_BENCH, simulation_time=frames / simp["target_fps"]))
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.checkpoint_path = os.path.join(tempfile.gettempdir(), "chip_smoke_no_checkpoint.npz")
    sim.load_scene("cube.obj", scenes_dir=os.path.join(ROOT, "scenes"))
    gpu, cpu = PointRenderer(), PointRenderer()
    seen, now = [], {}

    def on_image(img):
        ms = 1000.0 * (time.perf_counter() - now["t0"])
        state = now["state"]
        ref = cpu.render(state.position.cpu(), state.density.cpu())
        same = float((img == ref).all(axis=-1).mean())
        lit = int((img != np.array([18, 18, 24], np.uint8)).any(axis=-1).sum())
        seen.append(dict(render_ms=ms, equal_share=same, lit_pixels=lit))

    def view(state, params, is_full_frame):
        if not (state.position.is_cuda and state.density.is_cuda):
            raise RuntimeError("phase 10: device_view received host tensors")
        torch.cuda.synchronize()
        now.update(state=state, t0=time.perf_counter())
        gpu.view(state, params, is_full_frame)

    gpu.on_image = on_image
    sim.device_view = view
    t0 = time.perf_counter()
    sim.simulate()
    wall = time.perf_counter() - t0
    if len(seen) != frames + 1:
        raise RuntimeError(f"phase 10: the hook ran {len(seen)} times for {frames} frames")
    bad = [v for v in seen if v["equal_share"] < 0.999 or v["lit_pixels"] == 0]
    if bad:
        raise RuntimeError(f"phase 10: images differ from the CPU render: {bad}")
    log(f"phase 10 view: {N_BENCH} particles, {frames} frames in {wall:.2f} s with "
        f"PointRenderer.view (900 x 700) as device_view on CUDA tensors; per call "
        f"{json.dumps(seen)}; config {sim.step_config}; card {card}")


def phase11_emitter(dev, card, frames):
    """experiments/torch_emitter_run.py (the round-5 emitter row) at
    262,144 particles for ``frames`` frames: every frame after the first
    must recycle particles."""
    import torch_emitter_run as em

    out = em.run(n=em.N, frames=frames, device=str(dev))
    rec = out["recycled_per_frame"]
    if out["frames"] != frames or not all(r > 0 for r in rec[1:]):
        raise RuntimeError(f"phase 11: recycled per frame {rec} over {out['frames']} frames")
    log(f"phase 11 emitter: {json.dumps(out)}; card {card}")


def phase3_legacy(tmp, arrays, shift=0.3):
    """The CLI round trip through ``--import-legacy``: phase 3's final
    checkpoint, moved by ``shift`` in x, written as a reference-format
    last_frame.bin, imported by ``sph-torch ... --import-legacy`` and run
    for one frame; the run must start from the imported state (its
    centroid moved by ``shift``, not the lattice's) and stay finite."""
    import numpy as np

    from libclsph_tpu_torch import cli
    from libclsph_tpu_torch.io import legacy

    moved = dict(arrays)
    moved["position"] = arrays["position"] + np.float32([shift, 0.0, 0.0])
    src = os.path.join(tmp, "import", "last_frame.bin")
    os.makedirs(os.path.dirname(src))
    legacy.write_legacy_checkpoint(src, moved)
    root = os.path.join(tmp, "root")
    sim_file = os.path.join(root, "simulation_properties", "default.json")
    sim = json.load(open(sim_file))
    sim["simulation_time"] = 1 / sim["target_fps"]
    json.dump(sim, open(sim_file, "w"))
    work = os.path.join(tmp, "import")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc = cli.main(["water", "default", "cube", os.path.join(work, "out_"), "--root", root,
                       "--import-legacy", src])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"phase 3 --import-legacy: sph-torch exited {rc}")
    with np.load(os.path.join(work, "last_frame.npz")) as z:
        pos = z["position"]
    dx = float(pos[:, 0].mean() - arrays["position"][:, 0].mean())
    if not (np.isfinite(pos).all() and abs(dx - shift) < 0.02):
        raise RuntimeError(f"phase 3 --import-legacy: centroid moved {dx} in x, not {shift}")
    log(f"phase 3 --import-legacy: {pos.shape[0]} particles imported from a "
        f"{os.path.getsize(src)}-byte last_frame.bin and run 1 frame in {seconds:.2f} s; "
        f"centroid x {dx:+.4f} from phase 3's checkpoint (moved {shift:+.1f})")


# ---- phase 12: the mesh -------------------------------------------------------

def mesh_config(over=None):
    """The sharded path's StepConfig: the defaults without the 8-wide
    force pass (off under the mesh, as in the JAX CLI)."""
    from libclsph_tpu_torch.engine import step

    return step.StepConfig(**dict(over or {}, force_sub8=False))


def raw_delta(after, before):
    return {k: (after[k][0] - before[k][0],
                {v: n - before[k][1].get(v, 0) for v, n in after[k][1].items()})
            for k in after}


def raw_sum(a, b):
    return {k: (a[k][0] + b[k][0],
                {v: a[k][1].get(v, 0) + b[k][1].get(v, 0) for v in {*a[k][1], *b[k][1]}})
            for k in a}


def records_from_raw(raw) -> dict:
    """KERNELS' launch counts from raw wrapper counters
    (``ops.kernels.launch_counts``)."""
    return {rec: raw[fn][0] if variant is None else raw[fn][1].get(variant, 0)
            for rec, (fn, variant, *_) in KERNELS.items()}


def phase12_rank(mesh, arrays64, p64, dt64, p1m, cases, reuse_over):
    """Phase 12a-c on one rank (spawned by parallel.mesh.launch; the
    script's own functions run in the ranks, which import no JAX).
    Returns host arrays and numbers for the parent to check."""
    import dataclasses

    import numpy as np
    import torch

    from bench_torch import sync
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.io import checkpoint
    from libclsph_tpu_torch.ops import kernels
    from libclsph_tpu_torch.ops.kernels import density, forces
    from libclsph_tpu_torch.parallel import bench, sharded_step as ss

    dev, world = mesh.device, mesh.world
    out = dict(a={}, b={}, c={})
    # 12a: one sharded substep per case from the settled 64k cube
    scene64 = cube_scene(p64, dev)
    local = ss.local_rows(ss.pad_for_mesh(checkpoint.arrays_to_state(arrays64, dev), p64,
                                          world, mesh_config()), mesh.rank, world)
    dt = torch.tensor(dt64, dtype=torch.float32, device=dev)
    kernels.reset_launch_counts()
    for label, exchange, hops, over in cases:
        cfg = mesh_config(dict(over, cand_interval=1))
        halo_max = 0 if exchange == "all_gather" else ss.default_halo_max(
            p64.particles_count, world, cfg.block_size)
        before = kernels.launch_counts()
        mesh.barrier()
        t0 = time.perf_counter()
        st, dt_o, flags, _ = ss.local_substep(mesh, local, dt, p64, scene64, cfg, exchange,
                                              halo_max, hops)
        flags = int(flags)
        sync(dev)
        ms = 1000.0 * (time.perf_counter() - t0)
        out["a"][label] = dict(state=checkpoint.state_to_arrays(st), dt=float(dt_o),
                               flags=flags, ms=ms,
                               launches=raw_delta(kernels.launch_counts(), before))
    # 12a, tier 2 with candidate reuse: REUSE_SUBSTEPS substeps of the
    # sharded frame loop, its substeps counted
    cfg = dataclasses.replace(mesh_config(reuse_over), substeps_per_dispatch=REUSE_SUBSTEPS)
    for exchange in REUSE_EXCHANGES:
        halo_max = 0 if exchange == "all_gather" else ss.default_halo_max(
            p64.particles_count, world, cfg.block_size)
        stats = {}
        st, dt_o, _, flags = ss.local_frame(
            mesh, local, dt, torch.tensor(3.0e38, device=dev), p64, scene64, cfg, exchange,
            halo_max, 1, stats)
        out["a"][f"reuse {exchange}"] = dict(state=checkpoint.state_to_arrays(st),
                                             dt=float(dt_o), flags=int(flags), stats=stats)
    mesh_raw = kernels.launch_counts()

    # 12b: the 16-wide pair on this rank's exchanged tables at 1M
    st1m = ss.local_rows(ss.pad_for_mesh(init_state(p1m, dev), p1m, world, mesh_config()),
                         mesh.rank, world)
    dt1m = torch.tensor(p1m.max_dt, dtype=torch.float32, device=dev)
    for exchange in ("all_gather", "halo"):
        halo_max = 0 if exchange == "all_gather" else ss.default_halo_max(
            p1m.particles_count, world, 128)
        rec = {}
        ss.local_substep(mesh, st1m, dt1m, p1m, None, mesh_config(dict(cand_interval=1)),
                         exchange, halo_max, 1, record=rec)
        q = rec["qblock"]
        dargs = (rec["pos4"], rec["cand_sub"].contiguous(), rec["count_sub"].contiguous(), p1m)
        d, hits = density.density_c16(*dargs, hit_sub=16, qblock=q)
        d0, hits0 = density.density_c16_torch(*dargs, hit_sub=16, qblock=q)
        fargs = (rec["f8"], rec["density_c"], rec["real_c"], rec["cand_f"], rec["count_f"], p1m)
        a = forces.forces_q32_c16(*fargs, qblock=q)
        a0 = forces.forces_q32_c16_torch(*fargs, qblock=q)
        pos4 = rec["pos4"].cpu().numpy()
        live = pos4[:, 3] > 0
        out["b"][exchange] = dict(
            density_rel=float(((d - d0).abs() / d0.abs()).max()),
            hits_equal=bool(torch.equal(hits, hits0)),
            accel_err=float((a - a0).abs().max() / a0.abs().max()),
            max_abs_err=max(float((d - d0).abs().max()), float((a - a0).abs().max())),
            rows=pos4.shape[0], queries=int(q.numel()) * 128, qoff=int(q[0]) * 128,
            identity=bool(torch.equal(q.cpu(), torch.arange(q.numel(), dtype=torch.int32))),
            live=int(live.sum()),
            once=bool(np.unique(pos4[live, :3], axis=0).shape[0] == int(live.sum())),
            pairs=int(hits0.sum()))
    kernels.reset_launch_counts()

    # 12c: bench_torch's --mesh function at 1M, halo and all_gather
    scene_file = os.path.join(ROOT, "scenes", "cube.obj")
    for exchange in ("halo", "all_gather"):
        r = bench.bench_rank(mesh, p1m, mesh_config(), scene_file, exchange, 0, 1,
                             WARMUP_STEPS, MESH_STEPS)
        mesh_raw = raw_sum(mesh_raw, r["launches"])
        out["c"][exchange] = r
    out["launches"] = mesh_raw
    return out


def compare_sharded(tag, parts, ref, atol_pos=1e-5, rtol_dens=1e-5, atol_acc=5e-4):
    """The ranks' real rows against the single-chip substep's, matched by
    nearest position (the two runs order rows differently): positions
    atol 1e-5, density rtol 1e-5, acceleration atol 5e-4 * max|a| (JAX's
    test_parallel.py tolerances)."""
    import numpy as np
    from scipy.spatial import cKDTree

    pos = np.concatenate([p["position"] for p in parts])
    real = np.abs(pos).max(axis=1) < 1e30
    pos = pos[real]
    dens = np.concatenate([p["density"] for p in parts])[real]
    acc = np.concatenate([p["acceleration"] for p in parts])[real]
    p1, d1, a1 = (ref[k] for k in ("position", "density", "acceleration"))
    if pos.shape[0] != p1.shape[0]:
        raise RuntimeError(f"phase 12a {tag}: {pos.shape[0]} real rows, not {p1.shape[0]}")
    dist, idx = cKDTree(pos).query(p1)
    if np.unique(idx).shape[0] != idx.shape[0]:
        raise RuntimeError(f"phase 12a {tag}: rows do not match one to one")
    errs = dict(pos=float(dist.max()),
                dens=float(np.abs(dens[idx] / d1 - 1.0).max()),
                acc=float(np.abs(acc[idx] - a1).max() / np.abs(a1).max()))
    if errs["pos"] > atol_pos or errs["dens"] > rtol_dens or errs["acc"] > atol_acc:
        raise RuntimeError(f"phase 12a {tag}: sharded substep differs from the single-chip "
                           f"one: {errs}")
    return errs


def reuse_case(s64, p64):
    """Phase 12a's tier-2 reuse config: the mesh path on the 4/4 cadence
    with a base subblock capacity at the 75th percentile of the settled
    cube's refined counts at the reuse radius (one device's), a tier-2
    width past 1.5 x the deepest, and a tier-2 pool of every block."""
    import numpy as np

    from libclsph_tpu_torch.engine import step

    cfg = mesh_config(dict(SUB16, cand_interval=4, sort_interval=4, max_candidates_sub=4096))
    st, real, _ = step.pad_and_sort(s64, p64, True)
    counts, flags = step.build_candidates(st, real, p64, cfg)[1:]
    if int(flags):
        raise RuntimeError(f"phase 12a reuse: the full-depth refine raised {int(flags)}")
    counts = counts.cpu().numpy()
    c1 = int(np.percentile(counts, 75))
    mult = 2
    while c1 * mult < 1.5 * counts.max():
        mult *= 2
    return dict(SUB16, cand_interval=4, sort_interval=4, max_candidates_sub=c1,
                tier2_frac=1, tier2_mult=mult)


def check_reuse_case(ranks, s64, dt64, p64, scene64, over):
    """Phase 12a's tier-2 reuse case against the single-chip frame from
    the same state (compare_sharded's tolerances, the same dt, flags 0,
    the same rebuilds and reuses); tier 2 must receive blocks and the
    carried table have the tier-2 width."""
    import dataclasses

    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.io import checkpoint

    cfg = dataclasses.replace(mesh_config(over), substeps_per_dispatch=REUSE_SUBSTEPS)
    one = {}
    saved = save_launches()
    st, dt1, _, flags = step.frame(s64, dt64, torch.tensor(3.0e38, device=s64.device), p64,
                                   scene64, cfg, one)
    restore_launches(saved)
    ref = dict(checkpoint.state_to_arrays(st), dt=float(dt1))
    if int(flags) or not one["reuses"] or not one["tier2_blocks"]:
        raise RuntimeError(f"phase 12a reuse: the single-chip frame raised {int(flags)}, "
                           f"counted {one}")
    for exchange in REUSE_EXCHANGES:
        tag = f"reuse {exchange}"
        got = [r["a"][tag] for r in ranks]
        errs = compare_sharded(tag, [g["state"] for g in got], ref)
        counted = [g["stats"] for g in got]
        width = over["max_candidates_sub"] * over["tier2_mult"]
        if (any(g["flags"] for g in got)
                or any(abs(g["dt"] / ref["dt"] - 1.0) > 1e-5 for g in got)
                or any((c["rebuilds"], c["reuses"]) != (one["rebuilds"], one["reuses"])
                       for c in counted)
                or not sum(c["tier2_blocks"] for c in counted)
                or any(c["carry_width"] != width for c in counted)):
            raise RuntimeError(f"phase 12a {tag}: flags {[g['flags'] for g in got]}, dt "
                               f"{[g['dt'] for g in got]} against {ref['dt']}, counted "
                               f"{counted} against one device's {one}")
        log(f"phase 12a {tag} (tier 2, cand_interval 4): {MESH_RANKS} ranks, "
            f"{REUSE_SUBSTEPS} substeps of the frame loop from the settled 64k cube against "
            f"the single-chip frame: position err {errs['pos']:.3g}, density rel err "
            f"{errs['dens']:.3g}, accel err {errs['acc']:.3g} of max|a|, dt equal to 1e-5, "
            f"flags 0; per rank {[c['rebuilds'] for c in counted]} rebuilds and "
            f"{[c['reuses'] for c in counted]} reuse substeps (one device "
            f"{one['rebuilds']} / {one['reuses']}), blocks routed to tier 2 summed over the "
            f"substeps {[c['tier2_blocks'] for c in counted]} (one device "
            f"{one['tier2_blocks']}), carried table {width} wide (base "
            f"{over['max_candidates_sub']} x tier2_mult {over['tier2_mult']})")


def phase12_mesh(dev, card, ms_main, ms_16wide, paths, stats, tmp):
    """Phase 12: 4 ranks on the one card (gloo, staged through host
    buffers; on a machine with 4 cards, one card a rank over NCCL), one
    launch for a-c, the CLI's own for d; then bench_torch's --mesh 1
    (12c, N = 1)."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation
    from libclsph_tpu_torch.io import checkpoint
    from libclsph_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    p64 = water_params(65536)
    scene64 = cube_scene(p64, dev)
    s64, dt64 = warm_up(init_state(p64, dev), p64, scene64,
                        SPHSimulation(step.StepConfig(), device=dev, pretune=False), 10)
    refs = {}
    saved = save_launches()
    for label, _, _, over in MESH_CASES:
        st, dt_r, flags, _ = step.substep(s64, dt64, p64, scene64,
                                          mesh_config(dict(over, cand_interval=1)))
        if int(flags):
            raise RuntimeError(f"phase 12a {label}: the single-chip substep raised {int(flags)}")
        refs[label] = dict(checkpoint.state_to_arrays(st), dt=float(dt_r))
    restore_launches(saved)
    reuse_over = reuse_case(s64, p64)
    p1m = water_params(N_BENCH)
    ranks = mesh.launch(phase12_rank, MESH_RANKS, device="cuda", log=log, args=(
        checkpoint.state_to_arrays(s64), p64, float(dt64), p1m, MESH_CASES, reuse_over))
    check_reuse_case(ranks, s64, dt64, p64, scene64, reuse_over)
    del s64
    torch.cuda.empty_cache()
    for label, _, _, _ in MESH_CASES:
        got = [r["a"][label] for r in ranks]
        errs = compare_sharded(label, [g["state"] for g in got], refs[label])
        dts = {g["dt"] for g in got}
        flags = [g["flags"] for g in got]
        if len(dts) != 1 or abs(dts.pop() / refs[label]["dt"] - 1.0) > 1e-5 or any(flags):
            raise RuntimeError(f"phase 12a {label}: dt {[g['dt'] for g in got]} against "
                               f"{refs[label]['dt']}, flags {flags}")
        runs = [records_from_raw(g["launches"]) for g in got]
        pair = (("density_c16 hit_sub 16", "forces_q32_c16") if "q-granular" not in label
                else ("density_c32", "forces_q32_c32") if "128" not in label
                else ("density_c32 groups 1", "forces_q128_c32"))
        if any(run[k] <= 0 for run in runs for k in pair):
            raise RuntimeError(f"phase 12a {label}: {pair} did not launch in every rank: "
                               f"{[{k: run[k] for k in pair} for run in runs]}")
        log(f"phase 12a {label}: {MESH_RANKS} ranks, one substep from the settled 64k cube "
            f"against the single-chip substep: position err {errs['pos']:.3g}, density rel "
            f"err {errs['dens']:.3g}, accel err {errs['acc']:.3g} of max|a|, dt equal to "
            f"1e-5, flags 0; {pair} launched in every rank; rank substep ms "
            f"{[round(g['ms'], 2) for g in got]}")
    for exchange in ("all_gather", "halo"):
        rows = [r["b"][exchange] for r in ranks]
        for r, b in enumerate(rows):
            if (b["density_rel"] > 1e-5 or not b["hits_equal"] or b["accel_err"] > 1e-5
                    or not b["once"]):
                raise RuntimeError(f"phase 12b {exchange} rank {r}: {b}")
            for rec in ("density_c16 hit_sub 16", "forces_q32_c16"):
                record_err(stats, rec, b["max_abs_err"])
        log(f"phase 12b {exchange}: on each rank's exchanged tables at 1M, density_c16 "
            f"hit_sub 16 and forces_q32_c16 against their plain versions: density rel err "
            f"{max(b['density_rel'] for b in rows):.3g}, hits equal, accel err "
            f"{max(b['accel_err'] for b in rows):.3g} of max|a|; combined rows "
            f"{[b['rows'] for b in rows]}, queries at row {[b['qoff'] for b in rows]} "
            f"(qblock the identity: {[b['identity'] for b in rows]}), each live particle "
            f"once; pairs {[b['pairs'] for b in rows]}")
    for exchange in ("halo", "all_gather"):
        res = [r["c"][exchange] for r in ranks]
        record = bench_mesh_record(res, N_BENCH, MESH_STEPS, MESH_RANKS, exchange, True,
                                   card)
        d = record["detail"]
        if d["timed_flags"] or not all(x["finite"] for x in res):
            raise RuntimeError(f"phase 12c {exchange}: flags {d['timed_flags']}, finite "
                               f"{[x['finite'] for x in res]}")
        where = ("sharing one card, gloo" if d["ranks_share_card"]
                 else "one card each, nccl")
        log(f"phase 12c {exchange} ({MESH_RANKS} ranks {where}): {N_BENCH} particles, "
            f"{MESH_STEPS} timed substeps, {d['ms_per_step']:.3f} ms/substep, "
            f"{record['value']:.6g} particle-steps/s (phase 4, one rank: {ms_main:.3f} "
            f"ms/substep); per substep on rank 0: collectives {d['collectives_per_substep']}, "
            f"bytes {d['collective_bytes_per_substep']}, staged through host "
            f"{d['staged_bytes_per_substep']:.6g} B; warm-up {res[0]['warm_s']:.2f} s; "
            f"grown tables {d['tables']}; card {card}")
        log(f"phase 12c bench_torch --mesh {MESH_RANKS} --exchange {exchange}: "
            f"{json.dumps(record)}")
    # 12c at N = 1: bench_torch --mesh 1 --exchange halo, against phase 4b
    # (the 16-wide force path, the tables the mesh runs)
    record, one = bench_mesh(N_BENCH, MESH_STEPS, WARMUP_STEPS, "water", "cube", dev,
                             mesh_config(), 1, "halo", log=log)
    d = record["detail"]
    if d["timed_flags"] or not one[0]["finite"]:
        raise RuntimeError(f"phase 12c N = 1: flags {d['timed_flags']}, finite "
                           f"{one[0]['finite']}")
    log(f"phase 12c bench_torch --mesh 1 --exchange halo: {N_BENCH} particles, "
        f"{MESH_STEPS} timed substeps, {d['ms_per_step']:.3f} ms/substep against phase 4b's "
        f"{ms_16wide:.3f} (the 16-wide force path on one device, "
        f"{d['ms_per_step'] / ms_16wide:.3f}x); collectives per substep "
        f"{d['collectives_per_substep']}; warm-up {one[0]['warm_s']:.2f} s; grown tables "
        f"{d['tables']}; card {card}")
    log(f"phase 12c bench_torch --mesh 1 --exchange halo: {json.dumps(record)}")
    raw = one[0]["launches"]
    for r in ranks:
        raw = raw_sum(raw, r["launches"])
    paths["mesh"] = records_from_raw(raw)
    log(f"phase 12 a-c: {time.perf_counter() - t0:.2f} s")
    phase3_cli(tmp, "12d", ("--mesh", str(MESH_RANKS), "--exchange", "halo"),
               frames=MESH_FRAMES)


def run_probe(script, *args, timeout=900) -> dict:
    """``experiments/<script>`` in a process of its own on the card, as a
    user runs it (the sort backend the package defaults to, not phase 8's);
    its last line of output is its JSON record. A probe that exits non-zero
    fails the phase."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "LIBCLSPH_TPU_SORT"}
    out = subprocess.run([sys.executable, os.path.join(EXPERIMENTS, script), *args],
                         capture_output=True, text=True, cwd=ROOT, env=env, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"phase 13 {script} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase13_probes(card, stats):
    """Phase 13: the diagnostic probes on the card, each in a process of
    its own, each printing its JSON line: the refine split at 1M for 128,
    64 and 32 query rows (``torch_refine_probe``), the 2M dam-break
    substep by substep through its warm-up and SCALE_STEPS substeps
    (``torch_scale_diag``), and the 1M river dispatch by dispatch for
    RIVER_PROBE_FRAMES frames (``torch_river_frame_diag``, row 7's
    placement and pretune); then the stream probes at 1M
    (``torch_force_kernel_bisect``: the q128 force kernel split into feed,
    test and terms; ``torch_nl_kernel_variants``: the sums on the aabb
    lists' stream in both layouts and the asm route). Returns the stream
    probes' launches, as KERNELS' records; the bisect probe's lines give
    the stream kernels' records their times, plain times and work
    (``stats``)."""
    t0 = time.perf_counter()
    refine = run_probe("torch_refine_probe.py")
    for w in refine["widths"]:
        if not w["exact"]["tables_equal_refine_candidates_exact"]:
            raise RuntimeError(f"phase 13 refine probe: the parts' tables differ at rows "
                               f"{w['nl_query_rows']}")
        log(f"phase 13 refine q{w['nl_query_rows']}: rebuild substep "
            f"{w['rebuild_substep']['device_ms']:.3f} ms of device time; parts (event ms, "
            f"device ms, share of the rebuild's device time) "
            + ", ".join(f"{k} {v['ms']:.3f} / {v['device_ms']:.3f} / "
                        f"{w['share_of_rebuild'][k]:.3f}" for k, v in w["parts"].items())
            + f"; count_sub exact mean {w['exact']['mean']:.1f} max {w['exact']['max']}, "
            f"aabb mean {w['aabb']['mean']:.1f} max {w['aabb']['max']}")
    log(f"phase 13 torch_refine_probe: {json.dumps(refine)}")
    scale = run_probe("torch_scale_diag.py", "--n", str(N_SCALE), "--steps", str(SCALE_STEPS))
    log(f"phase 13 scale probe at {N_SCALE}: growth {json.dumps(scale['growth'])}; deepest "
        f"superblock shortlist / its cap by substep "
        f"{[(r['super_rows_max'], r['super_cap']) for r in scale['rows']]}; blocks a block "
        f"needs (max) {[r['count_max'] for r in scale['rows']]}")
    log(f"phase 13 torch_scale_diag: {json.dumps(scale)}")
    river = run_probe("torch_river_frame_diag.py", "--frames", str(RIVER_PROBE_FRAMES),
                      "--no-device-time")
    if not river["finite"]:
        raise RuntimeError("phase 13 river probe: non-finite state")
    frames = [(f["substeps"], f["rebuilds"], f["reuses"], f["reruns"], round(f["wall_s"], 4))
              for f in river["frames"]]
    log(f"phase 13 river probe: frames (substeps, rebuilds, reuses, re-runs, wall s) "
        f"{frames}")
    stops = []
    for f in river["frames"]:
        mine = [d for d in river["dispatches"]
                if d["frame"] == f["frame"] and d["attempt"] == f["reruns"]]
        stops.append(dict(frame=f["frame"], reads=sum(d["host_reads"] for d in mine),
                          wasted=sum(d["wasted"] for d in mine),
                          **{k: sum(d["stops"][k] for d in mine)
                             for k in ("time", "stale", "retry")}))
    log(f"phase 13 river probe: the dispatch layer's host reads and stops a frame "
        f"{json.dumps(stops)}")
    log(f"phase 13 torch_river_frame_diag: {json.dumps(river)}")
    raw = None
    for script in ("torch_force_kernel_bisect.py", "torch_nl_kernel_variants.py"):
        t1 = time.perf_counter()
        rec = run_probe(script, timeout=300)
        if not rec["planes_equal_staged"] or not rec.get("bit_equal_to_forces_q128_c32", True):
            raise RuntimeError(f"phase 13 {script}: the stream's modes disagree")
        log(f"phase 13 {script} ({time.perf_counter() - t1:.2f} s): {rec['live_slots']} live "
            f"slots of {rec['blocks']} lists, {rec['live_bytes']} live bytes of a "
            f"{rec['stream_bytes']}-byte stream; lines (event ms / device ms / bound ms) "
            + ", ".join(f"{k} {v['ms']:.4f} / {v['device_ms']:.4f} / {v['bound_ms']:.4f}"
                        for k, v in rec["lines"].items())
            + (f"; split of forces_q128_c32 (device ms) {json.dumps(rec['split'])}"
               if "split" in rec else ""))
        log(f"phase 13 {script[:-3]}: {json.dumps(rec)}")
        raw = rec["launches"] if raw is None else raw_sum(raw, rec["launches"])
        if script == "torch_force_kernel_bisect.py":
            lines = rec["lines"]
            for name in (k for k, spec in KERNELS.items() if "probe" in spec[4]):
                ln = lines[name]
                stats[name]["bench"] = (ln["ms"], ln["plain_ms"], ln["bytes"], ln["ops"])
            for name in ("gather_stream", "gather_stream planes"):
                stats[name]["library_ms"] = lines["index_select"]["ms"]
    log(f"phase 13 probes: {time.perf_counter() - t0:.2f} s; card {card}")
    return records_from_raw(raw)


class Walls:
    """Wall time of each phase (host clock) and the total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.walls = {}

    def mark(self, phase: str) -> None:
        now = time.perf_counter()
        self.walls[phase] = now - self.last
        self.last = now
        log(f"phase {phase} wall {self.walls[phase]:.2f} s")

    def total(self) -> float:
        return time.perf_counter() - self.start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="keep phase 4's profiler traces and tables of a 1M rebuild and "
                    "reuse substep in DIR")
    ap.add_argument("--river-frames", type=int, default=RIVER_FRAMES,
                    help="frames of the river run (phase 6)")
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of the parent commit (default: build/parent where it "
                    "exists), timed in turns with this tree in phase 4c")
    args = ap.parse_args(argv)
    if args.parent is None and os.path.isdir(os.path.join(ROOT, "build", "parent")):
        args.parent = os.path.join(ROOT, "build", "parent")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, EXPERIMENTS]
    # the exact impl's sort (phase 8) runs the fused radix sort; the
    # package reads its sort backend when it is imported
    os.environ["LIBCLSPH_TPU_SORT"] = "radix-fused"
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.io import geo_format, native
    from libclsph_tpu_torch.ops.kernels import build

    dev = configure_device("cuda")
    walls = Walls()
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    fresh = not native.library_path().exists()
    geo_format.native_writer(required=True)
    log(f"phase 1 native .geo writer: {'compiled' if fresh else 'found'} "
        f"{os.path.relpath(native.library_path(), ROOT)} in {time.perf_counter() - t0:.2f} s")
    walls.mark("0-1")
    stats = {name: {} for name in KERNELS}

    # phase 2
    engines = {}

    def engine_for(tag, over):
        key = (tag, tuple(sorted(over.items())))
        if key not in engines:  # the engine's growth, per table shape and cell
            engines[key] = SPHSimulation(step.StepConfig(**over), device=dev, pretune=False)
        return engines[key]

    def compare_all(tag, state, p, scene, time_it, qblock=False, rows=False):
        cell = tag.split()[0]
        t_main = main_path_tables(state, p, engine_for(cell, {}))
        compare_kernels(tag, t_main, stats, time_it)
        t_q = q_path_tables(state, p, engine_for(cell, Q_PATH))
        compare_q_kernels(tag, t_q, stats, time_it)
        t16 = sub16_tables(state, p, engine_for(cell, SUB16), 16)
        t32 = sub16_tables(state, p, engine_for(cell, FTF), 32)
        compare_sub16_kernels(tag, t16, t32, stats, time_it)
        compare_gated(tag, state, p, scene, engine_for(cell, SUB16), stats, time_it)
        compare_stream(tag, t_main, t_q, t16, stats)
        if qblock:
            compare_qblock(tag, t_main, t_q, t16, t32, stats)
        if rows:
            compare_all_rows(tag, state, p, engine_for, stats)
        if tag == BENCH_TAG:
            t_rows = {r: rows_tables(state, p, engine_for(cell, dict(Q_PATH_ROWS,
                                                                     nl_query_rows=r)))
                      for r in (64, 32)}
            compare_mxu(tag, mxu_cases(t_main, t_q, t16, t32, t_rows), stats)

    p64 = water_params(65536)
    scene64 = cube_scene(p64, dev)
    s64 = init_state(p64, dev)
    compare_all("64k lattice", s64, p64, scene64, True, rows=True)
    s64, _ = warm_up(s64, p64, scene64, engine_for("64k", {}), 10)
    compare_all("64k after 10 substeps", s64, p64, scene64, True)
    p1m = water_params(N_BENCH)
    scene1m = cube_scene(p1m, dev)
    s1m = init_state(p1m, dev)
    compare_all(BENCH_TAG, s1m, p1m, scene1m, True, qblock=True, rows=True)
    compare_blocks(BENCH_TAG, block_tables(s1m, p1m, engine_for(
        "1M", dict(pallas_variant="row", cand_interval=1))), stats)
    compare_asm(BENCH_TAG, asm_tables(s1m, p1m, engine_for("1M", dict(
        pallas_variant="asm", cand_interval=1, density_sub16=False, force_sub16=False,
        force_sub8=False))), stats)
    compare_radix(BENCH_TAG, stats, dev)
    del s64
    torch.cuda.empty_cache()
    walls.mark("2")

    # phases 3, 3c and 4 drive the main path; count the kernels' launches
    # there
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        _, ck = phase3_cli(tmp)
        phase3_legacy(tmp, ck)
    cli_launches = read_launches()
    if min(cli_launches["density_c16"], cli_launches["forces_q32_c8"]) <= 0:
        raise RuntimeError(f"CLI run launched the main kernels {cli_launches}")
    phase3c_fidelity(dev)

    # phase 4: bench_torch's 1M cube dam-break
    engine = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
    t0 = time.perf_counter()
    st, dt = warm_up(s1m, p1m, scene1m, engine, WARMUP_STEPS, window=TIMED_STEPS)
    sync(dev)
    log(f"phase 4 warm-up (bench_torch's, the timed window rehearsed): "
        f"{time.perf_counter() - t0:.2f} s, config {engine.step_config}")
    st, dt, ms_main, got = timed_window("phase 4", st, dt, p1m, scene1m, engine, TIMED_STEPS,
                                        read_launches)
    if min(got["density_c16"], got["forces_q32_c8"]) < TIMED_STEPS:
        raise RuntimeError(f"timed run launched the kernels {got}")
    log(f"phase 4 bench: {N_BENCH} particles, {TIMED_STEPS} substeps, "
        f"{ms_main:.3f} ms/substep, {N_BENCH * 1e3 / ms_main:.6g} particle-steps/s, "
        f"timed_flags 0, final dt {float(dt):.6g}, config {engine.step_config}; "
        f"card {card}")
    line = bench_result(N_BENCH, TIMED_STEPS, ms_main * TIMED_STEPS / 1e3, 0, dt, "water",
                        "pallas", "cube", dev, engine.step_config, card)
    log(f"phase 4 bench_torch: {json.dumps(line)}")
    warm = {}
    run_substeps(init_state(p1m, dev), torch.tensor(p1m.max_dt, device=dev), p1m, scene1m,
                 engine.step_config, WARMUP_STEPS, host=warm)
    log(f"phase 4 warm-up's first {WARMUP_STEPS} substeps again, the dispatch layer: "
        f"{warm['reads']} host reads, stops {warm['events']}")
    phase4_syncs(st, dt, p1m, scene1m, engine.step_config)
    with tempfile.TemporaryDirectory() as tmp:
        phase4_profile(args.profile or tmp, st, dt, p1m, scene1m, engine.step_config)
    paths = {"main": read_launches()}
    walls.mark("3-4")
    phase4c_parent(args.parent, card)
    walls.mark("4c")

    # phases 3b and 4b drive the 16-wide force path and the gated density
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        phase3_cli(tmp, "3b", ("--no-force-sub8",))
    got = read_launches()
    if min(got["density_c16 hit_sub 16"], got["forces_q32_c16"]) <= 0:
        raise RuntimeError(f"the --no-force-sub8 CLI run launched {got}")
    ms_16wide = phase4b_sub16(s1m, p1m, scene1m,
                              engine_with(engine, step.StepConfig(**SUB16)), card)
    paths["16-wide"] = read_launches()
    walls.mark("3b-4b")

    # phases 5 and 6 drive the deep-column path: two-tier routing and the
    # q-granular tables
    reset_launches()
    phase5_two_tier(st, p1m, scene1m)
    del st, s1m
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase6_river(tmp, dev, args.river_frames)
    paths["deep"] = read_launches()
    walls.mark("5-6")

    # phase 7 drives the row, fine, asym and asm paths, phase 8 the exact
    # impl; each path's counts are reset before it and read after it
    s1m = init_state(p1m, dev)
    phase7_blocks(s1m, p1m, scene1m, dev, card, ms_main, paths)
    walls.mark("7")
    with tempfile.TemporaryDirectory() as tmp:
        phase8_exact(tmp, dev, card, paths)
    walls.mark("8")

    # phase 9 drives the finer query blocks, the other block sizes and the
    # aabb refine, each shape a path of its own; phases 10 and 11 the
    # renderer and the emitter on the main path
    phase9_shapes(s1m, p1m, scene1m, dev, card, ms_main, paths)
    walls.mark("9")
    # phase 14 drives the identity mode, a path of its own
    phase14_mxu(s1m, p1m, scene1m, p64, scene64, dev, card, ms_main, paths)
    del s1m
    torch.cuda.empty_cache()
    walls.mark("14")
    phase10_view(dev, card, VIEW_FRAMES)
    torch.cuda.empty_cache()
    walls.mark("10")
    phase11_emitter(dev, card, EMITTER_FRAMES)
    walls.mark("11")
    # phase 12 drives the mesh path: 4 ranks on the card, each with its
    # counts set to 0 before and read after
    with tempfile.TemporaryDirectory() as tmp:
        phase12_mesh(dev, card, ms_main, ms_16wide, paths, stats, tmp)
    walls.mark("12")
    # phase 13: the diagnostic probes on the card; the stream probes run
    # the stream kernels, each probe counting their launches from 0
    paths["probe"] = phase13_probes(card, stats)
    walls.mark("13")

    launches = {rec: sum(paths[path][rec] for path in spec[4])
                for rec, spec in KERNELS.items()}
    required = {"main": ("density_c16", "forces_q32_c8"),
                "16-wide": ("density_c16 hit_sub 16", "density_c16 hit_sub 16, hit2_h",
                            "density_gated16", "forces_q32_c16"),
                "deep": ("density_c32", "density_c32 groups 1", "density_c32 hit_sub 16",
                         "forces_q32_c16", "forces_q32_c32", "forces_q128_c32"),
                "row": ("density_blocks row", "forces_blocks row"),
                "fine": ("density_blocks fine", "forces_blocks fine"),
                "asym": ("density_blocks asym", "forces_blocks asym"),
                "asm": ("density_c32 groups 1 (asm)", "forces_q128_c32 (asm)"),
                "exact": ("radix_sort",),
                "q64": ("density_c32 groups 1, rows 64", "forces_q128_c32 rows 64"),
                "q32": ("density_c32 groups 1, rows 32", "forces_q128_c32 rows 32"),
                "b64": ("density_c32 groups 1, rows 64", "forces_q128_c32 rows 64"),
                "asm32": ("density_c32 groups 1, rows 32 (asm)",
                          "forces_q128_c32 rows 32 (asm)"),
                "b64-row": ("density_blocks row, block 64", "forces_blocks row, block 64"),
                "q32-full": ("density_c32 densities only, rows 32", "forces_q128_c32 rows 32"),
                "mesh": ("density_c16 hit_sub 16", "forces_q32_c16", "density_c32",
                         "density_c32 groups 1", "forces_q32_c32", "forces_q128_c32"),
                "probe": tuple(rec for rec, spec in KERNELS.items() if "probe" in spec[4]),
                "mxu": tuple(rec for rec, spec in KERNELS.items() if "mxu" in spec[4])}
    for path, recs in required.items():
        missing = [rec for rec in recs if paths[path][rec] <= 0]
        if missing:
            raise RuntimeError(f"the {path} path did not launch {missing}: {paths[path]}")
    log(f"launches by path: {json.dumps(paths)}")

    record = []
    for rec, (_, _, src, replaces, _) in KERNELS.items():
        ms_k, ms_p, nbytes_, ops = stats[rec]["bench"]
        bound_ms, bound_by = bound(nbytes_, ops)
        record.append(dict(name=rec, route="cuda", source=src, replaces=replaces,
                           launches=launches[rec], max_abs_err=stats[rec]["max_abs_err"],
                           ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=stats[rec].get("library_ms")))
    log(f"phase walls {json.dumps({k: round(v, 2) for k, v in walls.walls.items()})}; "
        f"total {walls.total():.2f} s")
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
