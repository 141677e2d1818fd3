#!/usr/bin/env python3
"""Where the rebuild's refine spends its time, on the port (the JAX
package's experiments/refine_probe.py and the refine rows of
experiments/overhead_profile.py:104-140).

    python3 experiments/torch_refine_probe.py [--n 1000000] [--settle 8]
        [--rows 128 64 32] [--reps 5] [--device cuda|cpu]

bench_torch's dam-break of N particles onto ``scenes/cube.obj`` settles
``--settle`` substeps on the main path (bench_torch's warm-up, with the
engine's growth). Then, for each query width (``nl_query_rows``, with
bench_torch's clamps: below 128 rows the 32-granular tables and a rebuild
every substep), on the settled state sorted as a rebuild sorts it:

* the coarse block lists, and on the same lists both refines, the aabb
  one (``tiles.refine_candidates``) and the exact one
  (``kernels.refine.refine_candidates_exact``): the distributions of ``count`` and
  ``count_sub`` (mean, p50, p99, max), the overflow flags, and the pair
  slots a particle (mean ``count_sub`` x subblock size);
* the time of the exact refine's three parts: the gathered (rows, M, B,
  3) position stream (``tiles.refine_exact_gather``), its distance test
  (``tiles.refine_exact_test``) and the row sort
  (``tiles._self_priority_sort``), chunk by chunk as the refine runs them;
  then of ``engine.step.hit_lists`` and, inside it,
  ``tiles.compact_hits``, on the density kernel's hits over the exact
  table;
* the share of each part in the device time of one rebuild substep of
  that width from the settled state.

Times: on the card, CUDA events (median of ``--reps``) and the device
time that ``utils.profiling.trace`` records (kernels and copies); on the
CPU, the host clock and no device time. The tables the parts assemble
are checked id for id against the engine's stage's,
``kernels.refine.refine_candidates_exact`` (on the card, the CUDA
kernel's keys). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
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

ROWS = (128, 64, 32)
SETTLE = 8
REPS = 5


def device_ms(fn, tries: int = 3) -> float:
    """Device time (ms) of one call of ``fn`` on the card: the kernels and
    copies that ``utils.profiling.trace`` records. A trace that recorded
    no device work at all is taken again, up to ``tries`` times (in a
    process that has traced many times before, a trace can come back
    without its device records); after that, raises."""
    from torch.autograd import DeviceType

    from libclsph_tpu_torch.utils import profiling

    for _ in range(tries):
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp) as prof:
                fn()
                bench_torch.sync("cuda")
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)]
        if events:
            return sum(e.self_device_time_total for e in events) / 1e3
    raise RuntimeError(f"{tries} traces recorded no device work")


def timed(fn, device, reps: int, trace: bool = True) -> dict:
    """``ms``: the median of ``reps`` calls after one untimed call (CUDA
    events on the card, the host clock on the CPU); ``device_ms``: the
    device time of one call on the card, None on the CPU or without
    ``trace``."""
    import torch

    fn()
    bench_torch.sync(device)
    laps = []
    for _ in range(reps):
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            laps.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            laps.append(1000.0 * (time.perf_counter() - t0))
    return dict(ms=statistics.median(laps),
                device_ms=device_ms(fn) if trace and device.type == "cuda" else None)


def distribution(count) -> dict:
    c = count.cpu().numpy()
    return dict(mean=float(c.mean()), p50=float(np.percentile(c, 50)),
                p99=float(np.percentile(c, 99)), max=int(c.max()))


def refine_parts(cand, count, qlo, qhi, pos_blocked, h, sub, max_sub, self_lo=None,
                 self_width=1, reps=REPS):
    """The exact refine in its three parts, each run over every chunk and
    timed (:func:`timed`): ``gather``, ``test`` and ``sort``. Returns
    (cand_sub, count_sub, overflow, the parts' times), the tables as
    ``tiles.refine_candidates_exact`` returns them."""
    import torch

    from libclsph_tpu_torch.ops import tiles

    dev = cand.device
    chunks = tiles.refine_exact_chunks(cand, pos_blocked.shape[1])
    gathered, tested = [None] * len(chunks), [None] * len(chunks)

    def gather():
        for i, rows in enumerate(chunks):
            gathered[i] = tiles.refine_exact_gather(cand, count, pos_blocked, rows)

    def test():
        for i, rows in enumerate(chunks):
            tested[i] = tiles.refine_exact_test(gathered[i], cand, count, qlo, qhi, h, sub, rows)

    parts = dict(gather=timed(gather, dev, reps), test=timed(test, dev, reps))
    gathered.clear()
    keys = torch.cat([k for k, _ in tested])
    count_sub = torch.cat([n for _, n in tested])
    out = []

    def sort():
        out[:] = [tiles._self_priority_sort(keys, self_lo, self_width, max_sub)]

    parts["sort"] = timed(sort, dev, reps)
    overflow = torch.any(count_sub > max_sub)
    return (out[0].to(torch.int32), torch.clamp(count_sub, max=max_sub), overflow, parts)


def width_config(rows: int, grown):
    """bench_torch's config at ``nl_query_rows`` = ``rows`` (its clamps),
    with the capacities the main path grew to."""
    args = bench_torch.build_arg_parser().parse_args(["--nl-query-rows", str(rows)])
    cfg = bench_torch.config_from_args(args)
    keep = ("max_candidates", "max_candidates_sub", "cand_slack")
    return dataclasses.replace(cfg, **{k: getattr(grown, k) for k in keep})


def probe_width(state, dt, params, scene, cfg, reps) -> dict:
    """One query width's record (see the module's docstring)."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import kernels, tiles

    bsize, q_rows, q_rep = cfg.block_size, cfg.q_rows, cfg.q_rep
    st, real, _ = step.pad_and_sort(state, params, True, block_size=bsize)
    nb = st.n // bsize
    nq = nb * q_rep
    sub = bsize // cfg.subblock
    h = params.h * (1.0 + cfg.cand_slack) if cfg.cand_interval > 1 else params.h
    cap_sub = cfg.max_candidates_sub * (cfg.tier2_mult if cfg.two_tier else 1)
    pos_b = st.position.reshape(nb, bsize, 3)
    real_b = real.reshape(nb, bsize)
    bmin, bmax = tiles.split_block_bounds(pos_b, real_b)
    cand, count, ovf = tiles.candidate_blocks_auto(bmin, bmax, h, cfg.max_candidates)
    if q_rep > 1:
        cand = torch.repeat_interleave(cand, q_rep, dim=0)
        count = torch.repeat_interleave(count, q_rep)
    self_lo = (torch.arange(nq, dtype=torch.int32, device=st.device) // q_rep) * sub
    # the exact refine against the split boxes of each query block's rows
    if q_rep > 1:
        qlo, qhi = tiles.split_block_bounds(st.position.reshape(nq, q_rows, 3),
                                            real.reshape(nq, q_rows))
    else:
        qlo, qhi = bmin, bmax
    cand_sub, count_sub, ovf_ex, parts = refine_parts(cand, count, qlo, qhi, pos_b, h, sub,
                                                      cap_sub, self_lo, sub, reps)
    ref = kernels.refine.refine_candidates_exact(cand, count, qlo, qhi, pos_b, h, sub,
                                                 cap_sub, self_lo=self_lo, self_width=sub)
    equal = bool(torch.equal(cand_sub, ref[0]) and torch.equal(count_sub, ref[1]))
    # the aabb refine on the same lists: subblock boxes against query boxes
    sub_lo, sub_hi = tiles.subblock_bounds(pos_b, real_b, sub)
    if q_rep > 1:
        alo, ahi = tiles.subblock_bounds(pos_b, real_b, q_rep)
        alo, ahi = alo[:, None, :], ahi[:, None, :]
    else:
        alo, ahi = bmin, bmax
    _, count_aabb, ovf_aabb = tiles.refine_candidates(cand, count, alo, ahi, sub_lo, sub_hi,
                                                      h, sub, cap_sub, self_lo=self_lo,
                                                      self_width=sub)
    rec = dict(
        nl_query_rows=q_rows, config=str(cfg), blocks=nb, query_blocks=nq,
        coarse=dict(cap=cfg.max_candidates, overflow=bool(ovf), **distribution(count)),
        aabb=dict(cap=cap_sub, overflow=bool(ovf_aabb), **distribution(count_aabb),
                  pair_slots_per_particle=float(count_aabb.float().mean()) * cfg.subblock),
        exact=dict(cap=cap_sub, overflow=bool(ovf_ex), **distribution(count_sub),
                   pair_slots_per_particle=float(count_sub.float().mean()) * cfg.subblock,
                   tables_equal_refine_candidates_exact=equal),
        parts=parts)
    # the hit lists on the density kernel's hits over the exact table
    groups = step._groups(cfg, 1)
    if cfg.hit_compact and not cfg.two_tier:
        pos4 = kernels.pos_pack(st.position, real)
        _, hits = step._density_pass(pos4, cand_sub, count_sub, params, cfg, groups)
        parts["hit_lists"] = timed(lambda: step.hit_lists(cand_sub, hits, cfg, groups),
                                   st.device, reps)
        ids, lo, width_self, width = step.hit_ids(cand_sub, cfg, groups)
        cap = step._hit_cap(cfg, width, groups)
        parts["compact_hits"] = timed(
            lambda: tiles.compact_hits(ids, hits[:, : ids.shape[1]], cap, self_lo=lo,
                                       self_width=width_self), st.device, reps)
    # one rebuild substep of this width from the settled state
    rebuild = timed(lambda: step.substep(state, dt, params, scene, cfg), st.device, reps)
    rec["rebuild_substep"] = rebuild
    key = "device_ms" if st.device.type == "cuda" else "ms"
    rec["share_of_rebuild"] = {k: v[key] / rebuild[key] for k, v in parts.items()}
    rec["share_clock"] = "device time" if key == "device_ms" else "host clock"
    return rec


def run(n: int, settle: int = SETTLE, rows=ROWS, device="cuda", reps: int = REPS) -> dict:
    """The probe's record at ``n`` particles (see the module's
    docstring)."""
    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.engine.step import StepConfig
    from libclsph_tpu_torch.ops import collisions
    from libclsph_tpu_torch.scene.scene import Scene

    dev = configure_device(device)
    params = bench_torch.build_params(n)
    scene = collisions.build_device_scene(
        Scene.load("cube.obj", params.h * 2, scenes_dir=os.path.join(ROOT, "scenes")), dev)
    engine = SPHSimulation(StepConfig(), device=dev, pretune=False)
    state, dt = bench_torch.warm_up(init_state(params, dev), params, scene, engine, settle)
    widths = [probe_width(state, dt, params, scene, width_config(r, engine.step_config), reps)
              for r in rows]
    return dict(metric=f"refine split @ {n} particles, settled {settle} substeps", n=n,
                settle=settle, main_config=str(engine.step_config), widths=widths,
                device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None,
                host_cpu=bench_torch.host_cpu())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=bench_torch.N_CARD)
    ap.add_argument("--settle", type=int, default=SETTLE)
    ap.add_argument("--rows", type=int, nargs="+", default=list(ROWS), choices=ROWS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.settle, args.rows, args.device, args.reps)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_refine_probe: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
