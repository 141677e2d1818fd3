#!/usr/bin/env python3
"""Bisect the q128 force kernel's time on the port (the JAX package's
experiments/force_kernel_bisect.py): the sums alone on a candidate
stream gathered beforehand, split into the feed, the support test and
the pair terms.

    python3 experiments/torch_force_kernel_bisect.py [--n 1000000]
        [--reps 5] [--device cuda|cpu]

Setup (:func:`setup`, shared with ``torch_nl_kernel_variants.py``):
bench_torch's dam-break of N particles, 3 main-path substeps with no
scene and the engine's growth, then on that state sorted as a rebuild
sorts it the q128 machinery at h: the block search
(``candidate_blocks_auto``, 96), the exact refine to 32-particle
subblocks (4 a block, 128 slots), ``density_c32``'s hits per block and
the hit-compacted lists (96 slots); the force pack from those densities.

Lines, each with its time (CUDA events, median of ``--reps``; on the CPU
the host clock), its device time (``utils.profiling.trace``; None on the
CPU), its work (``bytes``, ``ops``: ``kernel_bounds.stream_works`` counts
them) and its bound (the larger of bytes at 3.35 TB/s and fp32
operations at 67 TFLOP/s); the stream kernels' lines also carry their
plain version's time (``plain_ms``, CUDA events, median of 2 after one
untimed call; None on the CPU, where the kernel's line is the plain
version). Each stream is held bit for bit against
``gather_stream_torch`` and its staged sums against
``forces_c32_stream_torch`` on the same stream (each sum within 1e-5 of
its largest |value|, ``stream.sums_error``); a disagreement fails the
probe, which then prints no record:

* ``gather_stream`` of the compacted lists (staged and planes layouts),
  and ``torch.index_select`` of the f8 rows by the same ids (the JAX
  probe's "gather_raw force" line);
* ``forces_c32_stream`` in its modes: sums (staged, cull), planes, no
  cull, test (the pair terms compiled out), and the zero-count control
  (sums with every count 0: launch and queries only);
* ``forces_q128_c32`` on the same lists (the feed fused into the
  kernel), and the stream's accel mode beside it with
  ``bit_equal_to_forces_q128_c32``;
* ``density_c32`` at 1 group on the refined table, for reference.

The JAX probe's dot modes (highest, split3, default) have no line: the
port's sums are fp32 FMAs on the CUDA cores in one order, with no matrix
unit to vary. ``split`` divides ``forces_q128_c32``'s time into the feed
(fused minus sums), the test (test minus zero-count) and the terms (sums
minus test). Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import bench_torch  # noqa: E402
import kernel_bounds  # noqa: E402
from torch_refine_probe import timed  # noqa: E402

N = 1_000_000
SETTLE = 3
MAX_CAND = 96  # blocks a block (candidate_blocks_auto)
MAX_SUB = 128  # refined 32-particle subblocks a block
MAX_HIT = 96  # hit-compacted slots a block
REPS = 5
PLAIN_REPS = 2  # timed calls of a plain version (about 0.7 s each at 1M)
SUB = 32
RECORD_BYTES = 48  # a staged record: three float4


def setup(n: int, device, refine: str = "exact", max_sub: int = MAX_SUB,
          compact: bool = True) -> dict:
    """The probes' inputs (see the module's docstring): ``refine`` "exact"
    or "aabb" at ``max_sub`` slots; with ``compact`` the hit lists
    (``cand_f``, ``count_f``), else the refined table itself."""
    import torch

    from libclsph_tpu_torch.core.state import init_state
    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.engine.simulation import SPHSimulation, configure_device
    from libclsph_tpu_torch.ops import kernels

    dev = configure_device(device)
    params = bench_torch.build_params(n)
    engine = SPHSimulation(step.StepConfig(), device=dev, pretune=False)
    state, _ = bench_torch.warm_up(init_state(params, dev), params, None, engine, SETTLE)
    cfg = step.StepConfig(density_sub16=False, force_sub16=False, force_sub8=False,
                          force_query_rows=128, refine_mode=refine, cand_interval=1,
                          max_candidates=MAX_CAND, max_candidates_sub=max_sub,
                          max_candidates_hit=MAX_HIT)
    st, real, _ = step.pad_and_sort(state, params, True)
    cand_sub, count_sub, flags = step.build_candidates(st, real, params, cfg)
    pos4 = kernels.pos_pack(st.position, real)
    dens, hits = kernels.density_c32(pos4, cand_sub, count_sub, params, groups=1)
    if compact:
        cand_f, count_f, hit_flags = step.hit_lists(cand_sub, hits, cfg, 1)
        flags = flags | hit_flags
    else:
        cand_f, count_f = cand_sub.contiguous(), count_sub.contiguous()
    _, f8 = step._pressure_and_pack(st, real, dens, params)
    bench_torch.sync(dev)
    return dict(device=dev, params=params, config=cfg, real=real, pos4=pos4, dens=dens,
                f8=f8, cand_sub=cand_sub, count_sub=count_sub, cand_f=cand_f,
                count_f=count_f, flags=int(flags), blocks=st.n // 128,
                main_config=str(engine.step_config))


def line(fn, dev, reps, work) -> dict:
    """:func:`torch_refine_probe.timed` of ``fn`` with its ``work``
    (bytes, operations) and their bound."""
    rec = timed(fn, dev, reps)
    rec["bytes"], rec["ops"] = work
    rec["bound_ms"], rec["bound_by"] = kernel_bounds.bound(*work)
    return rec


def plain_time(fn, dev):
    """A plain version's event time on the card (median of PLAIN_REPS
    after one untimed call); None on the CPU, where the kernel's line is
    the plain version."""
    return timed(fn, dev, PLAIN_REPS, trace=False)["ms"] if dev.type == "cuda" else None


def stream_lines(s: dict, reps: int, full: bool = True) -> tuple:
    """The stream kernels on ``s``'s lists: ``gather_stream`` in both
    layouts and ``forces_c32_stream``'s sums on each, each beside its
    plain version; with ``full`` also the no-cull, test, zero-count and
    accel modes. First, before any profiler trace, each stream is held bit
    for bit against its plain gather and the staged sums against their
    plain version (a disagreement raises), and the plain versions are
    timed; then the kernels are timed and traced. The plain versions'
    thousands of launches made between traces left later traces without
    device records (the 1M lists on the H100: three tries in a row, in
    both probes), so no plain version runs after the first trace. Returns
    (lines, facts: the live records, the pairs inside the support, the
    work of each line, the staged sums' largest difference from their
    plain version, and whether the planes' sums equal the staged ones).
    Each stream is freed before the next is gathered."""
    import torch

    from libclsph_tpu_torch.ops.kernels import stream

    dev, f8, dens, real, params = s["device"], s["f8"], s["dens"], s["real"], s["params"]
    cand, count = s["cand_f"], s["count_f"]
    visc = stream.stream_visc(params)
    live = int(count.sum()) * SUB

    def gather(layout, plain=False):
        fn = stream.gather_stream_torch if plain else stream.gather_stream
        return lambda: fn(f8, cand, count, SUB, visc, layout)

    def sums_of(st, plain=False, **kw):
        fn = stream.forces_c32_stream_torch if plain else stream.forces_c32_stream
        return lambda: fn(f8, dens, real, st, count, params, **kw)

    def checked(layout):
        st = gather(layout)()
        if not torch.equal(st.view(torch.int32), gather(layout, plain=True)().view(torch.int32)):
            raise RuntimeError(f"gather_stream {layout}: the stream differs from its plain "
                               f"version")
        return st

    modes = {"forces_c32_stream sums": {}}
    if full:
        modes.update({"forces_c32_stream no cull": dict(cull=False),
                      "forces_c32_stream test": dict(out="test"),
                      "forces_c32_stream accel": dict(out="accel")})
    # the plain versions, before any trace
    st = checked("staged")
    sums = sums_of(st)()
    sums_err, bad = stream.sums_error(sums, sums_of(st, plain=True)())
    if bad >= 0:
        raise RuntimeError(f"forces_c32_stream sums: sum {bad} leaves its plain version "
                           f"(largest difference {sums_err:.3g})")
    pairs_in = int(sums_of(st, out="test")().sum())
    plain = {"gather_stream": plain_time(gather("staged", plain=True), dev)}
    plain.update({name: plain_time(sums_of(st, plain=True, **kw), dev)
                  for name, kw in modes.items()})
    del st
    planes = checked("planes")
    planes_equal = bool(torch.equal(sums_of(planes, layout="planes")(), sums))
    plain["gather_stream planes"] = plain_time(gather("planes", plain=True), dev)
    plain["forces_c32_stream planes"] = plain_time(
        sums_of(planes, plain=True, layout="planes"), dev)
    del planes, sums
    # the kernels, traced
    work = kernel_bounds.stream_works(f8, dens, real, cand, count, live, pairs_in)
    st = gather("staged")()
    lines = {"gather_stream": line(gather("staged"), dev, reps, work["gather_stream"])}
    for name, kw in modes.items():
        lines[name] = line(sums_of(st, **kw), dev, reps, work[name])
    if full:
        zero = torch.zeros_like(count)
        lines["forces_c32_stream count=0"] = line(
            lambda: stream.forces_c32_stream(f8, dens, real, st, zero, params), dev, reps,
            work["forces_c32_stream count=0"])
    del st
    planes = gather("planes")()
    lines["gather_stream planes"] = line(gather("planes"), dev, reps,
                                         work["gather_stream planes"])
    lines["forces_c32_stream planes"] = line(sums_of(planes, layout="planes"), dev, reps,
                                             work["forces_c32_stream planes"])
    del planes
    for name, ms in plain.items():
        lines[name]["plain_ms"] = ms
    return lines, dict(live=live, pairs_in=pairs_in, work=work, sums_err=sums_err,
                       planes_equal_staged=planes_equal)


def run(n: int = N, device="cuda", reps: int = REPS) -> dict:
    """The probe's record at ``n`` particles (see the module's
    docstring)."""
    import torch

    from libclsph_tpu_torch.ops import kernels
    from libclsph_tpu_torch.ops.kernels import stream

    s = setup(n, device)
    dev, f8, dens, real, params = s["device"], s["f8"], s["dens"], s["real"], s["params"]
    cand, count = s["cand_f"], s["count_f"]
    kernels.reset_launch_counts()
    slot = torch.arange(cand.shape[1], device=dev)
    ids = (torch.where(slot < count[:, None], cand, 0).to(torch.int64)[..., None] * SUB
           + torch.arange(SUB, device=dev)).reshape(-1)
    lines, got = stream_lines(s, reps)
    lines["index_select"] = line(lambda: f8.index_select(0, ids), dev, reps,
                                 (kernel_bounds.nbytes(f8, ids) + ids.numel() * 32, 0))
    del ids
    st = stream.gather_stream(f8, cand, count, SUB, stream.stream_visc(params))
    fused = kernels.forces_q128_c32(f8, dens, real, cand, count, params)
    accel = stream.forces_c32_stream(f8, dens, real, st, count, params, out="accel")
    bit_equal = bool(torch.equal(fused.view(torch.int32), accel.view(torch.int32)))
    del st, accel
    lines["forces_q128_c32"] = line(
        lambda: kernels.forces_q128_c32(f8, dens, real, cand, count, params), dev, reps,
        got["work"]["forces_q128_c32"])
    dargs = (s["pos4"], s["cand_sub"], s["count_sub"], params)
    lines["density_c32 groups 1"] = line(lambda: kernels.density_c32(*dargs, groups=1), dev,
                                         reps, (kernel_bounds.nbytes(*dargs[:3], dens), 0))
    launches = kernels.launch_counts()
    key = "device_ms" if dev.type == "cuda" else "ms"

    def split(k):
        sums, test = lines["forces_c32_stream sums"][k], lines["forces_c32_stream test"][k]
        return dict(feed=lines["forces_q128_c32"][k] - sums,
                    test=test - lines["forces_c32_stream count=0"][k], terms=sums - test)

    return dict(
        metric=f"q128 force kernel bisect @ {n} particles", n=n, blocks=s["blocks"],
        refine="exact", max_sub=MAX_SUB, max_hit=MAX_HIT, flags=s["flags"],
        main_config=s["main_config"], live_slots=got["live"] // SUB,
        live_records=got["live"], live_bytes=got["live"] * RECORD_BYTES,
        stream_bytes=cand.numel() * SUB * RECORD_BYTES,
        count_mean=float(count.float().mean()), pairs_in_support=got["pairs_in"],
        bit_equal_to_forces_q128_c32=bit_equal, sums_err_vs_plain=got["sums_err"],
        planes_equal_staged=got["planes_equal_staged"],
        split=split(key), split_events=split("ms"), split_clock=key,
        lines=lines, launches=launches,
        not_ported=("force_kernel_bisect.py:173-177's dot modes (highest, split3, default): "
                    "TPU matrix-unit precision; the port's sums are fp32 FMAs on the CUDA "
                    "cores in one order"),
        device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.device, args.reps)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_force_kernel_bisect: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
