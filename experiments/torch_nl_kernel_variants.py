#!/usr/bin/env python3
"""The force sums alone on pre-gathered candidate streams of the aabb
lists, in the stream's two layouts, and the asm route on the same lists
(the port's counterpart of the JAX package's
experiments/nl_kernel_variants.py).

    python3 experiments/torch_nl_kernel_variants.py [--n 1000000]
        [--reps 5] [--device cuda|cpu]

Setup: ``torch_force_kernel_bisect.setup`` with the aabb refine
(``refine_candidates``, subblock boxes against the block's split boxes)
at 192 slots and the lists not compacted, as the JAX probe's ``prep``
builds them. As in the bisect probe, each stream is held bit for bit
against its plain gather and the staged sums against their plain
version; a disagreement fails the probe. Lines (times, device times, plain
times and bounds as the bisect probe's):

* ``gather_stream`` in the staged and planes layouts;
* ``forces_c32_stream`` sums on the staged stream, the counterpart of
  the JAX probe's "forces flat2d TPS=8" (``forces_flat2d_tps``,
  nl_kernel_variants.py:127), and on the planes, of "forces tile3d
  TPS=1" (``forces_tile3d``, :163);
* "asm e2e": ``density_c32`` at 1 group and ``forces_q128_c32`` over the
  same lists (the JAX probe's ``fused_density_asm`` and
  ``fused_forces_asm`` on them, :190-248).

``forces_flat2d_mxu`` (:356) and ``forces_flat2d_mxu2`` (:475) reduce
the ten sums as one matrix-unit product, with row- or column-layout
combines; the port's sums are fp32 FMAs on the CUDA cores in one order,
so the staged sums line serves both (``served_by``). The tile-step
widths (TPS 8 against 1) have no counterpart either: the port's kernel
stages four slots a round whatever the layout. Prints one JSON line
last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import torch_force_kernel_bisect as bisect  # noqa: E402 (puts the root on sys.path)
import bench_torch  # noqa: E402
import kernel_bounds  # noqa: E402

N = 1_000_000
MAX_SUB = 192
REPS = 5
COUNTERPARTS = {
    "forces_c32_stream sums": "nl_kernel_variants.py:127 forces flat2d TPS=8",
    "forces_c32_stream planes": "nl_kernel_variants.py:163 forces tile3d TPS=1",
}
SERVED_BY = {
    "nl_kernel_variants.py:356 forces_flat2d_mxu": "forces_c32_stream sums",
    "nl_kernel_variants.py:475 forces_flat2d_mxu2": "forces_c32_stream sums",
}


def run(n: int = N, device="cuda", reps: int = REPS) -> dict:
    """The probe's record at ``n`` particles (see the module's
    docstring)."""
    from libclsph_tpu_torch.ops import kernels

    s = bisect.setup(n, device, refine="aabb", max_sub=MAX_SUB, compact=False)
    dev, params = s["device"], s["params"]
    cand, count = s["cand_f"], s["count_f"]
    kernels.reset_launch_counts()
    lines, got = bisect.stream_lines(s, reps, full=False)
    dargs = (s["pos4"], cand, count, params)
    fargs = (s["f8"], s["dens"], s["real"], cand, count, params)
    lines["asm e2e density_c32 groups 1"] = bisect.line(
        lambda: kernels.density_c32(*dargs, groups=1), dev, reps,
        (kernel_bounds.nbytes(*dargs[:3], s["dens"]), 0))
    lines["asm e2e forces_q128_c32"] = bisect.line(
        lambda: kernels.forces_q128_c32(*fargs), dev, reps, got["work"]["forces_q128_c32"])
    return dict(
        metric=f"force sums on pre-gathered streams @ {n} particles", n=n,
        blocks=s["blocks"], refine="aabb", max_sub=MAX_SUB, compacted=False,
        flags=s["flags"], main_config=s["main_config"], live_slots=got["live"] // bisect.SUB,
        live_bytes=got["live"] * bisect.RECORD_BYTES,
        stream_bytes=cand.numel() * bisect.SUB * bisect.RECORD_BYTES,
        count_mean=float(count.float().mean()), pairs_in_support=got["pairs_in"],
        sums_err_vs_plain=got["sums_err"], planes_equal_staged=got["planes_equal_staged"],
        lines=lines,
        counterparts=COUNTERPARTS, served_by=SERVED_BY,
        launches=kernels.launch_counts(), device=str(dev),
        card=bench_torch.card_line() if dev.type == "cuda" else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.device, args.reps)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_nl_kernel_variants: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
