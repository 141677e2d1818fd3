#!/usr/bin/env python3
"""Substep-by-substep dynamics and table sizes of bench_torch's dam-break
at N particles (the JAX package's experiments/scale_diag.py).

    python3 experiments/torch_scale_diag.py [--n 2000000] [--warmup 3]
        [--steps 10] [--device cuda|cpu]

bench_torch's run, substep by substep: its warm-up of ``--warmup``
substeps re-run from the start with the engine's growth until no flag is
raised, then ``--steps`` substeps from the warm state grown the same way
(the window that bench_torch rehearses before it times it), both through
``bench_torch.warm_up`` with its per-substep and per-growth callbacks.
Nothing here changes a result: the tables are sized again from each
substep's input state, beside the run.

For each substep of each attempt: dt and flags; max |v|, max and min
density, whether any field is NaN; the Morton block count; the blocks a
block needs (the coarse search with room for every candidate), and on
more than 1,024 blocks the hierarchical search's superblock shortlists
(their deepest row against the cap the search gives them,
``tiles.super_cand_for``: a row past it raises ``FLAG_CAPACITY`` however
many blocks a block needs); and max and p99 ``count_sub`` of the refine
at the config's capacities. After every growth step, the grown tables.
Prints one JSON line a substep and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import bench_torch  # noqa: E402

N = 2_000_000
WARMUP = 3
STEPS = 10


def search_sizes(state, params, cfg) -> dict:
    """The tables a rebuild from ``state`` would build on ``cfg``: block
    count, the blocks each block needs (no cap), the superblock rows
    against their cap (hierarchical search only), and the refine's
    ``count_sub`` at the config's capacities."""
    import torch

    from libclsph_tpu_torch.engine import step
    from libclsph_tpu_torch.ops import tiles

    bsize = cfg.block_size
    st, real, _ = step.pad_and_sort(state, params, True, block_size=bsize)
    nb = st.n // bsize
    h = params.h * (1.0 + cfg.cand_slack) if cfg.cand_interval > 1 else params.h
    bmin, bmax = tiles.split_block_bounds(st.position.reshape(nb, bsize, 3),
                                          real.reshape(nb, bsize))
    out = dict(blocks=nb, super_rows_max=None, super_cap=None)
    if nb > tiles.HIERARCHICAL_THRESHOLD and nb % tiles.SUPER == 0:
        cap1 = tiles.super_cand_for(nb, cfg.max_candidates)
        rows1 = tiles.superblock_candidates(bmin, bmax, h, cap1)[2]
        wide = int(rows1.max())
        out.update(super_rows_max=wide, super_cap=cap1)
        # shortlists as deep as the deepest row: every block a block needs
        count = tiles.candidate_blocks_hierarchical(bmin, bmax, h, wide * tiles.SUPER,
                                                    super_cand=wide)[1]
    else:
        count = tiles.candidate_blocks(bmin, bmax, h, nb)[1]
    _, count_sub, flags = step.build_candidates(st, real, params, cfg)
    cs = count_sub.float()
    out.update(count_max=int(count.max()), count_p99=float(torch.quantile(count.float(), 0.99)),
               count_sub_max=int(count_sub.max()), count_sub_p99=float(torch.quantile(cs, 0.99)),
               build_flags=int(flags))
    return out


def state_stats(state) -> dict:
    import torch

    speed = torch.linalg.vector_norm(state.velocity, dim=1)
    fields = (state.position, state.velocity, state.density)
    return dict(max_speed=float(speed.max()), max_density=float(state.density.max()),
                min_density=float(state.density.min()),
                nan=bool(any(torch.isnan(f).any() for f in fields)))


def table_shape(cfg) -> dict:
    from libclsph_tpu_torch.parallel import bench

    return dict(bench.table_shape(cfg), cand_slack=cfg.cand_slack, tier2_mult=cfg.tier2_mult)


def run(n: int = N, warmup: int = WARMUP, steps: int = STEPS, device="cuda",
        log=lambda line: None) -> dict:
    """The probe's record at ``n`` particles: ``rows`` (one a substep),
    ``growth`` (one a growth step), the final tables."""
    import torch

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
    dt0 = torch.tensor(params.max_dt, dtype=torch.float32, device=dev)
    rows, growth = [], []
    at = dict(phase="warmup", attempt=0)

    def on_substep(i, before, after, d, f, cfg):
        row = dict(at, substep=i, rebuild=i % cfg.cand_interval == 0,
                   **search_sizes(before, params, cfg))
        row.update(dt=float(d), flags=int(f), **state_stats(after))
        rows.append(row)
        log(json.dumps(row))

    def on_rerun(flags):
        grew = dict(at, flags=int(flags), tables=table_shape(engine.step_config))
        growth.append(grew)
        log(json.dumps(dict(growth=grew)))
        at["attempt"] += 1

    start = table_shape(engine.step_config)
    state, dt = bench_torch.warm_up(init_state(params, dev), params, scene, engine, warmup,
                                    dt0, on_substep=on_substep, on_rerun=on_rerun)
    at.update(phase="steps", attempt=0)
    bench_torch.warm_up(state, params, scene, engine, steps, dt, on_substep=on_substep,
                        on_rerun=on_rerun)
    last = [r for r in rows if r["phase"] == "steps"][-steps:]
    return dict(metric=f"water dam-break @ {n} particles, substep by substep", n=n,
                warmup=warmup, steps=steps, start=start, growth=growth,
                final=table_shape(engine.step_config), rows=rows,
                final_dt=last[-1]["dt"], final_flags=int(np.bitwise_or.reduce(
                    [r["flags"] for r in last])),
                device=str(dev), card=bench_torch.card_line() if dev.type == "cuda" else None,
                host_cpu=bench_torch.host_cpu())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        out = run(args.n, args.warmup, args.steps, args.device,
                  log=lambda line: print(line, flush=True))
    except (RuntimeError, ValueError) as e:
        sys.exit(f"torch_scale_diag: {e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
