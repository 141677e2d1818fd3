"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--shell-seeds 7,8,9] [--seconds S] [--out FILE]

In one process (the set-up's build and load paid once), for each seed:
the cell's set-up, a window of ``--seconds`` and the comparison, as a run
of ``run.py`` makes them; for each control seed also the control (the
reference computed in TF32 in the program's place; in a frame cell also
the exports written at one digit fewer), for each shell seed (substep
cells) the dropped-shell fault (the reference that leaves out the pairs
beyond ``judge.SHELL_CUT`` h). One JSON line a seed to ``--out`` (and
standard output): the numbers, the control's and the fault's numbers and
the seconds each part took. The benchmark's own runs never run either.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (
    BENCH, ROOT, os.path.dirname(os.path.abspath(__file__)))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--shell-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        raise SystemExit("readings.py: no CUDA device")
    dev = torch.device("cuda:0")
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    prm = harness.params_of(cfg)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    shells = {int(s) for s in args.shell_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        tmpdir = harness.new_tmpdir()
        t = [time.monotonic()]
        entry = harness.make_entry(cfg, traffic, seed, dev, harness.Clock(False), tmpdir)
        entry.control = seed in controls  # a mesh computes it in its ranks
        entry.setup()
        t.append(time.monotonic())
        window = entry.window(args.seconds)
        t.append(time.monotonic())
        entry.release()
        gc.collect()
        torch.cuda.empty_cache()
        numbers, _ = entry.judge(harness.scene_path(cfg), prm)
        t.append(time.monotonic())
        line = dict(workload=args.workload, seed=seed, numbers=numbers,
                    failed=window["failed"], replays=window["replays"],
                    seconds=dict(setup=t[1] - t[0], window=t[2] - t[1], judge=t[3] - t[2]))
        if seed in controls:
            line["control"] = entry.judge(harness.scene_path(cfg), prm, control=True)[0]
            line["seconds"]["control"] = time.monotonic() - t[3]
        if seed in shells:
            line["shell"] = entry.judge(harness.scene_path(cfg), prm, shell=True)[0]
        entry.cleanup()
        shutil.rmtree(tmpdir, ignore_errors=True)
        del entry
        gc.collect()
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
