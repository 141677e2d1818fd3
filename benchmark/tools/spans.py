"""The program's spans in a cell's traced replay, and the recorder's cost.

    python3 benchmark/tools/spans.py --workload <cell> --seed <n> \\
        [--seconds S] [--turns K] [--out DIR]

One ``run.py --trace 1`` run of the cell in this process (its window of
``--seconds``), then, from its traced replay, by the program's span names
(:func:`benchmark.progtrace.breakdown`): the device milliseconds and
operations launched with each span innermost on the launching thread and
the device-idle milliseconds with each span innermost on the loop thread;
in a substep cell the share of the substeps' device time that the stage
metrics account for, in a frame cell the share of the idle time that
falls inside a span below ``simulate``. With ``--turns K`` (substep
cells) a second set-up then runs 2K windows of ``--seconds``, with
``profiling.recording()`` off and on in turns (off, on, on, off, ...),
and gives each one's particle-steps per second. One JSON line on standard
output; with ``--out`` the program's spans and the reduced trace are
written there too.
"""

import argparse
import gzip
import io
import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (
    BENCH, ROOT, os.path.dirname(os.path.abspath(__file__)))]


def coverage(metrics: dict, prog) -> dict:
    """The substeps' device time that the stage metrics account for:
    rebuilds x (search + refine) + substeps x (passes + advect) over
    rebuilds x rebuild_device_ms + reuses x reuse_device_ms."""
    from benchmark import progtrace

    kinds = [s.attrs.get("kind") for s in progtrace.named(prog, "substep")]
    reb, reu = kinds.count("rebuild"), kinds.count("reuse")
    v = {k: metrics[k]["value"] for k in metrics}
    keys = ("search_device_ms", "refine_device_ms", "passes_device_ms", "advect_device_ms",
            "rebuild_device_ms", "reuse_device_ms")
    if not all(k in v for k in keys):
        return {}
    stages = (reb * (v["search_device_ms"] + v["refine_device_ms"])
              + (reb + reu) * (v["passes_device_ms"] + v["advect_device_ms"]))
    whole = reb * v["rebuild_device_ms"] + reu * v["reuse_device_ms"]
    return dict(rebuilds=reb, reuses=reu, stages_ms=stages, substeps_ms=whole,
                share=stages / whole if whole else None)


def idle_below(tr, prog, root: str) -> dict:
    """The idle time inside some span below ``root`` on the loop thread,
    and its share of all the window's idle time."""
    from benchmark import progtrace

    idle = progtrace.idle_by_span(tr, prog)
    total = sum(idle.values())
    below = sum(v for sid, v in idle.items() if sid is not None and prog.spans[sid].name != root)
    return dict(idle_ms=1e-3 * total, below_ms=1e-3 * below,
                share=below / total if total else None)


def turns(args, k: int) -> list:
    """2k windows of the cell's substeps, recording off and on in turns."""
    import torch

    from benchmark import harness, spec
    from libclsph_tpu_torch.utils import profiling

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    tmpdir = harness.new_tmpdir()
    try:
        entry = harness.make_entry(cfg, traffic, args.seed + 1,
                                   torch.device(args.device or "cuda:0"),
                                   harness.Clock(False), tmpdir)
        entry.setup()
        out = []
        for on in [False, True, True, False] * (k // 2) + [False, True] * (k % 2):
            if on:
                with profiling.recording():
                    w = entry.window(args.seconds)
            else:
                w = entry.window(args.seconds)
            out.append(dict(recording=on, particle_steps_per_s=w["work"] / w["elapsed"],
                            failed=w["failed"]))
            print(json.dumps(out[-1]), file=sys.stderr, flush=True)
        entry.release()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--turns", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="default: the cell's CUDA devices")
    args = ap.parse_args(argv)

    from benchmark import devtrace, progtrace, run
    from libclsph_tpu_torch.utils import profiling

    kept = []
    load = devtrace.load

    def keep(*a, **kw):
        kept.append(load(*a, **kw))
        return kept[-1]

    devtrace.load = keep
    result = run.run(run.parse(["--workload", args.workload, "--seed", str(args.seed),
                                "--seconds", str(args.seconds), "--trace", "1"]),
                     device=args.device, out=io.StringIO())
    devtrace.load = load
    tr = kept[-1]
    root = "simulate" if "frames" in args.workload else "dispatch"
    prog = progtrace.load(dict(trace=tr), root)
    line = dict(workload=args.workload, seed=args.seed, correct=result["correct"],
                device=result["device"], metrics=result["metrics"], anchored=prog is not None)
    if prog is not None:
        line["by_span"] = progtrace.breakdown(tr, prog)
        line["spans"] = {n: len(progtrace.named(prog, n))
                         for n in sorted({s.name for s in prog.spans.values()})}
        line["off_loop_thread"] = sorted({s.name for s in prog.spans.values()
                                          if s.tid != prog.loop_tid})
        if root == "dispatch":
            line["coverage"] = coverage(result["metrics"], prog)
        else:
            line["idle_below_simulate"] = idle_below(tr, prog, root)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        stem = os.path.join(args.out, f"{args.workload}.{args.seed}")
        profiling.write_spans(stem + ".spans.json")
        with gzip.open(stem + ".trace.json.gz", "wt") as f:
            json.dump(dict(ops=tr.ops, ranges=tr.ranges, window=tr.window,
                           launches={str(k): v for k, v in tr.launches.items()}), f)
    if args.turns:
        line["turns"] = turns(args, args.turns)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
