#!/usr/bin/env python3
"""The 64k end to end (``experiments/torch_e2e_64k.py``, with export) and
the 256k emitter (``experiments/torch_emitter_run.py``) of a parent
checkout against this tree, in turns on one card, each run a process of
its own.

    python3 experiments/torch_e2e_ab.py --parent DIR [--pairs 10] [--frames 30]
        [--variants] [--emitter-pairs 3] [--emitter-frames 12] [--out FILE]
        [--device cuda|cpu] [--n N] [--emitter-n N]

A round runs the parent and this tree, and with ``--variants`` also this
tree with ``--fetch inline`` (the host copy on the loop thread) and with
``--loop reads`` (a host read before each predicate), in an order that
reverses every round. Then the emitter, parent and this tree in turns.
Prints one JSON line a run and one JSON line last: for each 64k variant
the median over its runs of their median and mean s/frame, and for each
round the change's median less the parent's; the same for the emitter.
``--out``: also appends every line to FILE; ``--device``, ``--n`` and
``--emitter-n`` go to the runs (the defaults: the card, the runners' own
sizes).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tree: str, script: str, args: list, timeout: int = 600) -> dict:
    """``script`` of checkout ``tree`` as a process of its own; its last
    stdout line as JSON."""
    env = {k: v for k, v in os.environ.items() if k != "LIBCLSPH_TPU_SORT"}
    out = subprocess.run([sys.executable, os.path.join(tree, script), *args], cwd=tree,
                         env=env, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}/{script} exited {out.returncode}: {out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout of the parent commit")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--emitter-pairs", type=int, default=3)
    ap.add_argument("--emitter-frames", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--emitter-n", type=int, default=None)
    args = ap.parse_args(argv)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    e2e = os.path.join("experiments", "torch_e2e_64k.py")
    common = ["--device", args.device]
    e2e_args = common + ([] if args.n is None else ["--n", str(args.n)])
    em_args = common + ([] if args.emitter_n is None else ["--n", str(args.emitter_n)])
    parent = os.path.abspath(args.parent)
    kinds = [("parent", parent, []), ("change", ROOT, [])]
    if args.variants:
        kinds += [("change_inline_fetch", ROOT, ["--fetch", "inline"]),
                  ("change_read_loop", ROOT, ["--loop", "reads"])]
    runs = []
    for r in range(args.pairs):
        for name, tree, extra in (kinds if r % 2 == 0 else kinds[::-1]):
            out = run(tree, e2e, ["--frames", str(args.frames), *e2e_args, *extra])
            rec = dict(run="e2e64k", round=r, tree=name, median_s=out["median_s_per_frame"],
                       mean_s=out["mean_s_per_frame"], p90_s=out["p90_s_per_frame"],
                       first_s=out["first_frame_s"], wall_s=out["wall_s"],
                       dispatch_stats=out.get("dispatch_stats"), card=out.get("card"))
            runs.append(rec)
            emit(rec)
    em_runs = []
    em = os.path.join("experiments", "torch_emitter_run.py")
    for r in range(args.emitter_pairs):
        for name, tree in ((("parent", parent), ("change", ROOT)) if r % 2 == 0
                           else (("change", ROOT), ("parent", parent))):
            out = run(tree, em, ["--frames", str(args.emitter_frames), *em_args])
            rec = dict(run="emitter", round=r, tree=name,
                       median_s=out["median_s_per_frame"],
                       mean_s=out["mean_s_per_frame"],
                       s_per_frame=out["s_per_frame"], substeps=out["substeps"])
            em_runs.append(rec)
            emit(rec)

    def summary(recs):
        names = list(dict.fromkeys(x["tree"] for x in recs))
        res = {}
        for name in names:
            mine = [x for x in recs if x["tree"] == name]
            res[name] = dict(runs=len(mine),
                             median_of_medians=statistics.median(x["median_s"] for x in mine),
                             median_of_means=statistics.median(x["mean_s"] for x in mine))
        for name in names[1:]:
            diffs = [a["median_s"] - b["median_s"] for a in recs for b in recs
                     if a["tree"] == name and b["tree"] == "parent" and a["round"] == b["round"]]
            res[name]["median_less_parent_by_round"] = diffs
            res[name]["rounds_slower"] = sum(d > 0 for d in diffs)
        return res

    emit(dict(run="summary", e2e64k=summary(runs) if runs else None,
              emitter=summary(em_runs) if em_runs else None,
              card=runs[0]["card"] if runs else None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
