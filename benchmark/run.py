"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository, on a machine with as
many CUDA devices as the cell asks for. The cell is found by name in
``BENCHMARK.json``; its configuration, traffic, limits and metric readers
by the names there (:mod:`benchmark.spec`). The run makes its inputs from
the seed, warms up every shape its traffic uses (set-up, ``setup_s``),
measures for ``--seconds``, then holds what the timed path produced
against the plain reference (:mod:`benchmark.judge`). It prints the
numbers compared, each beside its limit, as its last lines on standard
error, and one JSON line as the last line of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones, read from a profiled replay of the segment after the
window. Without the devices, or with JAX or the JAX package loaded, it
prints no result and exits with a code other than 0.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# import the harness as the package ``benchmark`` from the checkout's root,
# and none of its modules by their bare names
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (BENCH, ROOT)]

# compile caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")

from benchmark.spec import forbidden_modules  # noqa: E402


def card(index: int = 0) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}",
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        name, limit = [x.strip() for x in out.stdout.strip().split(",")[:2]]
        return dict(smi_name=name, power_limit=limit)
    except (OSError, subprocess.SubprocessError, ValueError):
        return dict(smi_name=None, power_limit=None)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def run(args, device=None, out=sys.stdout) -> dict:
    """The run of ``args``; ``device``: where a test runs it (the CPU),
    which skips the look for the cell's CUDA devices."""
    import torch

    from benchmark import harness, spec

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = "cuda:0"
    dev = torch.device(device)
    cfg = spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    clock = harness.Clock(bool(args.trace))
    tmpdir = harness.new_tmpdir()
    try:
        entry = harness.make_entry(cfg, traffic, args.seed, dev, clock, tmpdir)
        entry.setup()
        window = entry.window(args.seconds)
        setup_s = window["start"] - T0
        traced = entry.trace(tmpdir) if args.trace else {}
        peak = entry.peak()
        entry.release()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        prm = harness.params_of(cfg)
        numbers, pairs = entry.judge(harness.scene_path(cfg), prm)
        compared = {k: [numbers[k], limits[k]] for k in limits}
        correct = all(v <= lim for v, lim in compared.values()) and window["failed"] == 0
        ctx = dict(cell=cell, config=cfg, traffic=traffic, params=prm, window=window,
                   setup_s=setup_s, spans=clock.spans, pairs_per_substep=pairs,
                   substeps_per_frame=getattr(entry, "substeps_per_frame", None), **traced)
        metrics = {}
        for m in spec.metrics(bench, args.workload, bool(args.trace)):
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info = card(dev.index or 0) if dev.type == "cuda" else {}
        device_info = {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
            **info,
        }
        result = {"correct": bool(correct), "attempted": window["replays"],
                  "failed": window["failed"], "metrics": metrics, "device": device_info}
        if args.trace:
            from benchmark import devtrace as trace_mod

            tr = traced["trace"]
            device_info["busy_s"] = trace_mod.busy(tr) * 1e-6
            device_info["window_s"] = (tr.window[1] - tr.window[0]) * 1e-6
            result["breakdown"] = {"device_ops": trace_mod.top_ops(tr),
                                   "idle_gaps": trace_mod.idle_gaps(tr)}
        entry.cleanup()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["compared"] = compared
    # this process's modules and those that a mesh's ranks report
    found = sorted(set(forbidden_modules()) | set(window.get("forbidden", ())))
    if found:
        raise SystemExit(f"run.py: modules of JAX or the JAX package are loaded: {found}")
    for name, (value, limit) in compared.items():
        print(f"compared {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(f"failed replays: {window['failed']} of {window['replays']}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
