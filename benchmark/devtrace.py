"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device operations (kernels, copies, sets) with their times, the
host ranges the benchmark opened with ``record_function``, and the launch
of each device operation, followed by the profiler's correlation id from
the launching runtime call to the operation."""

from __future__ import annotations

import bisect
import json
import re
from typing import NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    start: float  # microseconds, the trace's clock
    dur: float
    device: int
    corr: Optional[int]


class Range(NamedTuple):
    name: str
    start: float
    end: float
    tid: object


class Trace(NamedTuple):
    ops: list  # Op, device operations
    ranges: list  # Range, the benchmark's own host ranges
    launches: dict  # correlation id -> (host time, thread)
    window: tuple  # (start, end) of the traced window, microseconds


def load(path: str, range_names, window_range: str) -> Trace:
    """The trace written by ``export_chrome_trace`` at ``path``. Host
    ranges whose name is in ``range_names`` are kept; ``window_range`` is
    the range that spans the traced window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return parse(events, range_names, window_range)


def parse(events, range_names, window_range: str) -> Trace:
    ops, ranges, launches = [], [], {}
    names = set(range_names) | {window_range}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append(Op(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                          int(args.get("device", 0) or 0), args.get("correlation")))
        elif cat in LAUNCH_CATS and args.get("correlation") is not None:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation" and e["name"] in names:
            ranges.append(Range(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                e.get("tid")))
    win = [r for r in ranges if r.name == window_range]
    if not win:
        raise ValueError(f"the trace holds no {window_range!r} range")
    window = (min(r.start for r in win), max(r.end for r in win))
    ops.sort(key=lambda o: o.start)
    return Trace(ops, [r for r in ranges if r.name != window_range], launches, window)


def union(intervals) -> list:
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(trace: Trace, device: Optional[int] = None) -> float:
    """Microseconds of the window in which some device operation ran."""
    lo, hi = trace.window
    spans = [(max(o.start, lo), min(o.start + o.dur, hi)) for o in trace.ops
             if device is None or o.device == device]
    return sum(e - s for s, e in union(spans) if e > s)


def idle_share(trace: Trace, device: Optional[int] = None) -> Optional[float]:
    """Percent of the window that no device operation covers; None for a
    window with no length or a trace with no device operation."""
    lo, hi = trace.window
    if hi <= lo or not trace.ops:
        return None
    return 100.0 * (1.0 - busy(trace, device) / (hi - lo))


def range_of(trace: Trace, t: float, tid=None) -> Optional[Range]:
    """The innermost benchmark range open at host time ``t`` (on thread
    ``tid`` where given)."""
    best = None
    for r in trace.ranges:
        if r.start <= t <= r.end and (tid is None or r.tid == tid):
            if best is None or r.end - r.start < best.end - best.start:
                best = r
    return best


def device_time_by_range(trace: Trace, name: str) -> list:
    """For each range called ``name``: the microseconds of device work
    launched inside it (each operation's launch found by its correlation
    id)."""
    rs = sorted((r for r in trace.ranges if r.name == name), key=lambda r: r.start)
    starts = [r.start for r in rs]
    out = [0.0] * len(rs)
    for o in trace.ops:
        launch = trace.launches.get(o.corr)
        if launch is None:
            continue
        t, tid = launch
        k = bisect.bisect_right(starts, t) - 1  # ranges of one name never overlap
        if k >= 0 and t <= rs[k].end and rs[k].tid == tid:
            out[k] += o.dur
    return out


def op_time(trace: Trace, patterns) -> float:
    """Microseconds of the device operations whose name holds any of
    ``patterns``, inside the window."""
    lo, hi = trace.window
    return sum(o.dur for o in trace.ops if lo <= o.start <= hi
               and any(p in o.name for p in patterns))


def short_name(name: str) -> str:
    """A device operation's name without its template and call arguments,
    with the last functor or launcher its name holds, where it holds one:
    ``elementwise_kernel[MulFunctor]``."""
    base = name
    for _ in range(8):  # innermost template arguments first
        base = re.sub(r"<[^<>]*>", "", base)
    base = base.split("(")[0].replace("void ", "").strip()
    what = re.findall(r"(\w+Functor\w*|\w+_kernel_cuda|launch_\w+)", name)
    return f"{base}[{what[-1]}]" if what and what[-1] not in base else base


def top_ops(trace: Trace, k: int = 10) -> list:
    """[name, seconds] of the ``k`` device operations that took most time
    in the window, summed by :func:`short_name`."""
    lo, hi = trace.window
    total = {}
    for o in trace.ops:
        if lo <= o.start <= hi:
            key = short_name(o.name)
            total[key] = total.get(key, 0.0) + o.dur
    return [[n, s * 1e-6] for n, s in sorted(total.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(trace: Trace, k: int = 10) -> list:
    """[what the host was doing, seconds] of the ``k`` longest stretches of
    the window in which the device ran nothing; the host's doing is the
    innermost benchmark range open at the gap's middle ("outside" where
    none is)."""
    lo, hi = trace.window
    busy_spans = union([(max(o.start, lo), min(o.start + o.dur, hi)) for o in trace.ops
                        if o.start + o.dur > lo and o.start < hi])
    gaps, at = [], lo
    for s, e in busy_spans:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:k]:
        r = range_of(trace, 0.5 * (s + e))
        out.append([r.name if r is not None else "outside", (e - s) * 1e-6])
    return out
