"""The program's own spans (``libclsph_tpu_torch.utils.profiling``) of the
traced replay, put on the device trace's clock, and what the per-layer
metrics read through them: the device time and the device operations
launched in each span, and the device's idle time by the span the loop
thread was in.

The spans are read from the program's store after the replay, in the
benchmark's process. The program's root spans (``dispatch`` in a substep
cell, ``simulate`` in a frame cell) are anchored to the benchmark's own
ranges of the same name around the same calls (``harness._range``, the
outermost ranges of that name in the trace): the clocks' offset is the
first pair's start difference, and every pair's starts and ends must
then agree within ANCHOR_US, else nothing is read. A device operation
goes to the innermost span open on its launching thread at its launch
(``Trace.launches``, by correlation id), and to every span above it; an
idle stretch of the device to the innermost span open on the loop thread
(the roots' thread). Where the program records no spans, as a checkout
without the recorder, every reader finds nothing and returns None.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

from . import devtrace

ANCHOR_US = 1000.0


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start: float  # microseconds, the trace's clock
    end: float
    tid: int
    attrs: dict


class Program(NamedTuple):
    spans: dict  # id -> Span: every span under the anchored roots
    loop_tid: int  # the roots' thread


def store() -> Optional[dict]:
    """The program's store (``profiling.snapshot()``), None where the
    program has none."""
    try:
        from libclsph_tpu_torch.utils import profiling

        return profiling.snapshot()
    except (ImportError, AttributeError):
        return None


def _outermost(ranges: list) -> list:
    return [r for r in ranges
            if not any(o != r and o.start <= r.start and r.end <= o.end for o in ranges)]


def anchor(trace: devtrace.Trace, root: str, snap: Optional[dict]) -> Optional[Program]:
    """The spans under the program's last root spans called ``root``,
    one for each of the benchmark's ranges of that name, on the trace's
    clock; None where there are none, the anchor fails, or the store's
    bound pushed out spans of these roots."""
    if trace is None or not snap or not snap.get("spans"):
        return None
    ranges = sorted(_outermost([r for r in trace.ranges if r.name == root]),
                    key=lambda r: r.start)
    roots = sorted((s for s in snap["spans"] if s.name == root and s.parent is None),
                   key=lambda s: s.start)
    if not ranges or len(roots) < len(ranges):
        return None
    roots = roots[-len(ranges):]
    base_ns, base_us = roots[0].start, ranges[0].start

    def clock(ns: int) -> float:
        return (ns - base_ns) * 1e-3 + base_us

    for r, s in zip(ranges, roots):
        if abs(clock(s.start) - r.start) > ANCHOR_US or abs(clock(s.end) - r.end) > ANCHOR_US:
            return None
    if snap["dropped"] and snap["spans"][0].end >= roots[0].start:
        return None  # the first kept span closed after the roots opened
    ids = {s.id for s in roots}
    spans = {s.id: Span(s.id, s.parent, s.name, clock(s.start), clock(s.end), s.tid, s.attrs)
             for s in snap["spans"] if s.root in ids}
    return Program(spans, roots[0].tid)


def load(ctx: dict, root: str) -> Optional[Program]:
    """:func:`anchor` on the cell's trace and the program's store."""
    return anchor(ctx.get("trace"), root, store())


def timeline(spans, tid) -> list:
    """[(start, end, span id)] of thread ``tid``: the innermost span open
    there, stretch by stretch, in order."""
    out, stack, at = [], [], None

    def close(upto: float):
        nonlocal at
        while stack and stack[-1].end <= upto:
            top = stack.pop()
            if top.end > at:
                out.append((at, top.end, top.id))
                at = top.end

    for s in sorted((s for s in spans if s.tid == tid), key=lambda s: (s.start, -s.end)):
        close(s.start)
        if stack and s.start > at:
            out.append((at, s.start, stack[-1].id))
        at = s.start if at is None else max(at, s.start)
        stack.append(s)
    close(float("inf"))
    return out


class _Lookup:
    """The innermost span open on a thread at a time."""

    def __init__(self, prog: Program):
        self.lines = {}
        for tid in {s.tid for s in prog.spans.values()}:
            line = timeline(prog.spans.values(), tid)
            self.lines[tid] = ([seg[0] for seg in line], line)

    def at(self, tid, t: float) -> Optional[int]:
        starts, line = self.lines.get(tid, ((), ()))
        k = bisect.bisect_right(starts, t) - 1
        return line[k][2] if k >= 0 and t <= line[k][1] else None


def ancestors(prog: Program, sid: Optional[int]):
    """``sid`` and every span above it, innermost first."""
    while sid is not None and sid in prog.spans:
        yield sid
        sid = prog.spans[sid].parent


def launched(trace: devtrace.Trace, prog: Program) -> tuple:
    """({span id: device microseconds}, {span id: device operations}) of
    the work launched inside each span, its children's included."""
    look = _Lookup(prog)
    time, ops = {}, {}
    for o in trace.ops:
        launch = trace.launches.get(o.corr)
        if launch is None:
            continue
        for sid in ancestors(prog, look.at(launch[1], launch[0])):
            time[sid] = time.get(sid, 0.0) + o.dur
            ops[sid] = ops.get(sid, 0) + 1
    return time, ops


def idle_stretches(trace: devtrace.Trace) -> list:
    """[(start, end)] of the window in which no device operation runs."""
    lo, hi = trace.window
    busy = devtrace.union([(max(o.start, lo), min(o.start + o.dur, hi)) for o in trace.ops
                           if o.start + o.dur > lo and o.start < hi])
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def idle_by_span(trace: devtrace.Trace, prog: Program) -> dict:
    """{span id, or None outside every span: device-idle microseconds of
    the window} by the innermost span open on the loop thread."""
    line = timeline(prog.spans.values(), prog.loop_tid)
    out, k = {}, 0
    for s, e in idle_stretches(trace):
        covered = 0.0
        while k < len(line) and line[k][1] <= s:
            k += 1
        j = k
        while j < len(line) and line[j][0] < e:
            part = min(e, line[j][1]) - max(s, line[j][0])
            if part > 0:
                out[line[j][2]] = out.get(line[j][2], 0.0) + part
                covered += part
            j += 1
        if e - s > covered:
            out[None] = out.get(None, 0.0) + (e - s - covered)
    return out


def under(prog: Program, sid: Optional[int], name: str) -> Optional[int]:
    """The nearest span called ``name`` at or above ``sid``."""
    for a in ancestors(prog, sid):
        if prog.spans[a].name == name:
            return a
    return None


def named(prog: Program, name: str, tid=None) -> list:
    return [s for s in prog.spans.values() if s.name == name and (tid is None or s.tid == tid)]


def stage_device_ms(ctx: dict, stages, kind: Optional[str] = None) -> Optional[float]:
    """Device milliseconds launched in the spans called one of ``stages``
    over the substeps of the dispatch's traced segment: with ``kind``
    ("rebuild" or "reuse") those inside the substeps of that kind, per
    such substep; else every such span, per substep."""
    tr = ctx.get("trace")
    prog = load(ctx, "dispatch")
    if prog is None or not tr.ops:
        return None
    subs = [s for s in named(prog, "substep") if kind is None or s.attrs.get("kind") == kind]
    if not subs:
        return None
    time, _ = launched(tr, prog)
    ids = {s.id for s in subs}
    total = sum(time.get(s.id, 0.0) for s in prog.spans.values() if s.name in stages
                and (kind is None or under(prog, s.id, "substep") in ids))
    return 1e-3 * total / len(subs)


def idle_pct(ctx: dict, root: str, name: str) -> Optional[float]:
    """Percent of the traced window in which the device is idle and the
    loop thread is inside a span called ``name`` (at any depth below)."""
    tr = ctx.get("trace")
    prog = load(ctx, root)
    if prog is None or not tr.ops or tr.window[1] <= tr.window[0]:
        return None
    idle = idle_by_span(tr, prog)
    t = sum(v for sid, v in idle.items() if under(prog, sid, name) is not None)
    return 100.0 * t / (tr.window[1] - tr.window[0])


def breakdown(trace: devtrace.Trace, prog: Program) -> dict:
    """By span name: the device milliseconds and operations launched with
    that span innermost, and the device-idle milliseconds in which it was
    the loop thread's innermost span ("outside" for none)."""
    look = _Lookup(prog)
    dev, ops = {}, {}
    for o in trace.ops:
        launch = trace.launches.get(o.corr)
        sid = look.at(launch[1], launch[0]) if launch is not None else None
        key = prog.spans[sid].name if sid is not None else "outside"
        dev[key] = dev.get(key, 0.0) + 1e-3 * o.dur
        ops[key] = ops.get(key, 0) + 1
    idle = {}
    for sid, v in idle_by_span(trace, prog).items():
        key = prog.spans[sid].name if sid is not None else "outside"
        idle[key] = idle.get(key, 0.0) + 1e-3 * v
    return dict(device_ms=dev, launches=ops, idle_ms=idle)
