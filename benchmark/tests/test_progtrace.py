"""The program-span readers (:mod:`benchmark.progtrace`) on a synthetic
device trace and synthetic program spans with a known clock offset: the
anchor, device time and operations by the innermost span of the
launching thread, idle stretches by the loop thread's span; and a whole
CPU run of the frame cell, whose line holds the saver's span metrics and
no device-time metric."""

import pytest

from benchmark import devtrace, progtrace
from conftest import cpu_run
from libclsph_tpu_torch.utils.profiling import Span

NS0 = 1_790_000_000_123_456_789  # the program's clock at the root's start
US0 = 5000.0  # the trace's clock there
LOOP, SAVER = 101, 202  # native thread ids


def ms(t: float) -> int:
    """A time ``t`` ms after the root's start on the program's clock."""
    return NS0 + int(round(t * 1e6))


def us(t: float) -> float:
    """The same time on the trace's clock."""
    return US0 + 1e3 * t


def spans(root_end: float = 12.0) -> list:
    """dispatch > substep (rebuild) > sort, search, refine, passes, advect
    on the loop thread; a span on the saver thread handed the substep."""
    rows = [  # id, parent, name, start ms, end ms, tid, attrs
        (2, 1, "substep", 0.5, 10.0, LOOP, {"kind": "rebuild"}),
        (3, 2, "sort", 1.0, 2.0, LOOP, {}),
        (4, 2, "search", 2.0, 3.0, LOOP, {}),
        (5, 2, "refine", 3.0, 6.0, LOOP, {}),
        (6, 2, "passes", 6.0, 8.0, LOOP, {}),
        (7, 2, "advect", 8.0, 9.0, LOOP, {}),
        (8, 2, "saver.fetch", 3.5, 4.5, SAVER, {}),
        (1, None, "dispatch", 0.0, root_end, LOOP, {}),
    ]
    return [Span(i, p, 1, n, ms(a), ms(b), tid, attrs) for i, p, n, a, b, tid, attrs in rows]


def trace(ops=(), launches=None, end: float = 12.0) -> devtrace.Trace:
    """The benchmark's ``dispatch`` range around the program's own range of
    the same name (both in the trace), the window a little wider."""
    ranges = [devtrace.Range("dispatch", us(0.0) - 2.0, us(end) + 2.0, LOOP),
              devtrace.Range("dispatch", us(0.0) + 1.0, us(end) - 1.0, LOOP)]
    return devtrace.Trace(sorted(ops, key=lambda o: o.start), ranges, launches or {},
                          (us(0.0) - 10.0, us(end) + 10.0))


def snap(rows) -> dict:
    return dict(spans=rows, counters={}, dropped=0)


def test_anchor():
    prog = progtrace.anchor(trace(), "dispatch", snap(spans()))
    assert prog is not None and prog.loop_tid == LOOP
    assert set(prog.spans) == set(range(1, 9))
    fetch = prog.spans[8]
    assert fetch.start == pytest.approx(us(3.5) - 2.0) and fetch.tid == SAVER
    # an older root of the same name is passed over for the newest
    old = [s._replace(id=s.id + 100, root=101, parent=s.parent and s.parent + 100,
                      start=s.start - 10**9, end=s.end - 10**9) for s in spans()]
    assert set(progtrace.anchor(trace(), "dispatch", snap(old + spans())).spans) == set(
        range(1, 9))
    # the root ends 1.5 ms from the benchmark's range: no anchor
    assert progtrace.anchor(trace(end=12.0), "dispatch", snap(spans(root_end=13.5))) is None
    # no spans (a program without the recorder), no root, or a bound that
    # pushed out spans closed after the root opened
    assert progtrace.anchor(trace(), "dispatch", snap([])) is None
    assert progtrace.anchor(trace(), "simulate", snap(spans())) is None
    assert progtrace.anchor(trace(), "dispatch", dict(snap(spans()), dropped=3)) is None


def test_device_time_goes_to_the_innermost_span_of_the_launching_thread(monkeypatch):
    ops = [devtrace.Op("a", us(2.0), 100.0, 0, 1),  # launched in sort
           devtrace.Op("b", us(5.0), 300.0, 0, 2),  # in refine
           devtrace.Op("c", us(5.0), 50.0, 0, 3),  # in refine's time, on the saver thread
           devtrace.Op("d", us(10.0), 7.0, 0, 4),  # in the substep, after advect
           devtrace.Op("e", us(11.0), 5.0, 0, 5),  # after the substep
           devtrace.Op("f", us(11.0), 9.0, 0, None)]  # no launch known
    launches = {1: (us(1.5) - 2.0, LOOP), 2: (us(4.0) - 2.0, LOOP),
                3: (us(4.0) - 2.0, SAVER), 4: (us(9.5) - 2.0, LOOP),
                5: (us(10.5) - 2.0, LOOP)}
    tr = trace(ops, launches)
    prog = progtrace.anchor(tr, "dispatch", snap(spans()))
    time, count = progtrace.launched(tr, prog)
    assert time[3] == 100.0 and time[5] == 300.0 and time[8] == 50.0
    assert 4 not in time and 6 not in time
    assert time[2] == 100.0 + 300.0 + 50.0 + 7.0  # its children's included
    assert time[1] == time[2] + 5.0
    assert (count[2], count[1]) == (4, 5)
    monkeypatch.setattr(progtrace, "store", lambda: snap(spans()))
    ctx = dict(trace=tr)
    assert progtrace.stage_device_ms(ctx, ("sort", "search"), "rebuild") == pytest.approx(0.1)
    assert progtrace.stage_device_ms(ctx, ("refine",), "rebuild") == pytest.approx(0.3)
    assert progtrace.stage_device_ms(ctx, ("refine",), "reuse") is None  # no reuse substep
    assert progtrace.stage_device_ms(ctx, ("passes",)) == 0.0


def test_idle_stretches_go_to_the_loop_threads_span(monkeypatch):
    # busy [1, 2] and [5, 9] ms; the window runs from -10 us to 12 ms + 10 us
    ops = [devtrace.Op("a", us(1.0), 1e3, 0, None), devtrace.Op("b", us(5.0), 4e3, 0, None)]
    tr = trace(ops)
    prog = progtrace.anchor(tr, "dispatch", snap(spans()))
    idle = progtrace.idle_by_span(tr, prog)
    # the anchor puts program times 2 us before the trace's: the stretch
    # [1, 2] ms ends in the sort, [9, 12] starts after the advect
    expect = {None: 8.0 + 12.0, 1: 500.0 + 2000.0, 2: 500.0 + 998.0, 3: 2.0, 4: 998.0,
              5: 2002.0}
    assert set(idle) == set(expect)
    for k, v in expect.items():
        assert idle[k] == pytest.approx(v), k
    assert sum(idle.values()) == pytest.approx(sum(e - s for s, e in
                                                   progtrace.idle_stretches(tr)))
    monkeypatch.setattr(progtrace, "store", lambda: snap(spans()))
    window = tr.window[1] - tr.window[0]
    under_substep = 1498.0 + 2.0 + 998.0 + 2002.0
    assert progtrace.idle_pct(dict(trace=tr), "dispatch", "substep") == pytest.approx(
        100.0 * under_substep / window)


def test_frame_run_reports_the_saver_spans(small):
    result, _ = cpu_run("dambreak_64k.frames_geo", trace=1)
    metrics = result["metrics"]
    assert metrics["saver_wait_ms"]["value"] >= 0.0
    assert 0.0 < metrics["fetch_ms"]["value"] < 1e4
    # a CPU trace holds no device operation: no device-time metric
    assert "idle_saver_wait_pct.frames" not in metrics
    assert "device_idle_pct.frames" not in metrics
