"""The reductions on synthetic inputs: the union of device intervals and
the idle share, the idle gaps by host range, device time by range through
the correlation ids, the nearest-rank p90 and the roofline's least time."""

import importlib.util
import os

import pytest

from benchmark import devtrace, peaks
from conftest import ROOT


def _events():
    k = lambda name, ts, dur, corr: dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,  # noqa
                                         args=dict(device=0, correlation=corr))
    launch = lambda ts, corr: dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",  # noqa
                                   ts=ts, dur=1, tid=7, args=dict(correlation=corr))
    rng = lambda name, ts, dur: dict(ph="X", cat="user_annotation", name=name, ts=ts,  # noqa
                                     dur=dur, tid=7)
    return [rng("segment", 0, 40), rng("rebuild", 0, 12), rng("reuse", 14, 10),
            launch(1, 1), launch(2, 2), launch(15, 3),
            k("void sph::density_rows_kernel<16>(float4 const*)", 0, 10, 1),
            k("b", 5, 10, 2), k("c", 20, 10, 3)]


def test_union_and_idle():
    tr = devtrace.parse(_events(), ("rebuild", "reuse"), "segment")
    assert devtrace.busy(tr) == 25.0
    assert devtrace.idle_share(tr) == pytest.approx(37.5)
    assert devtrace.union([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]


def test_gaps_and_ranges():
    tr = devtrace.parse(_events(), ("rebuild", "reuse"), "segment")
    gaps = devtrace.idle_gaps(tr)
    assert [g[0] for g in gaps] == ["outside", "reuse"]
    assert [g[1] for g in gaps] == pytest.approx([10e-6, 5e-6])
    assert devtrace.device_time_by_range(tr, "rebuild") == [20.0]
    assert devtrace.device_time_by_range(tr, "reuse") == [10.0]
    assert devtrace.top_ops(tr)[0][0] == "sph::density_rows_kernel"
    assert devtrace.op_time(tr, ("density_rows_kernel",)) == 10.0


def test_no_device_work_reads_nothing():
    tr = devtrace.parse([e for e in _events() if e["cat"] != "kernel"], (), "segment")
    assert devtrace.idle_share(tr) is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "benchmark", "metrics", name + ".py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_p90_is_nearest_rank():
    read = _reader("frame_s_p90").read
    assert read(dict(window=dict(intervals=[float(i) for i in range(10, 0, -1)]))) == 9.0
    assert read(dict(window=dict(intervals=[]))) is None


def test_roofline_counts():
    # 1e6 particles, 20 pairs each: operations bound it
    n, pairs = 1_000_000, 20_000_000
    ops = pairs * 67 / 67e12
    assert peaks.least_seconds(n, pairs) == pytest.approx(max(ops, n * 60 / 3.35e12))
    tr = devtrace.parse(_events(), ("rebuild", "reuse"), "segment")

    class P:
        pass

    prm = P()
    prm.n = n
    value = _reader("kernels_roofline_pct").read(dict(trace=tr, pairs_per_substep=pairs,
                                                      params=prm, trace_substeps=1))
    assert value == pytest.approx(100 * peaks.least_seconds(n, pairs) / 10e-6)
    assert _reader("kernels_roofline_pct").read(dict(trace=None, pairs_per_substep=pairs)) is None
