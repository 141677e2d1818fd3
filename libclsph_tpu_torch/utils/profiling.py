"""Tracing and step timing on the device.

PyTorch counterpart of ``libclsph_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` capture (CPU, and CUDA where a card
  is present) that writes a Chrome trace and the ``key_averages()``
  table into a directory;
* :func:`annotate`: a named range (``record_function``) that shows on
  the trace's timeline;
* :class:`StepTimer`: wall-clock laps that wait for the device first,
  because PyTorch returns before a CUDA kernel has run.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
TABLE_FILE = "key_averages.txt"


@contextlib.contextmanager
def trace(logdir: str, row_limit: int = 50) -> Iterator[profile]:
    """Profile the body into ``logdir``: ``trace.json`` (Chrome trace) and
    ``key_averages.txt`` (ops sorted by device time, or by CPU time
    without a card). Yields the profiler, whose ``key_averages()`` the
    caller may read after the block."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    sort_by = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=sort_by, row_limit=row_limit)
    with open(os.path.join(logdir, TABLE_FILE), "w") as f:
        f.write(table + "\n")


def annotate(name: str):
    """A named range on the trace's timeline (context manager)."""
    return record_function(name)


def wait_for(value) -> float:
    """``value`` as a float once the device has computed it: a CUDA
    tensor synchronises its device first; a CPU tensor or a number is
    converted directly."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)
        return value.item()
    return float(value)


class StepTimer:
    """Wall-clock laps with enforced device completion.

    Usage::

        timer = StepTimer()
        for _ in range(k):
            state, dt, flags, _ = substep(...)
            timer.lap(dt)          # waits for the device
        print(timer.summary())
    """

    def __init__(self):
        self._laps: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def lap(self, sync_value) -> float:
        """Record one lap, once ``sync_value`` is computed."""
        if self._t0 is None:
            self.start()
        wait_for(sync_value)
        now = time.perf_counter()
        dt = now - self._t0
        self._laps.append(dt)
        self._t0 = now
        return dt

    @property
    def laps(self) -> list[float]:
        return list(self._laps)

    def summary(self) -> dict:
        if not self._laps:
            return {"count": 0}
        arr = np.asarray(self._laps)
        return {
            "count": int(arr.size),
            "mean_ms": float(arr.mean() * 1000),
            "median_ms": float(np.median(arr) * 1000),
            "p90_ms": float(np.percentile(arr, 90) * 1000),
            "min_ms": float(arr.min() * 1000),
            "max_ms": float(arr.max() * 1000),
        }
