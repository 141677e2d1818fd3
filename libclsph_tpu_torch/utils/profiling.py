"""Tracing on the device, and the program's own spans and counters.

* :func:`trace`: a ``torch.profiler`` capture (CPU, and CUDA where a card
  is present) that writes a Chrome trace, the ``key_averages()`` table
  and the program's spans and counters into a directory;
* :func:`annotate`: the program's span, a context manager. With
  recording off it tests a process-wide flag and returns a shared null
  span: nothing is stored and no ``record_function`` is opened. With
  recording on it stores one :class:`Span` in a bounded in-memory store
  (the newest :data:`STORE_LIMIT` are kept, the dropped ones counted) and,
  on a thread that the profiler tracks, also opens a
  ``record_function(name)``, so that the span shows in the Chrome trace;
* :func:`count`: a named counter under the same switch;
* :func:`recording`: the switch without the profiler. Recording is also
  on while a ``torch.profiler`` capture is active (the profiler's own
  process-wide flag), on every thread, so a thread started inside the
  capture, such as the saver's, records too, though the profiler leaves
  its ``record_function`` ranges out of the Chrome trace.

Spans are stamped with ``time.time_ns()``, the clock of the Chrome
trace's host timestamps: a trace's ``ts`` is epoch microseconds less its
``baseTimeNanoseconds``. Each names its parent (the innermost span open
on its thread, or a handle from :func:`current` taken on another thread)
and its root, the outermost span above it, which every span under one
root shares.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
TABLE_FILE = "key_averages.txt"
SPANS_FILE = "spans.json"
STORE_LIMIT = 1 << 17  # spans kept; ~20 MB at most


class Span(NamedTuple):
    id: int
    parent: Optional[int]  # None for a root
    root: int
    name: str
    start: int  # time.time_ns()
    end: int
    tid: int  # threading.get_native_id(): the Chrome trace's tid of host events
    attrs: dict


class _Thread(threading.local):
    """A thread's open spans and its native id (read once a thread)."""

    def __init__(self):
        self.stack = []
        self.tid = threading.get_native_id()


class _Recorder:
    """The process's store of spans and counters."""

    def __init__(self, limit: int):
        self.lock = threading.Lock()
        self.spans = collections.deque(maxlen=limit)
        self.counters: dict = {}
        self.dropped = 0
        self.forced = 0  # open recording() blocks
        self.ids = itertools.count(1)
        self.thread = _Thread()

    def add(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(span)

    def clear(self) -> None:
        with self.lock:
            self.spans.clear()
            self.counters.clear()
            self.dropped = 0


_REC = _Recorder(STORE_LIMIT)


def active() -> bool:
    """Whether spans and counters are recorded now."""
    return bool(_REC.forced or _autograd_profiler._is_profiler_enabled)


class _Off:
    """The span :func:`annotate` returns with recording off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "handle", "id", "parent", "root", "tid", "start", "rf")

    def __init__(self, name: str, handle, attrs: dict):
        self.name, self.handle, self.attrs = name, handle, attrs

    def __enter__(self):
        thread = _REC.thread
        stack = thread.stack
        self.id = next(_REC.ids)
        if self.handle is not None:
            self.parent, self.root = self.handle
        elif stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        self.tid = thread.tid
        stack.append(self)
        self.rf = None
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():  # the profiler tracks this thread
            self.rf = record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _REC.thread.stack.pop()
        _REC.add(Span(self.id, self.parent, self.root, self.name, self.start, end, self.tid,
                      self.attrs))
        return False

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        """Add attributes to the span (kept when it closes)."""
        self.attrs.update(attrs)


def annotate(name: str, parent=None, **attrs):
    """The program's span ``name`` (context manager; ``as`` gives an
    object whose ``set(**attrs)`` adds attributes, false with recording
    off). ``parent``: a handle from :func:`current` taken on the thread
    that handed this one its work; default the innermost span open on
    this thread."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _On(name, parent, attrs)


def current():
    """A handle of this thread's innermost open span, (id, root), to
    pass as another thread's ``parent``; None where none is open or
    recording is off."""
    if not active():
        return None
    stack = _REC.thread.stack
    return (stack[-1].id, stack[-1].root) if stack else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return
    with _REC.lock:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def snapshot() -> dict:
    """The store: ``spans`` (:class:`Span`, in the order they closed),
    ``counters`` and ``dropped`` (spans the bound pushed out)."""
    with _REC.lock:
        return dict(spans=list(_REC.spans), counters=dict(_REC.counters), dropped=_REC.dropped)


def clear() -> None:
    """Empty the store and the counters."""
    _REC.clear()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters in the body, the store emptied first."""
    clear()
    with _REC.lock:
        _REC.forced += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.forced -= 1


def write_spans(path: str) -> None:
    """The store as JSON: ``clock`` (epoch nanoseconds), ``spans`` (one
    object each, :class:`Span`'s fields), ``counters``, ``dropped``."""
    snap = snapshot()
    body = dict(clock="time.time_ns", spans=[s._asdict() for s in snap["spans"]],
                counters=snap["counters"], dropped=snap["dropped"])
    with open(path, "w") as f:
        json.dump(body, f)


@contextlib.contextmanager
def trace(logdir: str, row_limit: int = 50) -> Iterator[profile]:
    """Profile the body into ``logdir``: ``trace.json`` (Chrome trace),
    ``key_averages.txt`` (ops sorted by device time, or by CPU time
    without a card) and ``spans.json`` (:func:`write_spans`, the spans
    recorded in the body, the saver thread's too). Yields the profiler,
    whose ``key_averages()`` the caller may read after the block."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    clear()
    prof = profile(activities=activities)
    with prof:
        yield prof
    write_spans(os.path.join(logdir, SPANS_FILE))
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    sort_by = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    table = prof.key_averages().table(sort_by=sort_by, row_limit=row_limit)
    with open(os.path.join(logdir, TABLE_FILE), "w") as f:
        f.write(table + "\n")
