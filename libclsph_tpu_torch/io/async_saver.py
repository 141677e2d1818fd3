"""Background-thread frame export.

The reference overlaps frame export with compute by launching the
save callback on a ``std::thread`` and joining it before the next save
(sph_simulation.cpp:268, :370-372, :396-404, :428-430). This is the
same pattern with a bounded single-slot worker: ``submit`` joins any
in-flight save first (so at most one save runs concurrently with the
device computing the next frame), then hands the host copies to the
thread. The loop thread's time blocked in a join is the span
``saver.wait`` (:mod:`utils.profiling`).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..utils import profiling


class AsyncSaver:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced on next submit/join
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            with profiling.annotate("saver.wait"):
                self._thread.join()
            self._thread = None

    def close(self) -> None:
        self.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
