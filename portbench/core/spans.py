"""The harness's own spans around each call into a layer of the port.

A span is (name, start, end, depth) on ``time.perf_counter_ns``. Spans
nest; the innermost one open at an instant says what the host was doing
then (``core/trace.py::DeviceTrace.idle_by_span``). They are kept in memory
and read when the run ends.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Tuple


class Spans:
    def __init__(self):
        self.done: List[Tuple[str, int, int, int]] = []      # name, t0, t1, depth
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.done.append((name, t0, time.perf_counter_ns(), self._depth))

    def wrap(self, it, name: str) -> Iterator:
        """Iterate ``it`` with a span around each ``next``."""
        it = iter(it)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
