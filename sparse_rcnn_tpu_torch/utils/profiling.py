"""Profiling helpers (port of ``utils/profiling.py``): a ``torch.profiler``
trace behind the ``--profile`` flag, a rolling scenes-a-second timer, and
the port's span recorder.

The recorder: :class:`span` marks a stage at a layer boundary (the train
step and its stages, the eval step and its stages, the fetch, the
scoring). Inside :func:`recording` every span is kept in a list in memory
with its name, its start and end on ``time.perf_counter_ns``, its parent,
the id of its root (the outermost span open on its thread when it opened:
one step, request or batch) and its thread; :func:`count` adds host-known
counts to the innermost open span. Outside :func:`recording` a span keeps
nothing and costs one global read and a branch beside its two clock reads:
it still times itself (:attr:`span.ns`). Nothing else turns the recorder
on: the benchmark and ``train.main --profile`` call :func:`recording`.

The JAX module's ``cost_table`` (XLA's cost analysis of a compiled program)
has no counterpart: the port compiles no whole-program graph.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

_records: Optional[list] = None      # the list of the open recording(), else None
_local = threading.local()           # .stack: this thread's open recorded spans
_ids = itertools.count()


class span:
    """``with span("name") as s:`` marks a stage; ``s.ns`` is its duration
    in ns once it has closed. Recorded (inside :func:`recording`) it is
    itself the record: ``name``, ``t0``, ``t1`` (``perf_counter_ns``),
    ``id``, ``parent`` (the id of the span it opened in, None for a root),
    ``root`` (its root's id), ``thread`` and ``counts`` (name → n, from
    :func:`count`)."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "root", "thread", "counts", "_on")

    def __init__(self, name: str):
        self.name = name
        self.counts: Optional[Dict[str, int]] = None
        self._on = False

    def __enter__(self) -> "span":
        records = _records
        if records is not None:
            stack = _stack()
            outer = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = None if outer is None else outer.id
            self.root = self.id if outer is None else outer.root
            self.thread = threading.get_ident()
            self._on = True
            stack.append(self)
            records.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._on:
            _local.stack.pop()

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of this thread's innermost open
    recorded span (nothing outside :func:`recording`). For counts the host
    already knows: it never reads the device."""
    if _records is None:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        s = stack[-1]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[List[span]]:
    """Keep every span opened in the block, on any thread, in the list it
    yields, in the order they opened."""
    global _records
    before, _records = _records, []
    try:
        yield _records
    finally:
        _records = before


def stage_table(records: List[span]) -> Dict[str, Dict[str, float]]:
    """The closed spans of ``records`` by name: ``calls``, ``total_ms``,
    ``self_ms`` (each span's duration less its child spans') and, where
    :func:`count` added any, ``counts``; the largest total first."""
    done = [r for r in records if hasattr(r, "t1")]
    child_ns: Dict[int, int] = {}
    for r in done:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.ns
    out: Dict[str, Dict[str, float]] = {}
    for r in done:
        row = out.setdefault(r.name, {"calls": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["total_ms"] += r.ns / 1e6
        row["self_ms"] += (r.ns - child_ns.get(r.id, 0)) / 1e6
        for k, n in (r.counts or {}).items():
            counts = row.setdefault("counts", {})
            counts[k] = counts.get(k, 0) + n
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


@contextlib.contextmanager
def maybe_trace(enabled: bool, logdir: str = "profile"):
    """The ``--profile`` flag: trace the block with ``torch.profiler`` (host
    operations and, where there is a card, its kernels and copies) and write
    a Chrome/Perfetto JSON trace into ``logdir``. Yields the trace's path
    (written when the block ends), or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(os.path.abspath(logdir),
                        f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path} (load in Perfetto or chrome://tracing)",
          flush=True)


class StepTimer:
    """Rolling scenes a second over the last ``window`` ticks."""

    def __init__(self, batch_size: int, window: int = 20):
        self.batch_size = batch_size
        self.window = window
        self._times = []

    def tick(self) -> float:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) * self.batch_size / max(dt, 1e-9)
