"""Profiling helpers (port of ``utils/profiling.py``): a ``torch.profiler``
trace behind the ``--profile`` flag, and a rolling scenes-a-second timer.

The JAX module's ``cost_table`` (XLA's cost analysis of a compiled program)
has no counterpart: the port compiles no whole-program graph.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


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
