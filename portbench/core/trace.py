"""The device trace of a window: ``torch.profiler`` over the card's kernels,
copies and memsets, reduced to busy time, idle time and time by kernel.

The busy and idle arithmetic is the rule of
``benchmarks/profile_torch_slice.py`` at commit 4dd78ef, frozen here: the
union of every kernel, copy and memset interval in the window is busy, the
rest of the window idle. The window opens at a marker launched on an idle
card right after a host timestamp, which also ties the trace's clock to
the host's, so each idle gap can be labelled with the harness span the host
was in at its middle.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments and namespaces'
    noise, at most 120 characters."""
    n = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return n.split("(")[0][:120]


class DeviceTrace:
    """Start with :meth:`start`, end with :meth:`stop`; then ``busy_s``,
    ``window_s``, ``by_kernel`` (name → [seconds, launches]) and
    :meth:`idle_by_span`."""

    def __init__(self, device, path: str):
        self.device, self.path = device, path
        self.intervals: List[Tuple[float, float, str]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)                 # the marker: the window's first kernel

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.t_end_ns = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        evs = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                     for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        if not evs:
            raise RuntimeError("the trace holds no device operation")
        self.t0_us = evs[0][0]                      # the marker
        self.window_s = (self.t_end_ns - self.t_mark_ns) / 1e9
        t_end_us = self.t0_us + self.window_s * 1e6
        self.intervals = [(max(a, self.t0_us), min(b, t_end_us), n) for a, b, n in evs
                          if b > self.t0_us and a < t_end_us]
        self.by_kernel: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for a, b, n in self.intervals[1:]:
            k = self.by_kernel[short_name(n)]
            k[0] += (b - a) / 1e6
            k[1] += 1
        starts = np.array([a for a, _, _ in self.intervals])
        ends = np.maximum.accumulate(np.array([b for _, b, _ in self.intervals]))
        # merged union: a new run begins where a start lies past every earlier end
        new = np.concatenate([[True], starts[1:] > ends[:-1]])
        run_id = np.cumsum(new) - 1
        run_start = starts[new]
        run_end = np.zeros(len(run_start))
        np.maximum.at(run_end, run_id, ends)
        self.busy_s = float(np.sum(run_end - run_start)) / 1e6
        gaps_a = np.concatenate([[self.t0_us], run_end])
        gaps_b = np.concatenate([run_start, [t_end_us]])
        keep = gaps_b > gaps_a
        self.gaps = np.stack([gaps_a[keep], gaps_b[keep]], 1)   # µs on the trace clock

    def sum_kernels(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``pattern``."""
        s = n = 0
        for name, (t, c) in self.by_kernel.items():
            if pattern in name:
                s += t
                n += c
        return s, n

    def top_ops(self) -> List[list]:
        ops = sorted(self.by_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[k, v[0]] for k, v in ops]

    def idle_by_span(self, spans) -> List[list]:
        """Idle seconds summed by the innermost harness span open at each
        gap's middle, the largest first."""
        if not len(self.gaps):
            return []
        mid_ns = self.t_mark_ns + ((self.gaps[:, 0] + self.gaps[:, 1]) / 2
                                   - self.t0_us) * 1e3
        label = np.full(len(mid_ns), "harness", dtype=object)
        depth = np.full(len(mid_ns), -1)
        for name, t0, t1, d in spans.done:
            inside = (mid_ns >= t0) & (mid_ns < t1) & (d > depth)
            label[inside] = name
            depth[inside] = d
        out: Dict[str, float] = defaultdict(float)
        for lab, (a, b) in zip(label, self.gaps):
            out[lab] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:TOP]]
