"""Stages of a traced window: each device operation and each idle gap
charged to the program's spans (``sparse_rcnn_tpu_torch/utils/profiling.py``)
and the harness's (``core/spans.py``), on one host clock.

:class:`StageTrace` is a :class:`~.trace.DeviceTrace` that also keeps each
operation's correlation id and the host time of the call that launched it
(a ``cuda_runtime`` or ``cuda_driver`` launch, copy or memset call, which
torch's CUDA activity records without its CPU activity), on
``time.perf_counter_ns``: the marker's own launch call is paired with the
host timestamp taken just before it. Its busy, idle and kernel figures are
the ``DeviceTrace``'s, unchanged.

Both kinds of span are (name, start, end) on ``time.perf_counter_ns``. A
program span is nested under the innermost harness span that encloses it,
so the harness's ``train_step`` divides into the program's ``backward``,
``hierarchy``, ``optimizer`` and so on. An operation is charged to the
innermost span open at its launch's host time, whatever thread launched
it: autograd's device thread launches the backward while the main thread
waits in ``backward``. In the stage table each stage's idle time is the
card's idle time while it was the innermost span; the breakdown's
``idle_gaps`` keep the rule of ``DeviceTrace.idle_by_span`` (a whole gap
to the span open at its middle), with the program's stages among its
labels once :func:`join` has added them. Where the harness wraps a program
call in a span of the same name, the table keeps the two apart: the
harness's row is ``<name> (harness)``.

A mode uses it by tracing with :class:`StageTrace` in place of
``DeviceTrace``, keeping the program's spans over the traced window
(``profiling.recording()``), and calling :func:`report` once the window
has closed. The modes do not do so yet.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from .trace import DEVICE_CATS, DeviceTrace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"                  # torch.cuda._sleep's kernel
ROOTS = ("train_step", "eval_step")      # the roots whose idle the children should take
NO_SPAN = "harness"                      # outside every span, as idle_by_span names it


class StageTrace(DeviceTrace):
    """A ``DeviceTrace`` that, once stopped, also has ``correlation`` (each
    interval's correlation id), ``marker`` (the index of the marker, the
    window's first ``spin_kernel``), ``launch_ns`` (the host time of each
    interval's launch call on ``perf_counter_ns``), ``launch_events`` (the
    intervals but the marker with a launch call), ``launch_tie_us`` (the
    trace-clock time of the marker's launch call, paired with
    ``t_mark_ns``), ``tie_slack_us`` (the host time around the marker's
    launch less the call itself: the most the tie can be off) and
    ``marker_lag_us`` (from the marker's launch call to its start on the
    card: how far the device-marker tie lies from this one)."""

    def start(self) -> None:
        super().start()
        self.t_marked_ns = time.perf_counter_ns()   # just after the marker's launch

    def stop(self) -> None:
        kept = []
        export = self._prof.export_chrome_trace

        def export_and_keep(path):
            export(path)
            with open(path) as f:
                kept.extend(json.load(f)["traceEvents"])
        self._prof.export_chrome_trace = export_and_keep
        super().stop()
        self._launches(kept, self.t0_us + self.window_s * 1e6)

    def _launches(self, events, t_end_us: float) -> None:
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                      e.get("args", {}).get("correlation", -1))
                     for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        ops = [op for op in ops if op[1] > self.t0_us and op[0] < t_end_us]
        self.correlation = [c for _, _, _, c in ops]
        self.marker = m = next(i for i, op in enumerate(ops) if MARKER in op[2])
        calls = {e["args"]["correlation"]: (float(e["ts"]), float(e.get("dur", 0)))
                 for e in events if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
        mark = calls.get(self.correlation[m])
        if mark is None:
            raise RuntimeError("the trace holds no launch call for the marker: "
                               "no operation can be put on the host clock")
        self.launch_ns = np.array([self.t_mark_ns + (calls[c][0] - mark[0]) * 1e3
                                   if c in calls else np.nan for c in self.correlation])
        self.launch_events = int(np.isfinite(self.launch_ns).sum()) - 1
        self.launch_tie_us = mark[0]
        self.tie_slack_us = (self.t_marked_ns - self.t_mark_ns) / 1e3 - mark[1]
        self.marker_lag_us = ops[m][0] - mark[0]


def join(spans, program, trace) -> None:
    """Add to the harness's ``spans.done`` the program spans that overlap
    the traced window, each at a depth below the innermost harness span
    that encloses its root, as (name, t0, t1, depth)."""
    harness = list(spans.done)
    by_id = {r.id: r for r in program}
    depth: Dict[int, int] = {}

    def depth_of(r) -> int:
        if r.id not in depth:
            if r.parent is None or r.parent not in by_id:
                outer = [d for _, a, b, d in harness if a <= r.t0 and r.t1 <= b]
                depth[r.id] = 1 + max(outer, default=-1)
            else:
                depth[r.id] = 1 + depth_of(by_id[r.parent])
        return depth[r.id]

    for r in program:
        if hasattr(r, "t1") and r.t1 > trace.t_mark_ns and r.t0 < trace.t_end_ns:
            spans.done.append((r.name, r.t0, r.t1, depth_of(r)))


def innermost(done: List[Tuple[str, int, int, int]], t_ns: np.ndarray) -> np.ndarray:
    """The index in ``done`` of the deepest span open at each instant of
    ``t_ns`` (-1: none)."""
    idx = np.full(len(t_ns), -1)
    depth = np.full(len(t_ns), -1)
    for i, (_, a, b, d) in enumerate(done):
        inside = (t_ns >= a) & (t_ns < b) & (d > depth)
        idx[inside] = i
        depth[inside] = d
    return idx


def host_ns(trace, ts_us):
    """Trace-clock µs on ``perf_counter_ns``, through the marker's launch
    call."""
    return trace.t_mark_ns + (np.asarray(ts_us, dtype=np.float64) - trace.launch_tie_us) * 1e3


def operations(trace) -> np.ndarray:
    """Whether each interval of the trace is one of the window's operations:
    all but the marker."""
    return np.arange(len(trace.intervals)) != trace.marker


def labels(done: List[Tuple[str, int, int, int]], n_harness: int) -> List[str]:
    """The stage table's name of each span of ``done``, the harness's
    ``n_harness`` first: a harness span that shares its name with a
    program span is ``<name> (harness)``."""
    program = {s[0] for s in done[n_harness:]}
    return [f"{s[0]} (harness)" if i < n_harness and s[0] in program else s[0]
            for i, s in enumerate(done)]


def _segments(trace, done: List[Tuple[str, int, int, int]]):
    """The traced window cut at every span's and gap's edge: (the indices
    in ``done`` of the spans that overlap the window, those spans, edges
    ns, the index in those of the innermost span over each segment (-1:
    none), whether the card was idle over it)."""
    lo = float(host_ns(trace, trace.t0_us))
    hi = lo + trace.window_s * 1e9
    keep = [i for i, s in enumerate(done) if s[2] > lo and s[1] < hi]
    done = [done[i] for i in keep]
    gaps = host_ns(trace, trace.gaps).reshape(-1, 2)
    edges = np.unique(np.clip(np.concatenate(
        [[lo, hi], gaps.ravel(), [t for s in done for t in s[1:3]]]), lo, hi))
    mid = (edges[:-1] + edges[1:]) / 2
    k = np.searchsorted(gaps[:, 0], mid, side="right") - 1
    idle = (k >= 0) & (mid < gaps[np.maximum(k, 0), 1]) if len(gaps) else mid < lo
    return keep, done, edges, innermost(done, mid), idle


def table(trace, done: List[Tuple[str, int, int, int]],
          n_harness: int) -> Dict[str, Dict[str, float]]:
    """By span name (:func:`labels`; ``done`` holds the harness's
    ``n_harness`` spans first, then the program's) over the traced window:
    ``calls`` (spans overlapping it), ``host_ms`` (their time inside it),
    ``self_ms`` (the time it was the innermost span), ``launches`` and
    ``device_ms`` (the operations whose launch call came while it was the
    innermost span; the marker left out) and ``idle_ms`` (the card's idle
    time while it was the innermost span). The window is the trace's, on
    the host clock; outside every span is :data:`NO_SPAN`."""
    names = labels(done, n_harness)
    keep, done, edges, at, idle = _segments(trace, done)
    names = [names[i] for i in keep]
    lo, hi = edges[0], edges[-1]
    rows: Dict[str, Dict[str, float]] = {}

    def row(name: str) -> Dict[str, float]:
        return rows.setdefault(name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                      "launches": 0, "device_ms": 0.0, "idle_ms": 0.0})

    def label(i: int) -> str:
        return NO_SPAN if i < 0 else names[i]

    for name, (_, a, b, _) in zip(names, done):
        r = row(name)
        r["calls"] += 1
        r["host_ms"] += (min(b, hi) - max(a, lo)) / 1e6
    for i, dt, off in zip(at, np.diff(edges), idle):
        r = row(label(i))
        r["self_ms"] += dt / 1e6
        if off:
            r["idle_ms"] += dt / 1e6
    ops = operations(trace)
    dur_ms = [(b - a) / 1e3 for (a, b, _), op in zip(trace.intervals, ops) if op]
    for i, ms in zip(innermost(done, trace.launch_ns[ops]), dur_ms):
        r = row(label(i))
        r["launches"] += 1
        r["device_ms"] += ms
    return rows


def root_share(trace, done: List[Tuple[str, int, int, int]]) -> Dict[str, list]:
    """For each name of :data:`ROOTS` in ``done``: [the card's idle ms while
    a span of that name was open, the share of it while a span nested below
    was the innermost, not the root itself]."""
    _, done, edges, at, idle = _segments(trace, done)
    mid = (edges[:-1] + edges[1:]) / 2
    dt = np.diff(edges) / 1e6
    names = np.array([s[0] for s in done] + [NO_SPAN], dtype=object)[at]
    out = {}
    for root in ROOTS:
        inside = np.zeros(len(mid), bool)
        for name, a, b, _ in done:
            if name == root:
                inside |= (mid >= a) & (mid < b)
        total = float(dt[inside & idle].sum())
        if total > 0:
            own = float(dt[inside & idle & (names == root)].sum())
            out[root] = [total, 1.0 - own / total]
    return out


def counts(trace, program: list) -> Dict[str, Dict[str, int]]:
    """The program's counters (``profiling.count``) by span name, summed
    over its spans inside the traced window."""
    out: Dict[str, Dict[str, int]] = {}
    for r in program:
        if getattr(r, "counts", None) and hasattr(r, "t1") \
                and r.t0 >= trace.t_mark_ns and r.t1 <= trace.t_end_ns:
            row = out.setdefault(r.name, {})
            for k, v in r.counts.items():
                row[k] = row.get(k, 0) + v
    return out


def report(trace: StageTrace, spans, program: list, units: int, unit: str) -> None:
    """Join the program's spans to the harness's (:func:`join`) and print
    the stage table to standard error, a ``unit`` (step, request, batch)
    over the ``units`` traced, with the program's counters beside their
    stage."""
    n_harness = len(spans.done)
    join(spans, program, trace)
    rows = table(trace, spans.done, n_harness)
    counted = counts(trace, program)
    n = max(units, 1)
    err = sys.stderr
    print(f"stages, a {unit} over {units} traced (ops by launch time, idle by overlap); "
          f"{trace.launch_events} of {len(trace.intervals) - 1} ops matched to a launch; "
          f"clock tie: launch call within {trace.tie_slack_us:.1f} us of the host mark, "
          f"marker ran {trace.marker_lag_us:.1f} us after its launch", file=err)
    print(f"{'stage':<22}{'calls':>7}{'host_ms':>10}{'self_ms':>10}{'launches':>10}"
          f"{'device_ms':>11}{'idle_ms':>10}  counts", file=err)
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["idle_ms"]):
        extra = " ".join(f"{k}={v / n:.2f}" for k, v in counted.get(name, {}).items())
        print(f"{name:<22}{r['calls'] / n:>7.2f}{r['host_ms'] / n:>10.3f}"
              f"{r['self_ms'] / n:>10.3f}{r['launches'] / n:>10.1f}"
              f"{r['device_ms'] / n:>11.3f}{r['idle_ms'] / n:>10.3f}  {extra}".rstrip(),
              file=err)
    for root, (total, share) in root_share(trace, spans.done).items():
        print(f"idle under {root}: {total / n:.3f} ms a {unit}, "
              f"{100 * share:.1f} % of it on its stages", file=err)
