"""The stage attribution of a traced window (``core/stages.py``) on a
hand-made trace: a marker, device operations with their correlation ids,
the launch calls (``cuda_runtime`` and ``cuda_driver``), harness spans and the
program's spans of one train step.

- Each operation is charged to the innermost span open at its launch's host
  time, through the marker's own launch call (the marker taken by its
  kernel's name, wherever it lies); every operation once, so the stages'
  launches add up to the window's operations. A harness span and the
  program's span of the same name are rows of their own.
- A stage's idle time is the card's idle time while it was the innermost
  span. The breakdown's gap labels keep the rule of a whole gap to the
  innermost span at its middle, program stages nested under the harness
  span that encloses them.
- The stage table's report carries the program's counters beside their
  stage; ``eval_compute_ms`` reads ``run_eval``'s own ``eval_compute_s``
  and finds nothing in a program that does not time it.
"""

import json
from types import SimpleNamespace

import pytest

from portbench.core import common, stages
from portbench.core.spans import Spans

MARK_NS = 10 ** 12       # the host's mark, perf_counter_ns
BASE_US = 100.0          # the trace clock (µs) of the marker's launch call

# (correlation, launch at µs after the mark or None, device start µs after the mark, dur µs)
OPS = [
    (7, 500, 600, 50),          # outside every span
    (6, 1150, 1160, 10),        # the program's train_step itself
    (2, 1300, 1400, 100),       # prepare_inputs
    (3, 3500, 3600, 1000),      # backward
    (4, 3600, 4600, 400),       # backward
    (5, 7500, 7600, 100),       # optimizer, a cuda_driver launch
    (8, 9200, 9500, 100),       # outside every span
]
HARNESS = [("train_step", 1000, 9000, 0)]
# (id, name, parent, t0 µs, t1 µs)
PROGRAM = [
    (10, "train_step", None, 1100, 8900),
    (11, "prepare_inputs", 10, 1200, 3000),
    (12, "backward", 10, 3000, 7000),
    (13, "optimizer", 10, 7000, 8800),
]


def ns(us):
    return MARK_NS + int(us * 1000)


def events():
    ev = [{"ph": "X", "cat": "kernel", "name": "spin_kernel(long)", "ts": BASE_US + 5, "dur": 5,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": BASE_US,
           "dur": 4, "args": {"correlation": 1}}]
    for corr, launch, start, dur in OPS:
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": BASE_US + start,
                   "dur": dur, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_driver" if corr == 5 else "cuda_runtime",
                   "name": "launch", "ts": BASE_US + launch, "dur": 3,
                   "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
               "ts": BASE_US + 9990, "dur": 5, "args": {"correlation": 99}})
    return ev


def stopped(tmp_path, monkeypatch, evs):
    """A StageTrace stopped over the events ``evs`` (no card: the
    profiler's export is stood in for)."""
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tr = stages.StageTrace("cpu", str(tmp_path / "trace.json"))

    def export(path):
        with open(path, "w") as f:
            json.dump({"traceEvents": evs}, f)
    tr._prof = SimpleNamespace(__exit__=lambda *a: None, export_chrome_trace=export)
    tr.t_mark_ns, tr.t_marked_ns = MARK_NS, ns(10)
    import time
    monkeypatch.setattr(time, "perf_counter_ns", lambda: ns(10000))
    tr.stop()
    monkeypatch.undo()
    return tr


@pytest.fixture
def trace(tmp_path, monkeypatch):
    return stopped(tmp_path, monkeypatch, events())


def program_spans():
    out = []
    for i, name, parent, a, b in PROGRAM:
        out.append(SimpleNamespace(id=i, name=name, parent=parent, root=10, t0=ns(a),
                                   t1=ns(b), thread=1, counts=None))
    out[1].counts = {"scenes": 2}
    return out


def harness_spans():
    sp = Spans()
    sp.done = [(name, ns(a), ns(b), d) for name, a, b, d in HARNESS]
    return sp


def test_launch_times_on_the_host_clock(trace):
    assert trace.launch_events == 7 and trace.marker == 0
    assert trace.correlation == [1, 7, 6, 2, 3, 4, 5, 8]
    assert trace.launch_ns[0] == MARK_NS
    assert trace.launch_ns[1] == ns(500) and trace.launch_ns[6] == ns(7500)
    assert trace.tie_slack_us == pytest.approx(6.0)
    assert trace.marker_lag_us == pytest.approx(5.0)


def test_each_operation_is_charged_once_to_its_stage(trace):
    sp = harness_spans()
    stages.join(sp, program_spans(), trace)
    rows = stages.table(trace, sp.done, len(HARNESS))
    launches = {k: r["launches"] for k, r in rows.items() if r["launches"]}
    assert launches == {"harness": 2, "train_step": 1, "prepare_inputs": 1, "backward": 2,
                        "optimizer": 1}
    assert sum(launches.values()) == len(trace.intervals) - 1
    assert rows["backward"]["device_ms"] == pytest.approx(1.4)
    assert sum(r["device_ms"] for r in rows.values()) == pytest.approx(1.76)
    # the card's idle time while each stage was the innermost span, on the
    # launch calls' tie: the window runs 5 to 10005 µs after the mark
    idle = {k: round(r["idle_ms"], 6) for k, r in rows.items() if r["idle_ms"]}
    assert idle == {"harness": (590 + 350 + 500 + 405) / 1e3, "train_step (harness)": 0.2,
                    "train_step": 0.19, "prepare_inputs": 1.7, "backward": 2.6, "optimizer": 1.7}
    assert sum(idle.values()) == pytest.approx(trace.window_s * 1e3 - trace.busy_s * 1e3)
    # host: the harness's train_step wraps the program's, a row each, each
    # 0.2 ms its own
    harness = rows["train_step (harness)"]
    assert rows["train_step"]["calls"] == 1 and harness["calls"] == 1
    assert rows["train_step"]["host_ms"] == pytest.approx(7.8)
    assert harness["host_ms"] == pytest.approx(8.0)
    assert rows["train_step"]["self_ms"] == pytest.approx(0.2)
    assert harness["self_ms"] == pytest.approx(0.2)
    assert rows["backward"]["self_ms"] == pytest.approx(4.0)
    assert rows["harness"]["self_ms"] == pytest.approx(2.0)
    assert sum(r["self_ms"] for r in rows.values()) == pytest.approx(trace.window_s * 1e3)
    assert stages.root_share(trace, sp.done) == {
        "train_step": [pytest.approx(6.39), pytest.approx(1 - 0.39 / 6.39)]}


def test_gap_labels_nest_program_stages_under_the_harness_span(trace):
    sp = harness_spans()
    stages.join(sp, program_spans(), trace)
    depth = {name: d for name, _, _, d in sp.done}
    assert depth == {"train_step": 1, "prepare_inputs": 2, "backward": 2, "optimizer": 2}
    assert sp.done[0] == ("train_step", ns(1000), ns(9000), 0)
    labels = dict(trace.idle_by_span(sp))
    assert set(labels) == {"harness", "prepare_inputs", "backward", "optimizer"}
    assert labels["backward"] == pytest.approx(2.6e-3)
    # without the program's spans the same gaps go to the harness span
    assert set(dict(trace.idle_by_span(harness_spans()))) == {"harness", "train_step"}


def test_report_prints_the_stage_table(trace, capsys):
    stages.report(trace, harness_spans(), program_spans(), 1, "step")
    err = capsys.readouterr().err
    assert "7 of 7 ops matched to a launch" in err and "93.9 % of it on its stages" in err
    assert "train_step (harness)" in err
    line = next(ln for ln in err.splitlines() if ln.startswith("prepare_inputs"))
    assert line.endswith("scenes=2.00")
    assert line.split()[1:5] == ["1.00", "1.800", "1.800", "1.0"]


def test_eval_compute_ms_reads_run_evals_own_time():
    ev = {"mode": "eval", "eval": {"scenes": 4, "eval_compute_s": 4e-4}}
    assert common.read_metric("eval_compute_ms", ev) == pytest.approx(0.1)
    # a run_eval that does not time its compute: nothing to read
    assert common.read_metric("eval_compute_ms", {"mode": "eval",
                                                  "eval": {"scenes": 4}}) is None
    assert common.read_metric("eval_compute_ms", {**ev, "mode": "online"}) is None


def test_the_tie_takes_the_marker_by_name(tmp_path, monkeypatch):
    """An operation on the card before the marker does not move the tie."""
    early = {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": BASE_US + 2, "dur": 1,
             "args": {"correlation": 50}}
    call = {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": BASE_US - 900,
            "dur": 3, "args": {"correlation": 50}}
    tr = stopped(tmp_path, monkeypatch, [early, call] + events())
    assert tr.correlation[:2] == [50, 1] and tr.marker == 1
    assert tr.launch_ns[2] == ns(500) and tr.marker_lag_us == pytest.approx(5.0)
    # the operation before the marker is counted, the marker is not
    assert tr.launch_events == 8
    rows = stages.table(tr, [], 0)
    assert sum(r["launches"] for r in rows.values()) == 8


def test_a_trace_without_the_markers_launch_call_is_refused(tmp_path, monkeypatch):
    evs = [e for e in events() if not (e["cat"] == "cuda_runtime"
                                       and e["args"]["correlation"] == 1)]
    with pytest.raises(RuntimeError, match="no launch call for the marker"):
        stopped(tmp_path, monkeypatch, evs)
