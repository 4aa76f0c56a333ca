"""Eval traffic: one ``run_eval`` pass, with its lookahead and scoring,
through the eval Loader (unaugmented, the configuration's batch), over a
stream that cycles through the val pool and stops yielding once the
window's seconds have passed.

Set-up writes the val pool from the seed, makes the weights on the device
in the train form and converts them once to the eval form
(``train/loop.py::eval_model``), then runs a short pass of
``warm_batches``. ``eval_scenes_per_s`` is the scenes the window's pass
scored over its whole wall time (``eval_wall_s``). The harness wraps the
pass's calls of ``eval_step`` and ``fetch_eval_outputs`` in spans and keeps
each batch's fetched outputs (``run_eval`` hands them to no caller, so the
wrappers stand in the port's module for the pass and are put back after
it), and keeps the RPN heads' outputs of a sample of the window's batches,
drawn from the seed (``core/capture.py``). After the window the reference
answers the scenes of those batches again, following the program by stages
(``reference/check.py``), and the two are compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ..capture import RpnCapture
from ..spans import Spans
from ..trace import DeviceTrace
from ...reference import check as RC
from ...reference.batches import read_scene, scene_files
from ...reference.stats import rulebook_stats

DETERMINISTIC = False     # cuDNN as eval.py leaves it


def run(ctx) -> tuple:
    from sparse_rcnn_tpu_torch.data.pipeline import Loader
    from sparse_rcnn_tpu_torch.train import evaluate as EV
    from sparse_rcnn_tpu_torch.train import loop as TL

    device, traffic = ctx.device, ctx.traffic
    cfg, model, init_host = ctx.setup_model("val")
    model = TL.eval_model(cfg, model)
    nc, b = cfg.model.num_classes, cfg.data.batch_size
    capture = RpnCapture(model, -(-traffic["check_scenes"] // b), ctx.seed)

    spans = Spans()
    fetched = []
    loaders = []
    orig_step, orig_fetch = TL.eval_step, EV.fetch_eval_outputs
    step_fn = ctx.hooks.get("eval_step", orig_step)

    calls = [0]
    trace_at = [None]          # the window's step calls to trace: [1, 1 + trace_batches)

    def eval_step(*a, **k):
        j = calls[0]
        calls[0] += 1
        if trace_at[0] is not None:
            trace_at[0](j)
        with spans.span("eval_step"):
            return step_fn(*a, **k)

    def fetch(out):
        with spans.span("fetch"):
            host = orig_fetch(out)
        fetched.append(host)
        capture.end_call()
        return host

    def stream(deadline):
        """Batches of the val pool, in order and again, until ``deadline``."""
        while True:
            ld = Loader(cfg, "val", train=False)
            loaders.append(ld)
            try:
                for batch in spans.wrap(ld, "loader.next"):
                    if deadline is not None and time.perf_counter() >= deadline:
                        return
                    yield batch
            finally:
                ld.close()

    def one_pass(batches, n_batches=None):
        EV.fetch_eval_outputs = fetch
        TL.eval_step = eval_step
        try:
            with spans.span("run_eval"):
                return EV.run_eval(cfg, model, batches, max_batches=n_batches)
        finally:
            EV.fetch_eval_outputs, TL.eval_step = orig_fetch, orig_step

    one_pass(stream(None), traffic["warm_batches"])
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    fetched.clear()
    loaders.clear()
    spans.done.clear()

    tracer = None
    traced = []
    calls[0] = 0

    def tracing(j):
        nonlocal tracer
        if j == 1:
            tracer = DeviceTrace(device, ctx.trace_path)
            tracer.start()
        elif tracer is not None and len(traced) < traffic["trace_batches"]:
            traced.append(j - 1)
            if len(traced) == traffic["trace_batches"]:
                tracer.stop()

    if ctx.trace and ctx.cuda:
        trace_at[0] = tracing
    capture.start()
    res = one_pass(stream(time.perf_counter() + ctx.seconds))
    trace_at[0] = None
    if tracer is not None and len(traced) < traffic["trace_batches"]:
        raise RuntimeError(f"the pass ran {calls[0]} steps: too few to trace "
                           f"{traffic['trace_batches']}")
    peak = ctx.memory_peak()
    kept = capture.close()
    del model, capture
    gc.collect()
    ctx.free()

    scenes = res["scenes"]
    rcfg = ctx.ref_cfg()
    files = scene_files(rcfg, "val")
    pool = len(files)
    sample = [(j, k) for j in sorted(kept) for k in range(len(kept[j][0]["obj"]))]
    prog = []
    for j, k in sample:
        got = RC.decode(fetched[j], k, nc)
        got["rpn"] = RC.rpn_scene(kept[j], k)
        prog.append(got)
    ref_in = [read_scene(rcfg, files[(j * b + k) % pool], (j * b + k) % pool)
              for j, k in sample]
    t_ref = time.perf_counter()
    ref = RC.eval_reference(rcfg, init_host, [{k: v[None] for k, v in s.items()}
                                              for s in ref_in], device,
                            follow=[p["rpn"] for p in prog])
    numbers = RC.answer_numbers(prog, ref, [s["valid"] for s in ref_in])
    record = {"mode": "eval", "cfg": rcfg, "trace": tracer, "reference_s":
              time.perf_counter() - t_ref, "eval": res, "traced": len(traced),
              "loader": {"wait_s": sum(ld.wait_s for ld in loaders),
                         "batches_out": sum(ld.batches_out for ld in loaders)}}
    if tracer is not None:
        record["rulebook_stats"] = []
        for i in traced:
            idx = [(i * b + j) % pool for j in range(b)]
            sc = [read_scene(rcfg, files[k], k) for k in idx]
            record["rulebook_stats"].append(rulebook_stats(
                rcfg, {k: np.stack([s[k] for s in sc]) for k in sc[0]}, device))
    metrics = {}
    if not ctx.trace:
        metrics["eval_scenes_per_s"] = {"value": scenes / res["eval_wall_s"],
                                        "unit": "scenes/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    return {"attempted": scenes, "failed": 0, "memory_peak_bytes": peak, "record": record,
            "numbers": numbers, "metrics": metrics, "spans": spans}
