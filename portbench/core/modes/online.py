"""Online traffic: one client in a closed loop hands over one sweep at a
time and waits for its per-point instance labels on the host.

Set-up writes the val pool from the seed, reads every sweep once through
the port's reader into host memory, makes the weights on the device (the
train form, as a checkpoint holds them) and puts the model in the eval
form, then serves ``warm_requests`` sweeps. Each request of the window is
the calls ``infer.main`` makes, without writing files: ``to_device`` →
``eval_step`` → ``fetch_eval_outputs`` → ``scene_result``, timed from the
hand-over to the labels. ``infer_p95_ms`` is the 95th percentile of every
request of the window. The RPN heads' outputs of a sample of the window's
requests, drawn from the seed, are kept (``core/capture.py``); after the
window the reference answers those requests again, following the program
by stages (``reference/check.py``), and the two are compared.
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

DETERMINISTIC = False     # cuDNN as infer.py leaves it


def run(ctx) -> tuple:
    from sparse_rcnn_tpu_torch.data.datasets import build_dataset
    from sparse_rcnn_tpu_torch.infer import scene_result
    from sparse_rcnn_tpu_torch.train import loop as TL
    from sparse_rcnn_tpu_torch.train.evaluate import fetch_eval_outputs

    device, traffic = ctx.device, ctx.traffic
    cfg, model, init_host = ctx.setup_model("val")
    ds = build_dataset(cfg, "val")
    sweeps = [{k: v[None] for k, v in ds[i].items()} for i in range(len(ds))]
    nc = cfg.model.num_classes
    model = TL.eval_model(cfg, model)
    capture = RpnCapture(model, traffic["check_requests"], ctx.seed)
    spans = Spans()
    eval_fn = ctx.hooks.get("eval_step", TL.eval_step)
    answer_fn = ctx.hooks.get("scene_result", scene_result)

    def request(i):
        with spans.span("to_device"):
            dev = TL.to_device(sweeps[i % len(sweeps)], device)
        with spans.span("eval_step"):
            raw = eval_fn(cfg, model, dev)
        with spans.span("fetch"):
            out = fetch_eval_outputs(raw)
            del raw
        capture.end_call()
        with spans.span("scene_result"):
            return out, answer_fn(out, 0, nc)

    for i in range(traffic["warm_requests"]):
        request(i)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    lat, answers = [], []
    capture.start()
    tracer, traced = None, 0
    t0 = time.perf_counter()
    n = 0
    while True:
        if ctx.trace and n == 1 and ctx.cuda:
            tracer = DeviceTrace(device, ctx.trace_path)
            tracer.start()
            s0 = len(spans.done)
        a = time.perf_counter()
        answers.append(request(n))
        lat.append(time.perf_counter() - a)
        n += 1
        if tracer is not None and traced < traffic["trace_requests"]:
            traced += 1
            if traced == traffic["trace_requests"]:
                tracer.stop()
                host_ns = sum(t1 - t0_ for name, t0_, t1, _ in spans.done[s0:]
                              if name in ("fetch", "scene_result"))
        if time.perf_counter() - t0 >= ctx.seconds and not (
                tracer is not None and traced < traffic["trace_requests"]):
            break
    peak = ctx.memory_peak()
    kept = capture.close()
    del model, capture
    gc.collect()
    ctx.free()

    sample = sorted(kept)
    rcfg = ctx.ref_cfg()
    files = scene_files(rcfg, "val")
    ref_in = [read_scene(rcfg, files[i % len(files)], i % len(files)) for i in sample]
    prog = []
    for i in sample:
        out, (inst, scores, pred_cls, pmask) = answers[i]
        got = RC.decode(out, 0, nc)
        got.update(inst=inst, scores=scores, cls=pred_cls, pmask=pmask.astype(bool),
                   rpn=kept[i])
        prog.append(got)
    t_ref = time.perf_counter()
    ref = RC.eval_reference(rcfg, init_host, [{k: v[None] for k, v in s.items()}
                                              for s in ref_in], device,
                            follow=[p["rpn"] for p in prog])
    numbers = RC.answer_numbers(prog, ref, [s["valid"] for s in ref_in])
    record = {"mode": "online", "cfg": rcfg, "trace": tracer,
              "returned": list(np.cumsum(lat)), "traced": traced,
              "reference_s": time.perf_counter() - t_ref, "n_sparse": (
                  rcfg.model.backbone.dense_from_scale or len(rcfg.model.backbone.widths))}
    if tracer is not None:
        record["online_host_s"] = host_ns / 1e9
        # the traced requests are the window's second to (traced + 1)-th
        record["rulebook_stats"] = [
            rulebook_stats(rcfg, {k: v[None] for k, v in read_scene(
                rcfg, files[(1 + j) % len(files)], (1 + j) % len(files)).items()}, device)
            for j in range(traced)]
    metrics = {}
    if not ctx.trace:
        metrics["infer_p95_ms"] = {"value": 1e3 * float(np.percentile(lat, 95)), "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    return {"attempted": n, "failed": 0, "memory_peak_bytes": peak, "record": record,
            "numbers": numbers, "metrics": metrics, "spans": spans}
