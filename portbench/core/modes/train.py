"""Training traffic: the job's own closed loop, ``Loader`` → ``device_batches``
→ ``train_step``, at the configuration's batch, with its Loader settings.

Set-up writes the train pool from the seed, makes the weights on the
device, builds the train state and drives it through the check steps with
the window's own call and feed; those steps are the warm-up, and their
readings are what the reference follows. The window then steps the same
state for ``--seconds``: ``train_scenes_per_s`` is every scene stepped over
the whole window, the last step waited for. With ``--trace 1`` the device
is traced over ``trace_steps`` steps of the window, and the Loader's
counters are read over all of it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..spans import Spans
from ..trace import DeviceTrace
from ...reference import check as RC
from ...reference.stats import rulebook_stats

DETERMINISTIC = True      # as the train entry point sets cuDNN


def loader_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed, 31]).generate_state(1)[0])


def run(ctx) -> tuple:
    from sparse_rcnn_tpu_torch.data.pipeline import Loader, device_batches
    from sparse_rcnn_tpu_torch.train import loop as TL

    device, traffic = ctx.device, ctx.traffic
    cfg, model, init_host = ctx.setup_model("train")
    b = cfg.data.batch_size
    lseed = loader_seed(ctx.seed)
    state = TL.init_state(cfg, device, model=model)
    p0 = [p.detach().clone() for p in model.parameters()]

    spans = Spans()
    loader = Loader(cfg, "train", seed=lseed)
    stream = device_batches(spans.wrap(loader, "loader.next"), device, TL.TRAIN_KEYS)
    step_fn = ctx.hooks.get("train_step", TL.train_step)
    bad = torch.zeros((), dtype=torch.int64, device=device)

    def step():
        nonlocal state, bad
        with spans.span("device_batches"):
            host, dev = next(stream)
        with spans.span("train_step"):
            state, m = step_fn(cfg, state, dev)
        bad = bad + (~torch.isfinite(m["total"])).to(torch.int64)
        return host, m

    # the check steps: the window's own call and feed, from the seed
    prog = {"batches": [], "losses": []}
    for t in range(traffic["check_steps"]):
        host, m = step()
        prog["batches"].append({k: np.array(host[k]) for k in TL.TRAIN_KEYS})
        prog["losses"].append(m["total"].detach().clone())
        if t == 0:
            mu = state.opt_state.mu
            prog["grad_norms"] = RC.leaf_norms(mu) / (1.0 - RC.B1)
    prog["change_norms"] = RC.leaf_norms(
        [p - q for p, q in zip(state.model.parameters(), p0)])
    prog["losses"] = [float(x) for x in prog["losses"]]
    del p0
    for _ in range(traffic["warm_steps"]):
        step()
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    # the window
    bad = torch.zeros_like(bad)
    w0, n0 = loader.wait_s, loader.batches_out
    tracer = None
    traced = []
    returned = []
    n = 0
    t0 = time.perf_counter()
    while True:
        if ctx.trace and n == 1 and ctx.cuda:
            tracer = DeviceTrace(device, ctx.trace_path)
            tracer.start()
        host, _ = step()
        n += 1
        returned.append(time.perf_counter() - t0)
        if tracer is not None and len(traced) < traffic["trace_steps"]:
            traced.append({k: np.array(host[k]) for k in ("points", "feats", "valid")})
            if len(traced) == traffic["trace_steps"]:
                tracer.stop()
        tracing = tracer is not None and len(traced) < traffic["trace_steps"]
        if time.perf_counter() - t0 >= ctx.seconds and not tracing:
            break
    ctx.sync()
    window = time.perf_counter() - t0
    failed = int(bad)
    loader_delta = {"wait_s": loader.wait_s - w0, "batches_out": loader.batches_out - n0}
    peak = ctx.memory_peak()
    loader.close()
    del state, model, stream, step_fn
    gc.collect()
    ctx.free()

    rcfg = ctx.ref_cfg()
    record = {"mode": "train", "cfg": rcfg, "returned": returned, "loader": loader_delta,
              "trace": tracer,
              "traced": len(traced) if tracer is not None else 0,
              "n_sparse": rcfg.model.backbone.dense_from_scale_train
              or rcfg.model.backbone.dense_from_scale or len(rcfg.model.backbone.widths)}
    if tracer is not None:
        record["rulebook_stats"] = [rulebook_stats(rcfg, hb, device) for hb in traced]

    t_ref = time.perf_counter()
    ref = RC.train_reference(rcfg, init_host, lseed, device, steps=traffic["check_steps"])
    record["reference_s"] = time.perf_counter() - t_ref
    numbers = RC.train_numbers(prog, ref)
    metrics = {}
    if not ctx.trace:
        metrics["train_scenes_per_s"] = {"value": n * b / window, "unit": "scenes/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    return {"attempted": n, "failed": failed, "memory_peak_bytes": peak,
            "record": record, "numbers": numbers, "metrics": metrics,
            "spans": spans}
