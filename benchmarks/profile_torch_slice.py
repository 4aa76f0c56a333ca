#!/usr/bin/env python3
"""Where one inference step and one training step of the PyTorch port spend
their time on the card.

    python benchmarks/profile_torch_slice.py [--config configs/config1_tiny_5cm.yaml]
        [--set key.path=value ...] [--scenes 3] [--out-dir DIR]
    python benchmarks/profile_torch_slice.py --config configs/config2_scannet_2cm.yaml \
        --set data.dataset=synthetic --scenes 2

Runs the port (``sparse_rcnn_tpu_torch``, seeded init) on CUDA, each step
split into stages with a synchronise after each:

- the eval step on val scenes: hierarchy (voxelize + rulebooks), backbone,
  heads (RPN, NMS, RoI, masks, devoxelize);
- the training step on batches of the train stream: prepare (voxelize,
  rulebooks, GT), forward (the model in training mode and the losses),
  backward, optimizer (gradient norm, clip, AdamW), as ``train_step`` runs
  them.

First without the profiler (host clock), then under ``torch.profiler`` with
CPU and CUDA activities. From the trace, per stage and per step: wall ms,
device busy ms (the union of the kernel and copy intervals), the idle
share, and the number of device operations; and the kernels that take the
most device time; the peak device memory of each kind of step. With a
dense tail, the eval step runs the eval form (``dense_from_scale``) and the
train step the train form (``dense_from_scale_train``) of one seeded init.
Prints one JSON line and writes it, with the gzipped chrome traces, to
``--out-dir``. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gzip
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sparse_rcnn_tpu_torch import infer  # noqa: E402
from sparse_rcnn_tpu_torch.config import load_config  # noqa: E402
from sparse_rcnn_tpu_torch.data.pipeline import EvalBatches, TrainStream  # noqa: E402
from sparse_rcnn_tpu_torch.train import loop as TL  # noqa: E402

EVAL_STAGES = ("hierarchy", "backbone", "heads")
TRAIN_STAGES = ("prepare", "forward", "backward", "optimizer")


class Stages:
    """Host ms of the stages of one step: each stage is a profiler range
    that ends with a synchronise."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with record_function(name):
            yield
            torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3

    def total(self) -> dict:
        return {**self.ms, "total": sum(self.ms.values())}


def eval_step(cfg, model, batch) -> dict:
    """One eval step by stage; returns the host ms of each."""
    stage = Stages()
    with torch.no_grad():
        with stage("hierarchy"):
            st, p2v, scales, _, _ = TL.prepare_inputs(cfg, batch)
        with stage("backbone"):
            outs = model.backbone(st.feats, scales)
        with stage("heads"):
            TL.finish(cfg, model.heads(outs, scales), scales, p2v)
    return stage.total()


def train_step(cfg, state, batch) -> dict:
    """One training step by stage, as ``TL.train_step`` runs it (without
    EMA); updates ``state`` in place and returns the host ms of each stage."""
    cfg = TL.train_cfg(cfg)
    stage = Stages()
    model = state.model
    params = list(model.parameters())
    with stage("prepare"):
        st, _, scales, gt, _ = TL.prepare_inputs(cfg, batch)
    with stage("forward"):
        out = model.train()(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
        total, _ = TL.compute_losses(cfg, out, scales, gt, st.row_mask)
    with stage("backward"):
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    with stage("optimizer"), torch.no_grad():
        TL.global_norm(grads)
        TL.Optimizer(cfg).apply(state.opt_state, params, grads)
    state.step += 1
    return stage.total()


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def measure(run, items, stage_names, trace_path) -> dict:
    """Warm up, time ``run(item)`` 3 times per item on the host clock, then
    once per item under the profiler; per step: stage split, device busy
    and idle share, device operations, top device consumers."""
    for it in items:
        run(it)
    torch.cuda.reset_peak_memory_stats()
    host = [run(it) for it in items for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in items:
            run(it)
    n = len(items)
    events = prof.events()
    # kernels, copies and sets; not the device-side copies of the stage ranges
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.name not in stage_names]
    if not device:
        raise SystemExit("profile_torch_slice: the profiler recorded no device "
                         "events; device time not measured")
    ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name in stage_names]
    stages = {}
    for name in stage_names:
        wall = busy = count = 0.0
        for r in (r for r in ranges if r.name == name):
            lo, hi = r.time_range.start, r.time_range.end
            inside = [(e.time_range.start, min(e.time_range.end, hi)) for e in device
                      if lo <= e.time_range.start < hi]
            wall += hi - lo
            busy += union_us(inside)
            count += len(inside)
        stages[name] = {"wall_ms": wall / n / 1e3, "device_busy_ms": busy / n / 1e3,
                        "idle_share": 1 - busy / wall if wall else None,
                        "device_ops": count / n}
    wall = sum(s["wall_ms"] for s in stages.values())
    busy = sum(s["device_busy_ms"] for s in stages.values())
    stages["total"] = {"wall_ms": wall, "device_busy_ms": busy,
                       "idle_share": 1 - busy / wall,
                       "device_ops": sum(s["device_ops"] for s in stages.values())}

    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    prof.export_chrome_trace(trace_path)
    with open(trace_path, "rb") as src, gzip.open(trace_path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace_path)
    return {
        "steps": n,
        "peak_bytes": peak,
        "unprofiled_ms_per_step": {k: statistics.median(h[k] for h in host)
                                   for k in host[0]},
        "profiled_per_step": stages,
        "top_device_ops": [{"name": k[:90], "ms_per_step": v[0] / n / 1e3,
                            "count_per_step": v[1] / n} for k, v in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(ROOT, "configs", "config1_tiny_5cm.yaml"))
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--scenes", type=int, default=3, help="val scenes, and train batches")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True      # as the train entry point
    os.makedirs(args.out_dir, exist_ok=True)

    cfg = load_config(args.config, infer.parse_overrides(args.overrides))
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = TL.eval_model(cfg, TL.build_model(TL.train_cfg(cfg), "cuda", gen))
    n_batches = -(-args.scenes // cfg.data.batch_size)
    val = [TL.to_device(b, "cuda") for b in itertools.islice(EvalBatches(cfg, "val"), n_batches)]
    ev = measure(lambda b: eval_step(cfg, model, b), val, EVAL_STAGES,
                 os.path.join(args.out_dir, "trace_eval.json"))
    state = TL.init_state(cfg, "cuda", torch.Generator().manual_seed(cfg.train.seed))
    stream = TrainStream(cfg, seed=cfg.train.seed)
    train = [TL.to_device(next(stream), "cuda", TL.TRAIN_KEYS) for _ in range(args.scenes)]
    tr = measure(lambda b: train_step(cfg, state, b), train, TRAIN_STAGES,
                 os.path.join(args.out_dir, "trace_train.json"))
    result = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        "config": cfg.name, "overrides": args.overrides or [], "batch_size": cfg.data.batch_size, "eval": ev, "train": tr,
    }
    with open(os.path.join(args.out_dir, "profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
