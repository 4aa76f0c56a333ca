#!/usr/bin/env python3
"""Where a scene's scoring goes in the eval pass, on the card's host: the
overlap counts against the per-point masks.

    python3 benchmarks/eval_scoring_split.py [--scenes 8] [--reps 10] [--out FILE]

Config 2 (``data.dataset=synthetic``, its eval form) at full width, seeded
init, over ``--scenes`` val scenes in the config's batches, with one math
thread on the host as the benchmark sets. For each batch, after a warm
step: the card's ms of the eval step and of ``overlap_counts`` after it
(CUDA events, ``--reps`` times each after a 1 ms spin), and the host's ms
to queue the counts. Then, on the same fetched outputs, each scene's host
ms a step:

- the mask path (``postprocess_scene`` + ``add_scene`` + the evaluator's
  ``_scene_cache``, written out step by step): the unpack, the boolean
  column index over the valid points, the row gather of the kept
  proposals, the float32 cast, the GT masks, the matmul, the mask sums;
- the counts path (``run_eval``'s scoring): ``scene_scores``,
  ``_gt_classes_from_points``, ``add_scene_counts``, the semantic add;
- each evaluator's final ``compute`` a scene (the 12 thresholds' matching
  and AP), the two dicts required equal.

Last, two ``run_eval`` passes over the scenes: ``eval_*_s`` a scene, with
the card's peak bytes against one eval step's. Prints one JSON line (and
writes it to ``--out``). Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

if __name__ == "__main__":    # one math thread, set before numpy loads its BLAS
    for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[_v] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from sparse_rcnn_tpu_torch.config import load_config  # noqa: E402
from sparse_rcnn_tpu_torch.data.pipeline import Loader  # noqa: E402
from sparse_rcnn_tpu_torch.train import evaluate as EV  # noqa: E402
from sparse_rcnn_tpu_torch.train import loop as TL  # noqa: E402
from sparse_rcnn_tpu_torch.utils.metrics import (  # noqa: E402
    InstanceAPEvaluator, SemanticMIoUEvaluator)

CONFIG2 = os.path.join(HERE, "configs", "config2_scannet_2cm.yaml")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def card_ms(fn, reps: int) -> list:
    """The card's ms of each of ``reps`` calls, between CUDA events, each
    after a 1 ms spin so that the host's queuing is hidden."""
    out = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


class Clock:
    """Host ms of named steps, appended per call."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name, fn, *args):
        t = time.perf_counter()
        r = fn(*args)
        self.ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t))
        return r


def mask_path(clock, o, labels, nc, ev):
    """``postprocess_scene`` + ``add_scene`` + ``_scene_cache``, step by step."""
    valid, pinst, psem = labels
    n = o["point_mask_n"]
    bits = clock("unpackbits", lambda: np.unpackbits(o["point_mask_bits"][0], axis=-1)[:, :n] > 0)
    clock("postprocess_rest", EV.scene_scores, o, 0, nc)
    scores, pred_cls, pmask = EV.scene_scores(o, 0, nc)
    gt_cls = EV._gt_classes_from_points(pinst, psem, valid)
    pm_all = clock("column_index", lambda: bits[:, valid])
    inst = pinst[valid]
    keep = clock("keep", ev._keep, scores, pred_cls, pmask)
    pm = clock("row_gather", lambda: pm_all[keep])
    pmf = clock("astype_f32", lambda: pm.astype(np.float32))
    gt_ids = np.unique(inst)
    gt_ids = gt_ids[gt_ids >= 0]
    gm = clock("gt_masks", lambda: np.stack([inst == g for g in gt_ids]).astype(np.float32))
    clock("matmul_f32", lambda: pmf @ gm.T)
    clock("mask_sums", lambda: pm.sum(axis=1))
    ev.add_scene(bits, scores, pred_cls, pmask, pinst, gt_cls, valid)


def counts_path(clock, o, labels, nc, ev, sem_ev):
    """``run_eval``'s scoring of one scene."""
    valid, pinst, psem = labels
    scores, pred_cls, pmask = clock("scene_scores", EV.scene_scores, o, 0, nc)
    gt_cls = clock("gt_classes", EV._gt_classes_from_points, pinst, psem, valid)
    clock("add_scene_counts", ev.add_scene_counts, *(o[k][0] for k in EV.OVERLAP_KEYS),
          scores, pred_cls, pmask, gt_cls)
    if "point_semantic_pred" in o:
        clock("semantic", lambda: sem_ev.add(o["point_semantic_pred"][0][valid], psem[valid]))


def med(xs):
    return round(statistics.median(xs), 4)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config(CONFIG2, {"data": {"dataset": "synthetic", "val_scenes": args.scenes}})
    nc = cfg.model.num_classes
    model = TL.build_model(cfg, dev, torch.Generator().manual_seed(0))
    batches = list(Loader(cfg, "val", train=False, threads=False))
    keys = TL.BATCH_KEYS + ("point_instance",)
    rec = {"card": card(), "torch": torch.__version__, "scenes": args.scenes,
           "points": int(batches[0]["valid"].shape[1]), "batch": cfg.data.batch_size}

    # the card: the step, then the counts after it
    step_ms, count_ms, queue_ms, widths, fetched = [], [], [], [], []
    for batch in batches:
        d = TL.to_device(batch, dev, keys)
        inst = d.pop("point_instance")
        w = EV.overlap_width(batch)
        widths.append(w)
        raw = TL.eval_step(cfg, model, d)
        torch.cuda.synchronize()
        step_ms += card_ms(lambda: TL.eval_step(cfg, model, d), args.reps)
        mask = raw["point_mask_logits"] > 0
        count_ms += card_ms(lambda: EV.overlap_counts(mask, d["valid"], inst, w), args.reps)
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            EV.overlap_counts(raw["point_mask_logits"] > 0, d["valid"], inst, w)
            queue_ms.append(1e3 * (time.perf_counter() - t))
        raw.update(zip(EV.OVERLAP_KEYS, EV.overlap_counts(mask, d["valid"], inst, w)))
        fetched.append(EV.fetch_eval_outputs(raw))
        del raw, mask, d, inst
    rec["card_ms_a_batch"] = {"eval_step": med(step_ms), "overlap_counts": med(count_ms)}
    rec["overlap_queue_host_ms_a_batch"] = med(queue_ms)
    rec["widths"] = widths

    # the host: each scene through both paths, on the same fetched outputs
    masks_clock, counts_clock = Clock(), Clock()
    ev_m, ev_c = InstanceAPEvaluator(nc), InstanceAPEvaluator(nc)
    sem_ev = SemanticMIoUEvaluator(nc + 1)
    for out, batch in zip(fetched, batches):
        for b in range(len(batch["valid"])):
            o, labels = EV._scene_slice(out, batch, b)
            mask_path(masks_clock, o, labels, nc, ev_m)
            counts_path(counts_clock, o, labels, nc, ev_c, sem_ev)
    n = sum(len(b["valid"]) for b in batches)
    t = time.perf_counter()
    res_m = ev_m.compute(per_class=True)
    compute_m = 1e3 * (time.perf_counter() - t) / n
    t = time.perf_counter()
    res_c = ev_c.compute(per_class=True)
    compute_c = 1e3 * (time.perf_counter() - t) / n
    if res_m != res_c:
        raise AssertionError(f"counts scored {res_c}, the masks {res_m}")
    rec["host_ms_a_scene"] = {
        "masks": {k: med(v) for k, v in masks_clock.ms.items()},
        "counts": {k: med(v) for k, v in counts_clock.ms.items()},
        "compute_masks": round(compute_m, 4), "compute_counts": round(compute_c, 4)}
    rec["mAP_equal"] = {k: res_c[k] for k in ("mAP@0.25", "mAP@0.5", "mAP")}

    # run_eval itself, and its peak against one step's
    d = TL.to_device(batches[0], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TL.eval_step(cfg, model, d)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    del d
    passes = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = EV.run_eval(cfg, model, batches, num_scenes=n)
        torch.cuda.synchronize()
        passes.append({k: round(1e3 * r[k] / r["scenes"], 3) for k in
                       ("eval_wall_s", "eval_dev_s", "eval_fetch_s", "eval_host_s",
                        "eval_compute_s")})
        passes[-1]["peak_bytes"] = torch.cuda.max_memory_allocated()
        if {k: r[k] for k in res_c if k in r} != {k: res_c[k] for k in res_c if k in r}:
            raise AssertionError(f"run_eval scored {r}, the masks {res_m}")
    rec["run_eval_ms_a_scene"] = passes
    rec["step_peak_bytes"] = step_peak
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    main()
