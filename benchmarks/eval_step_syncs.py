#!/usr/bin/env python3
"""The host syncs of the port's eval step, and the device work left when it
returns.

    python3 benchmarks/eval_step_syncs.py [--root DIR] [--reps 5] [--out FILE]

For config 1 and config 2 (``data.dataset=synthetic``, its dense-2 eval
form) at full width, seeded init, on two val batches, after two warm steps:

- every host sync of one ``TL.eval_step`` call, found by
  ``torch.cuda.set_sync_debug_mode("warn")`` (each sync warns): their count
  and their sites, by the innermost frames outside torch;
- ``--reps`` steps of each batch, each timed three ways: the host's ms from
  the call to its return (queueing the work, and any waits inside), the
  gap from the return to the completion of a CUDA event recorded after the
  step (the device work left for the host to overlap), and the card's ms
  from an event recorded before the step to that one.

``--root`` imports ``sparse_rcnn_tpu_torch`` from another checkout (an
unpacked parent commit), to compare two trees in one call. Prints one JSON
line (and writes it to ``--out``). Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "config1": ("configs/config1_tiny_5cm.yaml", []),
    "config2": ("configs/config2_scannet_2cm.yaml", ["data.dataset=synthetic"]),
}


@contextlib.contextmanager
def sync_sites():
    """Count the host syncs in the block, by site: yields a Counter of
    (the three innermost frames outside torch and the standard library) →
    syncs, filled when the block ends. Other warnings go on to the usual
    handler."""
    sites = collections.Counter()
    show = warnings.showwarning
    libs = (os.path.dirname(torch.__file__), os.path.dirname(os.__file__))

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            show(message, category, filename, lineno, file, line)
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.startswith(libs)]
        sites[" < ".join(f"{os.path.basename(os.path.dirname(f.filename))}/"
                         f"{os.path.basename(f.filename)}:{f.lineno}"
                         for f in reversed(frames[-3:]))] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def timed_return(step) -> dict:
    """One ``step()`` (the eval step, queued on the current stream): host ms
    to its return, the gap from the return to its end on the card, and the
    card's ms from its start to its end."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = step()
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    t2 = time.perf_counter()
    del out
    return {"host_ms": (t1 - t0) * 1e3, "gap_ms": (t2 - t1) * 1e3,
            "card_ms": start.elapsed_time(end)}


def summary(values) -> dict:
    return {"median": statistics.median(values), "min": min(values), "max": max(values),
            "n": len(values)}


def measure(name: str, reps: int) -> dict:
    from sparse_rcnn_tpu_torch import infer
    from sparse_rcnn_tpu_torch.config import load_config
    from sparse_rcnn_tpu_torch.data.pipeline import Loader
    from sparse_rcnn_tpu_torch.train import loop as TL

    path, sets = CONFIGS[name]
    cfg = load_config(os.path.join(HERE, path), infer.parse_overrides(sets))
    model = TL.build_model(cfg, "cuda", torch.Generator().manual_seed(cfg.train.seed))
    val = Loader(cfg, "val", train=False, threads=False)
    batches = [TL.to_device(next(val), "cuda") for _ in range(2)]
    for b in batches:
        TL.eval_step(cfg, model, b)
    with sync_sites() as sites:
        TL.eval_step(cfg, model, batches[0])
    runs = [timed_return(lambda: TL.eval_step(cfg, model, b))
            for _ in range(reps) for b in batches]
    return {"syncs": sum(sites.values()), "sync_sites": dict(sites.most_common()),
            **{k: summary([r[k] for r in runs]) for k in runs[0]},
            "scenes_per_batch": cfg.data.batch_size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout to import the port from")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eval_step_syncs: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rec = {"root": args.root, "card": card,
           **{name: measure(name, args.reps) for name in CONFIGS}}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
