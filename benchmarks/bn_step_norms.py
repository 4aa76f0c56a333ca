#!/usr/bin/env python3
"""The backbone's norms of one train step on the card, through the masked
BN + ReLU kernels and through the plain chain.

    python3 benchmarks/bn_step_norms.py --config configs/config3_s3dis.yaml \
        [--set key.path=value ...] [--no-check] [--out FILE]

Runs one warm ``TL.train_step`` of the config on its synthetic scenes
(seeded init), then one more with every norm's input captured
(``benchmarks/bn_cases.py::capture_step``: the first forwards and, under
remat, the recomputed ones), and on those inputs times each norm's forward
(every call) and backward (once a norm) through the kernels and through
the chain (``MaskedBatchNorm.normalize`` and ``torch.relu``, with their
autograd), each role's kernels alone, and the bound (bytes once at
3.35 TB/s); unless ``--no-check``, holds each first forward's kernels to the
chain (``bn_cases.compare``). Card time between CUDA events after a spin of
about 5 ms. Prints one JSON line (the sums over the step, the step's
launches by role, the card) and writes it with the per-norm records to
``--out``. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import bn_cases as BC  # noqa: E402

SPIN_CYCLES = 10_000_000      # about 5 ms at the H100's clock


def time_ms(fn, reps: int = 5, warmup: int = 2, inner: int = 3) -> float:
    """Median over ``reps`` of the mean of ``inner`` runs between two CUDA
    events, each after a spin that lets the host queue the runs first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bn_step_norms: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True      # as the train entry point
    res = BC.measure_step(args.config, ["data.dataset=synthetic"] + args.set, "cuda", time_ms,
                          checked=not args.no_check)
    line = {"config": res["config"], "card": card(), "launches_by_role": res["launches"],
            **res["total"]}
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**line, "norms": res["norms"]}, f, indent=1)
    return line


if __name__ == "__main__":
    main()
