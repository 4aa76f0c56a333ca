"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; then ``checks``, each number compared beside its
limit (also the last lines of standard error). Exits nonzero, with no
result, without a CUDA card or with fewer cards than the cell asks for, or
when JAX, Flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.set_environment()
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.core.runner import run_cell
    result, numbers, lims = run_cell(bench, wl, conf, traffic, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T_START)
    found = common.loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    common.emit(result, numbers, lims)
    return 0


if __name__ == "__main__":
    sys.exit(main())
