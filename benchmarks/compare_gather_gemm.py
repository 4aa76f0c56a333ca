#!/usr/bin/env python3
"""Two builds of the sparse-conv gather-GEMM, timed in turns on the inputs of
the config-1 main path.

    git show <rev>:sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu > _archive/base.cu
    python3 benchmarks/compare_gather_gemm.py --baseline-src _archive/base.cu

Captures the arguments of the forward's 10 convs (one inference forward of
val scene 0) and of the dgrad's 9 (one train step on the first train-stream
batch) of the port's seeded config-1 model on the card. Then, on each, times
the kernel built from ``--baseline-src`` and the repo's kernel in the order
baseline, repo, repo, baseline (``chip_smoke.time_ms``: card time, 10
launches per pair of events), and holds both against the plain version.
Prints one JSON line (the card, per-role sums of the mean of each build's
two timings, per-conv records) and writes it to ``--out-dir``. Needs a CUDA
card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from sparse_rcnn_tpu_torch import infer  # noqa: E402
from sparse_rcnn_tpu_torch.config import load_config  # noqa: E402
from sparse_rcnn_tpu_torch.data.pipeline import TrainStream  # noqa: E402
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc  # noqa: E402
from sparse_rcnn_tpu_torch.train import loop as TL  # noqa: E402


class SourceKernel(sc.SparseConvKernel):
    """The gather-GEMM built from another source, behind the repo's wrapper
    (the source must export ``sparse_conv_forward`` with the same signature)."""

    def __init__(self, source: str):
        super().__init__()
        so, _ = sc.build_kernel(source)
        self._fn = ctypes.CDLL(str(so)).sparse_conv_forward
        self._fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        self._fn.restype = ctypes.c_int

    def load(self):
        return self._fn


def main_path_calls(cfg) -> dict:
    """(feats, idx, W) of each forward conv and (g, t_idx, Wᵀ) of each dgrad."""
    model = TL.build_model(cfg, "cuda", torch.Generator().manual_seed(cfg.train.seed))
    scene = next(iter(infer.scene_batches(cfg, "val", 1)))
    fwd = CS.capture(lambda: CS.run_scene(cfg, model, scene, "cuda"), "conv_forward")
    batch = TL.to_device(next(TrainStream(cfg, seed=cfg.train.seed)), "cuda", TL.TRAIN_KEYS)
    dgrad = CS.capture(lambda: TL.loss_and_grads(cfg, model, batch), "conv_dgrad")
    dgrad = [(g, t, w.transpose(1, 2).to(g.dtype).contiguous()) for g, t, w in dgrad]
    return {"forward": fwd, "dgrad": dgrad}


def compare(calls, kernels) -> dict:
    per_conv = []
    for feats, idx, w in calls:
        want = sc.sparse_conv_reference(feats, idx, w).float()
        times = {name: [] for name in kernels}
        for name in ("baseline", "repo", "repo", "baseline"):
            times[name].append(CS.time_ms(lambda: kernels[name](feats, idx, w)))
        rec = {"K": w.shape[0], "Cin": w.shape[1], "Cout": w.shape[2],
               "M_in": feats.shape[1], "M_out": idx.shape[-1],
               "dead_pair_share": CS.dead_pair_share(idx, feats.shape[1])}
        for name, kernel in kernels.items():
            rec[f"{name}_ms"] = times[name]
            rec[f"{name}_max_abs_err"] = (kernel(feats, idx, w).float() - want).abs().max().item()
        per_conv.append(rec)
    return {f"{name}_ms": sum(statistics.mean(r[f"{name}_ms"]) for r in per_conv)
            for name in kernels} | {"per_conv": per_conv}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-src", required=True, help="a sparse_conv.cu to time against")
    ap.add_argument("--config", default=CS.CONFIG1)
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "compare"))
    args = ap.parse_args(argv)
    card = CS.card_info()
    os.makedirs(args.out_dir, exist_ok=True)
    kernels = {"baseline": SourceKernel(args.baseline_src), "repo": sc.SparseConvKernel()}
    cfg = load_config(args.config)
    result = {"card": card, "baseline_src": args.baseline_src, "timing": "chip_smoke.time_ms",
              **{role: compare(calls, kernels) for role, calls in main_path_calls(cfg).items()}}
    with open(os.path.join(args.out_dir, "compare.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
