#!/usr/bin/env python3
"""Two builds of the sparse-conv kernels, timed in turns on the inputs of the
config-1 main path.

    git show <rev>:sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu > _archive/base.cu
    python3 benchmarks/compare_gather_gemm.py --baseline-src _archive/base.cu
        [--roles forward,dgrad,wgrad,wgrad_bf16,wgrad_edge]

Captures the arguments of the forward's 10 convs (one inference forward of
val scene 0) and of the dgrad's 9 and the wgrad's 10 (one train step on the
first train-stream batch) of the port's seeded config-1 model on the card.
Then, on each, times the kernel built from ``--baseline-src`` and the repo's
kernel in the order baseline, repo, repo, baseline (``chip_smoke.time_ms``:
card time, 10 launches per pair of events), and holds both against the plain
version. The wgrad roles also record ``max_abs_diff_vs_baseline`` (the two
builds' outputs on the same inputs) and whether they are equal bit for bit:
``wgrad`` on the main path's f32 inputs, ``wgrad_bf16`` on the same inputs
cast to bf16, ``wgrad_edge`` on ``chip_smoke.EDGE_CONVS`` (random inputs, f32
and bf16). Prints one JSON line (the card, per-role sums of the mean of each
build's two timings, per-call records) and writes it to ``--out-dir``. Needs
a CUDA card and ``nvcc``; imports no JAX.
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
from sparse_rcnn_tpu_torch.config import load_config  # noqa: E402
from sparse_rcnn_tpu_torch.data.pipeline import Loader  # noqa: E402
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc  # noqa: E402
from sparse_rcnn_tpu_torch.train import loop as TL  # noqa: E402

ROLES = ("forward", "dgrad", "wgrad", "wgrad_bf16", "wgrad_edge")


def _entry(source: str, name: str, n_ptrs: int, n_ints: int):
    so, _ = sc.build_kernel(source)
    fn = getattr(ctypes.CDLL(str(so)), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class SourceKernel(sc.SparseConvKernel):
    """The gather-GEMM built from another source, behind the repo's wrapper
    (the source must export ``sparse_conv_forward`` with the same signature)."""

    def __init__(self, source: str):
        super().__init__()
        self._fn = _entry(source, "sparse_conv_forward", 4, 7)

    def load(self):
        return self._fn


class SourceWgrad(sc.SparseConvWgradKernel):
    """The wgrad built from another source, behind the repo's wrapper (the
    source must export ``sparse_conv_wgrad`` with the same signature)."""

    def __init__(self, source: str):
        super().__init__()
        self._fn = _entry(source, "sparse_conv_wgrad", 5, 9)

    def load(self):
        return self._fn


def main_path_calls(cfg) -> dict:
    """(feats, idx, W) of each forward conv, (g, t_idx, Wᵀ) of each dgrad
    and (feats, t_idx, g) of each wgrad."""
    model = TL.build_model(cfg, "cuda", torch.Generator().manual_seed(cfg.train.seed))
    scene = next(Loader(cfg, "val", train=False, threads=False))
    fwd = CS.capture(lambda: CS.run_scene(cfg, model, scene, "cuda"), "conv_forward")
    batch = TL.to_device(next(Loader(cfg, seed=cfg.train.seed, threads=False)), "cuda", TL.TRAIN_KEYS)
    dgrad = []
    wgrad = CS.capture(lambda: dgrad.extend(CS.capture(
        lambda: TL.loss_and_grads(cfg, model, batch), "conv_dgrad")), "conv_wgrad")
    dgrad = [(g, t, w.transpose(1, 2).to(g.dtype).contiguous()) for g, t, w in dgrad]
    return {"forward": fwd, "dgrad": dgrad, "wgrad": wgrad}


def edge_wgrad_calls() -> list:
    """(feats, t_idx, g) of each ``EDGE_CONVS`` row in f32 and bf16, made as
    ``chip_smoke.phase_backward_kernels`` makes them."""
    calls = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (_, k, cin, cout, m_in, m_out, live_rows) in enumerate(CS.EDGE_CONVS):
            feats, t_idx, g, _ = CS.bwd_inputs(k, cin, cout, m_in, m_out, dtype,
                                               seed=500 + i, live_rows=live_rows)
            calls.append((feats, t_idx, g))
    return calls


def _in_turns(kernels, args) -> dict:
    times = {name: [] for name in kernels}
    for name in ("baseline", "repo", "repo", "baseline"):
        times[name].append(CS.time_ms(lambda: kernels[name](*args)))
    return times


def compare(calls, kernels) -> dict:
    per_conv = []
    for feats, idx, w in calls:
        want = sc.sparse_conv_reference(feats, idx, w).float()
        times = _in_turns(kernels, (feats, idx, w))
        rec = {"K": w.shape[0], "Cin": w.shape[1], "Cout": w.shape[2],
               "M_in": feats.shape[1], "M_out": idx.shape[-1],
               "dead_pair_share": CS.dead_pair_share(idx, feats.shape[1])}
        for name, kernel in kernels.items():
            rec[f"{name}_ms"] = times[name]
            rec[f"{name}_max_abs_err"] = (kernel(feats, idx, w).float() - want).abs().max().item()
        per_conv.append(rec)
    return {f"{name}_ms": sum(statistics.mean(r[f"{name}_ms"]) for r in per_conv)
            for name in kernels} | {"per_conv": per_conv}


def compare_wgrad(calls, kernels) -> dict:
    """Each wgrad call on both builds, in turns, and both outputs against
    each other (bit for bit) and against the plain version."""
    per_call = []
    for feats, t_idx, g in calls:
        want = sc.sparse_conv_wgrad_reference(feats, t_idx, g)
        times = _in_turns(kernels, (feats, t_idx, g))
        out = {name: kernel(feats, t_idx, g) for name, kernel in kernels.items()}
        rec = {"dtype": str(feats.dtype).replace("torch.", ""), "K": t_idx.shape[1],
               "B": feats.shape[0], "Cin": feats.shape[2], "Cout": g.shape[2],
               "M_in": feats.shape[1], "M_out": g.shape[1],
               "dead_pair_share": CS.dead_pair_share(t_idx, g.shape[1], CS.WGRAD_STAGE),
               "max_abs_diff_vs_baseline":
                   (out["repo"] - out["baseline"]).abs().max().item(),
               "bit_equal": bool(torch.equal(out["repo"], out["baseline"]))}
        for name in kernels:
            rec[f"{name}_ms"] = times[name]
            rec[f"{name}_max_abs_err"] = (out[name] - want).abs().max().item()
        per_call.append(rec)
    return {f"{name}_ms": sum(statistics.mean(r[f"{name}_ms"]) for r in per_call)
            for name in kernels} | {
        "max_abs_diff_vs_baseline": max(r["max_abs_diff_vs_baseline"] for r in per_call),
        "bit_equal": all(r["bit_equal"] for r in per_call), "per_call": per_call}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-src", required=True, help="a sparse_conv.cu to time against")
    ap.add_argument("--config", default=CS.CONFIG1)
    ap.add_argument("--roles", default=",".join(ROLES),
                    help=f"comma-separated subset of {', '.join(ROLES)}")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "compare"))
    args = ap.parse_args(argv)
    roles = args.roles.split(",")
    if not set(roles) <= set(ROLES):
        ap.error(f"unknown role in {roles}")
    card = CS.card_info()
    os.makedirs(args.out_dir, exist_ok=True)
    gemm = {"baseline": SourceKernel(args.baseline_src), "repo": sc.SparseConvKernel()}
    wgrad = {"baseline": SourceWgrad(args.baseline_src), "repo": sc.SparseConvWgradKernel()}
    calls = main_path_calls(load_config(args.config))
    calls["wgrad_bf16"] = [(f.to(torch.bfloat16), t, g.to(torch.bfloat16))
                           for f, t, g in calls["wgrad"]]
    result = {"card": card, "baseline_src": args.baseline_src, "timing": "chip_smoke.time_ms"}
    for role in roles:
        if role in ("forward", "dgrad"):
            result[role] = compare(calls[role], gemm)
        else:
            result[role] = compare_wgrad(
                edge_wgrad_calls() if role == "wgrad_edge" else calls[role], wgrad)
        CS.log(f"{role}: " + json.dumps({k: v for k, v in result[role].items()
                                         if not k.startswith("per_")}))
    with open(os.path.join(args.out_dir, "compare.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
