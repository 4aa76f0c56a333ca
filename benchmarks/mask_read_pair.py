#!/usr/bin/env python3
"""Card time of the mask read's backward, its map and its kernel, per train
step on one config's train-path inputs, for the tree at ``--root``.

    python3 benchmarks/mask_read_pair.py [--root DIR] [--config configs/config2_scannet_2cm.yaml]
        [--set key.path=value ...] [--traffic model,gt] [--units 8192,16384,...] [--out FILE]

Imports the port from ``--root`` (default: this checkout), so that one
build's numbers can be set beside another's in one call on one card (the
parent unpacked with ``git archive`` into a git-ignored directory, then
parent, this, this, parent). Builds the model from ``train.seed``, takes one
batch of the synthetic train stream and runs ``loss_and_grads`` once,
recording each scene's mask read: its cells, its ``keep`` (where the tree
passes one), the box test ``inside`` and the cotangent that reaches
``mask_read_grad``.

Traffic ``model`` is that read as the seeded model makes it (most proposal
slots keep no point). Traffic ``gt`` stands in for a trained model's, whose
proposals hold points: every slot's proposal is replaced by a ground-truth
box of the scene (slot i the box i mod the scene's boxes whose crop box
holds a live voxel; a thin box, as a floor's, holds none), its centre moved
by up to 10 % of its size and each side scaled by 0.9-1.1 (from ``--seed``),
expanded to a crop box by ``roi.expand``; keep is the crop box's inside test
at the live voxels (the loss's weights with every slot foreground) and the
cotangent a bf16 value of random size there, 0 elsewhere. It needs a tree
with ``models/heads.py::mask_cells``.

Per scene and traffic: the rows of the read over every entry (the longest,
and the slots whose longest row holds more than half of the points, with
their kept points and boxes); card ms of the tree's map (with ``keep``
where the tree takes it; at each ``--units`` block size, given to
``IG.mask_read_map_kernel``, where the tree has it) and of
``mask_read_grad`` over it (10 calls between two CUDA events after a 1 ms
spin, median of 20); whether the gradient equals
``index_put_``'s over every entry bit for bit, and its sha1, which must not
change between trees; the map's and the kernel's bounds in bytes, as
``chip_smoke.py`` counts them. Prints one JSON line, with the card's name and power
limit. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12   # the H100 SXM's memory rate, as chip_smoke.py takes it


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median card ms of one call: ``inner`` calls between two events after a
    1 ms spin, ``reps`` times."""
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def scene_record(IG, g, cell, keep, cells, boxes, units) -> dict:
    """One scene's read: its rows, the map's and the kernel's card ms (the
    map at each of ``units`` too), bit-equality with ``index_put_`` and the
    gradient's sha1."""
    p, n = cell.shape
    rows = p * cells
    counts = torch.zeros((p, cells), dtype=torch.int64, device=cell.device)
    counts.scatter_add_(1, cell.long(), torch.ones_like(cell, dtype=torch.int64))
    kept_mask = keep if keep is not None else torch.ones_like(cell, dtype=torch.bool)
    kept_counts = torch.zeros_like(counts)
    kept_counts.scatter_add_(1, cell.long(), kept_mask.to(torch.int64))
    longest, kept = counts.max(1).values.cpu(), kept_mask.sum(1).cpu()
    over = [i for i in range(p) if longest[i] > n // 2]
    takes_keep = "keep" in inspect.signature(IG.mask_read_map).parameters

    def build_map():
        return IG.mask_read_map(cell, cells, keep) if takes_keep else IG.mask_read_map(
            cell, cells)
    rmap = build_map()
    grad_kernel = getattr(IG, "mask_read_grad_kernel", None) or IG.MASK_READ_GRAD
    out = grad_kernel(g, rmap, rows)
    want = IG.mask_read_grad_reference(g, cell, cells).reshape(-1)
    torch.cuda.synchronize()
    rec = {
        "P": p, "N": n, "cells": cells, "kept": int(kept.sum()),
        "longest_full_run": int(longest.max()),
        "slots_over_half": [[i, int(longest[i]), int(kept[i]),
                             [round(float(v), 3) for v in boxes[i].tolist()]] for i in over],
        "slots_keeping_none": int((kept == 0).sum()),
        "longest_kept_row": int(kept_counts.max()),
        "bit_equal": bool(torch.equal(out.view(torch.int16), want.view(torch.int16))),
        "grad_sha1": hashlib.sha1(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
        "map_ms": time_ms(build_map),
        "kernel_ms": time_ms(lambda: grad_kernel(g, rmap, rows)),
        # chip_smoke.py's bounds: keep read once, cell in the proposals that keep a
        # point, the kept entries' perm and lane and the offsets written once; the
        # kernel reads the offsets and the kept entries' lane, perm and g, writes the rows
        "map_bound_ms": ((p * n if keep is not None else 0) + int((kept > 0).sum()) * n * 4
                         + int(kept.sum()) * 5 + (rows + 1) * 4) / HBM_BYTES_PER_S * 1e3,
        "kernel_bound_ms": ((rows + 1) * 4 + int(kept.sum()) * 7 + rows * 2)
        / HBM_BYTES_PER_S * 1e3,
    }
    if units and hasattr(IG, "mask_read_map_kernel"):
        rec["unit"] = IG.map_unit(p, n)
        rec["map_ms_by_unit"] = {u: time_ms(lambda: IG.mask_read_map_kernel(cell, cells, keep, u))
                                 for u in units}
    return rec


def gt_traffic(cfg, heads, expand, ml, pos, live, gt_boxes, gen):
    """(g, cell, keep, crop boxes) of one scene's read with every proposal
    slot a jittered ground-truth box (see the module's docstring)."""
    p, grid = ml.shape[0], ml.shape[-1]
    dev = pos.device
    holds = (heads.mask_cells(expand(gt_boxes, cfg.model.roi.expand), pos, grid)[1]
             & live[None, :]).any(1)
    if not holds.any():
        raise SystemExit("mask_read_pair: no ground-truth box of the scene holds a voxel")
    gt_boxes = gt_boxes[holds]
    base = gt_boxes[torch.arange(p, device=dev) % gt_boxes.shape[0]]
    size = base[:, 3:] - base[:, :3]
    centre = (base[:, :3] + base[:, 3:]) / 2 + size * 0.1 * (
        2 * torch.rand((p, 3), generator=gen, device=dev) - 1)
    half = size / 2 * (0.9 + 0.2 * torch.rand((p, 3), generator=gen, device=dev))
    crop = expand(torch.cat([centre - half, centre + half], 1), cfg.model.roi.expand)
    cell, inside = heads.mask_cells(crop, pos, grid)
    keep = inside & live[None, :]
    g = torch.randn(keep.shape, generator=gen, device=dev) * torch.exp2(
        -20 * torch.rand(keep.shape, generator=gen, device=dev))
    return torch.where(keep, g, 0.0).to(torch.bfloat16), cell, keep, crop, gt_boxes.shape[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose port is measured")
    ap.add_argument("--config", default=os.path.join(HERE, "configs", "config2_scannet_2cm.yaml"))
    ap.add_argument("--set", action="append", dest="overrides", default=None,
                    metavar="key.path=value")
    ap.add_argument("--traffic", default="model", help="model, gt or model,gt")
    ap.add_argument("--units", default="", help="block sizes (points) at which the map is "
                    "also timed, comma-separated")
    ap.add_argument("--seed", type=int, default=0, help="the gt traffic's jitter and cotangent")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mask_read_pair: no CUDA device")
    traffic = args.traffic.split(",")
    units = [int(u) for u in args.units.split(",") if u]
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    infer = importlib.import_module("sparse_rcnn_tpu_torch.infer")
    config = importlib.import_module("sparse_rcnn_tpu_torch.config")
    pipeline = importlib.import_module("sparse_rcnn_tpu_torch.data.pipeline")
    det = importlib.import_module("sparse_rcnn_tpu_torch.models.detector")
    heads = importlib.import_module("sparse_rcnn_tpu_torch.models.heads")
    IG = importlib.import_module("sparse_rcnn_tpu_torch.ops.index_grad")
    TL = importlib.import_module("sparse_rcnn_tpu_torch.train.loop")
    if not IG.__file__.startswith(root):
        raise SystemExit(f"mask_read_pair: imported {IG.__file__}, not from {root}")
    if "gt" in traffic and not hasattr(heads, "mask_cells"):
        raise SystemExit(f"mask_read_pair: the tree at {root} has no mask_cells (traffic gt)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    overrides = args.overrides or ["data.dataset=synthetic"]
    cfg = TL.train_cfg(config.load_config(args.config, infer.parse_overrides(overrides)))
    model = TL.build_model(cfg, "cuda", torch.Generator().manual_seed(cfg.train.seed))
    batch = TL.to_device(next(pipeline.Loader(cfg, seed=cfg.train.seed, threads=False)), "cuda",
                         TL.TRAIN_KEYS)

    samples, reads, grads = [], [], []
    real_sample, real_read, real_grad = (det.sample_mask_at_positions, IG.mask_read,
                                         IG.mask_read_grad)

    def sample(ml, bx, pos, *rest):
        samples.append((ml.detach(), bx.detach(), pos))
        return real_sample(ml, bx, pos, *rest)

    def read(mask, cell, *rest):
        reads.append((cell, rest[0] if rest else None))
        return real_read(mask, cell, *rest)

    def grad(g, cell, rmap, cells):
        grads.append((g, cell, cells))
        return real_grad(g, cell, rmap, cells)

    det.sample_mask_at_positions, IG.mask_read, IG.mask_read_grad = sample, read, grad
    try:
        TL.loss_and_grads(cfg, model, batch)
    finally:
        det.sample_mask_at_positions, IG.mask_read, IG.mask_read_grad = (real_sample, real_read,
                                                                         real_grad)
    torch.cuda.synchronize()
    keep_of = {c.data_ptr(): k for c, k in reads}
    sample_of = {c.data_ptr(): smp for (c, _), smp in zip(reads, samples)}
    result = {"root": root, "config": cfg.name,
              "map_takes_keep": "keep" in inspect.signature(IG.mask_read_map).parameters}
    if "model" in traffic:
        result["model"] = [scene_record(IG, g, cell, keep_of[cell.data_ptr()], cells,
                                        sample_of[cell.data_ptr()][1], units)
                           for g, cell, cells in grads]
    if "gt" in traffic:
        with torch.no_grad():
            _, _, scales, gt, _ = TL.prepare_inputs(cfg, batch)
        gen = torch.Generator(device=grads[0][0].device).manual_seed(args.seed)
        result["gt"] = []
        for b, (g, cell, cells) in enumerate(grads):
            ml, _, pos = sample_of[cell.data_ptr()]
            live = torch.arange(pos.shape[0], device=pos.device) < scales[0].nvalid[b]
            gtb = gt.boxes[b][gt.valid[b]]
            gg, gcell, gkeep, crop, used = gt_traffic(cfg, heads, det.expand_boxes, ml, pos, live,
                                                      gtb, gen)
            result["gt"].append({"gt_boxes": int(gtb.shape[0]), "gt_boxes_used": used,
                                 **scene_record(IG, gg, gcell, gkeep, cells, crop, units)})
    for t in traffic:
        scenes = result[t]
        result[f"{t}_per_step"] = {k: sum(sc[k] for sc in scenes) for k in (
            "map_ms", "kernel_ms", "map_bound_ms", "kernel_bound_ms")}
        result[f"{t}_per_step"]["pair_ms"] = sum(sc["map_ms"] + sc["kernel_ms"] for sc in scenes)
        if units and "map_ms_by_unit" in scenes[0]:
            result[f"{t}_per_step"]["map_ms_by_unit"] = {
                u: sum(sc["map_ms_by_unit"][u] for sc in scenes) for u in units}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, **result}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
