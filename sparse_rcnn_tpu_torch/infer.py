"""Inference CLI of the port: run scenes, export per-point instance labels
(+ optional colored PLY).

    python -m sparse_rcnn_tpu_torch.infer --config configs/config1_tiny_5cm.yaml --num-scenes 3
    python -m sparse_rcnn_tpu_torch.infer --config configs/config2_scannet_2cm.yaml \
        --set data.dataset=synthetic

Runs on CUDA unless ``--device cpu``. The weights are the port's own seeded
init (``train.seed``) of the train form, converted to the eval form where
the two tail boundaries differ: restoring a checkpoint comes with ROADMAP §1
item 10.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict, Iterator

import numpy as np
import torch

from .config import Config, load_config
from .data.datasets import build_dataset
from .train import loop as TL
from .train.evaluate import postprocess_scene


def parse_overrides(pairs):
    """``["a.b=1", ...]`` → nested override dict (values parsed as literals)."""
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def scene_batches(cfg: Config, split: str, num_scenes: int) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``cfg.data.batch_size`` scenes of ``split`` in order, the
    last one wrap-padded from the split's start (as the eval loader does)."""
    ds = build_dataset(cfg, split)
    n = min(num_scenes, len(ds))
    bs = cfg.data.batch_size
    for start in range(0, n, bs):
        scenes = [ds[(start + i) % len(ds)] for i in range(bs)]
        yield {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


def to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def scene_result(out: Dict[str, np.ndarray], b: int, num_classes: int):
    """Scene ``b`` of host eval-step outputs → (instance int32[N], scores [P],
    pred_cls [P], pmask [P]). Proposals paint in descending score order and
    each point keeps the rank of the first that claims it (-1 = none)."""
    masks, scores, pred_cls, pmask = postprocess_scene(out, b, num_classes)
    inst = np.full(masks.shape[-1], -1, np.int32)
    for rank, p in enumerate(np.argsort(-scores)):
        if pmask[p]:
            sel = masks[p] & (inst < 0)
            inst[sel] = rank
    return inst, scores, pred_cls, pmask


def write_ply(path, points, colors):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="key.path=value")
    ap.add_argument("--split", default="val")
    ap.add_argument("--num-scenes", type=int, default=1)
    ap.add_argument("--out-dir", default="inference_out")
    ap.add_argument("--ply", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
        # an f32 config computes in f32: no TF32 in cuDNN's convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(args.config, parse_overrides(args.overrides))
    os.makedirs(args.out_dir, exist_ok=True)
    # the seeded init of the train form, in the eval form
    model = TL.eval_model(cfg, TL.build_model(
        TL.train_cfg(cfg), device, torch.Generator().manual_seed(cfg.train.seed)))

    palette = np.random.default_rng(0).integers(40, 255, (256, 3))
    done = 0
    for batch in scene_batches(cfg, args.split, args.num_scenes):
        out = to_host(TL.eval_step(cfg, model, TL.to_device(batch, device)))
        for b in range(cfg.data.batch_size):
            if done >= args.num_scenes:
                break
            inst_label, scores, pred_cls, pmask = scene_result(
                out, b, cfg.model.num_classes)
            pts, valid = batch["points"][b], batch["valid"][b]
            np.savez(
                os.path.join(args.out_dir, f"scene{done:04d}.npz"),
                points=pts[valid], instance=inst_label[valid],
                scores=scores, classes=pred_cls, proposal_valid=pmask,
            )
            if args.ply:
                colors = np.where(
                    inst_label[valid, None] >= 0,
                    palette[inst_label[valid] % 256], 128,
                ).astype(np.uint8)
                write_ply(os.path.join(args.out_dir, f"scene{done:04d}.ply"),
                          pts[valid], colors)
            print(f"scene {done}: {int(pmask.sum())} instances, "
                  f"{(inst_label >= 0).sum()} labeled points")
            done += 1


if __name__ == "__main__":
    main()
