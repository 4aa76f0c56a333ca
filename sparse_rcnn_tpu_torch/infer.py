"""Inference CLI of the port: run scenes, export per-point instance labels
(+ optional colored PLY).

    python -m sparse_rcnn_tpu_torch.infer --config configs/config1_tiny_5cm.yaml --num-scenes 3
    python -m sparse_rcnn_tpu_torch.infer --config configs/config2_scannet_2cm.yaml \
        --set data.dataset=synthetic
    python -m sparse_rcnn_tpu_torch.infer --config configs/config1_tiny_5cm.yaml --best

Runs on CUDA unless ``--device cpu``. The weights are the latest checkpoint
of ``train.checkpoint_dir`` (``--step N`` for another, ``--best`` for the
best-mAP weights training retains in ``<checkpoint_dir>_best``), else the
port's own seeded init (``train.seed``). With ``train.ema > 0`` the EMA
weights are run. They are stored in the train form and converted to the
eval form where the two tail boundaries differ. Masks come to the host as
the eval step's packed bits, never as the f32 logits.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict

import numpy as np
import torch

from .config import load_config
from .data.pipeline import EvalBatches
from .train import checkpoint as CK
from .train import loop as TL
from .train.evaluate import fetch_eval_outputs, postprocess_scene


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


def setup_device(name: str, deterministic: bool = False) -> torch.device:
    """The device of an entry point. ``cuda`` needs a card (exits nonzero
    without one) and turns TF32 off, so that an f32 config computes in f32;
    ``deterministic`` also makes cuDNN pick deterministic algorithms."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: no CUDA device (pass --device cpu)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if deterministic:
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
    return device


def to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor of an eval-step result on the host (the f32 logits too;
    ``fetch_eval_outputs`` leaves them on the device)."""
    return {k: v.detach().cpu().numpy() for k, v in out.items()
            if isinstance(v, torch.Tensor)}


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
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest)")
    ap.add_argument("--best", action="store_true",
                    help="restore from <checkpoint_dir>_best")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = setup_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    os.makedirs(args.out_dir, exist_ok=True)
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    ckpt_dir = (CK.best_dir(cfg.train.checkpoint_dir) if args.best
                else cfg.train.checkpoint_dir)
    if CK.restore(CK.make_manager(ckpt_dir, cfg.train.keep_checkpoints), state,
                  step=args.step) is not None:
        print(f"restored step {state.step} from {os.path.abspath(ckpt_dir)}")
    else:
        print(f"no checkpoint in {os.path.abspath(ckpt_dir)}: seeded init "
              f"train.seed={cfg.train.seed}")
    model = TL.eval_model(cfg, state)

    palette = np.random.default_rng(0).integers(40, 255, (256, 3))
    done = 0
    for batch in EvalBatches(cfg, args.split):
        if done >= args.num_scenes:
            break
        out = fetch_eval_outputs(TL.eval_step(cfg, model, TL.to_device(batch, device)))
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
