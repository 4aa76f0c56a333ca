"""Evaluation CLI of the port: restore a checkpoint and report instance mAP
on a split.

    python -m sparse_rcnn_tpu_torch.eval --config configs/config1_tiny_5cm.yaml --best
    python -m sparse_rcnn_tpu_torch.eval --config configs/config2_scannet_2cm.yaml \
        --set data.dataset=synthetic --step 2000 --per-class --per-scene

Runs on CUDA unless ``--device cpu``. Restores the latest checkpoint of
``train.checkpoint_dir`` (``--step N`` for another, ``--best`` for
``<checkpoint_dir>_best``) and logs a ``restored`` line, or a ``warning``
line and scores the seeded init; then scores the whole split (or
``--max-batches``), each scene once, read by the eval ``Loader`` (one worker
thread ahead of the steps; the host voxelizer with ``data.host_voxelize``),
and logs one ``eval`` jsonl line: the mAP dict of
``train/evaluate.py::run_eval``. With ``train.ema > 0`` the EMA
weights are scored, unless ``--raw-params``.
"""

from __future__ import annotations

import argparse

import torch

from .config import load_config
from .data.pipeline import Loader
from .infer import parse_overrides, setup_device
from .train import checkpoint as CK
from .train import loop as TL
from .train.evaluate import run_eval
from .utils.logging import JsonlLogger


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--split", default="val")
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step to restore (default: latest)")
    ap.add_argument("--best", action="store_true",
                    help="restore from <checkpoint_dir>_best (the best-mAP weights "
                         "training retains)")
    ap.add_argument("--raw-params", action="store_true",
                    help="with train.ema > 0: score the raw (last-step) weights of the "
                         "same checkpoint instead of the EMA weights")
    ap.add_argument("--per-class", action="store_true",
                    help="also report AP@t per class id")
    ap.add_argument("--per-scene", action="store_true",
                    help="also report the per-scene mAP@0.5 list and its mean, std, "
                         "min and max")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = setup_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    log = JsonlLogger()
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    ckpt_dir = (CK.best_dir(cfg.train.checkpoint_dir) if args.best
                else cfg.train.checkpoint_dir)
    mgr = CK.make_manager(ckpt_dir, cfg.train.keep_checkpoints)
    if CK.restore(mgr, state, step=args.step) is not None:
        log.log("restored", step=state.step)
    else:
        log.log("warning", message="no checkpoint found; evaluating random init")
    source = state
    if args.raw_params and state.ema_params is not None:
        source = state.model          # the raw weights of the same run
        log.log("eval_params", source="raw")
    with Loader(cfg, args.split, train=False) as loader:
        res = run_eval(cfg, source, loader, max_batches=args.max_batches,
                       num_scenes=len(loader.dataset), per_class=args.per_class,
                       per_scene=args.per_scene)
    log.log("eval", **res)
    return res


if __name__ == "__main__":
    main()
