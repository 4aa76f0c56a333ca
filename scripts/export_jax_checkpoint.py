#!/usr/bin/env python
"""Export a checkpoint of the JAX package to one flat ``.npz`` that the
PyTorch port imports without JAX (``sparse_rcnn_tpu_torch/train/checkpoint.py
::import_flat``).

    python scripts/export_jax_checkpoint.py --config configs/config1_tiny_5cm.yaml \
        --out config1.npz [--step N] [--best] [--set key.path=value ...]

Runs where JAX and orbax are installed. It restores the orbax checkpoint
with the JAX package's own ``train/checkpoint.py::restore`` and writes, with
the key convention of ``tests/fixtures/golden_config1_params.npz``:

- ``params/…``, ``batch_stats/…`` and, with EMA, ``ema_params/…``;
- the optimizer: Adam's ``mu/…`` and ``nu/…`` or SGD's momentum
  ``trace/…``, the inner update ``count``, and under ``optax.MultiSteps``
  its ``mini_step`` and ``acc_grads/…``;
- ``step``.

Then, on the card's machine:

    python -m sparse_rcnn_tpu_torch.train.checkpoint --config ... --npz config1.npz
"""

import argparse
import os
import sys
from collections.abc import Mapping

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _flatten(tree, prefix):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v)


def _opt_fields(node, found):
    """Collect the moment trees and counts of an optax state: every
    ``mu``/``nu``/``trace`` tree and every ``count`` (Adam's and the
    schedule's; they are equal), walking chains and named tuples."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            value = getattr(node, name)
            if name in ("mu", "nu", "trace"):
                found[name] = value
            elif name == "count":
                found.setdefault("count", []).append(int(np.asarray(value)))
            else:
                _opt_fields(value, found)
    elif isinstance(node, (tuple, list)):
        for value in node:
            _opt_fields(value, found)
    return found


def flat_state(state) -> dict:
    """A (host) JAX ``TrainState`` as the flat dict of the export."""
    import jax

    state = jax.device_get(state)
    flat = {"step": np.asarray(int(state.step), np.int64)}
    for root in ("params", "batch_stats", "ema_params"):
        tree = getattr(state, root)
        if tree is not None:
            flat.update(_flatten(tree, root))
    opt = state.opt_state
    if hasattr(opt, "mini_step"):              # optax.MultiSteps
        flat["mini_step"] = np.asarray(int(opt.mini_step), np.int64)
        flat.update(_flatten(opt.acc_grads, "acc_grads"))
        opt = opt.inner_opt_state
    found = _opt_fields(opt, {})
    counts = set(found.pop("count", []))
    if len(counts) != 1:
        raise ValueError(f"optimizer state: expected one update count, found {counts}")
    flat["count"] = np.asarray(counts.pop(), np.int64)
    for name, tree in found.items():
        flat.update(_flatten(tree, name))
    return flat


def export(manager, template, out: str, step=None) -> int:
    """Restore ``step`` (default: the latest) of an orbax ``manager`` onto
    ``template`` and write the flat npz to ``out``; returns the step."""
    from sparse_rcnn_tpu.train import checkpoint as CK

    state = CK.restore(manager, template, step=step)
    if state is None:
        raise SystemExit(f"no checkpoint in {manager.directory}")
    flat = flat_state(state)
    np.savez(out, **flat)
    return int(flat["step"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--best", action="store_true",
                    help="export <checkpoint_dir>_best instead")
    args = ap.parse_args(argv)

    from train import parse_overrides

    from sparse_rcnn_tpu.config import load_config
    from sparse_rcnn_tpu.data.pipeline import Loader
    from sparse_rcnn_tpu.train import checkpoint as CK
    from sparse_rcnn_tpu.train import loop as TL

    cfg = load_config(args.config, parse_overrides(args.overrides))
    loader = Loader(cfg, "val", train=False)
    template = TL.init_state(cfg, next(iter(loader)))
    loader.close()
    src = CK.best_dir(cfg.train.checkpoint_dir) if args.best else cfg.train.checkpoint_dir
    step = export(CK.make_manager(src, cfg.train.keep_checkpoints), template, args.out,
                  step=args.step)
    print(f"exported step {step} of {src} to {args.out}")


if __name__ == "__main__":
    main()
