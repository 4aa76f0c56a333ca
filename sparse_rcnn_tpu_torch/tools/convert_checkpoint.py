"""Convert a checkpoint to another backbone execution form, the dense-tail
boundary (port of ``scripts/convert_checkpoint.py``)::

    python -m sparse_rcnn_tpu_torch.tools.convert_checkpoint \\
        --config configs/config2_scannet_2cm.yaml --to-dense 2 \\
        --out-dir checkpoints/config2_dense2 [--step N] [--best] [--set k=v] [--device cpu]

A checkpoint holds its weights in the train form (``dense_from_scale_train``
when set). This tool restores one of ``train.checkpoint_dir`` (or its
``_best`` sibling) and rewrites it into the form ``dense_from_scale=N``
(``--to-dense none``: fully sparse), so that it restores under a config
with that boundary and no ``dense_from_scale_train``: a serving config at
dense-2, or a fully sparse deployment. The conversion is an exact
reparametrization (:mod:`..models.convert`): the parameters and BN
statistics, the EMA parameters, the Adam moments and the gradient
accumulator are permuted alike, so training resumes from the converted
checkpoint with the same dynamics. Restoring never converts
(``train/checkpoint.py`` refuses a change of shape): conversion is this
explicit step. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from ..config import Config, load_config
from ..infer import parse_overrides, setup_device
from ..models.convert import convert_variables
from ..train import checkpoint as CK
from ..train import loop as TL


def form_overrides(to_s0: Optional[int]) -> List[str]:
    """``--set`` entries of the config a checkpoint of form ``to_s0`` restores
    under: that boundary, and no per-mode train boundary."""
    return [f"model.backbone.dense_from_scale={to_s0}",
            "model.backbone.dense_from_scale_train=None"]


def convert_state(cfg: Config, state: TL.TrainState) -> TL.TrainState:
    """``state`` (any form) in the form of ``cfg``'s ``dense_from_scale``
    (``cfg`` has no ``dense_from_scale_train``), on the state's device. The
    lists in ``model.parameters()`` order (EMA, moments, accumulator) are
    converted by parameter name and put in the new model's order, each
    contiguous (the conversion permutes entries)."""
    if TL.train_cfg(cfg) is not cfg:
        raise ValueError("the target config of a conversion has no dense_from_scale_train")
    to_s0 = cfg.model.backbone.dense_from_scale
    names = [n for n, _ in state.model.named_parameters()]
    model = TL.build_model(cfg, next(state.model.parameters()).device)
    model.load_state_dict(convert_variables(state.model.state_dict(), to_s0))
    new_names = [n for n, _ in model.named_parameters()]

    def relist(ts):
        if ts is None:
            return None
        moved = convert_variables(dict(zip(names, ts)), to_s0)
        return [moved[n].contiguous() for n in new_names]     # the kernels' layout

    opt = state.opt_state
    return TL.TrainState(
        step=state.step, model=model,
        opt_state=TL.OptState(count=opt.count, mu=relist(opt.mu), nu=relist(opt.nu),
                              mini_step=opt.mini_step, acc_grads=relist(opt.acc_grads)),
        ema_params=relist(state.ema_params))


def main(argv=None) -> TL.TrainState:
    ap = argparse.ArgumentParser(
        description="Convert a checkpoint of the port to another dense-tail boundary.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--to-dense", required=True,
                    help="target dense_from_scale (int) or 'none' for the fully sparse form")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--best", action="store_true",
                    help="convert <checkpoint_dir>_best instead")
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    to_s0 = None if args.to_dense.lower() == "none" else int(args.to_dense)
    device = setup_device(args.device)
    sets = args.overrides or []
    cfg = load_config(args.config, parse_overrides(sets))
    target = load_config(args.config, parse_overrides(sets + form_overrides(to_s0)))
    src = CK.best_dir(cfg.train.checkpoint_dir) if args.best else cfg.train.checkpoint_dir
    state = CK.restore(CK.make_manager(src, cfg.train.keep_checkpoints),
                       TL.init_state(cfg, device), step=args.step)
    if state is None:
        raise SystemExit(f"no checkpoint under {src!r}")
    state = convert_state(target, state)
    if not CK.save(CK.make_manager(args.out_dir, keep=1), state):
        raise SystemExit(f"{args.out_dir!r} already holds step {state.step} or a later one")
    print(json.dumps({"kind": "converted", "step": state.step, "dense_from_scale": to_s0,
                      "dir": os.path.abspath(args.out_dir)}))
    return state


if __name__ == "__main__":
    main()
