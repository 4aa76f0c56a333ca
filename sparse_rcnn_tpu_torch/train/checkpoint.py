"""Checkpoints of the port in torch's own format (the semantics of
``sparse_rcnn_tpu/train/checkpoint.py``, which saves through orbax).

A checkpoint directory holds one directory per saved step, named by the
step, with one ``state.pt``:

    {"step": int,
     "model": the model's state_dict (parameters and BN running statistics,
              in the train form of the tail boundary),
     "opt_state": {"count", "mu", "nu", "mini_step", "acc_grads"},
     "ema_params": [...]}          # only when the state has EMA parameters

Tensors are moved to the CPU before ``torch.save`` and copied onto the
template's device on restore, which reads with ``weights_only=True``. A
step is written under a temporary name and moved into place with
``os.replace``, and the ``keep`` newest steps are kept. ``best_dir`` is a
sibling directory with a manager of its own, so the rotation never touches
it. The JAX package's orbax checkpoints come in through
:func:`import_flat`, from the flat ``.npz`` that
``scripts/export_jax_checkpoint.py`` writes where JAX is installed:

    python -m sparse_rcnn_tpu_torch.train.checkpoint --config CONFIG --npz FILE
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..models.transfer import from_flax, unflatten_variables
from . import loop as TL

_FILE = "state.pt"


class CheckpointManager:
    """The steps saved under ``directory`` (created at the first save), at
    most ``keep`` of them."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, _FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: dict) -> bool:
        """Write ``tree`` as step ``step``; False (and nothing written) when
        that step or a later one is already saved, as orbax's manager skips
        it."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _FILE))
        shutil.rmtree(self.path(step), ignore_errors=True)    # a partial one
        os.replace(tmp, self.path(step))
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.path(old))
        return True

    def load(self, step: int) -> dict:
        return torch.load(os.path.join(self.path(step), _FILE), map_location="cpu",
                          weights_only=True)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for (orbax's API)."""


def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, keep)


def best_dir(checkpoint_dir: str) -> str:
    """The sibling directory where training retains the best-mAP weights."""
    return checkpoint_dir.rstrip("/") + "_best"


def _best_file(checkpoint_dir: str) -> str:
    return os.path.join(os.path.abspath(best_dir(checkpoint_dir)), "best.json")


def read_best_score(checkpoint_dir: str) -> float:
    """Best mAP recorded in the ``_best`` sidecar (-inf if none): it seeds
    the best tracker across ``--resume``, so that a worse eval after a
    resume cannot overwrite the retained weights."""
    try:
        with open(_best_file(checkpoint_dir)) as f:
            return float(json.load(f)["score"])
    except (OSError, ValueError, KeyError):
        return float("-inf")


def write_best_score(checkpoint_dir: str, score: float, step: int) -> None:
    os.makedirs(os.path.dirname(_best_file(checkpoint_dir)), exist_ok=True)
    with open(_best_file(checkpoint_dir), "w") as f:
        json.dump({"score": float(score), "step": int(step)}, f)


def _cpu(ts):
    return None if ts is None else [t.detach().cpu() for t in ts]


def as_tree(state: TL.TrainState) -> dict:
    """A :class:`~.loop.TrainState` as the saved dict, on the CPU; no
    ``ema_params`` entry when the state has none (the JAX ``_as_tree``
    rule)."""
    opt = state.opt_state
    tree = {
        "step": int(state.step),
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "opt_state": {"count": int(opt.count), "mu": _cpu(opt.mu), "nu": _cpu(opt.nu),
                      "mini_step": int(opt.mini_step), "acc_grads": _cpu(opt.acc_grads)},
    }
    if state.ema_params is not None:
        tree["ema_params"] = _cpu(state.ema_params)
    return tree


def save(manager: CheckpointManager, state: TL.TrainState) -> bool:
    return manager.save(int(state.step), as_tree(state))


def _onto(saved, like, what: str):
    """Saved tensors copied onto the devices and dtypes of ``like``."""
    if (saved is None) != (like is None):
        raise ValueError(f"checkpoint {what}: saved {'none' if saved is None else 'some'}, "
                         f"the state expects {'none' if like is None else 'some'}")
    if saved is None:
        return None
    if len(saved) != len(like):
        raise ValueError(f"checkpoint {what}: {len(saved)} tensors, the state has {len(like)}")
    out = []
    for s, t in zip(saved, like):
        if s.shape != t.shape:
            raise ValueError(f"checkpoint {what}: shape {tuple(s.shape)} against "
                             f"{tuple(t.shape)}")
        out.append(s.to(device=t.device, dtype=t.dtype, copy=True))
    return out


def restore(manager: CheckpointManager, template: TL.TrainState,
            step: Optional[int] = None) -> Optional[TL.TrainState]:
    """Restore the latest (or the given) step into ``template`` — its model
    in place, the rest replaced — and return it; None, and the template
    untouched, when there is no such checkpoint. A template with EMA can
    restore only a checkpoint with EMA parameters, and the other way round:
    resuming across a change of ``train.ema`` is an error."""
    steps = manager.all_steps()
    if step is not None and step not in steps:
        return None
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None:
        return None
    return _load_tree(template, manager.load(step),
                      f"checkpoint step {step} in {manager.directory}")


def _load_tree(template: TL.TrainState, tree: dict, what: str) -> TL.TrainState:
    """``tree`` (the layout of :func:`as_tree`) into ``template``."""
    if ("ema_params" in tree) != (template.ema_params is not None):
        raise ValueError(
            f"{what} {'has' if 'ema_params' in tree else 'has no'} EMA parameters and the "
            f"config {'asks for' if template.ema_params is not None else 'has no'} EMA "
            "(train.ema): restoring across an EMA change is not supported")
    opt, saved = template.opt_state, tree["opt_state"]
    mu = _onto(saved["mu"], opt.mu, "mu")
    nu = _onto(saved["nu"], opt.nu, "nu")
    acc = _onto(saved["acc_grads"], opt.acc_grads, "acc_grads")
    ema = _onto(tree.get("ema_params"), template.ema_params, "ema_params")
    template.model.load_state_dict(tree["model"])
    template.opt_state = TL.OptState(count=int(saved["count"]), mu=mu, nu=nu,
                                     mini_step=int(saved["mini_step"]), acc_grads=acc)
    template.ema_params = ema
    template.step = int(tree["step"])
    return template


# --------------------------------------------------------------------------
# a JAX checkpoint, exported to a flat npz


def _tree_of(flat: Dict[str, np.ndarray], root: str) -> dict:
    """The nested tree of ``flat``'s entries under ``root/``."""
    return unflatten_variables({"params/" + k[len(root) + 1:]: v for k, v in flat.items()
                                if k.startswith(root + "/")})[0]


def _as_params(flat, root: str, names: List[str]) -> Optional[List[torch.Tensor]]:
    """A parameter-shaped tree of ``flat`` (EMA, Adam moments, the
    accumulator) as a list in ``model.parameters()`` order, or None when
    ``flat`` has no ``root``. The layout transform of :func:`from_flax` is
    per leaf and element-wise, so it maps these as it maps the parameters."""
    tree = _tree_of(flat, root)
    if not tree:
        return None
    sd = from_flax(tree, {})
    if sorted(sd) != sorted(names):
        raise ValueError(f"{root}: its entries are not the model's parameters")
    return [sd[n] for n in names]


def import_flat(cfg: Config, npz: str, device="cuda",
                directory: Optional[str] = None) -> TL.TrainState:
    """A JAX train state exported by ``scripts/export_jax_checkpoint.py``
    (keys ``params/…``, ``batch_stats/…``, ``ema_params/…``, ``mu/…`` and
    ``nu/…`` or the SGD momentum ``trace/…``, ``acc_grads/…``, and the
    scalars ``count``, ``mini_step`` and ``step``) as the port's
    :class:`~.loop.TrainState` on ``device``. With ``directory`` it is also
    saved there as a checkpoint of its step."""
    with np.load(npz) as f:
        flat = {k: f[k] for k in f.files}
    state = TL.init_state(cfg, device)         # every tensor is loaded below
    names = [n for n, _ in state.model.named_parameters()]
    tree = {
        "step": int(flat["step"]),
        "model": from_flax(_tree_of(flat, "params"), _tree_of(flat, "batch_stats")),
        "opt_state": {"count": int(flat["count"]),
                      "mu": _as_params(flat, "mu", names) or _as_params(flat, "trace", names),
                      "nu": _as_params(flat, "nu", names),
                      "mini_step": int(flat["mini_step"]) if "mini_step" in flat else 0,
                      "acc_grads": _as_params(flat, "acc_grads", names)},
    }
    ema = _as_params(flat, "ema_params", names)
    if ema is not None:
        tree["ema_params"] = ema
    state = _load_tree(state, tree, npz)
    if directory is not None:
        save(make_manager(directory, cfg.train.keep_checkpoints), state)
    return state


def main(argv=None) -> TL.TrainState:
    from ..infer import parse_overrides, setup_device

    ap = argparse.ArgumentParser(
        description="Import a JAX checkpoint, exported to a flat npz by "
                    "scripts/export_jax_checkpoint.py, as a checkpoint of the port.")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--npz", required=True)
    ap.add_argument("--out-dir", default=None,
                    help="checkpoint directory to save into (default: train.checkpoint_dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = setup_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    out = args.out_dir or cfg.train.checkpoint_dir
    state = import_flat(cfg, args.npz, device, out)
    print(json.dumps({"kind": "imported", "step": state.step, "dir": os.path.abspath(out)}))
    return state


if __name__ == "__main__":
    main()
