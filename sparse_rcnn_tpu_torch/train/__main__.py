"""Training CLI of the port.

    python -m sparse_rcnn_tpu_torch.train --config configs/config1_tiny_5cm.yaml --set train.total_steps=5
    python -m sparse_rcnn_tpu_torch.train --config configs/config1_tiny_5cm.yaml --resume

Runs on CUDA unless ``--device cpu``. From the port's seeded init
(``train.seed``), or with ``--resume`` from the latest checkpoint of
``train.checkpoint_dir``, it takes steps up to ``train.total_steps`` on the
single-worker train stream (``data/pipeline.py``; it restarts at
``train.seed`` on a resume, as the JAX trainer's does). jsonl lines, also
appended to ``--log-file`` and mirrored to ``--tensorboard``:

- ``train`` every ``train.log_every`` steps and at the last: loss parts,
  gradient norm, overflow counters, scenes per second;
- ``eval`` every ``train.eval_every`` steps: ``run_eval`` over the leading
  ``min(train.eval_scenes, val split)`` val scenes (the EMA weights with
  ``train.ema > 0``, then an ``eval_raw`` line of the raw weights); a better
  mAP@0.5 saves the state into ``<checkpoint_dir>_best`` with its
  ``best.json``, seeded from that file on a resume (``checkpoint_best``);
- ``checkpoint`` every ``train.checkpoint_every`` steps; a last save at the
  end.

A ``trainer.pid`` file in ``train.checkpoint_dir`` refuses a second live
trainer on the same directory; a stale one is reclaimed. On the card, TF32
is off (an f32 config computes in f32) and cuDNN runs its deterministic
algorithms. ``--profile`` waits for ROADMAP §1 item 13.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ..config import Config, load_config
from ..data.pipeline import EvalBatches, TrainStream
from ..infer import parse_overrides, setup_device
from ..utils.logging import JsonlLogger
from . import checkpoint as CK
from . import loop as TL
from .evaluate import run_eval


@contextlib.contextmanager
def claim_checkpoint_dir(directory: str):
    """Hold ``directory/trainer.pid`` with this process's pid for the block,
    and remove it after. A pidfile of a live process refuses the run: two
    trainers on one directory would interleave their checkpoints and
    best-score sidecar. A stale or unreadable one is reclaimed."""
    os.makedirs(directory, exist_ok=True)
    pidfile = os.path.join(directory, "trainer.pid")
    if os.path.exists(pidfile):
        try:
            with open(pidfile) as f:
                other = int(f.read().strip())
            os.kill(other, 0)               # raises if no such process
        except (ValueError, ProcessLookupError):
            pass
        except PermissionError:
            raise SystemExit(f"checkpoint_dir {directory!r} is in use by a live trainer "
                             f"we cannot signal ({pidfile})")
        else:
            raise SystemExit(f"checkpoint_dir {directory!r} is in use by live trainer pid "
                             f"{other} ({pidfile}); pick another dir or stop that run first")
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))
    try:
        yield pidfile
    finally:
        os.remove(pidfile)


def evaluate(cfg: Config, state: TL.TrainState, log: JsonlLogger) -> dict:
    """The in-training eval: the leading ``min(eval_scenes, n_val)`` val
    scenes, the same ones at every eval point; with EMA also the raw
    weights (``eval_raw``). Returns the logged ``eval`` dict."""
    loader = EvalBatches(cfg, "val")
    n_val = len(loader.dataset)
    n_eval = min(cfg.train.eval_scenes or n_val, n_val)
    mb = -(-n_eval // cfg.data.batch_size)
    res = run_eval(cfg, state, loader, max_batches=mb, num_scenes=n_eval)
    log.log("eval", step=state.step, **res)
    if cfg.train.ema > 0 and state.ema_params is not None:
        raw = run_eval(cfg, state.model, EvalBatches(cfg, "val"), max_batches=mb,
                       num_scenes=n_eval)
        log.log("eval_raw", step=state.step, **raw)
    return res


def main(argv=None) -> TL.TrainState:
    ap = argparse.ArgumentParser(
        description="Train the port, with checkpoints, in-training eval and resume "
                    "(--profile waits for ROADMAP §1 item 13).")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint of train.checkpoint_dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-file", default=None, help="append the jsonl lines here too")
    ap.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="mirror numeric metrics to TensorBoard event files")
    args = ap.parse_args(argv)

    device = setup_device(args.device, deterministic=True)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    with claim_checkpoint_dir(cfg.train.checkpoint_dir):
        return train(cfg, device, args)


def train(cfg: Config, device: torch.device, args) -> TL.TrainState:
    ckpt_dir = cfg.train.checkpoint_dir
    log = JsonlLogger(args.log_file, tb_dir=args.tensorboard)
    log.log("config", name=cfg.name, device=str(device), total_steps=cfg.train.total_steps)
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    mgr = CK.make_manager(ckpt_dir, cfg.train.keep_checkpoints)
    if args.resume and CK.restore(mgr, state) is not None:
        log.log("resume", step=state.step)
    best_mgr = CK.make_manager(CK.best_dir(ckpt_dir), keep=1)
    # seeded from the sidecar: a worse eval after a resume keeps the best
    best_map = CK.read_best_score(ckpt_dir)
    stream = TrainStream(cfg, seed=cfg.train.seed)
    t_last, step_last = time.perf_counter(), state.step
    while state.step < cfg.train.total_steps:
        batch = TL.to_device(next(stream), device, TL.TRAIN_KEYS)
        state, metrics = TL.train_step(cfg, state, batch)
        step = state.step
        if step % cfg.train.log_every == 0 or step == cfg.train.total_steps:
            metrics = {k: float(v) for k, v in metrics.items()}    # waits for the card
            now = time.perf_counter()
            sps = (step - step_last) * cfg.data.batch_size / (now - t_last)
            t_last, step_last = now, step
            log.log("train", step=step, scenes_per_sec=round(sps, 2), **metrics)
        if step % cfg.train.eval_every == 0:
            res = evaluate(cfg, state, log)
            score = res.get("mAP@0.5", res.get("mAP@0.25"))
            if score is not None and score > best_map:
                best_map = score
                CK.save(best_mgr, state)
                CK.write_best_score(ckpt_dir, score, step)
                log.log("checkpoint_best", step=step, map50=round(float(score), 4))
        if step % cfg.train.checkpoint_every == 0:
            CK.save(mgr, state)
            log.log("checkpoint", step=step)
    CK.save(mgr, state)
    log.log("done", step=state.step)
    log.close()
    return state


if __name__ == "__main__":
    main()
