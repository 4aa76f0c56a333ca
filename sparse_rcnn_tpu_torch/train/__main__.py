"""Training CLI of the port.

    python -m sparse_rcnn_tpu_torch.train --config configs/config1_tiny_5cm.yaml --set train.total_steps=5

Runs on CUDA unless ``--device cpu``. From the port's seeded init
(``train.seed``) it takes ``train.total_steps`` steps on the single-worker
train stream (``data/pipeline.py``) and prints a jsonl line of the loss
parts, the gradient norm, the overflow counters and scenes per second every
``train.log_every`` steps and at the last step (also appended to
``--log-file``). On the card, TF32 is off (an f32 config computes in f32)
and cuDNN runs its deterministic algorithms. Checkpoints, resume, the
in-training eval and the pidfile guard wait for ROADMAP §1 item 10.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import load_config
from ..data.pipeline import TrainStream
from ..infer import parse_overrides
from . import loop as TL


class JsonlLog:
    """One JSON object per line to stdout and, when given, to a file."""

    def __init__(self, path=None):
        self.path = path
        self.t0 = time.time()

    def __call__(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "t": round(time.time() - self.t0, 3)}
        rec.update({k: float(v) if hasattr(v, "item") else v for k, v in fields.items()})
        line = json.dumps(rec)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def main(argv=None) -> TL.TrainState:
    ap = argparse.ArgumentParser(
        description="Train the port from its seeded init (checkpoints, eval "
                    "and resume wait for ROADMAP §1 item 10).")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-file", default=None, help="append the jsonl lines here too")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")
        # an f32 config computes in f32: no TF32 in cuDNN's convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # the same gradients from run to run, as the JAX package's
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    cfg = load_config(args.config, parse_overrides(args.overrides))
    log = JsonlLog(args.log_file)
    log("config", name=cfg.name, device=str(device), total_steps=cfg.train.total_steps)
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    stream = TrainStream(cfg, seed=cfg.train.seed)
    t_last, step_last = time.perf_counter(), 0
    while state.step < cfg.train.total_steps:
        batch = TL.to_device(next(stream), device, TL.TRAIN_KEYS)
        state, metrics = TL.train_step(cfg, state, batch)
        if state.step % cfg.train.log_every == 0 or state.step == cfg.train.total_steps:
            metrics = {k: float(v) for k, v in metrics.items()}    # waits for the card
            now = time.perf_counter()
            sps = (state.step - step_last) * cfg.data.batch_size / (now - t_last)
            t_last, step_last = now, state.step
            log("train", step=state.step, scenes_per_sec=round(sps, 2), **metrics)
    log("done", step=state.step)
    return state


if __name__ == "__main__":
    main()
