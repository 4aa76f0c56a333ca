"""Training CLI of the port.

    python -m sparse_rcnn_tpu_torch.train --config configs/config1_tiny_5cm.yaml --set train.total_steps=5
    python -m sparse_rcnn_tpu_torch.train --config configs/config1_tiny_5cm.yaml --resume

Runs on CUDA unless ``--device cpu``. From the port's seeded init
(``train.seed``), or with ``--resume`` from the latest checkpoint of
``train.checkpoint_dir``, it takes steps up to ``train.total_steps`` on the
train ``Loader`` (``data/pipeline.py``: ``data.num_workers`` threads taken in
turn, ``data.prefetch`` batches ahead, the C++ host voxelizer with
``data.host_voxelize``, pinned non-blocking copies to the card; it restarts
at ``train.seed`` on a resume, as the JAX trainer's does). jsonl lines, also
appended to ``--log-file`` and mirrored to ``--tensorboard``:

- ``train`` every ``train.log_every`` steps and at the last: loss parts,
  gradient norm, overflow counters, scenes per second over the last 20
  steps (``utils/profiling.py::StepTimer``);
- ``eval`` every ``train.eval_every`` steps: ``run_eval`` over the leading
  ``min(train.eval_scenes, val split)`` val scenes (the EMA weights with
  ``train.ema > 0``, then an ``eval_raw`` line of the raw weights); a better
  mAP@0.5 saves the state into ``<checkpoint_dir>_best`` with its
  ``best.json``, seeded from that file on a resume (``checkpoint_best``);
- ``checkpoint`` every ``train.checkpoint_every`` steps; a last save at the
  end;
- ``loader`` at the end: the seconds the steps waited for a batch
  (``wait_s``), ``batches_out``, and the workers' seconds in the host
  voxelizer (``voxelize_s``, ``scenes_voxelized``);
- ``profile`` with ``--profile``: the path of the ``torch.profiler`` trace
  of the training loop (host operations and the card's kernels and copies;
  Chrome/Perfetto JSON) written into ``<checkpoint_dir>/profile/``, and
  ``stages``, the loop's spans by name (``utils/profiling.py::stage_table``:
  calls, host total and self ms, and the counters of ``count``).

A ``trainer.pid`` file in ``train.checkpoint_dir`` refuses a second live
trainer on the same directory; a stale one is reclaimed. On the card, TF32
is off (an f32 config computes in f32) and cuDNN runs its deterministic
algorithms.

Data parallel, one process per device (``parallel/data_parallel.py``)::

    python -m torch.distributed.run --nproc-per-node N -m sparse_rcnn_tpu_torch.train \
        --config configs/config5_v5e8_dp.yaml --set parallel.num_devices=N

A launcher's ``WORLD_SIZE`` makes the run data-parallel: rank r trains on
``cuda:{LOCAL_RANK}`` (or ``--device``) over ``--dist-backend`` (``nccl``
on the card, ``gloo`` on the CPU), on its slots of each global batch of
``data.batch_size`` scenes, and every step is the global batch's. Rank 0
alone holds the pidfile, writes the log and saves the checkpoints (in the
single-process format; the others wait for each save); a resume restores
on rank 0 and broadcasts the state. The in-training eval splits each eval
batch over the ranks and rank 0 scores the whole of it.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
from typing import Optional

import torch
from torch import distributed as dist

from ..config import Config, load_config
from ..data.pipeline import Loader, device_batches
from ..infer import parse_overrides, setup_device
from ..parallel import data_parallel as DP
from ..parallel.context import World, shard_context
from ..utils.logging import JsonlLogger
from ..utils.profiling import StepTimer, maybe_trace, recording, stage_table
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


def evaluate(cfg: Config, state: TL.TrainState, log: JsonlLogger,
             world: Optional[World] = None) -> dict:
    """The in-training eval: the leading ``min(eval_scenes, n_val)`` val
    scenes, the same ones at every eval point; with EMA also the raw
    weights (``eval_raw``). Under data parallel each rank runs its slots of
    each eval batch and every rank gets rank 0's result. Returns the logged
    ``eval`` dict."""
    share = {} if world is None else {"rank": world.rank, "world": world.size}

    def one_pass(source):
        with Loader(cfg, "val", train=False, **share) as loader, shard_context(world):
            n_val = len(loader.dataset)
            n_eval = min(cfg.train.eval_scenes or n_val, n_val)
            mb = -(-n_eval // cfg.data.batch_size)
            return run_eval(cfg, source, loader, max_batches=mb, num_scenes=n_eval)

    res = one_pass(state)
    log.log("eval", step=state.step, **res)
    if cfg.train.ema > 0 and state.ema_params is not None:
        log.log("eval_raw", step=state.step, **one_pass(state.model))
    return res


def main(argv=None) -> TL.TrainState:
    ap = argparse.ArgumentParser(
        description="Train the port, with checkpoints, in-training eval and resume, on one "
                    "device or data-parallel under python -m torch.distributed.run.")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint of train.checkpoint_dir")
    ap.add_argument("--device", default=None,
                    help="default cuda; under a launcher cuda:{LOCAL_RANK}")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collectives of a data-parallel run: by default nccl on the card, "
                         "gloo on the CPU (two ranks on one card need gloo)")
    ap.add_argument("--dist-init", default="env://",
                    help="init_method of the process group (env:// reads MASTER_ADDR and "
                         "MASTER_PORT; file://PATH needs no port)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the training loop with torch.profiler into "
                         "<checkpoint_dir>/profile/ (Chrome/Perfetto JSON)")
    ap.add_argument("--log-file", default=None, help="append the jsonl lines here too")
    ap.add_argument("--tensorboard", default=None, metavar="DIR",
                    help="mirror numeric metrics to TensorBoard event files")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, parse_overrides(args.overrides))
    if not DP.launched():
        device = setup_device(args.device or "cuda", deterministic=True)
        with claim_checkpoint_dir(cfg.train.checkpoint_dir):
            return train(cfg, device, args)
    DP.check_config(cfg, int(os.environ["WORLD_SIZE"]))
    device = setup_device(DP.rank_device(args.device), deterministic=True)
    created = not dist.is_initialized()
    world = DP.init(args.dist_backend or DP.default_backend(device), device, args.dist_init)
    try:
        claim = (claim_checkpoint_dir(cfg.train.checkpoint_dir) if world.rank == 0
                 else contextlib.nullcontext())
        with claim:
            return train(cfg, device, args, world)
    finally:
        if created:
            dist.destroy_process_group()


def train(cfg: Config, device: torch.device, args,
          world: Optional[World] = None) -> TL.TrainState:
    ckpt_dir = cfg.train.checkpoint_dir
    lead = world is None or world.rank == 0
    log = JsonlLogger(args.log_file, tb_dir=args.tensorboard, enabled=lead)
    dp = {} if world is None else {"world_size": world.size, "backend": world.backend}
    log.log("config", name=cfg.name, device=str(device), total_steps=cfg.train.total_steps,
            **dp)
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    mgr = CK.make_manager(ckpt_dir, cfg.train.keep_checkpoints)
    resumed = args.resume and lead and CK.restore(mgr, state) is not None
    state = DP.replicate_state(state, world)
    if resumed:
        log.log("resume", step=state.step)
    best_mgr = CK.make_manager(CK.best_dir(ckpt_dir), keep=1)
    # seeded from the sidecar: a worse eval after a resume keeps the best
    best_map = CK.read_best_score(ckpt_dir)
    if world is not None:
        best_map = DP.broadcast_from_rank0(best_map, world)
    step_fn = (functools.partial(TL.train_step, cfg) if world is None
               else DP.make_parallel_train_step(cfg, world))
    share = {} if world is None else {"rank": world.rank, "world": world.size}
    timer = StepTimer(cfg.data.batch_size)
    trace_dir = os.path.join(ckpt_dir, "profile")
    with Loader(cfg, "train", seed=cfg.train.seed, **share) as loader, \
            maybe_trace(args.profile, trace_dir) as trace, \
            (recording() if args.profile else contextlib.nullcontext()) as spans:
        stream = device_batches(loader, device, TL.TRAIN_KEYS)
        while state.step < cfg.train.total_steps:
            _, batch = next(stream)
            state, metrics = step_fn(state, batch)
            step = state.step
            sps = timer.tick()
            if step % cfg.train.log_every == 0 or step == cfg.train.total_steps:
                metrics = {k: float(v) for k, v in metrics.items()}    # waits for the card
                log.log("train", step=step, scenes_per_sec=round(sps, 2), **metrics)
            if step % cfg.train.eval_every == 0:
                res = evaluate(cfg, state, log, world)
                score = res.get("mAP@0.5", res.get("mAP@0.25"))
                if score is not None and score > best_map:
                    best_map = score
                    if lead:
                        CK.save(best_mgr, state)
                        CK.write_best_score(ckpt_dir, score, step)
                    log.log("checkpoint_best", step=step, map50=round(float(score), 4))
                DP.barrier(world)
            if step % cfg.train.checkpoint_every == 0:
                if lead:
                    CK.save(mgr, state)
                log.log("checkpoint", step=step)
                DP.barrier(world)
        log.log("loader", wait_s=loader.wait_s, batches_out=loader.batches_out,
                voxelize_s=loader.voxelize_s, scenes_voxelized=loader.scenes_voxelized,
                **({} if world is None else {"replay_s": loader.replay_s,
                                             "scenes_replayed": loader.scenes_replayed}))
    if trace is not None:
        log.log("profile", trace=trace, stages=stage_table(spans))
    if lead:
        CK.save(mgr, state)
    DP.barrier(world)
    log.log("done", step=state.step)
    log.close()
    return state


if __name__ == "__main__":
    main()
