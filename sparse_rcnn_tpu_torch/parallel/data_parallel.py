"""Data parallel over processes, one per device (port of
``sparse_rcnn_tpu/parallel/mesh.py``).

JAX shards the scene batch over a 1-D ``data`` mesh axis and GSPMD makes
the step the global batch's. Here each rank is a process with its own
device and its own slots of each global batch
(``data/pipeline.py::Loader(rank=, world=)``); the parallel steps run the
single-process steps inside :func:`.context.shard_context`, under which
the batch statistics and loss denominators are the global batch's and the
gradients are summed over the ranks in one all-reduce
(``train/loop.py::train_step``). ``DistributedDataParallel`` is not used:
its reducer hooks fire on ``.backward()``, and the step takes its
gradients with ``torch.autograd.grad``.

The process group comes from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, as ``python -m torch.distributed.run``
sets them), its backend is named by the caller (``nccl`` on the card,
``gloo`` on the CPU; two ranks on one card need ``gloo``, which NCCL
refuses), and every collective has a timeout, so a dead rank ends the run.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
from torch import distributed as dist

from ..config import Config
from ..train import loop as TL
from .context import World, shard_context

DEFAULT_TIMEOUT_S = 600


def launched() -> bool:
    """Whether a launcher started this process as one rank of several
    (``WORLD_SIZE`` is set)."""
    return "WORLD_SIZE" in os.environ


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(name: Optional[str]) -> str:
    """The device of this rank: ``name`` when it names one (``cuda:1``,
    ``cpu``), else ``cuda:{LOCAL_RANK}``."""
    if name not in (None, "cuda"):
        return name
    return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"


def init(backend: str, device, init_method: str = "env://",
         timeout_s: float = DEFAULT_TIMEOUT_S) -> World:
    """Join the process group of the launcher's environment with ``backend``
    (or take the one already joined) and return this rank's :class:`World`.
    Raises if the group's backend is not ``backend``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s))
    got = dist.get_backend()
    if got != backend:
        raise RuntimeError(f"the process group runs {got}, not the {backend} asked for")
    return World(rank=dist.get_rank(), size=dist.get_world_size(), backend=backend)


def check_config(cfg: Config, world_size: int) -> None:
    """``parallel.num_devices`` (0: any) must be the world size and
    ``data.batch_size`` a multiple of it. Every rank checks for itself, so
    every rank raises."""
    n = cfg.parallel.num_devices
    if n and n != world_size:
        raise ValueError(f"parallel.num_devices is {n} but the world has {world_size} ranks")
    if cfg.data.batch_size % world_size:
        raise ValueError(f"data.batch_size {cfg.data.batch_size} is not a multiple of the "
                         f"world size {world_size}")


def barrier(world: Optional[World]) -> None:
    if world is not None:
        dist.barrier(group=world.group)


def make_parallel_train_step(cfg: Config, world: World):
    """The global batch's train step, run by every rank on its own slots:
    ``step(state, batch) -> (state, metrics)`` as ``TL.train_step``, the
    state the same on every rank after it."""
    def step(state: TL.TrainState, batch):
        with shard_context(world):
            return TL.train_step(cfg, state, batch)
    return step


def make_parallel_eval_step(cfg: Config, world: World):
    """The eval step of this rank's slots: ``step(source, batch)`` as
    ``TL.eval_step``. (Inference reduces nothing over scenes: BN runs on
    its running statistics.)"""
    def step(source, batch):
        with shard_context(world):
            return TL.eval_step(cfg, source, batch)
    return step


def state_tensors(state: TL.TrainState) -> List[torch.Tensor]:
    """Every tensor of ``state``: parameters and BN running statistics, the
    optimizer's moments and accumulator, the EMA parameters."""
    opt = state.opt_state
    out = list(state.model.state_dict().values()) + list(opt.mu)
    for extra in (opt.nu, opt.acc_grads, state.ema_params):
        out += list(extra or [])
    return out


@torch.no_grad()
def replicate_state(state: TL.TrainState, world: Optional[World]) -> TL.TrainState:
    """Rank 0's state on every rank, in place: every tensor of
    :func:`state_tensors` broadcast, and the step and optimizer counts."""
    if world is None:
        return state
    for t in state_tensors(state):
        dist.broadcast(t, group=world.group, group_src=0)
    opt = state.opt_state
    counts = [state.step, opt.count, opt.mini_step]
    dist.broadcast_object_list(counts, group=world.group, group_src=0)
    state.step, opt.count, opt.mini_step = counts
    return state


def gather_to_rank0(obj: Any, world: World) -> Optional[List[Any]]:
    """Every rank's ``obj`` (host data), in rank order, on rank 0; None on
    the other ranks."""
    out = [None] * world.size if world.rank == 0 else None
    dist.gather_object(obj, out, group=world.group, group_dst=0)
    return out


def broadcast_from_rank0(obj: Any, world: World) -> Any:
    """Rank 0's ``obj`` (host data) on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, group=world.group, group_src=0)
    return box[0]
