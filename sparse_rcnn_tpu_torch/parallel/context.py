"""The data-parallel context: the port's counterpart of
``sparse_rcnn_tpu/ops/batching.py::shard_context``.

Under GSPMD the JAX step sees the global batch, so every reduction over
scenes is global: ``MaskedBatchNorm``'s masked sums and counts and every
masked-mean loss's weight sum. Here each rank's process holds only its own
scenes, so those reductions all-reduce explicitly, and only while a
:class:`World` is entered with :func:`shard_context` (the parallel steps of
:mod:`.data_parallel` enter it). Outside it, the code that consults it runs
exactly as it does without data parallel.

Like JAX's ``_ctx`` it is a thread-local. ``map_scenes`` needs no
counterpart: a rank's process holds only its scenes and unrolls them itself.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import List, Optional

import torch
from torch import distributed as dist

_ctx = threading.local()


class CollectiveStats:
    """Counts of the all-reduces issued under the context and their bytes
    (each rank's buffer once), forward and backward; set to 0 by the caller
    around the work it measures."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0

    def add(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()


STATS = CollectiveStats()


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place among the ranks: ``rank`` of ``size`` in
    ``group`` (None: the default group), the collectives of ``backend``."""
    rank: int
    size: int
    backend: str
    group: Optional[object] = None

    def share(self, n: int) -> range:
        """The slots of a global batch of ``n`` scenes that this rank holds:
        ``[rank·n/size, (rank+1)·n/size)``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} scenes does not split over {self.size} ranks")
        per = n // self.size
        return range(self.rank * per, (self.rank + 1) * per)


@contextmanager
def shard_context(world: Optional[World]):
    """Enter ``world`` for the block (None: no data parallel); nests, the
    innermost wins."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = world
    try:
        yield world
    finally:
        _ctx.val = prev


def current() -> Optional[World]:
    return getattr(_ctx, "val", None)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; its backward is the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        STATS.add(t)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        STATS.add(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """Σ over the ranks of ``t``, differentiable: the backward all-reduces
    the cotangent, so the global batch's gradient flows through."""
    return _AllReduceSum.apply(t, world.group)


def all_reduce_(t: torch.Tensor, world: World) -> torch.Tensor:
    """Σ over the ranks of ``t``, in place, outside autograd."""
    STATS.add(t)
    dist.all_reduce(t, group=world.group)
    return t


def all_reduce_flat_(tensors: List[torch.Tensor], world: World) -> None:
    """Σ over the ranks of each of ``tensors`` (one dtype), in place, with
    one collective on one flat buffer. The sums
    are copied back into the tensors themselves, so that every later
    reduction over them reads the same memory layout as without data
    parallel."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    STATS.add(flat)
    dist.all_reduce(flat, group=world.group)
    for t, x in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(x.view_as(t))
