"""One process, no data parallel: what the reference's copies of
``models/layers.py`` and ``models/losses.py`` ask of
``sparse_rcnn_tpu_torch/parallel/context.py`` (commit 4dd78ef) when no
world is entered."""

from __future__ import annotations

from contextlib import contextmanager


def current():
    return None


@contextmanager
def shard_context(world):
    yield


def all_reduce_(t, world):
    return t


def all_reduce_sum(t, world):
    return t
