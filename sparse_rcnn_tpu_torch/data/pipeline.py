"""The training batch stream (port of the single-worker train stream of
``sparse_rcnn_tpu/data/pipeline.py::Loader``).

One worker, in the caller's thread: ``rng = default_rng((seed, 0))``, then
per batch ``batch_size`` scene indices drawn from it and each scene
augmented with the same rng, in order — the batches the JAX ``Loader``
yields with ``num_workers=1``. Worker threads, prefetch, the ordered eval
pass and pinned, non-blocking copies to the card wait for ROADMAP §1
item 11. The port has no host voxelizer yet, so ``data.host_voxelize``
falls back to voxelizing on the device, as the JAX loader does when its
native library is unavailable.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..config import Config
from .augment import augment_scene
from .datasets import build_dataset


def collate(scenes) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


class TrainStream:
    """Infinite iterator of augmented train batches (dicts of numpy arrays)."""

    def __init__(self, cfg: Config, seed: int = 0):
        self.cfg = cfg
        self.dataset = build_dataset(cfg, "train")
        self.rng = np.random.default_rng((seed, 0))

    def _scene(self, idx: int):
        scene = self.dataset[idx % len(self.dataset)]
        if self.cfg.data.augment:
            scene = augment_scene(scene, self.cfg.data, self.rng)
        return scene

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        idxs = self.rng.integers(0, len(self.dataset), self.cfg.data.batch_size)
        return collate([self._scene(int(i)) for i in idxs])
