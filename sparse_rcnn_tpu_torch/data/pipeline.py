"""Host input pipeline: worker threads, prefetch, the C++ host voxelizer and
asynchronous copies to the card (port of ``data/pipeline.py``).

:class:`Loader` yields batches (dicts of numpy arrays) of a split. Training
streams are infinite: ``num_workers`` threads each draw scene indices and
augmentations from ``default_rng((seed, worker))`` and fill a bounded queue
of their own, and the consumer takes one batch from each worker in turn.
The order is therefore fixed by the seed and the worker count, the same in
every run; it is one of the orders the JAX ``Loader`` (whose consumer takes
whichever batch is ready first) can yield, and with one worker the JAX
order itself. An eval pass is one worker, in order, unaugmented, the last
batch wrap-padded from the split's start. ``threads=False`` makes the same
batches, in the same order, in the caller's thread. With
``data.host_voxelize`` the workers also voxelize every scene with the port's
C++ core (:mod:`..native`), and the device path skips its own voxelize;
a library that does not build fails the Loader, with the compiler's message.

Under data parallel a Loader of ``rank`` among ``world`` ranks yields slots
``[rank·b/world, (rank+1)·b/world)`` of each global batch of ``b`` scenes:
the very scenes, with the very augmentations, that one process's Loader
puts in those slots (JAX's sharded batch gives each device the same
slots). A scene's augmentation draws depend on its points, so a rank
replays the other slots' augmentations to keep its generator in step, and
voxelizes only its own scenes (``replay_s``, ``scenes_replayed``).

:func:`device_batches` puts a stream of host batches on a device. On the
card each batch goes through pinned host buffers and non-blocking copies on
a copy stream, the next batch's copy started before the current batch is
handed out (the JAX loader's double-buffered ``device_put``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..config import Config
from .augment import augment_scene
from .datasets import build_dataset

# the tables host_voxelize_scene adds to a scene; a batch that carries them
# skips the device's voxelize (train/loop.py::prepare_inputs)
VOXEL_KEYS = ("voxel_coords", "voxel_feats", "voxel_nvalid", "p2v", "voxel_overflow")
_END = object()           # a worker's pass is over
_POLL_S = 0.5


def collate(scenes) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


def device_keys(batch, keys: Sequence[str]) -> Tuple[str, ...]:
    """``keys`` and the host-voxelized tables ``batch`` carries: the arrays
    the device path reads."""
    return tuple(keys) + tuple(k for k in VOXEL_KEYS if k in batch and k not in keys)


def host_voxelize_scene(scene: Dict[str, np.ndarray], cfg: Config) -> Dict[str, np.ndarray]:
    """The scene with the C++ voxelizer's tables under :data:`VOXEL_KEYS`."""
    coords, feats, nv, p2v, ovf = native.voxelize_scene(
        scene["points"], scene["feats"], scene["valid"].astype(np.uint8),
        np.asarray(cfg.data.voxel_size, np.float32), cfg.data.voxel_capacity,
    )
    out = dict(scene)
    out["voxel_coords"] = coords
    out["voxel_feats"] = feats
    out["voxel_nvalid"] = np.int32(nv)
    out["p2v"] = p2v
    out["voxel_overflow"] = np.int32(ovf)
    return out


class Loader:
    """Batches of ``split``: infinite and augmented (``train``) or one
    ordered pass. Iterate it once; close it (or use it as a context
    manager) to stop its threads.

    Counters: ``wait_s``, the seconds the consumer spent waiting for a
    batch (near 0 past the first batch when the workers keep ahead of the
    step); ``batches_out``; ``voxelize_s`` and ``scenes_voxelized``, the
    workers' time in the C++ voxelizer; ``replay_s`` and
    ``scenes_replayed``, the workers' time reading and augmenting the
    scenes of other ranks' slots.
    """

    def __init__(self, cfg: Config, split: str = "train", train: bool = True,
                 seed: int = 0, threads: bool = True, rank: int = 0, world: int = 1):
        self.cfg = cfg
        self.split = split
        self.train = train
        self.seed = seed
        b = cfg.data.batch_size
        if b % world or not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world}: data.batch_size {b} must be a "
                             "multiple of the world size")
        self.slots = range(rank * b // world, (rank + 1) * b // world)
        self.dataset = build_dataset(cfg, split)
        if cfg.data.host_voxelize:
            native.load()          # raises here, not in a worker, if it cannot build
        self.num_workers = max(1, cfg.data.num_workers) if train else 1
        self.wait_s = 0.0
        self.batches_out = 0
        self.voxelize_s = 0.0
        self.scenes_voxelized = 0
        self.replay_s = 0.0
        self.scenes_replayed = 0
        self._count_lock = threading.Lock()
        self._turn = 0
        self._done = False
        self._stop = threading.Event()
        self._threads = []
        if threads:
            depth = max(1, -(-max(self.num_workers, cfg.data.prefetch) // self.num_workers))
            self._queues = [queue.Queue(maxsize=depth) for _ in range(self.num_workers)]
            self._threads = [threading.Thread(target=self._worker, args=(w,), daemon=True,
                                              name=f"loader-{split}-{w}")
                             for w in range(self.num_workers)]
            for t in self._threads:
                t.start()
        else:
            self._gens = [self._batches(w) for w in range(self.num_workers)]

    def __len__(self) -> int:
        """Batches in an eval pass."""
        if self.train:
            raise TypeError("a train Loader is infinite")
        return -(-len(self.dataset) // self.cfg.data.batch_size)

    def _scene(self, idx: int, rng: np.random.Generator):
        scene = self.dataset[idx % len(self.dataset)]
        if self.train and self.cfg.data.augment:
            scene = augment_scene(scene, self.cfg.data, rng)
        if self.cfg.data.host_voxelize:
            t0 = time.perf_counter()
            scene = host_voxelize_scene(scene, self.cfg)
            with self._count_lock:
                self.voxelize_s += time.perf_counter() - t0
                self.scenes_voxelized += 1
        return scene

    def _replay(self, idx: int, rng: np.random.Generator) -> None:
        """Another rank's scene: its augmentation's draws, and nothing kept."""
        if not (self.train and self.cfg.data.augment):
            return
        t0 = time.perf_counter()
        augment_scene(self.dataset[idx % len(self.dataset)], self.cfg.data, rng)
        with self._count_lock:
            self.replay_s += time.perf_counter() - t0
            self.scenes_replayed += 1

    def _batches(self, wid: int) -> Iterator[Dict[str, np.ndarray]]:
        """Worker ``wid``'s batches (this rank's slots of each), in its order."""
        rng = np.random.default_rng((self.seed, wid))
        b, n = self.cfg.data.batch_size, len(self.dataset)
        if self.train:
            while True:
                idxs = rng.integers(0, n, b)
                scenes = []
                for j, i in enumerate(idxs):
                    if j in self.slots:
                        scenes.append(self._scene(int(i), rng))
                    else:
                        self._replay(int(i), rng)
                yield collate(scenes)
        else:
            for start in range(0, n, b):
                yield collate([self._scene((start + j) % n, rng) for j in self.slots])

    def _worker(self, wid: int) -> None:
        q = self._queues[wid]
        try:
            for batch in self._batches(wid):
                if not self._put(q, batch):
                    return
        except Exception as e:        # handed to the consumer, which raises it
            self._put(q, e)
            return
        self._put(q, _END)

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, wid: int):
        q, thread = self._queues[wid], self._threads[wid]
        while True:
            if self._stop.is_set():
                raise RuntimeError("Loader is closed")
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                if not thread.is_alive() and q.empty():
                    raise RuntimeError(f"loader worker {wid} exited without a batch")

    def __iter__(self) -> "Loader":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._done:
            raise StopIteration
        wid = self._turn % self.num_workers
        t0 = time.perf_counter()
        if self._threads:
            item = self._get(wid)
        else:
            item = next(self._gens[wid], _END)
        self.wait_s += time.perf_counter() - t0
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise RuntimeError(f"loader worker {wid} failed") from item
        self._turn += 1
        self.batches_out += 1
        return item

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60)

    def __enter__(self) -> "Loader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def device_batches(batches: Iterable[Dict[str, np.ndarray]], device,
                   keys: Sequence[str]) -> Iterator[Tuple[Dict[str, np.ndarray],
                                                          Dict[str, torch.Tensor]]]:
    """``(host, dev)`` for each host batch of ``batches``: ``dev`` holds
    ``keys`` and any host-voxelized tables as tensors on ``device``.

    On a CUDA device every array is copied into a pinned host buffer and
    sent with a non-blocking copy on a copy stream of its own; the next
    batch's copies are issued before the current batch is handed out, so
    they overlap the consumer's step. The consumer's current stream waits
    on an event recorded after the copies, and ``record_stream`` keeps the
    copies' memory from being reused while that stream may still read it.
    On the CPU the tensors share the numpy arrays' memory.
    """
    device = torch.device(device)
    it = iter(batches)
    if device.type != "cuda":
        for host in it:
            yield host, {k: torch.as_tensor(host[k], device=device)
                         for k in device_keys(host, keys)}
        return
    copier = torch.cuda.Stream(device)

    def start_next():
        host = next(it, None)
        if host is None:
            return None
        with torch.cuda.stream(copier):
            dev = {k: torch.from_numpy(np.ascontiguousarray(host[k])).pin_memory()
                   .to(device, non_blocking=True) for k in device_keys(host, keys)}
            done = torch.cuda.Event()
            done.record(copier)
        return host, dev, done

    nxt = start_next()
    while nxt is not None:
        host, dev, done = nxt
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in dev.values():
            t.record_stream(consumer)
        nxt = start_next()
        yield host, dev
