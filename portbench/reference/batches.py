"""The train stream worked out again from the scene files and the seed.

The readers follow the two file layouts as documented (ScanNet's per-scene
``.npz``; SemanticKITTI's ``.bin`` sweeps with ``.label`` files, instance id
in the upper 16 bits) and pad a scene to the configuration's point
capacity, subsampling one with more points by ``default_rng(index)``. The
order is the Loader's contract (``sparse_rcnn_tpu_torch/data/pipeline.py``
at commit 4dd78ef): worker ``w`` of ``W`` draws from
``default_rng((seed, w))`` each batch's scene indices, then augments each
scene in turn from the same generator (``srcnn/data/augment.py``, a frozen
copy of the port's), and batch ``t`` is worker ``t mod W``'s
``(t div W)``-th batch.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .srcnn.data.augment import augment_scene

KITTI_TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
KITTI_VAL_SEQS = ["08"]


def _pad(points, feats, sem, inst, num_points, i) -> Dict[str, np.ndarray]:
    n = len(points)
    if n > num_points:
        sel = np.random.default_rng(i).choice(n, num_points, replace=False)
        points, feats, sem, inst = points[sel], feats[sel], sem[sel], inst[sel]
        n = num_points
    pad = num_points - n
    return {
        "points": np.pad(points, ((0, pad), (0, 0))).astype(np.float32),
        "feats": np.pad(feats, ((0, pad), (0, 0))).astype(np.float32),
        "valid": np.arange(num_points) < n,
        "point_semantic": np.pad(sem, (0, pad), constant_values=-1).astype(np.int32),
        "point_instance": np.pad(inst, (0, pad), constant_values=-1).astype(np.int32),
    }


def scene_files(cfg, split: str) -> List[str]:
    d = cfg.data
    if d.dataset == "scannet":
        sd = os.path.join(d.data_root, split)
        return sorted(os.path.join(sd, f) for f in os.listdir(sd) if f.endswith(".npz"))
    if d.dataset == "semantic_kitti":
        out = []
        for seq in (KITTI_TRAIN_SEQS if split == "train" else KITTI_VAL_SEQS):
            vd = os.path.join(d.data_root, "sequences", seq, "velodyne")
            if os.path.isdir(vd):
                out += sorted(os.path.join(vd, f) for f in os.listdir(vd) if f.endswith(".bin"))
        return out
    raise ValueError(f"dataset {d.dataset!r}")


def read_scene(cfg, path: str, i: int) -> Dict[str, np.ndarray]:
    d = cfg.data
    if path.endswith(".npz"):
        with np.load(path) as z:
            points, feats = z["points"], z["feats"]
            sem, inst = z["semantic"], z["instance"]
        if feats.shape[1] < d.num_features:
            feats = np.pad(feats, ((0, 0), (0, d.num_features - feats.shape[1])))
        feats = feats[:, :d.num_features]
    else:
        scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        points, feats = scan[:, :3], scan[:, 3:4]
        raw = np.fromfile(path.replace("velodyne", "labels").replace(".bin", ".label"),
                          dtype=np.uint32)
        sem = (raw & 0xFFFF).astype(np.int32)
        iraw = (raw >> 16).astype(np.int32)
        inst = np.full(len(points), -1, np.int32)
        pos = iraw > 0
        if pos.any():
            inst[pos] = np.unique(iraw[pos], return_inverse=True)[1].astype(np.int32)
        if d.num_features > 1:
            feats = np.pad(feats, ((0, 0), (0, d.num_features - 1)))
    return _pad(points.astype(np.float32), feats.astype(np.float32), sem.astype(np.int32),
                inst.astype(np.int32), d.num_points, i)


def train_batches(cfg, seed: int, n: int) -> List[Dict[str, np.ndarray]]:
    """The first ``n`` batches of the train stream of ``seed``."""
    files = scene_files(cfg, "train")
    b, workers = cfg.data.batch_size, max(1, cfg.data.num_workers)
    rngs = [np.random.default_rng((seed, w)) for w in range(workers)]
    out = []
    for t in range(n):
        rng = rngs[t % workers]
        idxs = rng.integers(0, len(files), b)
        scenes = []
        for i in idxs:
            s = read_scene(cfg, files[int(i)], int(i))
            if cfg.data.augment:
                s = augment_scene(s, cfg.data, rng)
            scenes.append(s)
        out.append({k: np.stack([s[k] for s in scenes]) for k in scenes[0]})
    return out
