"""Scene pools written from the seed, in the layouts the port's readers take.

``generate_scene`` and ``stretch_scene`` are frozen copies of
``sparse_rcnn_tpu_torch/data/synthetic.py`` at commit 4dd78ef (the easy
generator only), so that a later change to the port cannot move the
benchmark's inputs. The recipes follow ``bench.py``: 10–12 instances over
an 8 m extent, and for LiDAR the stretch ``[12.5, 12.5, 0.75]`` to about
100 × 100 m.

Two writers: ``write_scannet`` puts one ``.npz`` a scene under
``<root>/<split>/`` (keys ``points``, ``feats``, ``semantic``,
``instance``: the layout ``ScanNetDataset`` reads), and ``write_kitti``
puts ``sequences/<seq>/velodyne/<i>.bin`` (float32 x, y, z, remission) and
``labels/<i>.label`` (uint32: instance id + 1 in the upper 16 bits,
semantic class in the lower 16; points outside every instance get class
``num_classes``, the model's background slot) for ``SemanticKITTIDataset``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

KITTI_SEQS = {"train": "00", "val": "08"}


def generate_scene(seed: int, num_points: int = 16384, num_instances: int = 6,
                   num_classes: int = 18, num_features: int = 3,
                   extent: float = 8.0) -> Dict[str, np.ndarray]:
    """Frozen copy of the port's easy ``generate_scene``: a floor slab of
    background points plus K box-shaped instance blobs, capacity-full."""
    rng = np.random.default_rng(seed)
    n_bg = num_points // 3
    n_fg = num_points - n_bg
    bg_pts = np.stack([rng.uniform(0, extent, n_bg), rng.uniform(0, extent, n_bg),
                       rng.uniform(0, 0.15, n_bg)], axis=1)
    bg_inst = np.full(n_bg, -1, np.int32)
    bg_sem = np.full(n_bg, -1, np.int32)
    class_rng = np.random.default_rng(12345)
    class_colors = class_rng.uniform(-1, 1, (num_classes, num_features))
    k = int(rng.integers(max(1, num_instances - 2), num_instances + 1))
    per = n_fg // k
    fg_pts, fg_inst, fg_sem, fg_feat = [], [], [], []
    for i in range(k):
        center = rng.uniform(1.0, extent - 1.0, 3)
        center[2] = rng.uniform(0.3, 1.5)
        size = rng.uniform(0.3, 1.2, 3)
        cnt = per if i < k - 1 else n_fg - per * (k - 1)
        pts = center + rng.uniform(-0.5, 0.5, (cnt, 3)) * size
        cls = int(rng.integers(0, num_classes))
        fg_pts.append(pts)
        fg_inst.append(np.full(cnt, i, np.int32))
        fg_sem.append(np.full(cnt, cls, np.int32))
        fg_feat.append(class_colors[cls] + rng.normal(0, 0.3, (cnt, num_features)))
    points = np.concatenate([bg_pts] + fg_pts).astype(np.float32)
    inst = np.concatenate([bg_inst] + fg_inst)
    sem = np.concatenate([bg_sem] + fg_sem)
    bg_feat = rng.normal(0, 0.3, (n_bg, num_features))
    feats = np.concatenate([bg_feat] + fg_feat).astype(np.float32)
    perm = rng.permutation(num_points)
    return {"points": points[perm], "feats": feats[perm],
            "valid": np.ones(num_points, bool), "point_instance": inst[perm],
            "point_semantic": sem[perm]}


def stretch_scene(scene: Dict[str, np.ndarray], scale_xyz) -> Dict[str, np.ndarray]:
    """Frozen copy of the port's ``stretch_scene``: only ``points`` change."""
    out = dict(scene)
    out["points"] = (scene["points"] * np.asarray(scale_xyz, np.float32)[None, :]
                     ).astype(np.float32)
    return out


def scene_seed(split: str, i: int) -> int:
    """Scene ``i`` of ``split``'s pool: a fixed seed, disjoint between the
    splits and the same in every run, so that every run's seed draws its
    order, augmentations and weights over the same set of scene sizes."""
    tag = {"train": 1, "val": 2}[split]
    return int(np.random.SeedSequence([7919, tag, i]).generate_state(1, np.uint64)[0])


def make_scene(recipe: dict, seed: int, cfg) -> Dict[str, np.ndarray]:
    """One scene of a configuration's recipe (``configs/<config>.scenes.json``:
    layout, instances, extent, stretch) at the configuration's point
    capacity, features and classes: every scene fills its capacity."""
    s = generate_scene(seed, num_points=cfg.data.num_points,
                       num_instances=recipe["num_instances"],
                       num_classes=cfg.model.num_classes,
                       num_features=cfg.data.num_features, extent=recipe["extent"])
    if recipe.get("stretch"):
        s = stretch_scene(s, recipe["stretch"])
    return s


def write_scannet(root: str, split: str, scenes: List[Dict[str, np.ndarray]]) -> None:
    d = os.path.join(root, split)
    os.makedirs(d, exist_ok=True)
    for i, s in enumerate(scenes):
        v = s["valid"]
        np.savez(os.path.join(d, f"scene{i:04d}.npz"), points=s["points"][v],
                 feats=s["feats"][v], semantic=s["point_semantic"][v],
                 instance=s["point_instance"][v])


def write_kitti(root: str, split: str, scenes: List[Dict[str, np.ndarray]],
                num_classes: int) -> None:
    seq = os.path.join(root, "sequences", KITTI_SEQS[split])
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(seq, "labels"), exist_ok=True)
    for i, s in enumerate(scenes):
        v = s["valid"]
        scan = np.concatenate([s["points"][v], s["feats"][v][:, :1]], axis=1)
        scan.astype(np.float32).tofile(os.path.join(seq, "velodyne", f"{i:06d}.bin"))
        inst = s["point_instance"][v].astype(np.int64)
        sem = s["point_semantic"][v].astype(np.int64)
        sem = np.where(sem >= 0, sem, num_classes)
        lab = (np.where(inst >= 0, inst + 1, 0) << 16) | sem
        lab.astype(np.uint32).tofile(os.path.join(seq, "labels", f"{i:06d}.label"))


def write_pool(recipe: dict, cfg, root: str, split: str, n: int) -> None:
    """The first ``n`` scenes of ``split``'s pool, written in the recipe's layout."""
    scenes = [make_scene(recipe, scene_seed(split, i), cfg) for i in range(n)]
    if recipe["layout"] == "scannet":
        write_scannet(root, split, scenes)
    elif recipe["layout"] == "semantic_kitti":
        write_kitti(root, split, scenes, cfg.model.num_classes)
    else:
        raise ValueError(f"scene layout {recipe['layout']!r}")
