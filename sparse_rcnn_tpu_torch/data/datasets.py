"""Dataset readers: ScanNet, S3DIS, SemanticKITTI, and the synthetic
scenes (port of ``sparse_rcnn_tpu/data/datasets.py``).

Every reader yields the padded scene dict the synthetic generator produces
(points, feats, valid, point_instance, point_semantic), so the device path
is the same for all of them. The readers take the preprocessed formats of
this repo family: one ``.npz`` or torch ``.pth``/``.pt`` file a scene, or
SemanticKITTI's raw ``.bin`` and ``.label`` sweeps. Files are read lazily:
building a dataset over a root with no files raises ``FileNotFoundError``,
importing this module never does. A scene with more points than
``num_points`` is subsampled by ``default_rng(index)``, as in the JAX
package, so both read the same points.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import synthetic

def _pad_scene(
    points: np.ndarray,
    feats: np.ndarray,
    semantic: np.ndarray,
    instance: np.ndarray,
    num_points: int,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Random-subsample or pad a scene to the static point capacity."""
    n = len(points)
    if n > num_points:
        sel = (rng or np.random.default_rng(0)).choice(n, num_points, replace=False)
        points, feats = points[sel], feats[sel]
        semantic, instance = semantic[sel], instance[sel]
        n = num_points
    pad = num_points - n
    return {
        "points": np.pad(points, ((0, pad), (0, 0))).astype(np.float32),
        "feats": np.pad(feats, ((0, pad), (0, 0))).astype(np.float32),
        "valid": np.arange(num_points) < n,
        "point_semantic": np.pad(semantic, (0, pad), constant_values=-1).astype(np.int32),
        "point_instance": np.pad(instance, (0, pad), constant_values=-1).astype(np.int32),
    }


def _load_scene_file(path: str) -> Dict[str, np.ndarray]:
    """Load one preprocessed scene (.npz with standard keys, or torch .pth)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            points = z["points"]
            feats = z["feats"] if "feats" in z else z.get("colors", np.zeros((len(points), 3)))
            sem = z.get("semantic", np.full(len(points), -1))
            inst = z.get("instance", np.full(len(points), -1))
    elif path.endswith((".pth", ".pt")):
        data = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(data, (tuple, list)):
            # (coords, colors, sem_labels, inst_labels) — common preproc layout
            points, feats = np.asarray(data[0]), np.asarray(data[1])
            sem = np.asarray(data[2]) if len(data) > 2 else np.full(len(points), -1)
            inst = np.asarray(data[3]) if len(data) > 3 else np.full(len(points), -1)
        else:
            points = np.asarray(data["points"])
            feats = np.asarray(data.get("feats", data.get("colors")))
            sem = np.asarray(data.get("semantic", np.full(len(points), -1)))
            inst = np.asarray(data.get("instance", np.full(len(points), -1)))
    else:
        raise ValueError(f"Unsupported scene file: {path}")
    return {
        "points": points.astype(np.float32),
        "feats": feats.astype(np.float32),
        "semantic": sem.astype(np.int32),
        "instance": inst.astype(np.int32),
    }


class SceneFileDataset:
    """Directory of per-scene files; split via ``<root>/<split>/*`` or a
    ``<root>/<split>.txt`` list of scene names."""

    def __init__(self, root: str, split: str, num_points: int, num_features: int = 3):
        self.root, self.split = root, split
        self.num_points = num_points
        self.num_features = num_features
        self.files = self._index()
        if not self.files:
            raise FileNotFoundError(
                f"No scene files for split '{split}' under {root!r}"
            )

    def _index(self) -> List[str]:
        split_dir = os.path.join(self.root, self.split)
        exts = (".npz", ".pth", ".pt")
        if os.path.isdir(split_dir):
            return sorted(
                os.path.join(split_dir, f)
                for f in os.listdir(split_dir)
                if f.endswith(exts)
            )
        list_file = os.path.join(self.root, f"{self.split}.txt")
        if os.path.isfile(list_file):
            with open(list_file) as fh:
                names = [l.strip() for l in fh if l.strip()]
            out = []
            for name in names:
                for ext in exts:
                    p = os.path.join(self.root, name + ext)
                    if os.path.isfile(p):
                        out.append(p)
                        break
            return out
        return []

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        raw = _load_scene_file(self.files[i])
        feats = raw["feats"]
        if feats.shape[1] < self.num_features:
            feats = np.pad(feats, ((0, 0), (0, self.num_features - feats.shape[1])))
        return _pad_scene(
            raw["points"], feats[:, : self.num_features],
            raw["semantic"], raw["instance"], self.num_points,
            np.random.default_rng(i),
        )


class ScanNetDataset(SceneFileDataset):
    """ScanNet v2 instance segmentation (primary dataset, BASELINE cfg 1–2)."""


class S3DISDataset(SceneFileDataset):
    """S3DIS large rooms — stresses capacities/overflow (BASELINE cfg 3).
    Split convention: 'train' = all areas but `test_area`, 'val' = test_area."""

    def __init__(self, root: str, split: str, num_points: int,
                 num_features: int = 3, test_area: int = 5):
        self.test_area = test_area
        super().__init__(root, split, num_points, num_features)

    def _index(self) -> List[str]:
        files = super()._index()
        if files:
            return files
        # fallback: flat dir of Area_X_*.npz
        exts = (".npz", ".pth", ".pt")
        all_files = sorted(
            os.path.join(self.root, f)
            for f in (os.listdir(self.root) if os.path.isdir(self.root) else [])
            if f.endswith(exts)
        )
        tag = f"Area_{self.test_area}"
        if self.split == "train":
            return [f for f in all_files if tag not in os.path.basename(f)]
        return [f for f in all_files if tag in os.path.basename(f)]


class SemanticKITTIDataset:
    """SemanticKITTI LiDAR sweeps (BASELINE cfg 4): raw .bin + .label files.

    Instance ids live in the upper 16 bits of the .label format; semantic
    class in the lower 16. Anisotropic voxel sizes are configured in
    DataConfig.voxel_size.
    """

    SPLIT_SEQS = {
        "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
        "val": ["08"],
        "test": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
    }

    def __init__(self, root: str, split: str, num_points: int, num_features: int = 1):
        self.root = root
        self.num_points = num_points
        self.num_features = num_features
        self.files: List[str] = []
        seq_dir = os.path.join(root, "sequences")
        for seq in self.SPLIT_SEQS.get(split, []):
            vdir = os.path.join(seq_dir, seq, "velodyne")
            if os.path.isdir(vdir):
                self.files += sorted(
                    os.path.join(vdir, f) for f in os.listdir(vdir)
                    if f.endswith(".bin")
                )
        if not self.files:
            raise FileNotFoundError(
                f"No SemanticKITTI sweeps for split '{split}' under {root!r}"
            )

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        scan = np.fromfile(self.files[i], dtype=np.float32).reshape(-1, 4)
        points, remission = scan[:, :3], scan[:, 3:4]
        label_path = self.files[i].replace("velodyne", "labels").replace(
            ".bin", ".label"
        )
        if os.path.isfile(label_path):
            raw = np.fromfile(label_path, dtype=np.uint32)
            sem = (raw & 0xFFFF).astype(np.int32)
            inst_raw = (raw >> 16).astype(np.int32)
            # re-index instances densely; 0 = no instance (vectorized —
            # the per-id mask loop was O(ids x N) per sweep on the host)
            inst = np.full(len(points), -1, np.int32)
            pos = inst_raw > 0
            if pos.any():
                _, inv = np.unique(inst_raw[pos], return_inverse=True)
                inst[pos] = inv.astype(np.int32)
        else:
            sem = np.full(len(points), -1, np.int32)
            inst = np.full(len(points), -1, np.int32)
        feats = remission
        if self.num_features > 1:
            feats = np.pad(feats, ((0, 0), (0, self.num_features - 1)))
        return _pad_scene(points, feats, sem, inst, self.num_points,
                          np.random.default_rng(i))


class SyntheticDataset:
    """Deterministic generated scenes (tests/benchmarks; no files needed)."""

    def __init__(self, num_scenes: int, num_points: int, num_instances: int = 6,
                 num_classes: int = 18, num_features: int = 3, seed: int = 0,
                 difficulty: str = "easy"):
        self.num_scenes = num_scenes
        self.kw = dict(num_points=num_points, num_instances=num_instances,
                       num_classes=num_classes, num_features=num_features,
                       difficulty=difficulty)
        self.seed = seed

    def __len__(self):
        return self.num_scenes

    def __getitem__(self, i):
        return synthetic.generate_scene(self.seed * 100003 + i, **self.kw)


def build_dataset(cfg, split: str):
    """Factory from DataConfig.dataset."""
    d = cfg.data
    if d.dataset in ("synthetic", "synthetic_hard"):
        # disjoint scene pools per split (seed offset), like real splits;
        # num_scenes sizes the TRAIN pool only, val_scenes the val/test pools
        split_seed = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        pool = d.num_scenes if split == "train" else d.val_scenes
        return SyntheticDataset(
            num_scenes=pool if pool is not None else max(64, d.batch_size * 8),
            num_points=d.num_points,
            num_classes=cfg.model.num_classes, num_features=d.num_features,
            seed=split_seed,
            difficulty="hard" if d.dataset == "synthetic_hard" else "easy",
        )
    if d.dataset == "scannet":
        return ScanNetDataset(d.data_root, split, d.num_points, d.num_features)
    if d.dataset == "s3dis":
        return S3DISDataset(d.data_root, split, d.num_points, d.num_features)
    if d.dataset == "semantic_kitti":
        return SemanticKITTIDataset(d.data_root, split, d.num_points, d.num_features)
    raise ValueError(f"Unknown dataset {d.dataset!r}")
