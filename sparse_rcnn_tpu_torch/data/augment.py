"""Host-side point-cloud augmentation: the port's own copy of
``sparse_rcnn_tpu/data/augment.py`` (pure numpy, so the same rng gives the
same scenes; ``tests/test_torch_train.py`` holds the two train streams
equal). Rotation about z, flips, scale, jitter, elastic distortion, colour
jitter and the optional crop to ``scene_bounds``.
"""

from __future__ import annotations

import numpy as np

from ..config import DataConfig


def rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], points.dtype)
    return points @ rot.T


def elastic_distortion(points: np.ndarray, rng: np.random.Generator,
                       granularity: float = 0.8, magnitude: float = 0.16) -> np.ndarray:
    """Smooth random displacement field interpolated at the points."""
    lo, hi = points.min(0), points.max(0)
    dims = np.maximum(((hi - lo) / granularity).astype(int) + 3, 2)
    noise = rng.normal(size=(*dims, 3)).astype(points.dtype)
    # smooth with a few box blurs
    for _ in range(2):
        for axis in range(3):
            noise = (np.roll(noise, 1, axis) + noise + np.roll(noise, -1, axis)) / 3
    idx = np.clip(((points - lo) / granularity).astype(int) + 1, 1, np.asarray(dims) - 2)
    disp = noise[idx[:, 0], idx[:, 1], idx[:, 2]]
    return points + disp * magnitude


def augment_scene(scene: dict, cfg: DataConfig, rng: np.random.Generator) -> dict:
    """Apply the configured augmentations to one scene dict (in place safe)."""
    pts = scene["points"].copy()
    feats = scene["feats"].copy()
    if cfg.rotate_z:
        pts = rotate_z(pts, rng.uniform(0, 2 * np.pi))
    if cfg.flip:
        for axis in (0, 1):
            if rng.random() < 0.5:
                pts[:, axis] = -pts[:, axis]
    if cfg.scale_range != (1.0, 1.0):
        pts = pts * rng.uniform(*cfg.scale_range)
    if cfg.jitter_sigma > 0:
        pts = pts + rng.normal(0, cfg.jitter_sigma, pts.shape).astype(pts.dtype)
    if cfg.elastic_distortion:
        pts = elastic_distortion(pts, rng)
    if cfg.color_jitter > 0 and feats.shape[1] >= 3:
        feats[:, :3] = feats[:, :3] + rng.normal(
            0, cfg.color_jitter, (1, 3)
        ).astype(feats.dtype)
    out = dict(scene)
    out["points"] = pts.astype(np.float32)
    out["feats"] = feats.astype(np.float32)
    if cfg.crop_to_bounds and cfg.scene_bounds is not None:
        # scene-centred crop of whole points to the declared bounds; GT
        # shrinks with it (boxes are segment min/max of the surviving
        # points), padded rows stay masked via "valid", shapes unchanged
        valid = out["valid"].astype(bool)
        live = np.where(valid)[0]
        if live.size:
            p = out["points"][live]
            center = (p.min(0) + p.max(0)) / 2
            half = np.asarray(cfg.scene_bounds, np.float32) / 2
            inb = np.all(np.abs(p - center) <= half, axis=1)
            keep = valid.copy()
            keep[live] = inb
            out["valid"] = keep.astype(out["valid"].dtype)
    return out
