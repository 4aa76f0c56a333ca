"""Preprocess raw ScanNet v2 scans into the per-scene ``.npz`` files the
ScanNet reader (``data/datasets.py::ScanNetDataset``) reads (port of
``scripts/preprocess_scannet.py``, reading through the port's own PLY
reader, so it runs where JAX is not installed)::

    python -m sparse_rcnn_tpu_torch.tools.preprocess_scannet --raw RAW --out OUT \\
        [--splits-dir DIR]

Input layout (the official release):
  <raw>/scans/<scene_id>/<scene_id>_vh_clean_2.ply           (xyz + rgb)
  <raw>/scans/<scene_id>/<scene_id>_vh_clean_2.labels.ply    (nyu40 labels)
  <raw>/scans/<scene_id>/<scene_id>_vh_clean_2.0.010000.segs.json
  <raw>/scans/<scene_id>/<scene_id>.aggregation.json

Output: ``<out>/<split>/<scene_id>.npz`` with points, feats, semantic and
instance. The 18 ScanNet benchmark instance classes are mapped from nyu40
ids; every other semantic becomes -1 (unlabeled for the instance task). The
splits come from ``scannetv2_{train,val}.txt`` in ``--splits-dir``, or every
scan goes to ``train``. A scene whose output exists is skipped.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.ply import read_ply, vertices_xyz_rgb

# nyu40 id -> benchmark instance class index (18 classes; wall/floor excluded)
NYU40_TO_BENCH = {
    3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7, 11: 8, 12: 9,
    14: 10, 16: 11, 24: 12, 28: 13, 33: 14, 34: 15, 36: 16, 39: 17,
}


def process_scene(scan_dir: str, scene_id: str):
    base = os.path.join(scan_dir, scene_id, scene_id)
    props = read_ply(base + "_vh_clean_2.ply")
    points, rgb = vertices_xyz_rgb(props)

    lab = read_ply(base + "_vh_clean_2.labels.ply")
    nyu = lab["label"].astype(np.int64)
    semantic = np.full(len(points), -1, np.int32)
    for nyu_id, bench in NYU40_TO_BENCH.items():
        semantic[nyu == nyu_id] = bench

    with open(base + "_vh_clean_2.0.010000.segs.json") as f:
        seg = np.asarray(json.load(f)["segIndices"], np.int64)
    with open(base + ".aggregation.json") as f:
        agg = json.load(f)["segGroups"]

    instance = np.full(len(points), -1, np.int32)
    next_id = 0
    for group in agg:
        mask = np.isin(seg, group["segments"])
        sem = semantic[mask]
        if mask.any() and (sem >= 0).mean() > 0.5:
            instance[mask] = next_id
            next_id += 1
    return {
        "points": points, "feats": rgb,
        "semantic": semantic, "instance": instance,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="raw ScanNet v2 scans -> per-scene .npz files")
    ap.add_argument("--raw", required=True, help="ScanNet release root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits-dir", default=None,
                    help="dir with scannetv2_{train,val}.txt scene lists")
    args = ap.parse_args(argv)

    scans = os.path.join(args.raw, "scans")
    splits = {}
    if args.splits_dir:
        for split in ("train", "val"):
            p = os.path.join(args.splits_dir, f"scannetv2_{split}.txt")
            with open(p) as f:
                splits[split] = [line.strip() for line in f if line.strip()]
    else:
        splits["train"] = sorted(os.listdir(scans))

    for split, scene_ids in splits.items():
        out_dir = os.path.join(args.out, split)
        os.makedirs(out_dir, exist_ok=True)
        for sid in scene_ids:
            out_path = os.path.join(out_dir, sid + ".npz")
            if os.path.exists(out_path):
                continue
            # a scene that fails is reported and the run goes on to the next
            try:
                np.savez_compressed(out_path, **process_scene(scans, sid))
                print(f"{split}/{sid}: ok")
            except (OSError, ValueError, KeyError) as e:
                print(f"{split}/{sid}: FAILED {e}")


if __name__ == "__main__":
    main()
