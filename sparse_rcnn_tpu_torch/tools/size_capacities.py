"""Measure per-scale site occupancy and per-axis spans; suggest capacities
(port of ``scripts/size_capacities.py``, with ``scripts/size_config4_bench.py``
folded in as ``--stretched``).

Every sort, gather and scatter of the backbone runs at the configured
capacity, not at the live site count. This tool streams ``--scenes`` scenes
through the config's own :class:`~..data.pipeline.Loader` (augmentation and
the host-voxelize path apply as in training), builds the hierarchy of each
batch, and reports per scale the most live sites, the capacity, the
occupancy and a suggested capacity ``round_up(max · margin, 128)``. A scale
whose most equals its capacity is saturated (rows were dropped): its
suggestion is then a lower bound, and flagged. It also reports the per-axis
span at stride 1 (rebase margin included) against
``model.backbone.grid_extent``::

    python -m sparse_rcnn_tpu_torch.tools.size_capacities --config configs/config3_s3dis.yaml \\
        [--split train] [--scenes 8] [--margin 1.3] [--no-augment] [--stretched] [--device cpu]

``--stretched`` sizes over config 4's LiDAR-sweep stand-ins instead of the
Loader's split: synthetic scenes of seeds 300, 301, … stretched by
``synthetic.stretch_scene`` to 100 × 100 × 6 m, drawn as
``scripts/size_config4_bench.py`` draws them (size over every distribution
the capacities serve). The JSON report goes to stdout; the YAML fragment to
paste and the warnings to stderr. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterator

import numpy as np
import torch

from ..config import Config, load_config
from ..data import synthetic
from ..data.pipeline import Loader, collate
from ..infer import parse_overrides, setup_device
from ..train import loop as TL

# size_config4_bench.py's sweeps: seeds from 300, a room of extent 8 m
# stretched to 100 x 100 x 6 m
STRETCH_SEED = 300
STRETCH_XYZ = (12.5, 12.5, 0.75)


@torch.no_grad()
def probe(cfg: Config, batch: Dict[str, np.ndarray], device):
    """Per scene: the live sites of every scale [B, S], the stride-1 span of
    each axis [B, 3] (rebase margin included); and the batch's voxel and
    hierarchy overflow."""
    st, _, scales, _, aux = TL.prepare_inputs(cfg, TL.to_device(batch, device))
    nvalid = torch.stack([s.nvalid for s in scales], dim=1)
    # padding rows hold the sentinel: mask them by row index
    live = st.row_mask[..., None]
    span = torch.where(live, st.coords, 0).amax(dim=1) + 1
    return (nvalid.cpu().numpy(), span.cpu().numpy(), int(aux["voxel_overflow"]),
            int(aux["hierarchy_overflow"]))


def stretched_batches(cfg: Config) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches of config 4's stretched sweeps, seeds 300, 301, …"""
    seed = STRETCH_SEED
    while True:
        scenes = []
        for _ in range(cfg.data.batch_size):
            scenes.append(synthetic.stretch_scene(synthetic.generate_scene(
                seed, num_points=cfg.data.num_points, num_instances=12,
                num_classes=cfg.model.num_classes, num_features=cfg.data.num_features,
                extent=8.0), STRETCH_XYZ))
            seed += 1
        yield collate(scenes)


def round_up(v, m: int) -> int:
    return -(-int(v) // m) * m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="suggest per-scale capacities from measured "
                                             "occupancy")
    ap.add_argument("--config", required=True)
    ap.add_argument("--set", action="append", dest="overrides", metavar="key.path=value")
    ap.add_argument("--split", default="train")
    ap.add_argument("--scenes", type=int, default=8,
                    help="number of scenes to measure (maxima over all)")
    ap.add_argument("--margin", type=float, default=1.3,
                    help="suggested cap = round_up(max_sites * margin, 128)")
    ap.add_argument("--no-augment", action="store_true",
                    help="bypass train-split augmentation (sizes the raw data; augmented "
                         "rotations can grow x/y spans)")
    ap.add_argument("--stretched", action="store_true",
                    help="size over config 4's stretched sweeps (seeds 300+, 100 x 100 x 6 m) "
                         "instead of the Loader's split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = setup_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.overrides))
    ns = len(cfg.model.backbone.widths)
    caps = cfg.scale_capacities()
    train = args.split == "train" and not args.no_augment and not args.stretched
    if args.stretched:
        loader, it = None, stretched_batches(cfg)
    else:
        loader = Loader(cfg, args.split, train=train, seed=args.seed)
        it = iter(loader)
    max_sites = np.zeros(ns, np.int64)
    max_span = np.zeros(3, np.int64)
    vovf_total = hovf_total = 0
    seen = 0
    try:
        while seen < args.scenes:
            batch = next(it, None)
            if batch is None:
                # an eval pass is finite: stop at the split's end
                print(f"# pool exhausted after {seen} scenes (asked for {args.scenes})",
                      file=sys.stderr)
                break
            nvalid, span, vovf, hovf = probe(cfg, batch, device)
            take = min(cfg.data.batch_size, args.scenes - seen)
            max_sites = np.maximum(max_sites, nvalid[:take].max(axis=0))
            max_span = np.maximum(max_span, span[:take].max(axis=0))
            vovf_total += vovf
            hovf_total += hovf
            seen += take
    finally:
        if loader is not None:
            loader.close()

    rows, suggested = [], []
    for s in range(ns):
        sat = max_sites[s] >= caps[s]
        sug = round_up(max(max_sites[s] * args.margin, 128), 128)
        suggested.append(int(min(sug, caps[0])) if s else int(caps[0]))
        rows.append({
            "scale": s, "cap": int(caps[s]), "max_sites": int(max_sites[s]),
            "occupancy": round(float(max_sites[s]) / caps[s], 3),
            "suggested": suggested[-1], "saturated": bool(sat),
        })
    ext = cfg.model.backbone.grid_extent
    down = 1 << (ns - 1)
    sug_ext = [round_up(int(v), down) for v in max_span]
    # a crop-bounded config's extent follows from its declared bounds
    # (bounds / voxel + twice the rebase margin, to the coarsest stride),
    # whatever the sampled scenes
    bounded_ext = None
    if cfg.data.crop_to_bounds and cfg.data.scene_bounds is not None:
        bounded_ext = [round_up(int(np.ceil(b / v)) + 4, down)
                       for b, v in zip(cfg.data.scene_bounds, cfg.data.voxel_size)]
    report = {
        "config": cfg.name, "split": "stretched" if args.stretched else args.split,
        "scenes": seen, "augmented": train, "margin": args.margin,
        "scales": rows,
        "voxel_overflow": vovf_total, "hierarchy_overflow": hovf_total,
        "max_span_cells": [int(v) for v in max_span],
        "grid_extent": list(ext) if ext else None,
        "suggested_extent_lower_bound": sug_ext,
        "suggested_extent_from_bounds": bounded_ext,
    }
    print(json.dumps(report, indent=2))
    sat_scales = [r["scale"] for r in rows if r["saturated"]]
    if sat_scales:
        print(f"# WARNING: scales {sat_scales} saturated their capacity — rows were dropped; "
              "suggestions there are lower bounds. Raise those caps and re-run.",
              file=sys.stderr)
    if vovf_total or hovf_total:
        print(f"# WARNING: overflow during measurement (voxel={vovf_total}, "
              f"hierarchy={hovf_total}) — counts are clipped at capacity.", file=sys.stderr)
    print("# paste into the config (model.backbone):", file=sys.stderr)
    print(f"#   capacities: {suggested}", file=sys.stderr)
    if ext:
        slack = [int(e) - int(v) for e, v in zip(ext, max_span)]
        print(f"#   grid_extent slack (cells beyond measured span): {slack} — measured lower "
              f"bound {sug_ext}; size via data.scene_bounds for headroom beyond the sampled "
              "scenes", file=sys.stderr)
    if bounded_ext:
        print(f"#   grid_extent: {bounded_ext}  # guaranteed by crop_to_bounds + "
              "scene_bounds (coverage does not depend on the sampled scenes)",
              file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
