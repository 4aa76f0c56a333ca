"""Rulebook counts of a batch from the reference's own voxelize and
hierarchy: a frozen copy of ``sparse_rcnn_tpu_torch/utils/flops.py::
collect_rulebook_stats`` at commit 4dd78ef over ``srcnn/``."""

from __future__ import annotations

from typing import Dict, List

import torch

from .srcnn.ops import hierarchy as H
from .srcnn.ops import voxelize as V


@torch.no_grad()
def rulebook_stats(cfg, batch, device) -> Dict[str, List[int]]:
    """Per scale, over the batch: live sites, realized submanifold pairs and
    realized down-conv pairs, with rulebooks at every scale (the dense
    tail's counted as their submanifold equivalents)."""
    pts, feats, valid = (torch.as_tensor(batch[k], device=device)
                         for k in ("points", "feats", "valid"))
    st, _, _ = V.voxelize_batch(pts, feats, valid, cfg.data.voxel_size,
                                cfg.data.voxel_capacity)
    st, _ = V.rebase_coords(st, margin=2)
    scales, _ = H.build_hierarchy(st, len(cfg.model.backbone.widths), cfg.scale_capacities(),
                                  cfg.model.backbone.kernel_size, subm_scales=None)
    return {
        "sites": [int(s.nvalid.sum()) for s in scales],
        "subm_pairs": [int((s.subm_idx >= 0).sum()) for s in scales],
        "down_pairs": [int((s.down_idx >= 0).sum()) for s in scales[:-1]],
    }
