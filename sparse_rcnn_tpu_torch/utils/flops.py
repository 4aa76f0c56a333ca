"""Useful-work (sparse-equivalent) FLOP accounting (port of
``utils/flops.py``).

A profile counts every operation the card executes, including the dense
tail's convolutions over empty grid cells, which are padding, not work.
This module counts the *useful* forward FLOPs instead: for every conv,
``2 · (realized kernel-tap pairs) · Cin · Cout``, where the pair counts
come from the batch's own rulebooks (the rulebook is the list of realized
input → output pairs). The dense-tail scales are counted by the same
formula: the useful work of a masked dense conv is its submanifold
equivalent's pair count, so :func:`collect_rulebook_stats` builds rulebooks
at those scales too (the model's forward skips them).

The heads run at static shapes, so their nominal FLOPs are their useful
FLOPs. All counts are per batch, forward only; a train step's backward is
about twice the forward's convs (dgrad and wgrad).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..config import Config
from ..ops import hierarchy as H
from ..ops import voxelize as V


@torch.no_grad()
def collect_rulebook_stats(cfg: Config, batch, device="cuda") -> Dict[str, List[int]]:
    """Voxelize ``batch`` (numpy or tensors: ``points``, ``feats``,
    ``valid``) on ``device``, build the hierarchy with rulebooks at every
    scale, and count per scale the live sites, the realized submanifold
    pairs and the realized down-conv pairs (integers)."""
    pts, feats, valid = (torch.as_tensor(batch[k], device=device)
                         for k in ("points", "feats", "valid"))
    st, _, _ = V.voxelize_batch(pts, feats, valid, cfg.data.voxel_size,
                                cfg.data.voxel_capacity)
    st, _ = V.rebase_coords(st, margin=2)
    # subm_scales=None: rulebooks at the dense-tail scales too, so that
    # their useful (submanifold-equivalent) pair counts are exact
    scales, _ = H.build_hierarchy(st, len(cfg.model.backbone.widths), cfg.scale_capacities(),
                                  cfg.model.backbone.kernel_size, subm_scales=None)
    return {
        "sites": [int(s.nvalid.sum()) for s in scales],
        "subm_pairs": [int((s.subm_idx >= 0).sum()) for s in scales],
        "down_pairs": [int((s.down_idx >= 0).sum()) for s in scales[:-1]],
    }


def useful_forward_flops(cfg: Config, stats: Dict[str, List[int]]) -> float:
    """Sparse-equivalent forward FLOPs per batch from measured rulebooks."""
    mc = cfg.model
    ws = mc.backbone.widths
    ns = len(ws)
    bps = mc.backbone.blocks_per_scale
    sites = stats["sites"]
    sp = stats["subm_pairs"]
    dp = stats["down_pairs"]

    def conv(pairs, cin, cout):
        return 2.0 * pairs * cin * cout

    f = 0.0
    # UNet backbone (the dense tail counted as if sparse: the same sums)
    f += conv(sp[0], cfg.data.num_features, ws[0])          # stem
    for s in range(ns):                                      # encoder
        for _ in range(bps):
            f += conv(sp[s], ws[s], ws[s]) * 2               # conv1 + conv2
        if s < ns - 1:
            f += conv(dp[s], ws[s], ws[s + 1])               # down
    for s in range(ns - 2, -1, -1):                          # decoder
        f += conv(dp[s], ws[s + 1], ws[s])                   # up (t(up) = down)
        cin = 2 * ws[s]                                      # skip concat
        f += conv(sp[s], cin, ws[s]) + conv(sp[s], ws[s], ws[s])
        f += conv(sites[s], cin, ws[s])                      # 1-tap proj
        for _ in range(bps - 1):
            f += conv(sp[s], ws[s], ws[s]) * 2

    # RPN heads (per-row MLPs on live rows)
    h = mc.rpn.hidden
    for s in mc.rpn.rpn_scales or (mc.rpn.rpn_scale,):
        f += 2.0 * sites[s] * (ws[s] * h + h * h + h * 7)

    # RoI and mask head (static, dense-padded)
    b = cfg.data.batch_size
    p = mc.rpn.num_proposals
    d3 = mc.roi.grid_size ** 3
    rh = mc.roi.hidden
    rois = float(b * p)
    f += 2.0 * rois * d3 * 27 * (ws[0] * rh + rh * rh)       # conv1 + conv2
    f += 2.0 * rois * d3 * 8 * rh * rh                       # 2x2x2 up
    f += 2.0 * rois * (2 * mc.roi.grid_size) ** 3 * rh       # mask 1x1x1
    f += 2.0 * rois * (rh * rh + rh * (mc.num_classes + 1))  # cls MLP

    # semantic head
    if mc.use_semantic_head:
        f += 2.0 * sites[0] * (ws[0] * 64 + 64 * (mc.num_classes + 1))
    return float(f)
