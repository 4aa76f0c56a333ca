"""Frozen copy of ``sparse_rcnn_tpu_torch/ops/nms.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

3D boxes, IoU, top-k and greedy NMS with a fixed budget (port of ``ops/nms.py``).

Boxes are axis-aligned 3D: (x1, y1, z1, x2, y2, z2) in stride-1 voxel units.
Ties are broken as the JAX package breaks them: ``lax.top_k`` and
``jnp.argmax`` both take the lower index first, which a stable descending
sort and ``torch.argmax`` (first maximum) reproduce.
"""

from __future__ import annotations

import torch


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    d = torch.clamp(boxes[..., 3:] - boxes[..., :3], min=0.0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def box_iou_3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [N, 6], b [M, 6] → [N, M]."""
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    union = box_volume(a)[:, None] + box_volume(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_3d(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_threshold: float, max_outputs: int):
    """Greedy NMS with a static output budget.

    boxes [N, 6], scores [N], valid bool[N] → (keep_idx int32[max_outputs]
    (-1 padded), keep_mask bool[max_outputs]).
    """
    n = boxes.shape[0]
    dev = boxes.device
    iou = box_iou_3d(boxes, boxes)
    neg_inf = scores.new_full((), float("-inf"))
    s = torch.where(valid, scores, neg_inf)
    rows = torch.arange(n, device=dev)
    keep_idx = torch.full((max_outputs,), -1, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros((max_outputs,), dtype=torch.bool, device=dev)
    # the winner is a 1-element index: a 0-d tensor index is read on the host
    for i in range(max_outputs):
        best = torch.argmax(s).reshape(1)
        ok = s[best][0] > neg_inf
        keep_idx[i] = torch.where(ok, best[0].to(torch.int32), -1)
        keep_mask[i] = ok
        # suppress the winner and everything overlapping it
        suppress = (iou[best][0] >= iou_threshold) | (rows == best)
        s = torch.where(ok & suppress, neg_inf, s)
    return keep_idx, keep_mask


def topk_rows(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k over valid rows: (values, idx int32[k], mask bool[k]); ties
    keep the lower index first."""
    masked = torch.where(valid, scores, scores.new_full((), float("-inf")))
    vals, idx = torch.sort(masked, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    return vals, idx.to(torch.int32), torch.isfinite(vals)
