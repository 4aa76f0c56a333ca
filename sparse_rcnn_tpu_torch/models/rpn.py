"""Region-proposal head: anchor-free per-voxel objectness + 3D boxes
(port of ``models/rpn.py``), followed by static-budget top-k + padded 3D NMS.
The proposal list is always [B, P] with a validity mask."""

from __future__ import annotations

import torch
from torch import nn

from ..config import RPNConfig
from ..ops import nms as nms_ops
from .layers import MLP, Dense


def encode_box_targets(coords: torch.Tensor, gt_boxes: torch.Tensor, box_norm: float,
                       stride: int) -> torch.Tensor:
    """Inverse of the head's decoding: regression targets for matched voxels.

    coords int32[..., 3] (at ``stride``), gt_boxes float[..., 6] → [..., 6]
    (d_center, d_logsize) in the head's normalised parameterisation.
    """
    norm = box_norm * stride
    vc = (coords.to(torch.float32) + 0.5) * stride
    gt_center = (gt_boxes[..., :3] + gt_boxes[..., 3:]) / 2
    gt_size = torch.clamp(gt_boxes[..., 3:] - gt_boxes[..., :3], min=1e-4)
    d_center = (gt_center - vc) / norm
    d_size = torch.log(gt_size / norm)
    return torch.cat([d_center, d_size], dim=-1)


class RPNHead(nn.Module):
    """feats [B, M, C] → (obj_logits [B, M], boxes [B, M, 6], deltas [B, M, 6])."""

    def __init__(self, in_channels: int, cfg: RPNConfig, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.box_norm = cfg.box_norm
        self.stride = stride
        self.trunk = MLP(in_channels, (cfg.hidden, cfg.hidden), dtype=dtype)
        self.pred = Dense(cfg.hidden, 7, dtype=torch.float32)

    def forward(self, feats, coords, mask):
        out = self.pred(self.trunk(feats))
        obj = out[..., 0]
        d_center = out[..., 1:4]
        d_size = torch.clamp(out[..., 4:7], -4.0, 4.0)
        deltas = torch.cat([d_center, d_size], dim=-1)
        norm = self.box_norm * self.stride
        vc = (coords.to(torch.float32) + 0.5) * self.stride     # voxel centers
        center = vc + d_center * norm
        size = torch.exp(d_size) * norm
        boxes = torch.cat([center - size / 2, center + size / 2], dim=-1)
        obj = torch.where(mask, obj, obj.new_full((), -1e9))
        return obj, boxes, deltas


@torch.no_grad()
def select_proposals(obj_logits, boxes, valid, cfg: RPNConfig):
    """Static top-k + NMS per scene → (boxes [B,P,6], scores [B,P], mask [B,P]).

    No gradient flows: proposal geometry is a hard decision.
    """
    # logit of the score threshold, taken in f32 as the JAX package takes it
    thr = torch.log(obj_logits.new_full((), cfg.score_threshold / (1 - cfg.score_threshold),
                                        dtype=torch.float32))
    out_boxes, out_scores, out_mask = [], [], []
    for scores_m, boxes_m, valid_m in zip(obj_logits, boxes, valid):
        vals, idx, mask = nms_ops.topk_rows(scores_m, valid_m, cfg.pre_nms_topk)
        cand = boxes_m[idx.to(torch.int64)]
        keep_idx, keep_mask = nms_ops.nms_3d(
            cand, vals, mask, cfg.nms_iou_threshold, cfg.num_proposals)
        safe = keep_idx.clamp(0, cfg.pre_nms_topk - 1).to(torch.int64)
        p_scores = torch.where(keep_mask, vals[safe], vals.new_full((), float("-inf")))
        p_mask = keep_mask & (p_scores > thr)
        out_boxes.append(cand[safe])
        out_scores.append(torch.where(p_mask, p_scores, vals.new_full((), -1e9)))
        out_mask.append(p_mask)
    return torch.stack(out_boxes), torch.stack(out_scores), torch.stack(out_mask)
