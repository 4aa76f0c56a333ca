"""Frozen copy of ``sparse_rcnn_tpu_torch/models/detector.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels; ``select_from``, the proposals
selected from given RPN outputs).

The two-stage detector: backbone → RPN → RoI crop → mask/cls heads
(port of ``models/detector.py``).

Static shapes end to end; every output carries a validity mask. In
training mode (``.train()``) the backbone's BN normalises with batch
statistics, and given GT boxes the forward overwrites the last proposal
slots with them (the JAX package's Fast-R-CNN-style GT injection).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import roi as roi_ops
from ..ops.hierarchy import ScaleSet
from .heads import RoIHead, SemanticHead, sample_mask_at_positions
from .rpn import RPNHead, select_proposals
from .unet import SparseUNet


def expand_boxes(boxes: torch.Tensor, factor: float) -> torch.Tensor:
    center = (boxes[..., :3] + boxes[..., 3:]) / 2
    half = (boxes[..., 3:] - boxes[..., :3]) / 2 * factor
    return torch.cat([center - half, center + half], dim=-1)


class SparseRCNN(nn.Module):
    """Flagship model. Returns a dict of raw head outputs."""

    def __init__(self, cfg: ModelConfig, in_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = SparseUNet(
            in_channels, bb.widths, bb.blocks_per_scale, bb.kernel_size, dtype,
            dense_from_scale=bb.dense_from_scale, grid_extent=bb.grid_extent,
            remat=bb.remat, downsample=bb.downsample, dropout=bb.dropout)
        self.rpn_scales = tuple(cfg.rpn.rpn_scales or (cfg.rpn.rpn_scale,))
        for s in self.rpn_scales:
            name = "rpn" if s == self.rpn_scales[0] else f"rpn_s{s}"
            self.add_module(name, RPNHead(bb.widths[s], cfg.rpn, stride=1 << s,
                                          dtype=dtype))
        self.roi_head = RoIHead(bb.widths[0], cfg.roi, cfg.num_classes, dtype)
        self.semantic = (SemanticHead(bb.widths[0], cfg.num_classes)
                         if cfg.use_semantic_head else None)

    def forward(self, feats: torch.Tensor, scales: List[ScaleSet],
                gt_boxes: Optional[torch.Tensor] = None,
                gt_boxes_valid: Optional[torch.Tensor] = None,
                generators: Optional[Sequence[torch.Generator]] = None,
                select_from: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> Dict[str, torch.Tensor]:
        """``generators``: the sources of the backbone's dropout masks in
        training mode, one per scene."""
        outs = self.backbone(feats, scales, generators)
        return self.heads(outs, scales, gt_boxes, gt_boxes_valid, select_from)

    def heads(self, outs: List[torch.Tensor], scales: List[ScaleSet],
              gt_boxes: Optional[torch.Tensor] = None,
              gt_boxes_valid: Optional[torch.Tensor] = None,
              select_from: Optional[Tuple[torch.Tensor, ...]] = None
              ) -> Dict[str, torch.Tensor]:
        """Everything after the backbone, on its per-scale outputs ``outs``.
        ``gt_boxes`` [B, I, 6] and ``gt_boxes_valid`` bool[B, I] are
        injected into the proposals in training mode only. ``select_from``
        (objectness [B, M], boxes [B, M, 6], valid [B, M], the scales
        concatenated) replaces this model's own RPN outputs as what the
        proposals are selected from."""
        cfg = self.cfg
        rpn_obj, rpn_boxes, rpn_deltas, rpn_masks = [], [], [], []
        for s in self.rpn_scales:
            head = getattr(self, "rpn" if s == self.rpn_scales[0] else f"rpn_s{s}")
            smask = scales[s].row_mask
            obj_s, boxes_s, deltas_s = head(outs[s], scales[s].coords, smask)
            rpn_obj.append(obj_s)
            rpn_boxes.append(boxes_s)
            rpn_deltas.append(deltas_s)
            rpn_masks.append(smask)

        # pool candidates across scales before top-k + NMS
        if select_from is None:
            select_from = (torch.cat(rpn_obj, 1), torch.cat(rpn_boxes, 1),
                           torch.cat(rpn_masks, 1))
        props, scores, pmask = select_proposals(*select_from, cfg.rpn)
        if self.training and gt_boxes is not None:
            # Fast-R-CNN-style GT injection: overwrite the lowest-scored
            # proposal slots with GT boxes so the RoI heads see foreground
            # from step 0
            p = props.shape[1]
            n_inject = min(gt_boxes.shape[1], p // 2)
            gtb, gtv = gt_boxes[:, :n_inject], gt_boxes_valid[:, :n_inject]
            keep = p - n_inject
            props = torch.cat([props[:, :keep], gtb], dim=1)
            scores = torch.cat([scores[:, :keep], torch.where(gtv, 0.0, -1e9)], dim=1)
            pmask = torch.cat([pmask[:, :keep], gtv], dim=1)
        crop_boxes = expand_boxes(props, cfg.roi.expand)
        roi_feats = torch.stack([
            roi_ops.roi_crop(c, n, f, bx, cfg.roi.grid_size, stride=1)
            for c, n, f, bx in zip(scales[0].coords, scales[0].nvalid, outs[0],
                                   crop_boxes)])
        cls_logits, mask_logits = self.roi_head(roi_feats)
        out = {
            "rpn_obj": tuple(rpn_obj),         # each [B, M_s]
            "rpn_deltas": tuple(rpn_deltas),   # each [B, M_s, 6]
            "rpn_mask": tuple(rpn_masks),      # each [B, M_s]
            "rpn_boxes": tuple(rpn_boxes),     # each [B, M_s, 6]
            "proposals": props,                # [B, P, 6]
            "proposal_scores": scores,         # [B, P]
            "proposal_mask": pmask,            # [B, P]
            "crop_boxes": crop_boxes,          # [B, P, 6] (mask grid frame)
            "cls_logits": cls_logits,          # [B, P, K+1]
            "mask_logits": mask_logits,        # [B, P, G, G, G]
            "backbone_finest": outs[0],        # [B, M0, C0]
        }
        if self.semantic is not None:
            out["semantic_logits"] = self.semantic(outs[0])
        return out


def paint_instance_masks(outputs: Dict[str, torch.Tensor], scales: List[ScaleSet],
                         masked: bool = True, keep: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-proposal mask logits at every stride-1 voxel center.

    Returns (voxel_mask_logits [B, P, M0], inside bool[B, P, M0]). With
    ``masked=True`` (inference) voxels outside the crop box get -1e9; with
    ``masked=False`` the raw sampled logits are returned (the training loss
    weights outside voxels to zero instead: the same sampling path, so train
    and eval see the same mask geometry). ``keep`` (bool [B, P, M0], None:
    every entry): the entries whose cotangent may be other than 0, passed to
    the read (``ops/index_grad.py::mask_read``); the training loss passes
    the entries it weights.
    """
    centers = scales[0].coords.to(torch.float32) + 0.5
    keeps = [None] * centers.shape[0] if keep is None else keep
    per = [sample_mask_at_positions(ml, bx, c, k) for ml, bx, c, k in
           zip(outputs["mask_logits"], outputs["crop_boxes"], centers, keeps)]
    logits = torch.stack([p[0] for p in per])
    inside = torch.stack([p[1] for p in per])
    if masked:
        logits = torch.where(inside, logits, logits.new_full((), -1e9))
    return logits, inside
