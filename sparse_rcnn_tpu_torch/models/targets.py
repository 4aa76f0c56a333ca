"""Target assignment (port of ``models/targets.py``): static shapes, masked.

Instance boxes derive from instance point labels (min/max extent, see
:mod:`..data.gt`), and the per-voxel instance id at the stride-1 table is
carried through voxelization, so RPN positives are exact ("a voxel belongs
to instance i"), while RoI matching uses 3D IoU against GT boxes. The JAX
``vmap`` over scenes becomes a loop over B.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ModelConfig
from ..ops import nms as nms_ops
from .rpn import encode_box_targets


@dataclasses.dataclass(frozen=True)
class SceneGT:
    """Padded ground truth for a batch of scenes.

    boxes:          float[B, I, 6] instance AABBs, stride-1 voxel units.
    classes:        int32[B, I] semantic class per instance (-1 = pad).
    valid:          bool[B, I].
    voxel_instance: int32[B, M0] instance index per stride-1 voxel (-1 none).
    voxel_semantic: int32[B, M0] semantic class per voxel (-1 = unlabeled).
    """

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    voxel_instance: torch.Tensor
    voxel_semantic: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RPNTargets:
    objectness: torch.Tensor   # float[B, M] 0/1
    obj_weight: torch.Tensor   # float[B, M] (0 on padding rows)
    box_deltas: torch.Tensor   # float[B, M, 6]
    box_weight: torch.Tensor   # float[B, M] (1 on positive rows)


@dataclasses.dataclass(frozen=True)
class RoITargets:
    cls: torch.Tensor          # int32[B, P] target class (num_classes = background)
    cls_weight: torch.Tensor   # float[B, P]
    mask: torch.Tensor         # float[B, P, M0] matched-instance membership per voxel
    mask_weight: torch.Tensor  # float[B, P, M0] (live voxel ∧ inside box ∧ fg proposal)
    matched_gt: torch.Tensor   # int32[B, P] matched instance index (-1 bg)


def rpn_targets(coords: torch.Tensor, row_mask: torch.Tensor, gt: SceneGT,
                box_norm: float, stride: int,
                voxel_instance: Optional[torch.Tensor] = None) -> RPNTargets:
    """Per-voxel RPN targets at one RPN scale: a voxel is positive iff it
    carries an instance id, and regresses to its own instance's box. For
    coarse scales pass ``voxel_instance`` pooled down the hierarchy."""
    inst = voxel_instance if voxel_instance is not None else gt.voxel_instance
    pos = (inst >= 0) & row_mask
    safe = inst.clamp(0, gt.boxes.shape[1] - 1).to(torch.int64)
    matched_box = torch.gather(gt.boxes, 1, safe[..., None].expand(*safe.shape, 6))
    deltas = encode_box_targets(coords, matched_box, box_norm, stride)
    return RPNTargets(
        objectness=pos.to(torch.float32),
        obj_weight=row_mask.to(torch.float32),
        box_deltas=torch.where(pos[..., None], deltas, 0.0),
        box_weight=pos.to(torch.float32),
    )


def roi_targets(proposals: torch.Tensor, proposal_mask: torch.Tensor,
                table_coords: torch.Tensor, table_nvalid: torch.Tensor,
                gt: SceneGT, cfg: ModelConfig, fg_iou: float = 0.25) -> RoITargets:
    """Match proposals to GT boxes (foreground at IoU ≥ ``fg_iou``, first
    maximum on ties); build class and per-voxel mask targets on the actual
    stride-1 voxels inside each foreground proposal's box."""
    num_classes = cfg.num_classes
    per = []
    for props, pmask, tcoords, tnvalid, gboxes, gcls, gvalid, vinst in zip(
            proposals, proposal_mask, table_coords, table_nvalid,
            gt.boxes, gt.classes, gt.valid, gt.voxel_instance):
        iou = nms_ops.box_iou_3d(props, gboxes)                     # [P, I]
        iou = torch.where(gvalid[None, :], iou, -1.0)
        best = torch.argmax(iou, dim=1)
        best_iou = torch.gather(iou, 1, best[:, None])[:, 0]
        fg = (best_iou >= fg_iou) & pmask
        best = best.to(torch.int32)
        matched = torch.where(fg, best, -1)
        cls_t = torch.where(fg, gcls[best.clamp(0, gcls.shape[0] - 1).to(torch.int64)],
                            num_classes)
        m = tcoords.shape[0]
        centers = tcoords.to(torch.float32) + 0.5                    # [M, 3]
        rel = (centers[None, :, :] - props[:, None, :3]) / torch.clamp(
            props[:, None, 3:] - props[:, None, :3], min=1e-6)
        inside = torch.all((rel >= 0.0) & (rel < 1.0), dim=-1)       # [P, M]
        live = torch.arange(m, dtype=torch.int32, device=tcoords.device)[None, :] < tnvalid
        target = (vinst[None, :] == matched[:, None]) & (matched[:, None] >= 0)
        weight = inside & live & fg[:, None]
        per.append((cls_t.to(torch.int32), pmask.to(torch.float32),
                    target.to(torch.float32), weight.to(torch.float32), matched))
    cls_t, cls_w, mask_t, mask_w, matched = (torch.stack(x) for x in zip(*per))
    return RoITargets(cls=cls_t, cls_weight=cls_w, mask=mask_t, mask_weight=mask_w,
                      matched_gt=matched)
