"""Frozen copy of ``sparse_rcnn_tpu_torch/models/losses.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Loss functions (port of ``models/losses.py``): RPN BCE + box L1, RoI CE,
mask BCE, semantic CE.

All losses are masked means over static-shape tensors; weights come from
``TrainConfig.loss_weights`` = (rpn_obj, rpn_box, roi_cls, roi_mask), and the
semantic term is added unweighted. The two cross entropies are optax's
formulas: ``sigmoid_binary_cross_entropy`` in log-sigmoid form and
``softmax_cross_entropy_with_integer_labels`` as logsumexp minus the label
logit.

Under data parallel (:func:`..parallel.context.shard_context`) each
masked mean divides this rank's ``Σ x·w`` by the global ``Σ w``, so the
global batch's loss is the sum of the ranks' terms, as under JAX's GSPMD.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from ..parallel import context as DPC
from .targets import RoITargets, RPNTargets


def masked_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σ x·w / max(Σ w, 1)``; under data parallel ``Σ w`` is the global
    batch's (the weights are targets: no gradient flows through them)."""
    world = DPC.current()
    if world is None:
        return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)
    count = DPC.all_reduce_(torch.sum(w).detach(), world)
    return torch.sum(x * w) / torch.clamp(count, min=1.0)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor,
                                              labels: torch.Tensor) -> torch.Tensor:
    label_logits = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def rpn_loss(obj_logits: torch.Tensor, deltas: torch.Tensor,
             t: RPNTargets) -> Tuple[torch.Tensor, torch.Tensor]:
    """(objectness BCE, box L1 on the head's normalised deltas)."""
    obj = masked_mean(sigmoid_binary_cross_entropy(obj_logits, t.objectness), t.obj_weight)
    box = masked_mean(torch.sum(torch.abs(deltas - t.box_deltas), dim=-1), t.box_weight)
    return obj, box


def roi_cls_loss(cls_logits: torch.Tensor, t: RoITargets) -> torch.Tensor:
    return masked_mean(softmax_cross_entropy_with_integer_labels(cls_logits, t.cls),
                       t.cls_weight)


def roi_mask_loss(voxel_mask_logits: torch.Tensor, t: RoITargets) -> torch.Tensor:
    """BCE at the stride-1 voxels inside each fg proposal ([B, P, M0])."""
    return masked_mean(sigmoid_binary_cross_entropy(voxel_mask_logits, t.mask),
                       t.mask_weight)


def semantic_loss(sem_logits: torch.Tensor, voxel_semantic: torch.Tensor,
                  row_mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    labeled = (voxel_semantic >= 0) & row_mask
    safe = torch.clamp(voxel_semantic, 0, num_classes)
    ce = softmax_cross_entropy_with_integer_labels(sem_logits, safe)
    return masked_mean(ce, labeled.to(torch.float32))


def total_loss(parts: Dict[str, torch.Tensor], weights) -> torch.Tensor:
    w_obj, w_box, w_cls, w_mask = weights
    total = (w_obj * parts["rpn_obj"] + w_box * parts["rpn_box"]
             + w_cls * parts["roi_cls"] + w_mask * parts["roi_mask"])
    if "semantic" in parts:
        total = total + parts["semantic"]
    return total
