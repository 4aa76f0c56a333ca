"""Frozen copy of parts of ``sparse_rcnn_tpu_torch/train/loop.py`` at commit
4dd78ef, for the benchmark's reference: the device-side front half
(``prepare_inputs``), the eval step's tail (``finish``, ``packbits``), the
losses (``compute_losses``) and the schedule (``make_schedule``), as the port
has them. Written for the benchmark: ``build_model`` (a float32 model unless
the config says otherwise), ``eval_step`` and ``loss_and_grads`` without
the port's dispatch, and :class:`AdamW`, optax's ``clip_by_global_norm`` →
``adamw`` in plain float32 tensor arithmetic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.gt import build_scene_gt
from ..models import losses as L
from ..models.detector import SparseRCNN, paint_instance_masks
from ..models.targets import roi_targets, rpn_targets
from ..ops import hierarchy as H
from ..ops.consts import device_tensor
from ..ops import voxelize as V
from ..sparse import make_sparse_tensor


BATCH_KEYS = ("points", "feats", "valid")
TRAIN_KEYS = BATCH_KEYS + ("point_instance", "point_semantic")


def prepare_inputs(cfg: Config, batch: Dict[str, torch.Tensor]):
    """Device-side front half: voxelize → rebase → hierarchy → GT. A batch
    that carries the host voxelizer's tables (``data/pipeline.py::
    VOXEL_KEYS``) skips the voxelize: they are the same tables.

    Returns (SparseTensor, p2v [B, N], scales, gt, aux). ``gt`` is a
    :class:`~..models.targets.SceneGT` when the batch carries the point
    labels (``point_instance``, ``point_semantic``), else None; ``aux``
    holds the overflow counters (tensors on the batch's device), with a
    dense tail also ``dense_tail_oob``: the live sites of its first scale
    that fall outside the grid and are dropped from it.
    """
    if "voxel_coords" in batch:
        st = make_sparse_tensor(batch["voxel_coords"], batch["voxel_feats"],
                                batch["voxel_nvalid"], assume_sorted=True)
        p2v, ovf = batch["p2v"], batch["voxel_overflow"]
    else:
        st, p2v, ovf = V.voxelize_batch(
            batch["points"], batch["feats"], batch["valid"], cfg.data.voxel_size,
            cfg.data.voxel_capacity)
    # integer per-scene rebase to non-negative coords: exact, and the frame
    # the dense tail and the GT boxes use
    st, base = V.rebase_coords(st, margin=2)
    bb = cfg.model.backbone
    dfs = bb.dense_from_scale
    scales, hovf = H.build_hierarchy(
        st, len(bb.widths), cfg.scale_capacities(), bb.kernel_size, subm_scales=dfs)
    aux = {
        "voxel_overflow": ovf.sum(),
        "hierarchy_overflow": hovf.sum(),
        "voxels_per_scene": st.nvalid.to(torch.float32).mean(),
    }
    if dfs is not None:
        # a site outside the grid at the tail's first scale is outside at
        # every deeper scale too
        sc = scales[dfs]
        ext = device_tensor([e >> dfs for e in bb.grid_extent], torch.int32,
                            sc.coords.device)
        inside = ((sc.coords >= 0) & (sc.coords < ext)).all(-1)
        aux["dense_tail_oob"] = (sc.row_mask & ~inside).sum()
    gt = None
    if "point_instance" in batch:
        gt = build_scene_gt(
            batch["points"], batch["valid"], batch["point_instance"],
            batch["point_semantic"], p2v, cfg.data.voxel_capacity,
            cfg.data.voxel_size, cfg.model.max_instances, base=base)
        # points whose instance id does not fit max_instances: dropped from
        # the GT boxes, and counted
        aux["gt_instance_overflow"] = (
            batch["valid"] & (batch["point_instance"] >= cfg.model.max_instances)).sum()
    return st, p2v, scales, gt, aux


def finish(cfg: Config, out: Dict[str, torch.Tensor], scales, p2v) -> Dict[str, torch.Tensor]:
    """The tail of the eval step: masks painted on voxels, then on points."""
    vox_logits, _ = paint_instance_masks(out, scales)
    point_logits = V.devoxelize(vox_logits.transpose(1, 2), p2v, fill_value=-1e9)
    result = {
        "proposal_scores": out["proposal_scores"],
        "proposal_mask": out["proposal_mask"],
        "cls_logits": out["cls_logits"],
        "point_mask_logits": point_logits.transpose(1, 2),   # [B, P, N]
    }
    if cfg.model.use_semantic_head:
        sem_pred = out["semantic_logits"].argmax(-1).to(torch.int32)
        result["point_semantic_pred"] = V.devoxelize(sem_pred, p2v, fill_value=-1)
    return result


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """``np.packbits(mask, axis=-1)`` on the tensor's device: bool [..., N] →
    uint8 [..., ceil(N / 8)], the first of each 8 in the most significant
    bit, N padded with False."""
    n = mask.shape[-1]
    mask = torch.nn.functional.pad(mask, (0, -n % 8))
    weights = device_tensor([128, 64, 32, 16, 8, 4, 2, 1], torch.uint8, mask.device)
    return (mask.reshape(*mask.shape[:-1], -1, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)


def train_cfg(cfg: Config) -> Config:
    """The config the train step runs with: the per-mode tail boundary
    ``backbone.dense_from_scale_train``, when set, replaces the eval form's
    ``dense_from_scale``. Weights live in this train form; :func:`eval_model`
    converts them to the eval form. Idempotent."""
    bb = cfg.model.backbone
    t = bb.dense_from_scale_train
    if t is None or t == bb.dense_from_scale:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(bb, dense_from_scale=t)))


def pool_instance_labels(gt, scales, max_level: Optional[int] = None) -> List[torch.Tensor]:
    """Per-scale voxel instance ids: max over each coarse voxel's children,
    for levels [0, max_level]."""
    n = len(scales) - 1 if max_level is None else max_level
    levels = [gt.voxel_instance]
    for s in range(n):
        idx = scales[s].down_idx                       # [B, 8, M_{s+1}]
        prev = levels[-1]                              # [B, M_s]
        safe = idx.clamp(0, prev.shape[1] - 1).to(torch.int64)
        rows = torch.gather(prev[:, None, :].expand(-1, idx.shape[1], -1), 2, safe)
        levels.append(torch.where(idx >= 0, rows, -1).amax(dim=1))
    return levels


def compute_losses(cfg: Config, out, scales, gt, row_mask):
    """(total, parts) of the JAX ``compute_losses``; the RoI targets match
    the crop boxes, as in the JAX package."""
    rpn_scales = cfg.model.rpn.rpn_scales or (cfg.model.rpn.rpn_scale,)
    inst_levels = pool_instance_labels(gt, scales, max_level=max(rpn_scales))
    obj_l = box_l = 0.0
    for i, s in enumerate(rpn_scales):
        rt = rpn_targets(scales[s].coords, out["rpn_mask"][i], gt,
                         cfg.model.rpn.box_norm, 1 << s, voxel_instance=inst_levels[s])
        o, bx = L.rpn_loss(out["rpn_obj"][i], out["rpn_deltas"][i], rt)
        obj_l = obj_l + o / len(rpn_scales)
        box_l = box_l + bx / len(rpn_scales)
    tt = roi_targets(out["crop_boxes"], out["proposal_mask"], scales[0].coords,
                     scales[0].nvalid, gt, cfg.model)
    # the mask loss at the actual voxels, through the inference sampling path;
    # its cotangent is 0 where the loss weights a voxel by 0, so the read's
    # backward adds only the weighted entries
    voxel_mask_logits, _ = paint_instance_masks(out, scales, masked=False,
                                                keep=tt.mask_weight > 0)
    parts = {
        "rpn_obj": obj_l,
        "rpn_box": box_l,
        "roi_cls": L.roi_cls_loss(out["cls_logits"], tt),
        "roi_mask": L.roi_mask_loss(voxel_mask_logits, tt),
    }
    if cfg.model.use_semantic_head:
        parts["semantic"] = L.semantic_loss(out["semantic_logits"], gt.voxel_semantic,
                                            row_mask, cfg.model.num_classes)
    return L.total_loss(parts, cfg.train.loss_weights), parts


def make_schedule(cfg: Config):
    """optax ``warmup_cosine_decay_schedule`` from 0 to ``lr`` and down to
    ``lr · 0.01``, counted in optimizer updates (micro-steps / k), in f32."""
    k = max(1, cfg.train.grad_accum_steps)
    total = max(cfg.train.total_steps // k, 1)
    warmup = min(cfg.train.warmup_steps // k, max(total // 10, 0))
    decay = max(total, warmup + 1) - warmup
    peak, end = cfg.train.lr, cfg.train.lr * 0.01
    alpha = np.float32(0.0 if peak == 0.0 else end / peak)
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup:          # linear_schedule(0 → peak, warmup)
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak) * ((f32(1) - alpha) * cosine + alpha))
    return schedule




def as_float32(cfg: Config) -> Config:
    """The config with the backbone computing in float32."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(cfg.model.backbone, dtype="float32")))


def build_model(cfg: Config, device) -> SparseRCNN:
    """The detector of ``cfg`` on ``device``, its weights unset (load them)."""
    dtype = torch.bfloat16 if cfg.model.backbone.dtype == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = SparseRCNN(cfg.model, cfg.data.num_features, dtype)
    return model.to_empty(device=device)


@torch.no_grad()
def eval_step(cfg: Config, model, batch: Dict[str, torch.Tensor], select_from=None):
    """The eval step's outputs for ``batch`` (points, feats, valid): model
    outputs, point mask logits [B, P, N] and their packed bits, and the RPN
    heads' per-scale outputs (``rpn_obj``, ``rpn_boxes``, ``rpn_deltas``,
    ``rpn_mask``). ``select_from``: see ``SparseRCNN.heads``."""
    st, p2v, scales, gt, aux = prepare_inputs(cfg, batch)
    out = model.eval()(st.feats, scales, select_from=select_from)
    result = finish(cfg, out, scales, p2v)
    result["point_mask_bits"] = packbits(result["point_mask_logits"] > 0)
    result.update(aux)
    result.update({k: out[k] for k in ("rpn_obj", "rpn_boxes", "rpn_deltas", "rpn_mask")})
    return result


def loss_and_grads(cfg: Config, model, batch: Dict[str, torch.Tensor]):
    """Forward in training mode (batch statistics, GT injection), the losses
    and every parameter's gradient (zeros where none flows)."""
    cfg = train_cfg(cfg)
    st, _, scales, gt, aux = prepare_inputs(cfg, batch)
    model.train()
    out = model(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
    total, parts = compute_losses(cfg, out, scales, gt, st.row_mask)
    params = list(model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads, aux


class AdamW:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr_t, 0.9, 0.999, 1e-8,
    weight_decay))`` over a list of float32 tensors, the schedule read at
    the count before each update. :meth:`step` returns the clipped
    gradients it applied."""

    def __init__(self, cfg: Config, params: List[torch.Tensor]):
        self.schedule = make_schedule(cfg)
        self.clip, self.wd = cfg.train.grad_clip, cfg.train.weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        norm = torch.sqrt(sum(torch.sum(g.to(torch.float64) ** 2) for g in grads))
        factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = [g * factor.to(g.dtype) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - 0.9 ** self.count
        bc2 = 1.0 - 0.999 ** self.count
        for p, g, m, v in zip(params, grads, self.mu, self.nu):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).add_(g * g, alpha=0.001)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) + self.wd * p
            p.add_(upd, alpha=-lr)
        return grads, float(norm)
