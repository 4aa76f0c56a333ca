"""Evaluation over a split (port of ``sparse_rcnn_tpu/train/evaluate.py``):
run the eval batches, post-process each scene on the host and score
instance mAP on points (predictions are devoxelized to points before
scoring), with the semantic head's mIoU when it is on."""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..utils.metrics import InstanceAPEvaluator, SemanticMIoUEvaluator
from . import loop as TL

# eval-step outputs that stay on the device: the [B, P, N] f32 logits
# (their booleans travel as point_mask_bits) and the GT struct
_NOT_FETCHED = ("point_mask_logits", "gt")


def _gt_classes_from_points(pinst: np.ndarray, psem: np.ndarray,
                            valid: np.ndarray) -> np.ndarray:
    """Class per GT instance id (index = id) from per-point labels: the max
    semantic label among the instance's valid points (the segment max of
    ``data/gt.py``)."""
    pi = pinst[valid]
    ps = psem[valid]
    keep = pi >= 0
    pi, ps = pi[keep], ps[keep]
    if pi.size == 0:
        return np.zeros((0,), np.int64)
    out = np.full(int(pi.max()) + 1, -1, np.int64)
    np.maximum.at(out, pi, ps)
    return out


def fetch_eval_outputs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy an ``eval_step`` result to the host, selectively.

    The [B, P, N] f32 ``point_mask_logits`` (268 MB a config-2 batch) and
    ``gt`` are not fetched: ``point_mask_bits`` carries the same booleans in
    a 32nd of the bytes. Only the logits' point count is kept, as
    ``point_mask_n``, for the unpack. A caller that needs a mask threshold
    other than 0.5 post-processes the step's own output instead."""
    host = {k: v.cpu().numpy() for k, v in out.items() if k not in _NOT_FETCHED}
    host["point_mask_n"] = int(out["point_mask_logits"].shape[-1])
    return host


def postprocess_scene(out: Dict[str, np.ndarray], b: int, num_classes: int,
                      mask_threshold: float = 0.5):
    """Per-scene predictions for the evaluator from eval-step outputs (host
    numpy arrays): (masks bool[P, N], scores [P], pred_cls [P], pmask [P]).
    At the default threshold the masks come from the bit-packed path when
    the outputs carry it."""
    pmask = np.asarray(out["proposal_mask"][b])
    cls_logits = np.asarray(out["cls_logits"][b])
    cls_prob = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
    cls_prob = cls_prob / cls_prob.sum(-1, keepdims=True)
    fg_prob = cls_prob[:, :num_classes]
    pred_cls = fg_prob.argmax(-1)
    obj = 1 / (1 + np.exp(-np.clip(np.asarray(out["proposal_scores"][b]), -30, 30)))
    scores = fg_prob.max(-1) * obj
    if mask_threshold == 0.5 and "point_mask_bits" in out:
        n = (out["point_mask_n"] if "point_mask_n" in out
             else out["point_mask_logits"].shape[-1])
        masks = np.unpackbits(np.asarray(out["point_mask_bits"][b]), axis=-1)[:, :n] > 0
    else:
        point_logits = np.asarray(out["point_mask_logits"][b])  # [P, N]
        masks = point_logits > np.log(mask_threshold / (1 - mask_threshold))
    return masks, scores, pred_cls, pmask


def run_eval(cfg: Config, source, loader, max_batches: Optional[int] = None,
             num_scenes: Optional[int] = None, per_class: bool = False,
             per_scene: bool = False) -> Dict[str, float]:
    """Score ``loader``'s batches (dicts of numpy arrays, as
    :class:`~..data.pipeline.EvalBatches` yields them) with ``source``, a
    model or a :class:`~.loop.TrainState` (its EMA weights when
    ``train.ema > 0``; see :func:`~.loop.eval_model`), on the device of its
    parameters.

    ``num_scenes`` (the split's size; by default ``len(loader.dataset)``)
    makes the wrap-padded tail of the last batch score each scene exactly
    once. GT classes come from the raw point labels, so a scene with more
    instances than ``model.max_instances`` still scores all of them.

    Returns the evaluator's mAP dict (``per_class``: AP@t per class id),
    with ``per_scene`` the per-scene mAP@0.5 list (None for a scene with no
    scoreable GT) and its mean, std, min and max; ``semantic_mIoU`` and
    ``semantic_acc`` with the semantic head; ``scenes``; and the pass's
    seconds: ``eval_wall_s`` in all, ``eval_dev_s`` from the start of each
    eval step to the device's end of it (host launch work included: the
    step syncs with the host on its way), ``eval_fetch_s`` the copies to the
    host, ``eval_host_s`` the scoring. The batches run and are scored in
    order, one after the other.
    """
    t_pass = time.perf_counter()
    model = TL.eval_model(cfg, source)
    device = next(model.parameters()).device
    bs = cfg.data.batch_size
    ev = InstanceAPEvaluator(cfg.model.num_classes)
    sem_ev = SemanticMIoUEvaluator(cfg.model.num_classes + 1)
    if num_scenes is None:
        ds = getattr(loader, "dataset", None)
        num_scenes = len(ds) if ds is not None else None
    seen = 0
    semantic = False
    t_dev = t_fetch = t_host = 0.0
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        t0 = time.perf_counter()
        raw = TL.eval_step(cfg, model, TL.to_device(batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        out = fetch_eval_outputs(raw)
        del raw
        t2 = time.perf_counter()
        for b in range(bs):
            if num_scenes is not None and bi * bs + b >= num_scenes:
                break          # a wrap-pad duplicate of a scene already scored
            masks, scores, pred_cls, pmask = postprocess_scene(out, b, cfg.model.num_classes)
            point_valid = np.asarray(batch["valid"][b])
            pinst = np.asarray(batch["point_instance"][b])
            psem = np.asarray(batch["point_semantic"][b])
            gt_cls = _gt_classes_from_points(pinst, psem, point_valid)
            ev.add_scene(masks, scores, pred_cls, pmask, pinst, gt_cls, point_valid)
            if "point_semantic_pred" in out:
                semantic = True
                sem_ev.add(np.asarray(out["point_semantic_pred"][b])[point_valid],
                           psem[point_valid])
            seen += 1
        t_dev += t1 - t0
        t_fetch += t2 - t1
        t_host += time.perf_counter() - t2
    res = ev.compute(per_class=per_class)
    if per_scene:
        ps = np.asarray(ev.per_scene_map(0.5), np.float64)
        finite = ps[np.isfinite(ps)]
        if finite.size:
            res["scene_map50_mean"] = float(finite.mean())
            res["scene_map50_std"] = float(finite.std())
            res["scene_map50_min"] = float(finite.min())
            res["scene_map50_max"] = float(finite.max())
        # None for a scene with no scoreable GT: NaN is not JSON
        res["per_scene_mAP@0.5"] = [round(float(x), 4) if np.isfinite(x) else None
                                    for x in ps]
    if semantic:
        sem = sem_ev.compute()
        res["semantic_mIoU"] = sem["mIoU"]
        res["semantic_acc"] = sem["accuracy"]
    res["scenes"] = seen
    res["eval_wall_s"] = time.perf_counter() - t_pass
    res["eval_dev_s"] = t_dev
    res["eval_fetch_s"] = t_fetch
    res["eval_host_s"] = t_host
    return res
