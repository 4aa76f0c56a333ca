"""3D instance-segmentation mAP and semantic mIoU evaluators (the port's
copy of ``sparse_rcnn_tpu/utils/metrics.py``).

ScanNet-protocol average precision over per-point instance masks: greedy
score-ordered matching of predictions to GT instances of the same class at
an IoU threshold, then class-wise AP (all-point interpolation), averaged.
Host-side numpy, as in the JAX package, whose module the port may not
import: the classes below are that code as it is, so the two packages give
equal numbers on equal predictions (``tests/test_torch_metrics.py``).
``InstanceAPEvaluator.add_scene_counts`` is the port's own: a scene given
by its prediction x GT overlap counts, made on the card, instead of its
per-point masks, scored to the same numbers.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


class SemanticMIoUEvaluator:
    """Per-class IoU / mIoU over labeled voxels or points (aux semantic head)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self._conf = np.zeros((num_classes, num_classes), np.int64)

    def add(self, pred: np.ndarray, label: np.ndarray) -> None:
        """pred int[N] predicted class, label int[N] (-1 = unlabeled)."""
        keep = (label >= 0) & (label < self.num_classes) & (pred >= 0) & (
            pred < self.num_classes
        )
        idx = label[keep] * self.num_classes + pred[keep]
        self._conf += np.bincount(
            idx, minlength=self.num_classes ** 2
        ).reshape(self.num_classes, self.num_classes)

    def compute(self) -> Dict[str, float]:
        tp = np.diag(self._conf).astype(np.float64)
        denom = self._conf.sum(0) + self._conf.sum(1) - tp
        present = denom > 0
        iou = np.where(present, tp / np.maximum(denom, 1), np.nan)
        return {
            "mIoU": float(np.nanmean(iou)) if present.any() else 0.0,
            "accuracy": float(tp.sum() / max(self._conf.sum(), 1)),
        }


class InstanceAPEvaluator:
    """Accumulate scenes, then compute mAP at given IoU thresholds.

    With ``average_band`` (default, the ScanNet benchmark protocol) the
    result also carries ``"mAP"``: AP averaged over the IoU band
    0.5:0.95:0.05, next to the fixed-threshold ``mAP@0.25`` / ``mAP@0.5``.
    Matching cost is amortized: the per-scene pred x gt IoU matrix is
    computed once (one matmul, or from the counts of
    :meth:`add_scene_counts`) and every threshold replays the greedy
    score-ordered matching from it.
    """

    BAND = tuple(round(0.5 + 0.05 * i, 2) for i in range(10))

    def __init__(self, num_classes: int,
                 iou_thresholds: Sequence[float] = (0.25, 0.5),
                 average_band: bool = True):
        self.num_classes = num_classes
        self.iou_thresholds = tuple(iou_thresholds)
        self.average_band = average_band
        self._preds: List[dict] = []  # per scene

    def add_scene(
        self,
        pred_masks: np.ndarray,     # bool [P, N] per-point masks
        pred_scores: np.ndarray,    # [P]
        pred_classes: np.ndarray,   # int [P]
        pred_valid: np.ndarray,     # bool [P]
        gt_instance: np.ndarray,    # int [N] per-point instance id (-1 none)
        gt_classes: np.ndarray,     # int [I] class per instance id
        point_valid: np.ndarray,    # bool [N]
    ) -> None:
        self._preds.append(
            dict(
                pred_masks=pred_masks[:, point_valid],
                pred_scores=pred_scores, pred_classes=pred_classes,
                pred_valid=pred_valid,
                gt_instance=gt_instance[point_valid], gt_classes=gt_classes,
            )
        )

    def add_scene_counts(
        self,
        inter: np.ndarray,          # int [P, W] points of pred p and GT id g, valid
        pred_sum: np.ndarray,       # int [P] valid points of pred p
        gt_sum: np.ndarray,         # int [W] valid points of GT id g
        pred_scores: np.ndarray,    # [P]
        pred_classes: np.ndarray,   # int [P]
        pred_valid: np.ndarray,     # bool [P]
        gt_classes: np.ndarray,     # int [I] class per instance id
    ) -> None:
        """:meth:`add_scene` from the scene's overlap counts instead of its
        per-point masks (``train/evaluate.py::overlap_counts``, over the
        valid points; W above every GT id at a valid point). The GT
        instances are the ids with ``gt_sum > 0``; the scene's cache is the
        one :meth:`_scene_cache` makes from the masks, number for number:
        the counts are the integers its matmul and sums give."""
        gt_ids = np.flatnonzero(gt_sum > 0)
        keep = self._keep(pred_scores, pred_classes, pred_valid)
        self._preds.append(dict(cache=self._cache(
            pred_scores, pred_classes, keep, gt_classes, gt_ids,
            inter[np.ix_(keep, gt_ids)].astype(np.float32),
            pred_sum[keep].astype(np.float32), gt_sum[gt_ids].astype(np.float32))))

    def _keep(self, pred_scores, pred_classes, pred_valid) -> np.ndarray:
        """The scored predictions, highest score first: valid, of a class
        in range."""
        order = np.argsort(-pred_scores)
        return np.array(
            [p for p in order
             if pred_valid[p] and 0 <= int(pred_classes[p]) < self.num_classes],
            np.int64)

    def _cache(self, pred_scores, pred_classes, keep, gt_classes, gt_ids,
               inter, psum, gsum) -> dict:
        """A scene's matching cache from its kept predictions' and GT
        instances' overlaps (f32 [Q, G]) and sizes (f32 [Q], [G])."""
        gt_classes = np.array([int(gt_classes[g]) for g in gt_ids], np.int64)
        gt_count = defaultdict(int)
        for c in gt_classes:
            if 0 <= c < self.num_classes:
                gt_count[int(c)] += 1
        union = psum[:, None] + gsum[None, :] - inter
        iou = inter / np.maximum(union, 1.0)
        return dict(
            scores=pred_scores[keep], classes=pred_classes[keep].astype(np.int64),
            empty=psum == 0, iou=iou, gt_classes=gt_classes, gt_count=gt_count,
        )

    def _scene_cache(self, scene: dict) -> dict:
        """Score-ordered valid preds + the pred x gt IoU matrix, computed
        once per scene (a single f32 matmul over the point masks) and
        reused by every threshold's matching pass."""
        if "cache" in scene:
            return scene["cache"]
        gt_ids = np.unique(scene["gt_instance"])
        gt_ids = gt_ids[gt_ids >= 0]
        keep = self._keep(scene["pred_scores"], scene["pred_classes"], scene["pred_valid"])
        pm = scene["pred_masks"][keep] if len(keep) else \
            np.zeros((0, scene["gt_instance"].shape[0]), bool)
        n = scene["gt_instance"].shape[0]
        gm = (np.stack([scene["gt_instance"] == g for g in gt_ids])
              if len(gt_ids) else np.zeros((0, n), bool))
        inter = pm.astype(np.float32) @ gm.astype(np.float32).T  # [Q, G]
        scene["cache"] = self._cache(
            scene["pred_scores"], scene["pred_classes"], keep, scene["gt_classes"], gt_ids,
            inter, pm.sum(axis=1).astype(np.float32), gm.sum(axis=1).astype(np.float32))
        return scene["cache"]

    def _match_scene(self, scene: dict, iou_t: float):
        """Returns per-class lists of (score, tp) plus GT counts. Greedy:
        best-IoU unmatched same-class GT per pred, highest score first."""
        cc = self._scene_cache(scene)
        out = defaultdict(list)
        matched = np.zeros(len(cc["gt_classes"]), bool)
        for q in range(len(cc["scores"])):
            c = int(cc["classes"][q])
            score = float(cc["scores"][q])
            if cc["empty"][q]:
                out[c].append((score, 0))
                continue
            cand = (cc["gt_classes"] == c) & ~matched
            ious = np.where(cand, cc["iou"][q], 0.0)
            best_g = int(np.argmax(ious)) if ious.size else -1
            if best_g >= 0 and ious[best_g] > 0 and ious[best_g] >= iou_t:
                matched[best_g] = True
                out[c].append((score, 1))
            else:
                out[c].append((score, 0))
        return out, cc["gt_count"]

    @staticmethod
    def _average_precision(scored: List, n_gt: int) -> float:
        if n_gt == 0:
            return float("nan")
        if not scored:
            return 0.0
        scored = sorted(scored, key=lambda x: -x[0])
        tp = np.cumsum([s[1] for s in scored])
        fp = np.cumsum([1 - s[1] for s in scored])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1)
        # all-point interpolation
        ap, prev_r = 0.0, 0.0
        for i in range(len(scored)):
            ap += (recall[i] - prev_r) * precision[i:].max()
            prev_r = recall[i]
        return float(ap)

    def class_aps(self, iou_t: float) -> Dict[int, float]:
        """AP per class id at one IoU threshold. Classes with no GT in the
        accumulated scenes are omitted (the ScanNet protocol averages over
        present classes only)."""
        per_class = defaultdict(list)
        gt_totals = defaultdict(int)
        for scene in self._preds:
            matches, counts = self._match_scene(scene, iou_t)
            for c, lst in matches.items():
                per_class[c].extend(lst)
            for c, n in counts.items():
                gt_totals[c] += n
        return {
            c: self._average_precision(per_class[c], gt_totals[c])
            for c in range(self.num_classes)
            if gt_totals[c] > 0
        }

    def _map_at(self, iou_t: float) -> float:
        aps = self.class_aps(iou_t)
        return float(np.mean(list(aps.values()))) if aps else 0.0

    def per_scene_map(self, iou_t: float) -> List[float]:
        """mAP@iou_t of each accumulated scene scored ALONE (AP over the
        classes with GT in that scene). The spread across scenes is the
        error bar on the split-level number — a protocol whose mAP moves
        by points when the eval subset changes shows up here as a large
        scene-to-scene std, not as a mystery (round-3 verdict item 1)."""
        out = []
        for scene in self._preds:
            matches, counts = self._match_scene(scene, iou_t)
            aps = [self._average_precision(matches[c], counts[c])
                   for c in range(self.num_classes) if counts[c] > 0]
            out.append(float(np.mean(aps)) if aps else float("nan"))
        return out

    def compute(self, per_class: bool = False) -> Dict[str, float]:
        results = {f"mAP@{t:g}": self._map_at(t) for t in self.iou_thresholds}
        if self.average_band:
            # ScanNet benchmark "AP": the band average over IoU .5:.95:.05
            results["mAP"] = float(np.mean([self._map_at(t) for t in self.BAND]))
        if per_class:
            # ScanNet-style per-class table: AP@t for each fixed threshold
            for t in self.iou_thresholds:
                for c, ap in self.class_aps(t).items():
                    results[f"AP@{t:g}/class{c}"] = float(ap)
        return results
