"""Evaluation over a split (port of ``sparse_rcnn_tpu/train/evaluate.py``):
run the eval batches, post-process each scene on the host and score
instance mAP on points (predictions are devoxelized to points before
scoring), with the semantic head's mIoU when it is on."""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import device_batches
from ..parallel import context as DPC
from ..parallel import data_parallel as DP
from ..utils.metrics import InstanceAPEvaluator, SemanticMIoUEvaluator
from ..utils.profiling import count, span
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
    other than 0.5 post-processes the step's own output instead. Span:
    ``fetch``."""
    with span("fetch"):
        host = {k: v.cpu().numpy() for k, v in out.items() if k not in _NOT_FETCHED}
        host["point_mask_n"] = int(out["point_mask_logits"].shape[-1])
        return host


def _scene_slice(out: Dict[str, np.ndarray], batch: Dict[str, np.ndarray], b: int):
    """Scene ``b`` of fetched eval outputs (a batch of one; scalars as they
    are) and its point labels (valid, instance, semantic)."""
    o = {k: (v[b:b + 1] if np.ndim(v) else v) for k, v in out.items()}
    labels = tuple(np.asarray(batch[k][b]) for k in ("valid", "point_instance",
                                                     "point_semantic"))
    return o, labels


def postprocess_scene(out: Dict[str, np.ndarray], b: int, num_classes: int,
                      mask_threshold: float = 0.5):
    """Per-scene predictions for the evaluator from eval-step outputs (host
    numpy arrays): (masks bool[P, N], scores [P], pred_cls [P], pmask [P]).
    At the default threshold the masks come from the bit-packed path when
    the outputs carry it. Span: ``postprocess``."""
    with span("postprocess"):
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
    """Score ``loader``'s batches (dicts of numpy arrays, as an eval
    :class:`~..data.pipeline.Loader` yields them) with ``source``, a model or
    a :class:`~.loop.TrainState` (its EMA weights when ``train.ema > 0``; see
    :func:`~.loop.eval_model`), on the device of its parameters, where the
    batches go by :func:`~..data.pipeline.device_batches`.

    ``num_scenes`` (the split's size; by default ``len(loader.dataset)``)
    makes the wrap-padded tail of the last batch score each scene exactly
    once. GT classes come from the raw point labels, so a scene with more
    instances than ``model.max_instances`` still scores all of them.

    One batch of lookahead, as the JAX package's ``run_eval``: the eval step
    of batch i+1 is queued on the card (:func:`~.loop.eval_step` reads
    nothing back on the host, so it returns before the card is done), then
    batch i is scored on the host while the card runs, then the host waits
    for step i+1 and fetches its outputs. The step's device outputs (the
    [B, P, N] f32 logits among them) are dropped right after the fetch,
    before the next step is queued, so the card never holds two of them.
    The scenes are scored in batch order, so the evaluators add them up as
    a strictly sequential pass would. On the CPU the step is synchronous and
    the same loop runs one batch after the other.

    Returns the evaluator's mAP dict (``per_class``: AP@t per class id),
    with ``per_scene`` the per-scene mAP@0.5 list (None for a scene with no
    scoreable GT) and its mean, std, min and max; ``semantic_mIoU`` and
    ``semantic_acc`` with the semantic head; ``scenes``; and the pass's
    seconds: ``eval_wall_s`` in all, ``eval_dev_s`` the waits for the card
    left over after scoring (the device time not hidden behind the host;
    all of each step on the CPU), ``eval_fetch_s`` the copies to the host,
    ``eval_host_s`` the scoring. A well overlapped pass has ``eval_wall_s``
    near ``eval_dev_s + eval_fetch_s`` plus the host's work to queue the
    steps and to score the last batch. The last three are the summed
    durations of the pass's spans ``eval.wait`` (on the CPU around the
    step itself), ``eval.fetch`` and ``eval.score`` (with ``postprocess``,
    ``add_scene`` and ``semantic`` under it); ``eval_compute_s``, the
    evaluators' final ``compute``, is the duration of the span
    ``eval.compute``.

    Under data parallel (:func:`..parallel.context.shard_context`, with
    ``loader`` a rank's share of each global batch) every rank runs the
    eval step on its slots and fetches them to the host, where rank 0
    gathers the scenes in global order with the fetch and scores them once,
    one batch behind, as one process scores the whole batches; every rank
    returns rank 0's result (its times are rank 0's).
    """
    t_pass = time.perf_counter()
    world = DPC.current()
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
    t_dev = t_fetch = t_host = 0      # ns, the spans' durations summed

    def score(scenes) -> None:
        """Add one fetched batch's scenes, (global index, (outputs, labels)),
        to the evaluators."""
        nonlocal seen, semantic, t_host
        with span("eval.score") as s:
            for g, (o, labels) in scenes:
                if num_scenes is not None and g >= num_scenes:
                    continue       # a wrap-pad duplicate of a scene already scored
                masks, scores, pred_cls, pmask = postprocess_scene(
                    o, 0, cfg.model.num_classes)
                point_valid, pinst, psem = labels
                with span("add_scene"):
                    gt_cls = _gt_classes_from_points(pinst, psem, point_valid)
                    ev.add_scene(masks, scores, pred_cls, pmask, pinst, gt_cls, point_valid)
                if "point_semantic_pred" in o:
                    semantic = True
                    with span("semantic"):
                        sem_ev.add(np.asarray(o["point_semantic_pred"][0])[point_valid],
                                   psem[point_valid])
                seen += 1
                count("scenes")
        t_host += s.ns

    pending = None     # the scenes of the batch before, fetched (rank 0's, gathered)
    batches = loader if max_batches is None else itertools.islice(loader, max_batches)
    for bi, (batch, dev) in enumerate(device_batches(batches, device, TL.BATCH_KEYS)):
        if device.type == "cuda":
            raw = TL.eval_step(cfg, model, dev)      # queued; the card starts on it
            # the end of this step on its stream: not of device_batches'
            # copies of the next batch, which run on a stream of their own
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        else:
            with span("eval.wait") as s:             # the step runs inside the call
                raw = TL.eval_step(cfg, model, dev)
            t_dev += s.ns
        if pending is not None:
            score(pending)   # on the host while the card runs step bi
        if device.type == "cuda":
            with span("eval.wait") as s:
                done.synchronize()
            t_dev += s.ns
        with span("eval.fetch") as s:
            out = fetch_eval_outputs(raw)
            del raw              # drop the device outputs before the next step
            local = len(batch["valid"])
            first = bi * bs + (0 if world is None else world.rank * local)
            pending = [(first + b, _scene_slice(out, batch, b)) for b in range(local)]
            if world is not None:
                ranks = DP.gather_to_rank0(pending, world)
                pending = [] if ranks is None else [x for r in ranks for x in r]
        t_fetch += s.ns
    if pending is not None:
        score(pending)
    if world is not None and world.rank != 0:
        return DP.broadcast_from_rank0(None, world)
    with span("eval.compute") as s:
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
    res["eval_dev_s"] = t_dev / 1e9
    res["eval_fetch_s"] = t_fetch / 1e9
    res["eval_host_s"] = t_host / 1e9
    res["eval_compute_s"] = s.ns / 1e9
    if world is not None:
        DP.broadcast_from_rank0(res, world)
    return res
