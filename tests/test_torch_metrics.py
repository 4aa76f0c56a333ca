"""The port's evaluators (``sparse_rcnn_tpu_torch/utils/metrics.py``) and GT
class derivation (``train/evaluate.py::_gt_classes_from_points``) against
the JAX package's, on seeded random scenes.

Both are the same numpy code, so every number must be equal, NaN for NaN:
``compute(per_class=True)``, ``class_aps``, ``per_scene_map`` and the
semantic mIoU. The scenes hold predictions that overlap their GT in part,
duplicates of one mask, predictions of the wrong class, empty masks,
invalid proposals, unlabeled points and invalid points.

The port's own path, the scene given by its overlap counts
(``train/evaluate.py::overlap_counts`` on CPU tensors, then
``add_scene_counts``), is held to the same numbers, and the counts to the
evaluator's own f32 matmul and sums bit for bit.
"""

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.train import evaluate as JE
from sparse_rcnn_tpu.utils import metrics as JM
from sparse_rcnn_tpu_torch.train import evaluate as E
from sparse_rcnn_tpu_torch.utils import metrics as M

NUM_CLASSES = 5


def _scene(rng, n=600, n_inst=6, n_pred=16):
    """(pred_masks, scores, classes, pred_valid, gt_instance, gt_classes,
    point_valid) of one random scene."""
    gt_instance = rng.integers(-1, n_inst, n)
    gt_classes = rng.integers(0, NUM_CLASSES, n_inst)
    point_valid = rng.random(n) > 0.1
    masks, classes = [], []
    for _ in range(n_pred):
        kind = rng.integers(0, 4)
        g = rng.integers(0, n_inst)
        m = gt_instance == g
        if kind == 0:                                # GT mask with noise
            m = m ^ (rng.random(n) < 0.05)
        elif kind == 1:                              # a part of it
            m = m & (rng.random(n) < rng.uniform(0.2, 0.9))
        elif kind == 2:                              # random points
            m = rng.random(n) < 0.1
        else:                                        # empty
            m = np.zeros(n, bool)
        masks.append(m)
        c = gt_classes[g] if rng.random() < 0.7 else rng.integers(0, NUM_CLASSES)
        classes.append(c)
    masks.append(masks[0].copy())                    # a duplicate
    classes.append(classes[0])
    masks = np.stack(masks)
    scores = rng.random(len(masks)).astype(np.float32)
    scores[-1] = scores[0]                           # tied with the original
    pred_valid = rng.random(len(masks)) > 0.15
    return (masks, scores, np.asarray(classes), pred_valid, gt_instance, gt_classes,
            point_valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_instance_evaluator_equals_jax(seed):
    rng = np.random.default_rng(seed)
    port, jax_ev = M.InstanceAPEvaluator(NUM_CLASSES), JM.InstanceAPEvaluator(NUM_CLASSES)
    for _ in range(4):
        scene = _scene(rng)
        port.add_scene(*scene)
        jax_ev.add_scene(*scene)
    got, want = port.compute(per_class=True), jax_ev.compute(per_class=True)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("AP@0.5/class") for k in got)
    np.testing.assert_equal(got, want)
    assert 0 < got["mAP@0.25"] < 1                   # the scenes score something
    for t in (0.25, 0.5, 0.75):
        np.testing.assert_equal(port.class_aps(t), jax_ev.class_aps(t))
        np.testing.assert_equal(port.per_scene_map(t), jax_ev.per_scene_map(t))


def test_instance_evaluator_scene_without_gt():
    """A scene with no labeled point: NaN in the per-scene list in both."""
    rng = np.random.default_rng(5)
    scene = list(_scene(rng))
    scene[4] = np.full_like(scene[4], -1)
    port, jax_ev = M.InstanceAPEvaluator(NUM_CLASSES), JM.InstanceAPEvaluator(NUM_CLASSES)
    port.add_scene(*scene)
    jax_ev.add_scene(*scene)
    assert np.isnan(port.per_scene_map(0.5)[0])
    np.testing.assert_equal(port.per_scene_map(0.5), jax_ev.per_scene_map(0.5))
    np.testing.assert_equal(port.compute(per_class=True), jax_ev.compute(per_class=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_semantic_evaluator_equals_jax(seed):
    rng = np.random.default_rng(seed)
    k = NUM_CLASSES + 1
    port, jax_ev = M.SemanticMIoUEvaluator(k), JM.SemanticMIoUEvaluator(k)
    for _ in range(3):
        pred = rng.integers(-1, k + 1, 500)          # out-of-range predictions too
        label = rng.integers(-1, k, 500)
        port.add(pred, label)
        jax_ev.add(pred, label)
    assert port.compute() == jax_ev.compute()


@pytest.mark.parametrize("seed", [0, 1])
def test_gt_classes_from_points_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pinst = rng.integers(-1, 9, 700)
    psem = rng.integers(0, NUM_CLASSES, 700)
    valid = rng.random(700) > 0.2
    got = E._gt_classes_from_points(pinst, psem, valid)
    np.testing.assert_array_equal(got, JE._gt_classes_from_points(pinst, psem, valid))
    assert got.dtype == np.int64
    empty = E._gt_classes_from_points(np.full(5, -1), psem[:5], valid[:5])
    assert empty.shape == (0,)


def _counts(masks, point_valid, gt_instance, width=None):
    """``overlap_counts`` of one scene, as numpy (inter, pred_sum, gt_sum)."""
    if width is None:
        width = E.overlap_width({"point_instance": gt_instance[None],
                                 "valid": point_valid[None]})
    got = E.overlap_counts(torch.from_numpy(masks)[None], torch.from_numpy(point_valid)[None],
                           torch.from_numpy(gt_instance)[None], width)
    return tuple(t[0].numpy() for t in got)


def _scene_cases(rng):
    """Scenes of every kind the counts must score as the masks do: as
    :func:`_scene`; with no labeled point; with instance ids that have gaps
    and reach past a model's ``max_instances`` (64); with classes out of
    range (-1 and ``NUM_CLASSES``); with no valid proposal; with every mask
    empty; with no valid point."""
    plain = list(_scene(rng))
    no_gt = list(_scene(rng))
    no_gt[4] = np.full_like(no_gt[4], -1)
    gaps = list(_scene(rng))
    ids = np.array([0, 3, 4, 9, 70, 17])
    gaps[4] = np.where(gaps[4] >= 0, ids[np.maximum(gaps[4], 0)], -1)
    gaps[5] = np.full(ids.max() + 1, -1)
    gaps[5][ids] = rng.integers(0, NUM_CLASSES, len(ids))
    out_of_range = list(_scene(rng))
    out_of_range[2] = out_of_range[2].copy()
    out_of_range[2][::3] = NUM_CLASSES
    out_of_range[2][1::5] = -1
    no_pred = list(_scene(rng))
    no_pred[3] = np.zeros_like(no_pred[3])
    empty = list(_scene(rng))
    empty[0] = np.zeros_like(empty[0])
    no_point = list(_scene(rng))
    no_point[6] = np.zeros_like(no_point[6])
    return [plain, no_gt, gaps, out_of_range, no_pred, empty, no_point]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scenes_from_counts_score_as_from_masks_and_jax(seed):
    rng = np.random.default_rng(seed)
    masks_ev, counts_ev = M.InstanceAPEvaluator(NUM_CLASSES), M.InstanceAPEvaluator(NUM_CLASSES)
    jax_ev = JM.InstanceAPEvaluator(NUM_CLASSES)
    for scene in _scene_cases(rng):
        masks, scores, classes, pred_valid, gt_instance, gt_classes, point_valid = scene
        masks_ev.add_scene(*scene)
        jax_ev.add_scene(*scene)
        counts_ev.add_scene_counts(*_counts(masks, point_valid, gt_instance), scores,
                                   classes, pred_valid, gt_classes)
    got, want = counts_ev.compute(per_class=True), masks_ev.compute(per_class=True)
    assert sorted(got) == sorted(want)
    np.testing.assert_equal(got, want)
    np.testing.assert_equal(got, jax_ev.compute(per_class=True))
    assert 0 < got["mAP@0.25"] < 1
    for t in (0.25, 0.5, 0.75):
        np.testing.assert_equal(counts_ev.class_aps(t), masks_ev.class_aps(t))
        np.testing.assert_equal(counts_ev.class_aps(t), jax_ev.class_aps(t))
        ps = counts_ev.per_scene_map(t)
        np.testing.assert_equal(ps, masks_ev.per_scene_map(t))
        np.testing.assert_equal(ps, jax_ev.per_scene_map(t))
        assert np.isnan(ps[1]) and np.isnan(ps[6])   # no GT; no valid point
    # the caches themselves, entry for entry and dtype for dtype
    for a, b in zip(counts_ev._preds, masks_ev._preds):
        ca, cb = a["cache"], masks_ev._scene_cache(b)
        assert sorted(ca) == sorted(cb)
        for k in ca:
            np.testing.assert_equal(ca[k], cb[k], err_msg=k)
            assert np.asarray(ca[k]).dtype == np.asarray(cb[k]).dtype, k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("extra_width", [0, 3])
def test_overlap_counts_equal_the_evaluators_matmul_and_sums(seed, extra_width):
    """A batch of two scenes, invalid points and id -1 among them: the
    counts equal the f32 matmul and sums of ``_scene_cache`` over the
    valid points bit for bit, at the batch's width and past it."""
    rng = np.random.default_rng(seed)
    scenes = [_scene(rng), _scene(rng, n_inst=9)]
    scenes[1][4][scenes[1][4] == 2] = -1             # a gap: id 2 unused
    masks = np.stack([s[0] for s in scenes])
    valid = np.stack([s[6] for s in scenes])
    inst = np.stack([s[4] for s in scenes]).astype(np.int32)
    w = E.overlap_width({"point_instance": inst, "valid": valid})
    assert w == inst[valid].max() + 1
    got = E.overlap_counts(torch.from_numpy(masks), torch.from_numpy(valid),
                           torch.from_numpy(inst), w + extra_width)
    assert [t.dtype for t in got] == [torch.int32] * 3
    inter, psum, gsum = (t.numpy() for t in got)
    assert inter.shape == (2, masks.shape[1], w + extra_width)
    for b in range(2):
        pm = masks[b][:, valid[b]]
        gm = np.stack([inst[b][valid[b]] == g for g in range(w + extra_width)])
        want = pm.astype(np.float32) @ gm.astype(np.float32).T
        np.testing.assert_array_equal(inter[b].astype(np.float32), want)
        np.testing.assert_array_equal(psum[b], pm.sum(axis=1))
        np.testing.assert_array_equal(gsum[b], gm.sum(axis=1))
    assert (gsum[1][2] == 0) and gsum[:, w:].sum() == 0
    # no labeled point: width 0, empty tables
    none = np.full_like(inst, -1)
    assert E.overlap_width({"point_instance": none, "valid": valid}) == 0
    inter0, _, gsum0 = E.overlap_counts(torch.from_numpy(masks), torch.from_numpy(valid),
                                        torch.from_numpy(none), 0)
    assert inter0.shape == (2, masks.shape[1], 0) and gsum0.shape == (2, 0)
