"""The port's evaluators (``sparse_rcnn_tpu_torch/utils/metrics.py``) and GT
class derivation (``train/evaluate.py::_gt_classes_from_points``) against
the JAX package's, on seeded random scenes.

Both are the same numpy code, so every number must be equal, NaN for NaN:
``compute(per_class=True)``, ``class_aps``, ``per_scene_map`` and the
semantic mIoU. The scenes hold predictions that overlap their GT in part,
duplicates of one mask, predictions of the wrong class, empty masks,
invalid proposals, unlabeled points and invalid points.
"""

import numpy as np
import pytest

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
