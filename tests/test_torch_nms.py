"""The port's greedy 3D NMS off the card: ``nms_3d`` on CPU tensors runs the
plain loop ``nms_3d_reference`` scene by scene and launches nothing, the
kernel's wrapper refuses CPU tensors, and the cases of
``benchmarks/nms_cases.py`` (which ``tests/test_torch_kernel_cuda.py`` and
``chip_smoke.py`` run on the card) hold what they claim to. The JAX
comparisons of the NMS and of the batched ``select_proposals`` are in
``tests/test_torch_heads.py``."""

import numpy as np
import pytest
import torch

from benchmarks import nms_cases as NC
from sparse_rcnn_tpu_torch import config as PCfg
from sparse_rcnn_tpu_torch.models import rpn as PRpn
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import nms as PN
from sparse_rcnn_tpu_torch.utils import profiling


@pytest.mark.parametrize("name", [c[0] for c in NC.NMS_CASES])
def test_cpu_nms_is_the_plain_loop_per_scene(name):
    c = NC.nms_case(name, "cpu", seed=3)
    before = NL.LAUNCHES["nms_3d"]
    got = PN.nms_3d(c["boxes"], c["scores"], c["valid"], c["threshold"], c["p"])
    want = NC.run_plain(c)
    assert NL.LAUNCHES["nms_3d"] == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # a scene alone gives the same as in its batch, and -1 exactly where nothing is kept
    alone = PN.nms_3d(c["boxes"][-1], c["scores"][-1], c["valid"][-1], c["threshold"], c["p"])
    assert torch.equal(alone[0], got[0][-1]) and torch.equal(alone[1], got[1][-1])
    assert torch.equal(got[0] >= 0, got[1])


def test_nms_kernel_refuses_cpu_tensors():
    c = NC.nms_case("ragged", "cpu")
    with pytest.raises(ValueError):
        PN.nms_3d_kernel(c["boxes"], c["scores"], c["valid"], c["threshold"], c["p"])


def test_near_threshold_cases_straddle_the_float_threshold():
    """The "ulp" pairs' IoUs are the float32 below 0.35's float32, that
    float32 and the one above; the plain loop keeps the first pair's inner
    box only (the threshold compared as a float32)."""
    c = NC.nms_case("ulp", "cpu")
    t = np.float32(NC.THRESHOLD)
    assert NC.pair_ious(c) == [float(np.nextafter(t, np.float32(0))), float(t),
                               float(np.nextafter(t, np.float32(1)))]
    keep_idx, keep_mask = NC.run_plain(c)
    kept = set(keep_idx[keep_mask].tolist())
    assert {0, 1, 2, 4} <= kept and not {3, 5} & kept


def test_prod_case_depends_on_the_order_of_products():
    c = NC.nms_case("prod", "cpu")
    a, b = (c["boxes"][0, i].numpy() for i in c["pairs"][0])
    card = NC.iou_f32(a, b)
    assert float(card) == c["threshold"]
    assert all(NC.iou_f32(a, b, o) < card for o in ((0, 1, 2), (1, 2, 0)))


def test_select_proposals_on_the_cpu_launches_no_kernel(rng):
    obj = torch.from_numpy(rng.normal(size=(2, 300)).astype(np.float32))
    lo = rng.uniform(0, 40, (2, 300, 3))
    boxes = torch.from_numpy(np.concatenate([lo, lo + rng.uniform(2, 8, lo.shape)], -1)
                             .astype(np.float32))
    valid = torch.from_numpy(rng.random((2, 300)) < 0.9)
    cfg = PCfg.RPNConfig(num_proposals=32, pre_nms_topk=96)
    before = NL.LAUNCHES["nms_3d"]
    with profiling.recording() as spans:
        with profiling.span("select"):
            props, scores, mask = PRpn.select_proposals(obj, boxes, valid, cfg)
    assert NL.LAUNCHES["nms_3d"] == before and spans[0].counts is None
    assert props.shape == (2, 32, 6) and scores.shape == mask.shape == (2, 32)
    for b in range(2):
        vals, idx, m = PN.topk_rows(obj[b], valid[b], 96)
        keep_idx, keep_mask = PN.nms_3d_reference(boxes[b][idx.long()], vals, m, 0.35, 32)
        safe = keep_idx.clamp(0, 95).long()
        assert torch.equal(props[b], boxes[b][idx.long()][safe])
        assert torch.equal(mask[b], keep_mask & (vals[safe] > torch.log(torch.tensor(0.1 / 0.9))))
