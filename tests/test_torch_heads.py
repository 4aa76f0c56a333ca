"""Heads and proposal ops of the port against the JAX package: RPNHead,
select_proposals, box IoU, top-k and NMS (with ties), the RoI crop,
RoIHead (which pins the ConvTranspose orientation of ``from_flax``) and
sample_mask_at_positions. Index outputs exact; floats to 1e-5 (one f32
layer) or 1e-4 (the conv stack of the RoI head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import RoIConfig, RPNConfig
from sparse_rcnn_tpu.models import heads as JHd
from sparse_rcnn_tpu.models import rpn as JRpn
from sparse_rcnn_tpu.ops import nms as JN
from sparse_rcnn_tpu.ops import roi as JRoi
from sparse_rcnn_tpu_torch import config as PCfg
from sparse_rcnn_tpu_torch.models import heads as PHd
from sparse_rcnn_tpu_torch.models import rpn as PRpn
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.ops import nms as PN
from sparse_rcnn_tpu_torch.ops import roi as PRoi

T = torch.from_numpy


def eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def close(a, b, rtol=1e-5, atol=1e-5, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def port_module(cls, *args, params):
    with torch.device("meta"):
        m = cls(*args)
    m = m.to_empty(device="cpu")
    m.load_state_dict(from_flax(jax.device_get(params), {}))
    return m.eval()


def random_boxes(rng, n, span=20.0):
    lo = rng.uniform(0, span, (n, 3))
    return np.concatenate([lo, lo + rng.uniform(1, 6, (n, 3))], 1).astype(np.float32)


def test_rpn_head(rng):
    feats = rng.normal(size=(2, 64, 8)).astype(np.float32)
    coords = rng.integers(0, 30, (2, 64, 3)).astype(np.int32)
    mask = rng.random((2, 64)) < 0.8
    cfg = RPNConfig(hidden=16)
    jm = JRpn.RPNHead(cfg, stride=2)
    v = jm.init(jax.random.PRNGKey(0), feats, coords, mask)
    want = jm.apply(v, feats, coords, mask)
    pm = port_module(PRpn.RPNHead, 8, PCfg.RPNConfig(hidden=16), 2, params=v["params"])
    got = pm(T(feats), T(coords), T(mask))
    for name, g, w in zip(("obj", "boxes", "deltas"), got, want):
        close(g, w, what=name)


def select_with_ties(rng, batch=2, n=80, topk=40, proposals=16):
    """JAX's select_proposals against the port's on scores with ties (two
    runs of equal values, an identical box among them), a batch at once."""
    obj = rng.normal(size=(batch, n)).astype(np.float32)
    obj[:, 10:20] = 1.5                          # tied scores
    obj[:, 30:40] = obj[:, 40:50]                # more ties, at other values
    boxes = np.stack([random_boxes(rng, n) for _ in range(batch)])
    boxes[:, 12] = boxes[:, 11]                  # an identical box among the ties
    valid = rng.random((batch, n)) < 0.85
    cfg = RPNConfig(num_proposals=proposals, pre_nms_topk=topk, nms_iou_threshold=0.3)
    want = JRpn.select_proposals(jnp.asarray(obj), jnp.asarray(boxes), jnp.asarray(valid), cfg)
    got = PRpn.select_proposals(T(obj), T(boxes), T(valid), PCfg.RPNConfig(
        num_proposals=proposals, pre_nms_topk=topk, nms_iou_threshold=0.3))
    for name, g, w in zip(("boxes", "scores", "mask"), got, want):
        eq(g, w, name)


def test_select_proposals_with_ties(rng):
    select_with_ties(rng)


@pytest.mark.parametrize("batch,n,topk,proposals", [(3, 80, 40, 16), (2, 97, 45, 20),
                                                    (3, 150, 70, 24)],
                         ids=["batch3", "topk45", "batch3_topk70"])
def test_select_proposals_with_ties_batched(rng, batch, n, topk, proposals):
    """Batch 3 and candidate counts (N = pre_nms_topk) not a multiple of 32."""
    select_with_ties(rng, batch, n, topk, proposals)


def test_topk_nms_iou_with_ties(rng):
    boxes = random_boxes(rng, 30, span=8.0)
    scores = np.round(rng.uniform(0, 1, 30), 1).astype(np.float32)   # many ties
    valid = rng.random(30) < 0.9
    close(PN.box_iou_3d(T(boxes), T(boxes)), JN.box_iou_3d(boxes, boxes), 1e-6, 1e-7)
    for name, g, w in zip(("vals", "idx", "mask"),
                          PN.topk_rows(T(scores), T(valid), 20),
                          JN.topk_rows(jnp.asarray(scores), jnp.asarray(valid), 20)):
        eq(g, w, f"topk {name}")
    for name, g, w in zip(("keep_idx", "keep_mask"),
                          PN.nms_3d(T(boxes), T(scores), T(valid), 0.25, 12),
                          JN.nms_3d(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), 0.25, 12)):
        eq(g, w, f"nms {name}")


def _site_table(rng, n, cap):
    c = np.unique(rng.integers(0, 12, size=(n, 3)).astype(np.int32), axis=0)
    c = c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))]
    pad = np.full((cap, 3), 2 ** 15 - 1, np.int32)
    pad[:len(c)] = c
    return pad, len(c)


def test_roi_crop_and_sample_nearest(rng):
    coords, n = _site_table(rng, 500, 512)
    feats = rng.normal(size=(512, 5)).astype(np.float32)
    feats[n:] = 0
    boxes = random_boxes(rng, 6, span=8.0)
    close(PRoi.roi_crop(T(coords), torch.tensor(n), T(feats), T(boxes), 4),
          jax.jit(JRoi.roi_crop, static_argnums=4)(
              jnp.asarray(coords), jnp.int32(n), jnp.asarray(feats), jnp.asarray(boxes), 4),
          what="roi_crop")
    labels = rng.integers(0, 9, 512).astype(np.int32)
    pos = rng.uniform(-1, 13, (200, 3)).astype(np.float32)
    eq(PRoi.sample_nearest(T(coords), torch.tensor(n), T(labels), T(pos)),
       JRoi.sample_nearest(jnp.asarray(coords), jnp.int32(n), jnp.asarray(labels),
                           jnp.asarray(pos)), "sample_nearest")


def test_roi_head_conv_transpose_orientation(rng):
    roi = rng.normal(size=(2, 3, 4, 4, 4, 6)).astype(np.float32)
    jm = JHd.RoIHead(RoIConfig(grid_size=4, hidden=8, mask_grid=8), num_classes=5)
    # every parameter random (biases too), at the scale of a lecun init;
    # shapes from tracing init, which compiles nothing
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), roi)["params"]
    params = jax.tree_util.tree_map(lambda s: jnp.asarray(rng.normal(
        0, (1 / np.prod(s.shape[:-1])) ** 0.5 if len(s.shape) > 1 else 0.1,
        s.shape).astype(np.float32)), shapes)
    want_cls, want_mask = jm.apply({"params": params}, roi)
    pm = port_module(PHd.RoIHead, 6, PCfg.RoIConfig(grid_size=4, hidden=8, mask_grid=8), 5,
                     params=params)
    got_cls, got_mask = pm(T(roi))
    close(got_cls, want_cls, 1e-4, 1e-5, "cls_logits")
    assert got_mask.shape == (2, 3, 8, 8, 8)
    close(got_mask, want_mask, 1e-4, 1e-5, "mask_logits")


def test_sample_mask_at_positions(rng):
    ml = rng.normal(size=(4, 8, 8, 8)).astype(np.float32)
    boxes = random_boxes(rng, 4, span=6.0)
    # a far-away position exercises the out-of-range cell clamp
    pos = np.concatenate([rng.uniform(-2, 14, (300, 3)),
                          [[32767.5, 32767.5, 32767.5]]]).astype(np.float32)
    jl, jin = JHd.sample_mask_at_positions(jnp.asarray(ml), jnp.asarray(boxes), jnp.asarray(pos))
    pl, pin = PHd.sample_mask_at_positions(T(ml), T(boxes), T(pos))
    eq(pin, jin, "inside")
    eq(pl, jl, "bf16-read logits")
    assert pin.any() and (~pin).any()
