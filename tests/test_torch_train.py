"""The port's training slice against the JAX package, at the config of
``tests/e2e/test_train.py`` (widths [8, 16], 1024 points, batch 2): GT,
RPN and RoI targets and pooled instance labels bit-exact; the loss parts and
the gradient of every parameter of one step from one JAX ``init_state``
carried over by ``from_flax``; the train stream against JAX ``Loader``.

The JAX gradients come from ``jax.value_and_grad`` over ``prepare_inputs``
and ``compute_losses`` with the model in training mode, as JAX
``train_step`` builds them; the loss weights are an argument, so one
compile serves both weightings. Tolerances and their reasons are stated at
``GRAD_TOL``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.data import gt as JGT
from sparse_rcnn_tpu.data import synthetic as jax_synthetic
from sparse_rcnn_tpu.data.pipeline import Loader
from sparse_rcnn_tpu.models import losses as JL
from sparse_rcnn_tpu.models import targets as JT
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.gt import build_scene_gt
from sparse_rcnn_tpu_torch.data.pipeline import Loader as TorchLoader
from sparse_rcnn_tpu_torch.models import targets as PT
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.ops import voxelize as V
from sparse_rcnn_tpu_torch.train import loop as TL

# the config of tests/e2e/test_train.py
OVERRIDES = {
    "data": {"num_points": 1024, "voxel_capacity": 512, "batch_size": 2,
             "voxel_size": [0.15, 0.15, 0.15]},
    "model": {
        "backbone": {"widths": [8, 16], "blocks_per_scale": 1},
        "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
        "roi": {"grid_size": 4, "hidden": 16, "mask_grid": 8},
        "num_classes": 4, "max_instances": 8,
    },
    "train": {"lr": 3e-3, "warmup_steps": 2, "total_steps": 50},
}
SCENE = dict(seed=3, batch_size=2, num_points=1024, num_instances=3, num_classes=4)

# Gradient tolerances, relative to the largest entry of each parameter's
# gradient (entries near 0 carry the absolute error of their tensor).
#  * mask weight 0: the mask head gets an exactly zero cotangent, and every
#    other gradient is the same f32 arithmetic summed in other orders
#    through ~20 layers: 1e-5 (measured worst 1.1e-6, a BN scale).
#  * full loss: the mask logits are read in bf16 (heads.py), so their
#    gradient is a bf16 scatter-add in both packages. On the CPU both add
#    the points in the same order (measured worst 1.2e-6), but any other
#    order moves a sum by bf16 roundings (2^-8 relative), and everything
#    upstream of the mask head inherits that: 1e-4 here; the card, which
#    sums that scatter in f32, is held to its own stated tolerance in
#    chip_smoke.py.
GRAD_TOL = {"mask0": 1e-5, "full": 1e-4}
WEIGHTS = {"mask0": (1.0, 1.0, 1.0, 0.0), "full": (1.0, 1.0, 1.0, 1.0)}


def _assert_gt_equal(got, want):
    """Labels, classes and validity bit-exact. Boxes to one f32 ulp: XLA
    turns ``points / voxel_size`` (a constant) into a multiply by its
    reciprocal, fused with the rebase subtraction on some lanes and not on
    others, where the port divides; min and max then pick the same point."""
    for f in ("classes", "valid", "voxel_instance", "voxel_semantic"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_max_ulp(got.boxes.numpy(), np.asarray(want.boxes), maxulp=1)


def _batch():
    kw = dict(SCENE)
    return synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)


@jax.jit
def _jax_step_parts(params, batch_stats, batch, weights):
    """JAX loss parts, total and grads of one step (``train_step``'s
    ``loss_fn``) with the loss weights as an argument, and the GT."""
    cfg = jax_load_config(overrides=OVERRIDES)
    model = JTL.build_model(cfg)
    st, _, scales, gt, aux = JTL.prepare_inputs(cfg, batch)

    def loss_fn(p):
        out, upd = model.apply(
            {"params": p, "batch_stats": batch_stats}, st.feats, scales, train=True,
            gt_boxes=gt.boxes, gt_boxes_valid=gt.valid, mutable=["batch_stats"])
        _, parts = JTL.compute_losses(cfg, out, scales, gt, st.row_mask)
        return JL.total_loss(parts, weights), (parts, upd["batch_stats"])

    (total, (parts, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return total, parts, grads, stats, gt, aux


@pytest.fixture(scope="module")
def jax_state():
    cfg = jax_load_config(overrides=OVERRIDES)
    kw = dict(SCENE)
    b = jax_synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    state = JTL.init_state(cfg, batch)
    return state, batch


def _port_model(state, cfg):
    model = TL.build_model(cfg, "cpu")
    model.load_state_dict(from_flax(jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)))
    return model


@pytest.fixture(scope="module")
def step_parts(jax_state):
    """JAX and port (total, parts, grads, new BN stats) for each weighting."""
    state, batch = jax_state
    res = {}
    for name, w in WEIGHTS.items():
        jtotal, jparts, jgrads, jstats, jgt, jaux = jax.device_get(_jax_step_parts(
            state.params, state.batch_stats, batch, jnp.asarray(w, jnp.float32)))
        cfg = load_config(overrides={**OVERRIDES, "train": {
            **OVERRIDES["train"], "loss_weights": list(w)}})
        model = _port_model(state, cfg)
        total, parts, grads, aux = TL.loss_and_grads(
            cfg, model, TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS))
        names = [n for n, _ in model.named_parameters()]
        res[name] = dict(jax=(jtotal, jparts, from_flax(jgrads, {}), jstats, jgt, jaux),
                         port=(total, parts, dict(zip(names, grads)), model, aux))
    return res


def test_prepare_inputs_gt_matches_jax(step_parts):
    _, _, _, _, jgt, jaux = step_parts["mask0"]["jax"]
    _, _, _, gt = TL.prepare_inputs(load_config(overrides=OVERRIDES),
                                    TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS))[:4]
    _assert_gt_equal(gt, jgt)
    aux = step_parts["mask0"]["port"][4]
    assert int(aux["gt_instance_overflow"]) == int(jaux["gt_instance_overflow"])


@pytest.mark.parametrize("max_instances", [8, 1])
def test_build_scene_gt_bit_exact(max_instances):
    """Including instance ids past ``max_instances`` (with 1 slot: dropped
    from boxes and classes, kept on voxels) and a nonzero rebase."""
    cfg = load_config(overrides=OVERRIDES)
    b = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    st, p2v, _ = V.voxelize_batch(b["points"], b["feats"], b["valid"],
                                  cfg.data.voxel_size, cfg.data.voxel_capacity)
    _, base = V.rebase_coords(st, margin=2)
    args = (b["points"], b["valid"], b["point_instance"], b["point_semantic"], p2v)
    got = build_scene_gt(*args, cfg.data.voxel_capacity, cfg.data.voxel_size,
                         max_instances, base=base)
    want = jax.jit(functools.partial(
        JGT.build_scene_gt, voxel_capacity=cfg.data.voxel_capacity,
        voxel_size=cfg.data.voxel_size, max_instances=max_instances))(
        *(jnp.asarray(a.numpy()) for a in args), base=jnp.asarray(base.numpy()))
    assert bool(base.any())
    _assert_gt_equal(got, want)
    if max_instances == 1:
        assert int(got.voxel_instance.max()) >= 1 and bool(got.valid.all())


def test_targets_and_pooled_labels_bit_exact(jax_state):
    """RPN and RoI targets and pooled instance labels of the port and of JAX
    on the same inputs: the port's tables, GT and training-forward boxes."""
    state, _ = jax_state
    cfg = load_config(overrides=OVERRIDES)
    st, _, scales, gt, _ = TL.prepare_inputs(cfg, TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS))
    model = _port_model(state, cfg).train()
    with torch.no_grad():
        out = model(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
    j = {f: jnp.asarray(getattr(gt, f).numpy()) for f in
         ("boxes", "classes", "valid", "voxel_instance", "voxel_semantic")}
    jgt = JT.SceneGT(**j)

    class _Scale:
        def __init__(self, sc):
            self.down_idx = None if sc.down_idx is None else jnp.asarray(sc.down_idx.numpy())

    levels = TL.pool_instance_labels(gt, scales)
    jlevels = JTL.pool_instance_labels(jgt, [_Scale(s) for s in scales])
    assert len(levels) == len(jlevels) == 2
    for s, (a, b) in enumerate(zip(levels, jlevels)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"level {s}")
    assert bool((levels[1] >= 0).any())

    for s, stride in ((0, 1), (1, 2)):
        mask = scales[s].row_mask
        got = PT.rpn_targets(scales[s].coords, mask, gt, 8.0, stride, levels[s])
        want = JT.rpn_targets(jnp.asarray(scales[s].coords.numpy()), jnp.asarray(mask.numpy()),
                              jgt, 8.0, stride, jnp.asarray(levels[s].numpy()))
        for f in ("objectness", "obj_weight", "box_deltas", "box_weight"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"scale {s} {f}")

    got = PT.roi_targets(out["crop_boxes"], out["proposal_mask"], scales[0].coords,
                         scales[0].nvalid, gt, cfg.model)
    want = JT.roi_targets(jnp.asarray(out["crop_boxes"].numpy()),
                          jnp.asarray(out["proposal_mask"].numpy()),
                          jnp.asarray(scales[0].coords.numpy()),
                          jnp.asarray(scales[0].nvalid.numpy()), jgt, cfg.model)
    for f in ("cls", "cls_weight", "mask", "mask_weight", "matched_gt"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool((got.matched_gt >= 0).any())        # the injected GT boxes match


@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_loss_parts_and_grads_match_jax(step_parts, weights):
    jtotal, jparts, jgrads, jstats, _, _ = step_parts[weights]["jax"]
    total, parts, grads, model, _ = step_parts[weights]["port"]
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    tol = GRAD_TOL[weights]
    for name, g in grads.items():
        want = jgrads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol * scale, err_msg=name)
    if weights == "mask0":
        assert not grads["roi_head.mask_pred.weight"].any()
    # the BN running statistics moved as flax's did
    sd = model.state_dict()
    for k, v in from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_train_stream_matches_jax_loader():
    """The first 2 batches of the port's train Loader with one worker (in
    the caller's thread) against JAX ``Loader(..., num_workers=1)`` with the
    same seed (augmentation on)."""
    ov = {**OVERRIDES, "data": {**OVERRIDES["data"], "num_workers": 1}}
    loader = Loader(jax_load_config(overrides=ov), "train", train=True, seed=5)
    try:
        it = iter(loader)
        want = [jax.device_get(next(it)) for _ in range(2)]
    finally:
        loader.close()
    stream = TorchLoader(load_config(overrides=ov), seed=5, threads=False)
    for i, w in enumerate(want):
        got = next(stream)
        assert sorted(got) == sorted(w)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(w[k]), err_msg=f"batch {i} {k}")


def test_train_cfg_refuses_dense_tail():
    """``train_cfg`` swaps in the train boundary, as JAX ``train_cfg`` does;
    a pooling backbone builds, with its 1×1 projection in place of the down
    conv."""
    bb = {"widths": [8, 16, 24], "dense_from_scale": 1, "grid_extent": [64, 64, 32]}
    cfg = load_config(overrides={"model": {"backbone": bb}})
    assert TL.train_cfg(cfg) is cfg
    per_mode = {"model": {"backbone": {**bb, "dense_from_scale_train": 2}}}
    for ov in (per_mode, {"model": {"backbone": {**bb, "dense_from_scale_train": 1}}}):
        got, want = TL.train_cfg(load_config(overrides=ov)), JTL.train_cfg(
            jax_load_config(overrides=ov))
        assert got.model.backbone.dense_from_scale == want.model.backbone.dense_from_scale
    assert TL.train_cfg(TL.train_cfg(load_config(overrides=per_mode))).model.backbone \
        .dense_from_scale == 2
    pooled = TL.build_model(load_config(overrides={"model": {"backbone": {
        "widths": [8, 16], "downsample": "maxpool"}}}), "cpu")
    assert hasattr(pooled.backbone, "down0_proj") and not hasattr(pooled.backbone, "down0_conv")
