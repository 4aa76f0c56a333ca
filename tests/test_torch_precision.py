"""bf16 compute and remat in the port, at the shapes of
``tests/e2e/test_precision_remat.py`` (widths [8, 16], 512 points, capacity
256, batch 2) and, for remat through the dense tail, of
``tests/test_torch_dense_tail.py``.

* bf16 against JAX, from one set of flax weights: every output of the
  detector's forward has the JAX package's dtype (backbone features bf16;
  RPN objectness, boxes, class, mask and semantic logits f32), and its
  values agree to ``BF16_TOL`` of each output's largest entry; one train
  step's loss parts to ``BF16_TOL`` relative and every gradient to
  ``BF16_GRAD_TOL`` of its largest entry, with the median over parameters
  below ``BF16_GRAD_MEDIAN``. The two packages round to bf16 at the same
  places but sum their f32 products in other orders, so a value can land
  one bf16 ulp (2^-8 relative) apart, and the difference grows through the
  layers and the backward: against an f32 run of the same weights, the
  deepest backbone gradients of either package are off by up to 23 % of
  their largest entry, the median by 2 %. The two stay closer to each
  other (median 1.1e-2); the worst, 7.0e-2, is the RoI head's conv2 bias,
  whose bf16 gradient JAX on the CPU sums in bf16 (6.8e-2 from the f32
  run) where the port sums it in f32 (4.1e-3).
* remat against no remat in the port: the losses, every gradient, the
  parameters after two steps and the BN running statistics bit for bit.
* the parameters and the optimizer state stay f32 in a bf16 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.models import losses as JLoss
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import OVERRIDES as DENSE, TRAIN_SCENE, jax_variables

# the config of tests/e2e/test_precision_remat.py
OVERRIDES = {
    "data": {"num_points": 512, "voxel_capacity": 256, "batch_size": 2,
             "voxel_size": [0.2, 0.2, 0.2]},
    "model": {
        "backbone": {"widths": [8, 16], "blocks_per_scale": 1, "dtype": "bfloat16"},
        "rpn": {"hidden": 8, "num_proposals": 4, "pre_nms_topk": 16},
        "roi": {"grid_size": 3, "hidden": 8, "mask_grid": 6},
        "num_classes": 3, "max_instances": 6,
    },
}
SCENE = dict(seed=9, batch_size=2, num_points=512, num_instances=2, num_classes=3)
BF16_TOL = 3e-2
BF16_GRAD_TOL = 1e-1
BF16_GRAD_MEDIAN = 2e-2
FORWARD_KEYS = ("rpn_obj", "rpn_deltas", "rpn_boxes", "cls_logits", "mask_logits",
                "backbone_finest", "semantic_logits")


def _batch(spec=SCENE):
    kw = dict(spec)
    return synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)


@pytest.fixture(scope="module")
def bf16():
    b = _batch()
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = jax_variables(OVERRIDES, batch, np.random.default_rng(11))
    return b, batch, params, stats


def _flat(out, key):
    v = out[key]
    return list(v) if isinstance(v, tuple) else [v]


def _port_model(cfg, params, stats):
    model = TL.build_model(cfg, "cpu")
    model.load_state_dict(from_flax(params, stats))
    return model


def test_bf16_forward_matches_jax(bf16):
    b, batch, params, stats = bf16
    jcfg = jax_load_config(overrides=OVERRIDES)

    @jax.jit
    def forward(p, s, bt):
        st, _, scales, _, _ = JTL.prepare_inputs(jcfg, bt)
        return JTL.build_model(jcfg).apply({"params": p, "batch_stats": s}, st.feats, scales,
                                           train=False)

    want = jax.device_get(forward(params, stats, batch))
    cfg = load_config(overrides=OVERRIDES)
    model = _port_model(cfg, params, stats)
    assert TL.compute_dtype(cfg) == torch.bfloat16
    st, _, scales, _, _ = TL.prepare_inputs(cfg, TL.to_device(b, "cpu"))
    with torch.no_grad():
        got = model(st.feats, scales)
    for key in FORWARD_KEYS:
        for g, w in zip(_flat(got, key), _flat(want, key)):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype), key
            g, w = g.float().numpy(), np.asarray(w, np.float32)
            live = w > -1e8 if key == "rpn_obj" else np.ones(w.shape, bool)   # masked rows
            np.testing.assert_allclose(g[live], w[live], rtol=0,
                                       atol=BF16_TOL * max(np.abs(w[live]).max(), 1e-6),
                                       err_msg=key)
    assert got["backbone_finest"].dtype == torch.bfloat16
    for key in ("proposal_mask", "proposals"):
        np.testing.assert_allclose(got[key].float().numpy(), np.asarray(want[key], np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL, err_msg=key)


@jax.jit
def _jax_step(params, batch_stats, batch):
    cfg = jax_load_config(overrides=OVERRIDES)
    model = JTL.build_model(cfg)
    st, _, scales, gt, _ = JTL.prepare_inputs(cfg, batch)

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": batch_stats}, st.feats, scales,
                               train=True, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid,
                               mutable=["batch_stats"])
        _, parts = JTL.compute_losses(cfg, out, scales, gt, st.row_mask)
        return JLoss.total_loss(parts, cfg.train.loss_weights), (parts, upd["batch_stats"])

    (total, (parts, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return total, parts, grads, stats


def test_bf16_train_step_matches_jax(bf16):
    b, batch, params, stats = bf16
    jtotal, jparts, jgrads, jstats = jax.device_get(_jax_step(params, stats, batch))
    cfg = load_config(overrides=OVERRIDES)
    model = _port_model(cfg, params, stats)
    # the backward casts the cotangent to the feats dtype before its gathers
    # (JAX ops/sparse_conv.py::_bwd), so dgrad and wgrad take bf16 operands
    seen = []
    real = (sc.conv_dgrad, sc.conv_wgrad)
    sc.conv_dgrad = lambda g, t, w: seen.append(g.dtype) or real[0](g, t, w)
    sc.conv_wgrad = lambda f, t, g: seen.append((f.dtype, g.dtype)) or real[1](f, t, g)
    try:
        total, parts, grads, _ = TL.loss_and_grads(cfg, model,
                                                   TL.to_device(b, "cpu", TL.TRAIN_KEYS))
    finally:
        sc.conv_dgrad, sc.conv_wgrad = real
    assert seen and set(seen) == {torch.bfloat16, (torch.bfloat16, torch.bfloat16)}
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=BF16_TOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=BF16_TOL)
    names = [n for n, _ in model.named_parameters()]
    jg = from_flax(jgrads, {})
    errs = []
    for name, g in zip(names, grads):
        assert g.dtype == torch.float32, name
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=BF16_GRAD_TOL * scale,
                                   err_msg=name)
        errs.append(float(np.abs(g.numpy() - want).max()) / scale)
    assert np.median(errs) < BF16_GRAD_MEDIAN, np.median(errs)
    sd = model.state_dict()
    for k, v in from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=BF16_TOL, atol=BF16_TOL,
                                   err_msg=k)


def test_bf16_params_stay_f32(bf16):
    b, _, params, stats = bf16
    cfg = load_config(overrides=OVERRIDES)
    state = TL.init_state(cfg, model=_port_model(cfg, params, stats))
    for _ in range(2):
        state, metrics = TL.train_step(cfg, state, TL.to_device(b, "cpu", TL.TRAIN_KEYS))
        assert np.isfinite(float(metrics["total"]))
    assert all(t.dtype == torch.float32 for t in state.model.state_dict().values())
    assert all(t.dtype == torch.float32 for t in state.opt_state.mu + state.opt_state.nu)


def _with(overrides, **backbone):
    return {**overrides, "model": {**overrides["model"], "backbone": {
        **overrides["model"]["backbone"], **backbone}},
        "train": {**overrides.get("train", {}), "warmup_steps": 1}}


@pytest.mark.parametrize("case", ["sparse_bf16", "dense1_f32"])
def test_remat_changes_no_bit(case):
    """Two train steps with and without remat from one seeded init: losses,
    gradients, parameters and BN running statistics identical; with remat
    the blocks' forward convs run again in the backward."""
    base, b = ((OVERRIDES, _batch()) if case == "sparse_bf16"
               else (DENSE, _batch(TRAIN_SCENE)))
    runs = {}
    for remat in (False, True):
        cfg = load_config(overrides=_with(base, remat=remat))
        state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(0))
        batch = TL.to_device(b, "cpu", TL.TRAIN_KEYS)
        calls = []
        real = sc.conv_forward
        sc.conv_forward = lambda *a: calls.append(None) or real(*a)
        try:
            total, parts, grads, _ = TL.loss_and_grads(cfg, state.model, batch)
        finally:
            sc.conv_forward = real
        for _ in range(2):
            state, _ = TL.train_step(cfg, state, batch)
        runs[remat] = (total, parts, grads, state.model.state_dict(), len(calls))
    (t0, p0, g0, sd0, n0), (t1, p1, g1, sd1, n1) = runs[False], runs[True]
    assert n1 > n0
    assert torch.equal(t0, t1) and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))
    assert sorted(sd0) == sorted(sd1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
