"""The port's sparse ⇄ dense weight conversion (``models/convert.py``)
against the JAX package's.

Tolerances: the round trips and the conversion itself are reshapes, flips
and renames, so atol 0, and the port's converter equals JAX's
``convert_backbone`` carried through ``from_flax`` bit for bit. The
per-mode eval (train form dense-2, eval form dense-1) against JAX
``eval_step``: 1e-4 relative / 1e-5 absolute on scores and class logits
(f32 sums in other orders through the network, as
``tests/test_torch_golden.py``), and 1e-2 relative / 1e-3 absolute on the
point-mask logits, which both packages read in bf16 (one f32 ulp upstream
can move one by a bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.models import convert as JC
from sparse_rcnn_tpu.models import unet as JU
from sparse_rcnn_tpu.ops import hierarchy as JH
from sparse_rcnn_tpu.ops import voxelize as JV
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.models import convert as PC
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_backbone import _random_variables
from tests.test_torch_dense_tail import (
    CAPS, EXTENT, OVERRIDES, TRAIN_SCENE, WIDTHS, _batch, jax_variables,
)

# tests/parity/test_convert.py's per-mode config: train dense-2, eval dense-1
PER_MODE = {**OVERRIDES, "model": {**OVERRIDES["model"], "backbone": {
    **OVERRIDES["model"]["backbone"], "dense_from_scale_train": 2}}}
EVAL_TOL = {"proposal_scores": dict(rtol=1e-4, atol=1e-5),
            "cls_logits": dict(rtol=1e-4, atol=1e-5),
            "point_mask_logits": dict(rtol=1e-2, atol=1e-3)}


@pytest.fixture(scope="module")
def sparse_tree():
    """A fully sparse flax backbone tree of 2 blocks per scale (params and
    batch_stats), with random values."""
    b = _batch()

    def tables(points, feats, valid):
        st, _, _ = JV.voxelize_batch(points, feats, valid, jnp.asarray([0.05] * 3), CAPS[0])
        st, _ = JV.rebase_coords(st)
        return st, JH.build_hierarchy(st, len(WIDTHS), CAPS, 3)[0]
    # shapes only: jax.eval_shape compiles nothing
    jst, jscales = jax.eval_shape(tables, *(jnp.asarray(b[k]) for k in ("points", "feats",
                                                                          "valid")))
    net = JU.SparseUNet(widths=WIDTHS, blocks_per_scale=2)
    v = _random_variables(jax.eval_shape(
        lambda f, sc: net.init(jax.random.PRNGKey(0), f, sc, train=False), jst.feats, jscales),
        np.random.default_rng(7))
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _port(params, stats):
    return from_flax(params, stats)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_roundtrips_exact(sparse_tree):
    """sparse → dense-s0 → sparse, and sparse → dense-2 → dense-1 → sparse,
    on the parameters and the BN running statistics: atol 0."""
    sd = _port(*sparse_tree)
    assert any(k.endswith("mean") for k in sd) and PC.tree_boundary(sd) is None
    for s0 in (1, 2):
        dense = PC.to_dense(sd, s0)
        assert PC.tree_boundary(dense) == s0
        assert not any(k.startswith(("enc2", "dec2", "up2", "down2")) for k in dense)
        _assert_same(PC.to_sparse(dense), sd)
    moved = PC.convert_backbone(PC.convert_backbone(sd, 2), 1)
    assert PC.tree_boundary(moved) == 1
    _assert_same(PC.convert_backbone(moved, None), sd)
    with pytest.raises(ValueError):
        PC.to_dense(PC.to_dense(sd, 2), 1)


@pytest.mark.parametrize("s0", [1, 2])
def test_conversion_equals_jax_converter(sparse_tree, s0):
    """The port's converter on the port's state_dict equals JAX's
    ``convert_backbone`` carried over by ``from_flax``, both ways, and with
    the backbone under a detector's ``backbone.`` prefix."""
    params, stats = sparse_tree
    sd = _port(params, stats)
    want = _port(JC.convert_backbone(dict(params), s0), JC.convert_backbone(dict(stats), s0))
    _assert_same(PC.convert_backbone(sd, s0), want)
    _assert_same(PC.convert_backbone(want, None), sd)
    other = {"rpn.pred.weight": torch.ones(7, 8)}
    det = {**{"backbone." + k: v for k, v in sd.items()}, **other}
    conv = PC.convert_variables(det, s0)
    _assert_same(conv, {**{"backbone." + k: v for k, v in want.items()}, **other})


@pytest.fixture(scope="module")
def per_mode():
    """JAX ``eval_step`` on a train-form (dense-2) state with the per-mode
    config (it converts to dense-1 inside), and the port's inputs."""
    b = _batch(TRAIN_SCENE)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = jax_variables(PER_MODE, batch, np.random.default_rng(8))
    assert JC.tree_boundary(params["backbone"]) == 2
    jcfg = jax_load_config(overrides=PER_MODE)
    state = JTL.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=None, rng=jax.random.PRNGKey(0))
    want = jax.device_get(jax.jit(lambda s, bt: {
        k: v for k, v in JTL.eval_step(jcfg, s, bt).items() if k != "gt"})(state, batch))
    return b, params, stats, want


def test_per_mode_eval_matches_jax(per_mode):
    b, params, stats, want = per_mode
    cfg = load_config(overrides=PER_MODE)
    tcfg = TL.train_cfg(cfg)
    assert (tcfg.model.backbone.dense_from_scale, cfg.model.backbone.dense_from_scale) == (2, 1)
    model = TL.build_model(tcfg, "cpu")
    model.load_state_dict(from_flax(params, stats))
    state = TL.init_state(cfg, model=model)
    ev = TL.eval_model(cfg, state)
    assert ev.backbone.dense_from_scale == 1 and ev is not model
    assert TL.eval_model(cfg, ev) is ev
    batch = TL.to_device(b, "cpu")
    got = TL.eval_step(cfg, state, batch)
    for key, tol in EVAL_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **tol)
    np.testing.assert_array_equal(got["proposal_mask"].numpy(), want["proposal_mask"])
    # the same state run in its own (train) form as the eval form
    direct = load_config(overrides={**PER_MODE, "model": {**PER_MODE["model"], "backbone": {
        **PER_MODE["model"]["backbone"], "dense_from_scale": 2,
        "dense_from_scale_train": None}}})
    same = TL.eval_step(direct, model, batch)
    for key, tol in EVAL_TOL.items():
        np.testing.assert_allclose(got[key].numpy(), same[key].numpy(), err_msg=key, **tol)


def test_per_mode_train_step_runs_in_train_form(per_mode):
    b, params, stats, _ = per_mode
    cfg = load_config(overrides=PER_MODE)
    model = TL.build_model(TL.train_cfg(cfg), "cpu")
    model.load_state_dict(from_flax(params, stats))
    state = TL.init_state(cfg, model=model)
    state, metrics = TL.train_step(cfg, state, TL.to_device(b, "cpu", TL.TRAIN_KEYS))
    assert np.isfinite(float(metrics["total"])) and int(metrics["dense_tail_oob"]) == 0
    assert state.model.backbone.dense_from_scale == 2
    assert EXTENT == tuple(cfg.model.backbone.grid_extent)
