"""The port's pooling ops, feature dropout and the pooled backbone against
the JAX package.

Tolerances:
 * ``max_pool`` and ``global_pool(max)``, forward and gradient (the tie
   split ``ct / count`` at the tied children): exact, the same f32 ops;
 * ``avg_pool``, ``global_pool(mean)``: 1e-6 relative and absolute (a sum
   of up to 8 children, or of every live row, in another order);
 * ``sparse_dropout`` fed JAX's keep mask: exact against the jitted JAX
   ``SparseDropout`` (a product with the reciprocal of ``1 - rate``);
 * the config1_pool_dropout backbone at widths [8, 16] from ``from_flax``
   weights, eval mode: 1e-4 relative / 1e-5 absolute, as
   ``tests/test_torch_backbone.py``.

The pooled train steps are in ``tests/test_torch_pool_train.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.models import convert as JCV
from sparse_rcnn_tpu.models import layers as JL
from sparse_rcnn_tpu.models import unet as JU
from sparse_rcnn_tpu.ops import pooling as JP
from sparse_rcnn_tpu.ops import rulebook as JR
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models import convert as PCV
from sparse_rcnn_tpu_torch.models import layers as PL
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.ops import pooling as PP
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import jax_variables
from tests.test_torch_sites import site_table

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "config1_pool_dropout.yaml")
# config1_pool_dropout (max-pool, dropout 0.1) cut to widths [8, 16] and a
# tiny scene
SMALL = {"data": {"num_points": 1024, "voxel_capacity": 512, "batch_size": 2,
                  "voxel_size": [0.15, 0.15, 0.15], "num_scenes": 4},
         "model": {"backbone": {"widths": [8, 16], "downsample": "maxpool", "dropout": 0.1},
                   "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
                   "roi": {"grid_size": 4, "hidden": 16, "mask_grid": 8},
                   "num_classes": 4, "max_instances": 8},
         "train": {"lr": 3e-3, "warmup_steps": 0, "total_steps": 50}}
SCENE = dict(seed=3, batch_size=2, num_points=1024, num_instances=3, num_classes=4)
TOL = dict(rtol=1e-4, atol=1e-5)


def _ov(**backbone):
    return {**SMALL, "model": {**SMALL["model"], "backbone": {
        **SMALL["model"]["backbone"], **backbone}}}


def _pool_inputs(seed, cap=512, m_out=256, c=5):
    """Post-ReLU features rounded to 0.5 (ties at 0 and above), a site table
    with coarse sites of 1 to 8 children, and its strided rulebook, padded
    past the live coarse sites (all -1 there)."""
    rng = np.random.default_rng(seed)
    coords, n = site_table(rng, 300, cap, lo=-6, hi=6)
    oc, n_out, _ = JR.downsample_sites(jnp.asarray(coords), jnp.int32(n), 2, m_out)
    idx = np.array(JR.strided_rulebook(jnp.asarray(coords), jnp.int32(n), oc, n_out, 2))
    feats = np.maximum(np.round(rng.normal(size=(cap, c)) * 2) / 2, 0).astype(np.float32)
    feats[n:] = 0
    ct = rng.normal(size=(m_out, c)).astype(np.float32)
    assert int(n_out) < m_out and (idx[:, :int(n_out)] < 0).any()
    return feats[None], idx[None], ct[None]


class _Ops(TorchDispatchMode):
    """The aten ops that run inside the block, with their arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((str(func), args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def _accumulating(calls):
    return [name for name, args, kw in calls
            if ("index_put" in name and (kw.get("accumulate") or (len(args) > 3 and args[3])))
            or "index_add" in name or "scatter_add" in name or "scatter_reduce" in name]


@pytest.mark.parametrize("op", ["max", "avg"])
def test_pool_forward_and_grad_match_jax(op):
    feats, idx, ct = _pool_inputs(1 if op == "max" else 2)
    jfn = JP.max_pool if op == "max" else JP.avg_pool
    want, vjp = jax.vjp(lambda f: jfn(f, jnp.asarray(idx)), jnp.asarray(feats))
    (want_g,) = vjp(jnp.asarray(ct))
    f = torch.from_numpy(feats).requires_grad_()
    fn = PP.max_pool if op == "max" else PP.avg_pool
    got = fn(f, torch.from_numpy(idx))
    ops = _Ops()
    with ops:
        (g,) = torch.autograd.grad(got, f, torch.from_numpy(ct))
    assert not _accumulating(ops.calls), _accumulating(ops.calls)
    tol = dict(rtol=0, atol=0) if op == "max" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **tol)
    # ties: some coarse site's live children share their max; the gradient splits
    assert ((g.numpy() > 0) & (g.numpy() < np.abs(ct).max())).any() or op == "avg"
    assert not got.detach().numpy()[0, (idx[0] < 0).all(0)].any()    # no child → 0


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_global_pool_matches_jax(mode):
    rng = np.random.default_rng(4)
    feats = np.maximum(np.round(rng.normal(size=(2, 50, 3)) * 2) / 2, 0).astype(np.float32)
    nvalid = np.array([37, 50], np.int32)
    ct = rng.normal(size=(2, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: JP.global_pool(f, jnp.asarray(nvalid), mode),
                        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    got = PP.global_pool(f, torch.from_numpy(nvalid), mode)
    (g,) = torch.autograd.grad(got, f, torch.from_numpy(ct))
    tol = dict(rtol=0, atol=0) if mode == "max" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), **tol)


def test_sparse_dropout_matches_jax_and_is_inert_in_eval():
    rate = 0.1
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 400, 16)).astype(np.float32)
    x[np.abs(x) < 1e-3] = 1.0                      # no zero inputs: keep == (out != 0)
    jmod = JL.SparseDropout(rate)
    want = np.asarray(jax.jit(lambda a, k: jmod.apply({}, a, True, rngs={"dropout": k}))(
        jnp.asarray(x), jax.random.PRNGKey(7)))
    keep = want != 0
    assert 0.85 < keep.mean() < 0.95
    got = PL.sparse_dropout(torch.from_numpy(x), torch.from_numpy(keep), rate)
    np.testing.assert_array_equal(got.numpy(), want)
    mod = PL.SparseDropout(rate)
    t = torch.from_numpy(x)
    assert mod.eval()(t) is t and PL.SparseDropout(0.0).train()(t) is t
    def gens(*seeds):                              # one generator per scene
        return [torch.Generator().manual_seed(s) for s in seeds]

    a = mod.train()(t, gens(1, 3))
    b = mod.train()(t, gens(1, 3))
    c = mod.train()(t, gens(2, 3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.85 < float((a != 0).float().mean()) < 0.95


def test_pool_dropout_backbone_matches_jax():
    """config1_pool_dropout (max-pool, dropout 0.1) at widths [8, 16], eval
    mode, from random flax weights: each scale's output; ``down0_proj``
    arrives as the transposed flax ``Dense`` kernel."""
    ov = _ov()
    bb = load_config(CONFIG).model.backbone
    assert (bb.downsample, bb.dropout) == ("maxpool", 0.1)
    b = synthetic.generate_batch(**SCENE)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = jax_variables(ov, batch, np.random.default_rng(6))
    assert "down0_proj" in params["backbone"] and "down0_conv" not in params["backbone"]
    jcfg = jax_load_config(overrides=ov)
    jbb = jcfg.model.backbone
    jmodel = JU.SparseUNet(widths=jbb.widths, blocks_per_scale=jbb.blocks_per_scale,
                           downsample=jbb.downsample, dropout=jbb.dropout)

    @jax.jit
    def jax_backbone(v, bt):
        st, _, scales, _, _ = JTL.prepare_inputs(jcfg, bt)
        return jmodel.apply(
            {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]},
            st.feats, scales, train=False)

    want = jax_backbone({"params": params, "batch_stats": stats}, batch)
    cfg = load_config(overrides=ov)
    model = TL.build_model(cfg, "cpu")
    sd = from_flax(params, stats)
    np.testing.assert_array_equal(sd["backbone.down0_proj.weight"].numpy(),
                                  params["backbone"]["down0_proj"]["kernel"].T)
    model.load_state_dict(sd)
    with torch.no_grad():
        st, _, scales, _, _ = TL.prepare_inputs(cfg, TL.to_device(b, "cpu"))
        got = model.eval().backbone(st.feats, scales)
    assert [type(model.backbone.enc0_drop), model.backbone.downsample] == [PL.SparseDropout,
                                                                          "maxpool"]
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"scale {s}", **TOL)


def test_convert_refuses_a_pooled_boundary():
    """A pooled scale cannot move into the dense tail: the port's and JAX's
    converters refuse it with the same message; below the boundary the
    projection stays sparse."""
    cfg = load_config(overrides=_ov(widths=[8, 16, 24]))
    sd = {k[len("backbone."):]: v for k, v in
          TL.build_model(cfg, "cpu", torch.Generator().manual_seed(0)).state_dict().items()
          if k.startswith("backbone.")}
    jtree = {"down1_proj": {"kernel": np.zeros((16, 24), np.float32)},
             "down0_proj": {"kernel": np.zeros((8, 16), np.float32)}}
    with pytest.raises(ValueError) as want:
        JCV.to_dense(jtree, 1)
    with pytest.raises(ValueError) as got:
        PCV.to_dense(sd, 1)
    assert str(got.value) == str(want.value) and "down1_proj" in str(got.value)
    dense2 = PCV.to_dense(sd, 2)
    assert "down1_proj.weight" in dense2 and "dense_tail.enc2_block0.conv1.weight" in dense2
