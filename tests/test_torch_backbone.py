"""The port's sparse UNet against JAX ``SparseUNet.apply``: weights carried
across by ``from_flax`` (with BN statistics and affine parameters made
non-trivial), per-scale outputs in eval mode and in train mode, and one
train-mode BN normalisation with its running-statistics update. Tolerance
1e-4 relative / 1e-5 absolute: the same f32 products summed in other
orders through a few layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.models import layers as JL
from sparse_rcnn_tpu.models import unet as JU
from sparse_rcnn_tpu.ops import hierarchy as JH
from sparse_rcnn_tpu.ops import voxelize as JV
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models import layers as PL
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.models.unet import SparseUNet
from sparse_rcnn_tpu_torch.train import loop as TL

WIDTHS = (8, 16, 24)
TOL = dict(rtol=1e-4, atol=1e-5)


def _random_variables(shapes, rng):
    """Random values for a flax variable tree of ``shapes`` (from
    ``jax.eval_shape`` of ``init``, which compiles nothing): He-normal
    kernels, BN scale and running var in [0.5, 1.5), biases and running
    means N(0, 0.3), so that BN is far from the identity."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(0, (2.0 / np.prod(s.shape[:-1])) ** 0.5, s.shape)
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, s.shape)
        else:
            x = rng.normal(0, 0.3, s.shape)
        return jnp.asarray(x.astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def setup():
    cfg = load_config(overrides={
        "data": {"num_points": 2048, "voxel_capacity": 1024, "batch_size": 2,
                 "voxel_size": [0.15, 0.15, 0.15]},
        "model": {"backbone": {"widths": list(WIDTHS)}}})
    b = synthetic.generate_batch(2, 2, num_points=2048)
    st, _, scales, _, _ = TL.prepare_inputs(cfg, TL.to_device(b, "cpu"))

    @jax.jit
    def tables(points, feats, valid):
        jst, _, _ = JV.voxelize_batch(points, feats, valid,
                                      jnp.asarray(cfg.data.voxel_size),
                                      cfg.data.voxel_capacity)
        jst, _ = JV.rebase_coords(jst, margin=2)
        return jst, JH.build_hierarchy(jst, len(WIDTHS), cfg.scale_capacities(), 3)[0]

    jst, jscales = tables(*(jnp.asarray(b[k]) for k in ("points", "feats", "valid")))
    jmodel = JU.SparseUNet(widths=WIDTHS)
    v = _random_variables(jax.eval_shape(
        lambda f, sc: jmodel.init(jax.random.PRNGKey(3), f, sc, train=False),
        jst.feats, jscales), np.random.default_rng(0))
    params, stats = v["params"], v["batch_stats"]
    port = _port_unet(params, stats)
    return cfg, st, scales, jst, jscales, jmodel, params, stats, port


def _port_unet(params, stats):
    with torch.device("meta"):
        m = SparseUNet(3, WIDTHS)
    m = m.to_empty(device="cpu")
    m.load_state_dict(from_flax(jax.device_get(params), jax.device_get(stats)))
    return m


def test_unet_eval_per_scale(setup):
    cfg, st, scales, jst, jscales, jmodel, params, stats, port = setup
    np.testing.assert_allclose(st.feats.numpy(), np.asarray(jst.feats), rtol=1e-6, atol=1e-6)
    want = jax.jit(lambda v, f, sc: jmodel.apply(v, f, sc, train=False))(
        {"params": params, "batch_stats": stats}, jst.feats, jscales)
    with torch.no_grad():
        got = port.eval()(st.feats, scales)
    assert len(got) == len(WIDTHS)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (2, cfg.scale_capacities()[s], WIDTHS[s])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"scale {s}", **TOL)


def test_unet_train_mode_per_scale_and_stats(setup):
    _, st, scales, jst, jscales, jmodel, params, stats, _ = setup
    port = _port_unet(params, stats).train()
    want, upd = jax.jit(lambda v, f, sc: jmodel.apply(
        v, f, sc, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jst.feats, jscales)
    with torch.no_grad():
        got = port(st.feats, scales)
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"scale {s}", **TOL)
    new = from_flax({}, jax.device_get(upd["batch_stats"]))
    sd = port.state_dict()
    for k, v in new.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **TOL)


def test_masked_batchnorm_train_normalisation():
    rng = np.random.default_rng(1)
    feats = rng.normal(2.0, 3.0, size=(2, 50, 6)).astype(np.float32)
    mask = np.arange(50)[None, :] < np.array([[37], [12]])
    feats = feats * mask[..., None]
    jbn = JL.MaskedBatchNorm()
    v = _random_variables(jax.eval_shape(
        lambda f, m: jbn.init(jax.random.PRNGKey(0), f, m, False),
        jnp.asarray(feats), jnp.asarray(mask)), rng)
    want, upd = jbn.apply(v, jnp.asarray(feats), jnp.asarray(mask), True,
                          mutable=["batch_stats"])
    with torch.device("meta"):
        bn = PL.MaskedBatchNorm(6)
    bn = bn.to_empty(device="cpu")
    bn.load_state_dict(from_flax(jax.device_get(v["params"]), jax.device_get(v["batch_stats"])))
    got = bn.train()(torch.from_numpy(feats), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert not got[~torch.from_numpy(mask)].any()          # padding rows stay zero
    for k in ("mean", "var"):                               # flax momentum 0.9
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(upd["batch_stats"][k]),
                                   **TOL)


def test_unsupported_backbones_raise():
    """A downsample the JAX package does not know is refused (pooling and
    dropout build, ``tests/test_torch_pooling.py``); a dense tail needs its
    grid."""
    with pytest.raises(ValueError, match="downsample"):
        SparseUNet(3, WIDTHS, downsample="stridedpool")
    for kw in ({"downsample": "maxpool"}, {"downsample": "avgpool"}, {"dropout": 0.1}):
        SparseUNet(3, WIDTHS, **kw)
    with pytest.raises(ValueError, match="grid_extent"):
        SparseUNet(3, WIDTHS, dense_from_scale=1)
