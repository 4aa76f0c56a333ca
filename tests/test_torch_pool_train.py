"""Pooled training steps of the port against the JAX package.

Tolerances:
 * a maxpool and an avgpool train step (dropout 0) against the loss and
   gradients of JAX's ``train_step``: loss parts 1e-5 relative, every
   gradient 1e-4 of its largest entry, BN statistics 1e-4 / 1e-5, as
   ``tests/test_torch_dense_tail.py``'s train step;
 * config1_pool_dropout's dropout train steps run twice, and resumed from a
   checkpoint: bit-equal.
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
from sparse_rcnn_tpu_torch.data.pipeline import Loader
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import jax_variables
from tests.test_torch_pooling import CONFIG, SCENE, SMALL, TOL, _ov


@pytest.mark.parametrize("downsample", ["maxpool", "avgpool"])
def test_pooled_train_step_matches_jax(downsample):
    ov = _ov(downsample=downsample, dropout=0.0)
    b = synthetic.generate_batch(**SCENE)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = jax_variables(ov, batch, np.random.default_rng(8))
    jtotal, jparts, jgrads, jstats = jax.device_get(_jax_step_cfg(ov)(params, stats, batch))
    cfg = load_config(overrides=ov)
    model = TL.build_model(cfg, "cpu")
    model.load_state_dict(from_flax(params, stats))
    total, parts, grads, _ = TL.loss_and_grads(cfg, model, TL.to_device(b, "cpu", TL.TRAIN_KEYS))
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    jg = from_flax(jgrads, {})
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)
    assert grads[names.index("backbone.down0_proj.weight")].any()
    sd = model.state_dict()
    for k, v in from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **TOL)


def _jax_step_cfg(ov):
    """JAX ``train_step``'s loss, parts, gradients and BN statistics for the
    config ``ov`` (``tests/test_torch_dense_tail.py::_jax_step`` with
    another config)."""
    cfg = jax_load_config(overrides=ov)
    model = JTL.build_model(cfg)

    @jax.jit
    def step(params, batch_stats, batch):
        st, _, scales, gt, _ = JTL.prepare_inputs(cfg, batch)

        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": batch_stats}, st.feats,
                                   scales, train=True, gt_boxes=gt.boxes,
                                   gt_boxes_valid=gt.valid, mutable=["batch_stats"])
            _, parts = JTL.compute_losses(cfg, out, scales, gt, st.row_mask)
            return JLoss.total_loss(parts, cfg.train.loss_weights), (parts, upd["batch_stats"])

        (total, (parts, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return total, parts, grads, stats
    return step


def test_dropout_train_steps_bit_equal_and_resume(tmp_path):
    """config1_pool_dropout at widths [8, 16]: 3 steps twice from the seeded
    init are bit-equal (parameters, moments, BN statistics, losses); 2 steps,
    a checkpoint, a restore and the third step equal them too, since each
    step's masks come from (train.seed, step). The masks are live: another
    step's generator gives another loss."""
    cfg = load_config(CONFIG, overrides=SMALL)
    with Loader(cfg, seed=cfg.train.seed, threads=False) as loader:
        batches = [TL.to_device(next(loader), "cpu", TL.TRAIN_KEYS) for _ in range(3)]

    def run(state, steps):
        return [{k: float(v) for k, v in TL.train_step(cfg, state, batches[i])[1].items()}
                for i in steps]

    def fresh():
        return TL.init_state(cfg, "cpu", torch.Generator().manual_seed(cfg.train.seed))

    a, b = fresh(), fresh()
    ma, mb = run(a, range(3)), run(b, range(3))
    assert ma == mb
    mgr = CK.make_manager(str(tmp_path / "ckpt"))
    c = fresh()
    mc = run(c, range(2))
    CK.save(mgr, c)
    d = CK.restore(mgr, TL.init_state(cfg, "cpu", torch.Generator().manual_seed(99)))
    assert d.step == 2
    mc += run(d, [2])
    assert mc == ma
    for x in (b, d):
        for (k, v), w in zip(a.model.state_dict().items(), x.model.state_dict().values()):
            assert torch.equal(v, w), k
        for u, w in zip(a.opt_state.mu + a.opt_state.nu, x.opt_state.mu + x.opt_state.nu):
            assert torch.equal(u, w)
    e = fresh()
    e.step = 7                                   # another step's masks
    assert run(e, [0])[0]["total"] != ma[0]["total"]
