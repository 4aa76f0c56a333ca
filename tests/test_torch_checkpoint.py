"""Checkpoints of the port (``sparse_rcnn_tpu_torch/train/checkpoint.py``)
and the import of a JAX checkpoint.

The port's own format: a save and restore round trip is ``torch.equal`` on
every tensor (parameters, BN statistics, Adam moments, the ``MultiSteps``
accumulator, EMA), and a step from the restored state is bit-equal to a
step from the state in memory (the CPU step is deterministic); the keep-N
rotation leaves ``<dir>_best`` alone; the ``best.json`` sidecar; a missing
step restores nothing; a change of ``train.ema`` between save and restore
is an error.

The JAX import: the JAX init (``_jax_init``) and 2 JAX steps, JAX's orbax save,
``scripts/export_jax_checkpoint.py``, the port's ``import_flat``, then one
more step in each package: the loss parts, the parameters and the EMA
parameters agree within the tolerances of ``tests/test_torch_train_steps.py``
(the imported state itself is bit-equal to JAX's). The optimizer states of
SGD and of ``MultiSteps`` (mid-accumulation) go through the same export and
import, and the next update agrees with optax's to 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import export_jax_checkpoint as EX
from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.train import checkpoint as JCK
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models.transfer import from_flax, unflatten_variables
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_train import OVERRIDES, SCENE
from tests.test_torch_train_steps import _check_close, _check_metrics, _lr_sum

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_config1_params.npz")
VARIANTS = {"adamw": {}, "ema": {"ema": 0.9},
            "accum2_ema": {"ema": 0.9, "grad_accum_steps": 2, "warmup_steps": 0},
            "sgd": {"optimizer": "sgd"}}


def _overrides(train):
    return {**OVERRIDES, "train": {**OVERRIDES["train"], **train}}


def _batch():
    kw = dict(SCENE)
    return synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)


def _trained(cfg, steps, seed=0):
    """A port state on the CPU after ``steps`` steps on the test batch."""
    state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    batch = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    for _ in range(steps):
        TL.train_step(cfg, state, batch)
    return state


def _tensors(state):
    """Every tensor of a state, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.opt_state
    for name in ("mu", "nu", "acc_grads"):
        for i, t in enumerate(getattr(opt, name) or []):
            out[f"{name}.{i}"] = t
    for i, t in enumerate(state.ema_params or []):
        out[f"ema.{i}"] = t
    return out


def _assert_equal_states(a, b):
    assert (a.step, a.opt_state.count, a.opt_state.mini_step) == \
        (b.step, b.opt_state.count, b.opt_state.mini_step)
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_round_trip_and_next_step_are_exact(tmp_path, variant):
    # 3 steps: the accumulator is mid-way (mini_step 1) for accum2
    cfg = load_config(overrides=_overrides(VARIANTS[variant]))
    state = _trained(cfg, 3)
    mgr = CK.make_manager(tmp_path / "ckpt")
    assert CK.save(mgr, state)
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    assert not CK.save(mgr, state)                  # the step exists: skipped
    restored = CK.restore(mgr, _trained(cfg, 0, seed=1))
    _assert_equal_states(restored, state)
    if variant == "accum2_ema":
        assert restored.opt_state.mini_step == 1 and restored.opt_state.acc_grads[0].any()
    # one more step from each: bit-equal
    batch = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    _, m_a = TL.train_step(cfg, state, batch)
    _, m_b = TL.train_step(cfg, restored, batch)
    assert {k: float(v) for k, v in m_a.items()} == {k: float(v) for k, v in m_b.items()}
    _assert_equal_states(restored, state)


def test_rotation_keeps_best_and_missing_step(tmp_path):
    cfg = load_config(overrides=OVERRIDES)
    state = _trained(cfg, 0)
    ckpt = str(tmp_path / "ckpt")
    best = CK.make_manager(CK.best_dir(ckpt), keep=1)
    CK.save(best, state)
    CK.write_best_score(ckpt, 0.25, 0)
    mgr = CK.make_manager(ckpt, keep=2)
    for step in range(1, 5):
        state.step = step
        CK.save(mgr, state)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(ckpt)) == ["3", "4"]   # no temporary left behind
    assert best.all_steps() == [0]
    assert sorted(os.listdir(CK.best_dir(ckpt))) == ["0", "best.json"]
    assert CK.read_best_score(ckpt) == 0.25
    template = _trained(cfg, 0, seed=1)
    before = _tensors(template)
    assert CK.restore(mgr, template, step=2) is None          # rotated away
    assert CK.restore(CK.make_manager(tmp_path / "none"), template) is None
    assert not os.path.exists(tmp_path / "none")              # reading creates nothing
    for k, v in _tensors(template).items():
        assert torch.equal(v, before[k]), k
    assert CK.restore(mgr, template, step=3).step == 3


def test_best_score_sidecar(tmp_path):
    ckpt = str(tmp_path / "run")
    assert CK.read_best_score(ckpt) == float("-inf")
    CK.write_best_score(ckpt, 0.5, 12)
    assert CK.read_best_score(ckpt) == 0.5
    with open(os.path.join(CK.best_dir(ckpt), "best.json"), "w") as f:
        f.write("{broken")
    assert CK.read_best_score(ckpt) == float("-inf")


@pytest.mark.parametrize("saved_ema,restore_ema", [(0.9, 0.0), (0.0, 0.9)])
def test_ema_change_raises(tmp_path, saved_ema, restore_ema):
    cfg = load_config(overrides=_overrides({"ema": saved_ema}))
    mgr = CK.make_manager(tmp_path)
    CK.save(mgr, _trained(cfg, 0))
    cfg2 = load_config(overrides=_overrides({"ema": restore_ema}))
    with pytest.raises(ValueError, match="EMA"):
        CK.restore(mgr, _trained(cfg2, 0))


# --------------------------------------------------------------------------
# a JAX checkpoint, exported and imported


def _jax_init():
    """(params, batch_stats) of JAX ``init_state`` at this file's model
    widths: the committed ``golden_config1_params.npz``, which
    ``tests/test_torch_golden.py`` holds equal to a fresh JAX init (a JAX
    init compiles for 13 s on the CPU)."""
    with np.load(FIXTURE) as f:
        flat = {k: f[k] for k in f.files}
    assert json.loads(str(flat.pop("__config__")))["overrides"]["model"] == OVERRIDES["model"]
    return unflatten_variables(flat)


def test_jax_checkpoint_import_continues_the_trajectory(tmp_path):
    ov = _overrides(VARIANTS["ema"])
    jcfg = jax_load_config(overrides=ov)
    b = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = _jax_init()
    jstate = JTL.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=JTL.make_optimizer(jcfg).init(params), rng=jax.random.PRNGKey(0),
        ema_params=jax.tree_util.tree_map(np.copy, params))
    step = JTL.make_train_step(jcfg)
    for _ in range(2):
        jstate, _ = step(jstate, jbatch)
    mgr = JCK.make_manager(str(tmp_path / "orbax"), keep=2)
    JCK.save(mgr, jstate)
    mgr.wait_until_finished()
    npz = str(tmp_path / "state.npz")
    assert EX.export(mgr, jstate, npz) == 2

    cfg = load_config(overrides=ov)
    state = CK.import_flat(cfg, npz, "cpu", directory=str(tmp_path / "port"))
    assert CK.make_manager(tmp_path / "port").all_steps() == [2]
    host = jax.device_get(jstate)
    names = [n for n, _ in state.model.named_parameters()]
    want = from_flax(host.params, host.batch_stats)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    want_ema = from_flax(host.ema_params, {})
    for n, t in zip(names, state.ema_params):
        assert torch.equal(t, want_ema[n]), n
    adam = host.opt_state[1][0]
    assert state.step == 2 and state.opt_state.count == int(adam.count) == 2
    for mine, theirs in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        theirs = from_flax(theirs, {})
        for n, t in zip(names, mine):
            assert torch.equal(t, theirs[n]), n

    # one more step in each package
    jstate, jm = step(jstate, jbatch)
    _, m = TL.train_step(cfg, state, TL.to_device(b, "cpu", TL.TRAIN_KEYS))
    _check_metrics([{k: float(v) for k, v in m.items()}],
                   [{k: float(v) for k, v in jax.device_get(jm).items()}])
    host = jax.device_get(jstate)
    lr_sum = _lr_sum(ov, 3)
    _check_close(state.model.state_dict(), from_flax(host.params, host.batch_stats), lr_sum)
    _check_close(dict(zip(names, state.ema_params)), from_flax(host.ema_params, {}), lr_sum)


@pytest.mark.parametrize("train", [{"optimizer": "sgd"},
                                   {"optimizer": "adamw", "grad_accum_steps": 2},
                                   {"optimizer": "sgd", "grad_accum_steps": 2}])
def test_jax_optimizer_state_import(tmp_path, train):
    """optax's state after 3 calls on random gradients (mid-accumulation
    under ``MultiSteps``), exported and imported; then the same fourth
    gradient through optax and through the port's optimizer."""
    import optax

    ov = _overrides({"warmup_steps": 0, **train})
    jcfg = jax_load_config(overrides=ov)
    cfg = load_config(overrides=ov)
    params, stats = _jax_init()
    rng = np.random.default_rng(0)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32), params)

    opt = JTL.make_optimizer(jcfg)
    ostate = opt.init(params)

    @jax.jit
    def update(g, ostate, params):
        updates, ostate = opt.update(g, ostate, params)
        return optax.apply_updates(params, updates), ostate

    for _ in range(3):
        params, ostate = jax.device_get(update(grads(), ostate, params))
    jstate = JTL.TrainState(step=jnp.asarray(3, jnp.int32), params=params, batch_stats=stats,
                            opt_state=ostate, rng=jax.random.PRNGKey(0))
    npz = str(tmp_path / "opt.npz")
    np.savez(npz, **EX.flat_state(jstate))
    state = CK.import_flat(cfg, npz, "cpu")
    names = [n for n, _ in state.model.named_parameters()]
    assert state.opt_state.mini_step == (1 if "grad_accum_steps" in train else 0)
    g = grads()
    want = from_flax(jax.device_get(update(g, ostate, params)[0]), {})
    gt = from_flax(g, {})
    TL.Optimizer(cfg).apply(state.opt_state, list(state.model.parameters()),
                            [gt[n] for n in names])
    for n, p in zip(names, state.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
