"""Checkpoint form conversion (``tools/convert_checkpoint.py``) against the
JAX package's ``scripts/convert_checkpoint.py``, on the CPU, at the shapes
of ``tests/test_torch_dense_tail.py`` with a per-mode config (train form
dense-2, eval form dense-1), EMA and gradient accumulation, so that every
tree of a train state is present.

Tolerances: the conversion is a permutation of entries, so the round trips
and the trees against JAX's ``convert_state_trees`` (carried across by
``from_flax``) are exact; a step resumed from a converted checkpoint
against one from the unconverted: ``tests/test_torch_dense_tail.py``'s
dense ≡ sparse tolerance (2e-3, relative to each loss part and to each
first moment's largest entry: the same sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scripts import convert_checkpoint as JCC
from sparse_rcnn_tpu.models import convert as JC
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.infer import parse_overrides
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.tools import convert_checkpoint as PCC
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import OVERRIDES, SPARSE_TOL, TRAIN_SCENE, _batch, jax_variables

SETS = ["model.backbone.dense_from_scale_train=2", "train.ema=0.9", "train.grad_accum_steps=2"]


def _sets(ckpt_dir, extra=()):
    return list(SETS) + [f"train.checkpoint_dir={ckpt_dir}", *extra]


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    """``OVERRIDES`` as a YAML config, for the CLI's ``--config``."""
    path = tmp_path_factory.mktemp("cfg") / "dense_tail.yaml"
    path.write_text(yaml.safe_dump(OVERRIDES))
    return str(path)


def _cfg(config_file, ckpt_dir, extra=()):
    return load_config(config_file, parse_overrides(_sets(ckpt_dir, extra)))


@pytest.fixture(scope="module")
def trees():
    """Random flax trees of the JAX detector's train form (dense-2): params,
    batch_stats, and param-shaped EMA, Adam moments and accumulator."""
    batch = {k: jnp.asarray(v) for k, v in _batch(TRAIN_SCENE).items()}
    over = {**OVERRIDES, "model": {**OVERRIDES["model"], "backbone": {
        **OVERRIDES["model"]["backbone"], "dense_from_scale_train": 2}}}
    params, stats = jax_variables(over, batch, np.random.default_rng(11))
    assert JC.tree_boundary(params["backbone"]) == 2
    rng = np.random.default_rng(12)

    def like(scale, positive=False):
        return jax.tree_util.tree_map(
            lambda p: (np.abs if positive else np.asarray)(
                rng.normal(0, scale, p.shape)).astype(np.float32), params)
    return {"params": params, "batch_stats": stats, "ema": like(0.1), "mu": like(1e-3),
            "nu": like(1e-6, positive=True), "acc": like(1e-3)}


def _save_port(trees, config_file, ckpt_dir, step=7):
    """The JAX trees as a port train state in the train form, saved at
    ``step``; returns the state."""
    cfg = _cfg(config_file, ckpt_dir)
    state = TL.init_state(cfg, "cpu")
    state.model.load_state_dict(from_flax(trees["params"], trees["batch_stats"]))
    names = [n for n, _ in state.model.named_parameters()]

    def as_list(tree):
        sd = from_flax(tree, {})
        return [sd[n] for n in names]
    state.ema_params = as_list(trees["ema"])
    state.opt_state = TL.OptState(count=3, mu=as_list(trees["mu"]), nu=as_list(trees["nu"]),
                                  mini_step=1, acc_grads=as_list(trees["acc"]))
    state.step = step
    CK.save(CK.make_manager(ckpt_dir), state)
    return state


def _convert(config_file, src, out, to, step=None, extra=()):
    argv = ["--config", config_file, "--to-dense", to, "--out-dir", out, "--device", "cpu"]
    argv += sum((["--set", s] for s in _sets(src, extra)), [])
    argv += [] if step is None else ["--step", str(step)]
    return PCC.main(argv)


def _restore(config_file, out, to_s0):
    """The converted checkpoint restored under the config of its form."""
    cfg = _cfg(config_file, out, PCC.form_overrides(to_s0))
    assert TL.train_cfg(cfg) is cfg and cfg.model.backbone.dense_from_scale == to_s0
    state = CK.restore(CK.make_manager(out), TL.init_state(cfg, "cpu"))
    assert state is not None
    return cfg, state


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    names = [n for n, _ in state.model.named_parameters()]
    for key, ts in (("ema", state.ema_params), ("mu", state.opt_state.mu),
                    ("nu", state.opt_state.nu), ("acc", state.opt_state.acc_grads)):
        out.update({f"{key}.{n}": t for n, t in zip(names, ts)})
    return out


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("via", ["none", "1", "2"])
def test_round_trip_bit_equal(trees, config_file, tmp_path, via):
    """dense-2 → ``via`` → dense-2: every tree bit-equal, counts kept."""
    src = str(tmp_path / "src")
    state = _save_port(trees, config_file, src)
    mid, back = str(tmp_path / "mid"), str(tmp_path / "back")
    _convert(config_file, src, mid, via)
    to_s0 = None if via == "none" else int(via)
    _, conv = _restore(config_file, mid, to_s0)
    assert conv.model.backbone.dense_from_scale == to_s0
    _convert(config_file, mid, back, "2", extra=PCC.form_overrides(to_s0))
    _, again = _restore(config_file, back, 2)
    _assert_equal(_tensors(again), _tensors(state))
    assert (again.step, again.opt_state.count, again.opt_state.mini_step) == (7, 3, 1)
    with pytest.raises(SystemExit):          # the step is already there
        _convert(config_file, mid, back, "2", extra=PCC.form_overrides(to_s0))


@pytest.mark.parametrize("to", ["none", "1"])
def test_trees_equal_jax_convert_state_trees(trees, config_file, tmp_path, to):
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    _save_port(trees, config_file, src)
    _convert(config_file, src, out, to, step=7)
    to_s0 = None if to == "none" else int(to)
    _, got = _restore(config_file, out, to_s0)
    conv = {k: JCC.convert_state_trees(dict(v), to_s0) for k, v in trees.items()}
    want = {f"model.{k}": v for k, v in from_flax(conv["params"], conv["batch_stats"]).items()}
    for key in ("ema", "mu", "nu", "acc"):
        want.update({f"{key}.{n}": v for n, v in from_flax(conv[key], {}).items()})
    _assert_equal(_tensors(got), want)
    # restoring needs the target form: the source config refuses the shapes
    with pytest.raises((ValueError, RuntimeError)):
        CK.restore(CK.make_manager(out), TL.init_state(_cfg(config_file, out), "cpu"))


@pytest.fixture(scope="module")
def unconverted_step(trees, config_file, tmp_path_factory):
    """A train-form checkpoint at step 0, and one step from it unconverted:
    (its directory, the state after the step, the step's metrics, the batch)."""
    src = str(tmp_path_factory.mktemp("unconverted") / "src")
    state = _save_port(trees, config_file, src, step=0)
    batch = TL.to_device(_batch(TRAIN_SCENE), "cpu", TL.TRAIN_KEYS)
    _, metrics = TL.train_step(_cfg(config_file, src), state, batch)
    return src, state, metrics, batch


@pytest.mark.parametrize("to", ["none", "1"])
def test_resumed_step_matches_unconverted(unconverted_step, config_file, tmp_path, to):
    src, state, want, batch = unconverted_step
    out = str(tmp_path / "out")
    _convert(config_file, src, out, to)
    tcfg, conv = _restore(config_file, out, None if to == "none" else int(to))
    _, got = TL.train_step(tcfg, conv, batch)
    for k in ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=SPARSE_TOL["rtol"],
                                   err_msg=k)
    # the step's first moments, carried back to the train form
    back = PCC.convert_state(_cfg(config_file, src, PCC.form_overrides(2)), conv)
    names = [n for n, _ in state.model.named_parameters()]
    for name, g, w in zip(names, back.opt_state.mu, state.opt_state.mu):
        scale = max(float(w.abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=SPARSE_TOL["atol"] * scale, err_msg=name)
    assert (conv.step, conv.opt_state.count) == (state.step, state.opt_state.count) == (1, 4)
