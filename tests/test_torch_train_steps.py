"""Three training steps of the port against JAX ``make_train_step``.

From one JAX ``init_state`` carried over by ``from_flax``, both packages
take 3 steps on the batch of ``tests/e2e/test_train.py``: the loss parts
and gradient norm of each step, and the params, BN statistics and EMA
params after step 3, with EMA on, and with ``grad_accum_steps=2`` (plus
EMA, gated to the applied update). The port's optimizer is optax's chain
written out (``train/loop.py``).

``tests/fixtures/golden_config1_train.npz`` is JAX's 3-step trajectory at
the config of ``tests/test_torch_golden.py``, from the committed
``golden_config1_params.npz``; the card's machine has no JAX, so
``chip_smoke.py`` holds the card against it too. Regenerate it from the
repository's root with ``python -m tests.test_torch_train_steps``.

Tolerances: loss parts 1e-5 relative and the gradient norm 1e-4 (f32 sums
in other orders). Params: Adam moves each entry by about ``lr · sign(g)``
per update whatever the size of g, so an entry whose gradient is f32 noise
(a sum that cancels) can move differently in the two packages. Measured on
these inputs: of ~40k entries all but at most 2 agree within 1e-6 (the
summation order carried through the updates) and the others within 4.2e-5.
So: every entry within 2 · Σ lr of the applied updates (the most two Adam
steps with |update| ≤ 1 can part), and at most ``PARAM_OUTLIERS`` of the
entries past ``PARAM_ATOL``. ``test_optimizer_matches_optax`` holds the
optimizer alone, fed the same gradients, to 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.data import synthetic as jax_synthetic
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models.transfer import (flatten_variables, from_flax,
                                                   unflatten_variables)
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_train import OVERRIDES, SCENE

HERE = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(HERE, "fixtures", "golden_config1_params.npz")
TRAIN_FIXTURE = os.path.join(HERE, "fixtures", "golden_config1_train.npz")
GOLDEN_TRAIN = {"lr": 3e-3, "warmup_steps": 2, "total_steps": 50}
STEPS = 3
METRIC_KEYS = ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic", "total")
PARAM_ATOL = 1e-6
PARAM_OUTLIERS = 2.5e-4
VARIANTS = {"ema": {"ema": 0.9},
            "accum2_ema": {"ema": 0.9, "grad_accum_steps": 2, "warmup_steps": 0}}


def _overrides(train):
    return {**OVERRIDES, "train": {**OVERRIDES["train"], **train}}


def _jax_trajectory(overrides, params, batch_stats, batch):
    cfg = jax_load_config(overrides=overrides)
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731 (donated)
    state = JTL.TrainState(
        step=jnp.zeros((), jnp.int32), params=copy(params), batch_stats=copy(batch_stats),
        opt_state=JTL.make_optimizer(cfg).init(params), rng=jax.random.PRNGKey(0),
        ema_params=copy(params) if cfg.train.ema > 0 else None)
    step = JTL.make_train_step(cfg)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return jax.device_get(state), metrics


def _port_trajectory(overrides, flat, batch):
    cfg = load_config(overrides=overrides)
    model = TL.build_model(cfg, "cpu")
    model.load_state_dict(from_flax(*unflatten_variables(flat)))
    state = TL.init_state(cfg, model=model)
    metrics = []
    for _ in range(STEPS):
        state, m = TL.train_step(cfg, state, TL.to_device(batch, "cpu", TL.TRAIN_KEYS))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _check_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4,
                                   err_msg=f"step {i} grad_norm")


def _check_close(got: dict, want: dict, lr_sum: float):
    """Parameters (or EMA parameters) by name, to the tolerances above."""
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([np.abs(np.asarray(got[k]) - np.asarray(want[k])).ravel()
                            for k in want])
    worst = max(want, key=lambda k: np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
    assert diffs.max() <= 2 * lr_sum, (worst, diffs.max())
    assert (diffs > PARAM_ATOL).mean() <= PARAM_OUTLIERS, (worst, np.sort(diffs)[-10:])


def _lr_sum(overrides, updates):
    sched = TL.make_schedule(load_config(overrides=overrides))
    return sum(sched(i) for i in range(updates))


@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_load_config(overrides=OVERRIDES)
    kw = dict(SCENE)
    b = jax_synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    state = JTL.init_state(cfg, batch)
    return jax.device_get(state.params), jax.device_get(state.batch_stats), batch, b


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_steps_match_jax(jax_init, variant):
    params, stats, jbatch, batch = jax_init
    ov = _overrides(VARIANTS[variant])
    jstate, jmetrics = _jax_trajectory(ov, params, stats, jbatch)
    state, metrics = _port_trajectory(ov, flatten_variables(params, stats), batch)
    _check_metrics(metrics, jmetrics)
    assert metrics[2]["total"] != metrics[1]["total"]      # an update with lr > 0
    updates = state.opt_state.count
    assert updates == (1 if variant == "accum2_ema" else STEPS)
    lr_sum = _lr_sum(ov, updates)
    _check_close(state.model.state_dict(), from_flax(jstate.params, jstate.batch_stats),
                 lr_sum)
    names = [n for n, _ in state.model.named_parameters()]
    _check_close(dict(zip(names, state.ema_params)), from_flax(jstate.ema_params, {}), lr_sum)


def test_schedule_matches_optax():
    for train in ({"warmup_steps": 2, "total_steps": 50},
                  {"warmup_steps": 0, "total_steps": 50, "grad_accum_steps": 4},
                  {"warmup_steps": 100, "total_steps": 10000}):
        sched = TL.make_schedule(load_config(overrides=_overrides(train)))
        jsched = JTL.make_schedule(jax_load_config(overrides=_overrides(train)))
        for count in (0, 1, 2, 3, 11, 12, 40, 100, 5000, 20000):
            np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{train} count {count}")


def _golden_inputs():
    with np.load(PARAMS) as f:
        flat = {k: f[k] for k in f.files}
    spec = json.loads(str(flat.pop("__config__")))
    kw = dict(spec["scene"])
    batch = synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    return spec, flat, batch


def test_port_reproduces_golden_train_trajectory():
    spec, flat, batch = _golden_inputs()
    with np.load(TRAIN_FIXTURE) as f:
        want = {k: f[k] for k in f.files}
    meta = json.loads(str(want.pop("__config__")))
    assert meta == {"overrides": spec["overrides"], "scene": spec["scene"],
                    "train": GOLDEN_TRAIN, "steps": STEPS}
    ov = {**spec["overrides"], "train": GOLDEN_TRAIN}
    state, metrics = _port_trajectory(ov, flat, batch)
    _check_metrics(metrics, [{k: float(want[f"metrics/{k}"][i])
                              for k in METRIC_KEYS + ("grad_norm",)} for i in range(STEPS)])
    _check_close(state.model.state_dict(), from_flax(*unflatten_variables(
        {k: v for k, v in want.items() if not k.startswith("metrics/")})), _lr_sum(ov, STEPS))


@pytest.mark.parametrize("train", [
    {"optimizer": "adamw"}, {"optimizer": "adamw", "grad_clip": 1e3},
    {"optimizer": "sgd"}, {"optimizer": "adamw", "grad_accum_steps": 2}])
def test_optimizer_matches_optax(train):
    """The port's optimizer and optax's chain on the same parameters and
    gradients, call by call (the default clip of 10 is active on these
    gradients; 1e3 leaves them as they are)."""
    ov = _overrides({"warmup_steps": 0, **train})
    opt = JTL.make_optimizer(jax_load_config(overrides=ov))
    port = TL.Optimizer(load_config(overrides=ov))
    rng = np.random.default_rng(0)
    shapes = {"a": {"kernel": (27, 4, 8)}, "b": {"bias": (8,), "scale": (8,)}}
    params = {m: {k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    leaves = [params[m][k] for m in shapes for k in shapes[m]]
    tparams = [torch.from_numpy(x.copy()) for x in leaves]
    jstate, state = opt.init(params), port.init(tparams)
    for call in range(4):
        grads = {m: {k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in d.items()}
                 for m, d in shapes.items()}
        updates, jstate = opt.update(grads, jstate, params)
        params = jax.device_get(optax_apply(params, updates))
        port.apply(state, tparams, [torch.from_numpy(grads[m][k]) for m in shapes
                                    for k in shapes[m]])
        for t, want in zip(tparams, [params[m][k] for m in shapes for k in shapes[m]]):
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{train} call {call}")


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    spec, flat, batch = _golden_inputs()
    params, stats = unflatten_variables(flat)
    jstate, jmetrics = _jax_trajectory({**spec["overrides"], "train": GOLDEN_TRAIN},
                                       params, stats,
                                       {k: jnp.asarray(v) for k, v in batch.items()})
    out = flatten_variables(jstate.params, jstate.batch_stats)
    for k in METRIC_KEYS + ("grad_norm",):
        out[f"metrics/{k}"] = np.asarray([m[k] for m in jmetrics], np.float32)
    out["__config__"] = np.array(json.dumps({
        "overrides": spec["overrides"], "scene": spec["scene"], "train": GOLDEN_TRAIN,
        "steps": STEPS}))
    np.savez(TRAIN_FIXTURE, **out)
    print(f"wrote {TRAIN_FIXTURE}")
