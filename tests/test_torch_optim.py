"""The optimizer's plain versions (``sparse_rcnn_tpu_torch/ops/optim.py``)
and their place in the train step, on the CPU.

- :func:`chunk_plan` cuts every tensor into chunks that cover each entry
  once, in parameter order, and the list into launches of at most
  ``MAX_TENSORS`` whole tensors;
- :func:`global_norm_reference` adds in the order its docstring (and the
  kernel's) states, checked bit for bit against a loop over numpy float32
  scalars, and is within 1e-6 relative of the float64 norm on config 2's
  165 parameter shapes, and of ``optax.global_norm`` beyond optax's own
  error there (its float32 sums miss the float64 norm by about 1e-6);
- ``Optimizer.apply`` on CPU tensors launches no kernel and updates the
  moments in place;
- a NaN gradient makes every parameter NaN, in the port as in optax
  (``clip_by_global_norm`` scales by a NaN norm);
- the EMA that ``train_step`` now runs inside ``Optimizer.apply`` equals,
  bit for bit, the EMA it ran before as two foreach calls after the update.

``tests/test_torch_train_steps.py::test_optimizer_matches_optax`` holds the
update itself against optax to 1e-6.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import optim as OPT
from sparse_rcnn_tpu_torch.train import loop as TL
from benchmarks.optim_cases import config_shapes

C = OPT.CHUNK


@pytest.mark.parametrize("numels,max_tensors", [
    ([1], OPT.MAX_TENSORS),
    ([C - 1, C, C + 1], OPT.MAX_TENSORS),
    ([0, 5, 0, 2 * C + 1, 0], 2),
    ([(i * 997) % 3000 + 1 for i in range(OPT.MAX_TENSORS + 8)], OPT.MAX_TENSORS),
    ([3 * C] * 20 + [0] * 9, 7),
], ids=["one", "chunk_edges", "empty_tensors", "past_one_launch", "small_launches"])
def test_chunk_plan_covers_every_entry_once_in_order(numels, max_tensors):
    chunks, launches = OPT.chunk_plan(numels, max_tensors=max_tensors)
    want = [(i, s) for i, n in enumerate(numels) for s in range(0, n, C)]
    assert [(t, s) for t, s, _ in chunks] == want
    for i, n in enumerate(numels):
        assert sum(ln for t, _, ln in chunks if t == i) == n
        assert all(0 < ln <= C for t, _, ln in chunks if t == i)
    covered = []
    for a, b, c0, c1 in launches:
        assert 0 < b - a <= max_tensors and c1 > c0
        assert [t for t, _, _ in chunks[c0:c1]] == [t for t in range(a, b) for _ in
                                                    range(-(-numels[t] // C))]
        covered += list(range(c0, c1))
    assert covered == list(range(len(chunks)))
    assert len(launches) == sum(1 for a in range(0, len(numels), max_tensors)
                                if sum(numels[a:a + max_tensors]))


def _norm_by_loops(arrays) -> np.float32:
    """The kernels' order written as loops over numpy float32 scalars."""
    f = np.float32
    T = OPT.THREADS

    def tree(vals):
        vals = list(vals)
        w = T
        while w > 1:
            w //= 2
            vals = [f(vals[t] + vals[t + w]) for t in range(w)]
        return vals[0]
    partials = []
    for x in arrays:
        for start in range(0, x.size, C):
            chunk = x[start:start + C]
            sums = []
            for t in range(T):
                acc = f(0)
                for i in range(OPT.GROUPS):
                    for u in range(4):
                        j = 4 * (i * T + t) + u
                        if j < chunk.size:
                            acc = f(acc + f(chunk[j] * chunk[j]))
                sums.append(acc)
            partials.append(tree(sums))
    sums = [f(0)] * T
    for j, p in enumerate(partials):
        sums[j % T] = f(sums[j % T] + p)
    return np.sqrt(tree(sums))


def test_global_norm_reference_follows_the_kernel_order():
    rng = np.random.default_rng(1)
    arrays = [(rng.standard_normal(n) * s).astype(np.float32)
              for n, s in ((1, 3.0), (1029, 0.01), (C + 3, 1.0), (5, 1e3))]
    got = OPT.global_norm_reference([torch.from_numpy(a) for a in arrays])
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().view(np.int32) == _norm_by_loops(arrays).view(np.int32)


def test_global_norm_reference_matches_float64_and_optax():
    """Config 2's 165 parameter shapes (11.7 M entries), each tensor its own
    scale, as gradients are."""
    shapes = config_shapes("config2_scannet_2cm")
    assert len(shapes) == 165
    rng = np.random.default_rng(2)
    arrays = [(rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
              for s in shapes]
    got = float(OPT.global_norm_reference([torch.from_numpy(a) for a in arrays]))
    f64 = float(np.sqrt(sum(np.dot(a.ravel().astype(np.float64), a.ravel().astype(np.float64))
                            for a in arrays)))
    jx = float(jax.jit(optax.global_norm)(arrays))
    assert abs(got - f64) <= 1e-6 * f64, (got, f64)
    # optax's own float32 sums over these 11.7 M entries miss the float64
    # norm by about 1e-6 of it (1.2e-6 on this seed; the fixed order here by
    # 6e-8): against optax, 1e-6 beyond optax's own error
    assert abs(got - jx) <= 1e-6 * jx + abs(jx - f64), (got, jx, f64)
    assert float(OPT.global_norm([torch.from_numpy(a) for a in arrays])) == got


def _cfg(**train):
    return load_config(overrides={"train": {"warmup_steps": 0, **train}})


def _lists(rng, shapes, scale=3.0):
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
            for s in shapes]


SHAPES = [(27, 4, 8), (8,), (8,), (5,)]


@pytest.mark.parametrize("train", [{"optimizer": "adamw", "ema": 0.9},
                                   {"optimizer": "sgd"},
                                   {"optimizer": "adamw", "grad_accum_steps": 2, "ema": 0.9}],
                         ids=["adamw_ema", "sgd", "accum2_ema"])
def test_cpu_optimizer_launches_no_kernel_and_updates_moments_in_place(train):
    cfg = _cfg(**train)
    rng = np.random.default_rng(3)
    params = _lists(rng, SHAPES, 1.0)
    opt = TL.Optimizer(cfg)
    state = opt.init(params)
    mu, nu = state.mu, state.nu
    ema = [p.clone() for p in params] if cfg.train.ema > 0 else None
    before = (NL.LAUNCHES["global_norm"], NL.LAUNCHES["optim_apply"])
    for _ in range(2):
        opt.apply(state, params, _lists(rng, SHAPES), ema, np.float32(0.5))
    assert (NL.LAUNCHES["global_norm"], NL.LAUNCHES["optim_apply"]) == before
    assert state.mu is mu and all(a is b for a, b in zip(state.mu, mu))
    assert state.nu is nu and (nu is None or all(a is b for a, b in zip(state.nu, nu)))
    assert state.count == (1 if cfg.train.grad_accum_steps > 1 else 2)
    assert all(m.abs().max() > 0 for m in state.mu)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_nan_gradient_gives_nan_parameters_as_in_optax(optimizer):
    ov = {"train": {"warmup_steps": 0, "optimizer": optimizer}}
    rng = np.random.default_rng(4)
    params = [(rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    grads = [(rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
    grads[1][3] = np.nan
    tparams = [torch.from_numpy(p.copy()) for p in params]
    port = TL.Optimizer(load_config(overrides=ov))
    norm = port.apply(port.init(tparams), tparams, [torch.from_numpy(g) for g in grads])
    assert torch.isnan(norm)
    opt = JTL.make_optimizer(jax_load_config(overrides=ov))
    want = jax.device_get(jax.jit(lambda g, p: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(grads, params))
    for t, w in zip(tparams, want):
        assert np.isnan(w).all() and torch.isnan(t).all()


@pytest.mark.parametrize("accum", [1, 2])
def test_ema_through_apply_equals_the_foreach_ema_after_the_update(accum):
    """``train_step``'s optimizer stage against the update without EMA
    followed by the EMA as ``train_step`` ran it before (two foreach calls,
    d = 1 on a mini-step that applied nothing), over 4 steps."""
    cfg = _cfg(ema=0.99, grad_accum_steps=accum)
    rng = np.random.default_rng(5)
    params = _lists(rng, SHAPES, 1.0)
    grads = [_lists(rng, SHAPES) for _ in range(4)]
    new_p = [p.clone() for p in params]
    new = TL.TrainState(step=0, model=None, opt_state=TL.Optimizer(cfg).init(new_p),
                        ema_params=[p.clone() for p in params])
    old_p = [p.clone() for p in params]
    old = TL.TrainState(step=0, model=None, opt_state=TL.Optimizer(cfg).init(old_p),
                        ema_params=[p.clone() for p in params])
    for step, g in enumerate(grads):
        norm = TL.optimizer_step(cfg, new, new_p, [x.clone() for x in g])
        new.step += 1
        applied = TL.Optimizer(cfg).apply(old.opt_state, old_p, [x.clone() for x in g])
        t = np.float32(step)
        d = min(np.float32(cfg.train.ema), (np.float32(1) + t) / (np.float32(10) + t))
        if accum > 1 and applied is None:
            d = np.float32(1)
        torch._foreach_mul_(old.ema_params, float(d))
        torch._foreach_add_(old.ema_params, torch._foreach_mul(old_p, float(np.float32(1) - d)))
        assert torch.equal(norm, TL.global_norm(g))
        for a, b in zip(new_p + new.ema_params, old_p + old.ema_params):
            assert torch.equal(a, b), step
    assert new.opt_state.count == 4 // accum
