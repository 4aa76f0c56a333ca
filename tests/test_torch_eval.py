"""Evaluation over a split: the port's ``run_eval``, ``eval_step`` and
``fetch_eval_outputs`` (``sparse_rcnn_tpu_torch/train/``) against the JAX
package's, on a state with EMA.

The weights: the JAX init of ``tests/test_torch_checkpoint.py::_jax_init``,
2 JAX steps with ``train.ema = 0.9`` (lr 0.05, no warmup, so that the EMA
and the raw weights part clearly), saved by orbax, exported by
``scripts/export_jax_checkpoint.py`` and imported by ``import_flat``. The
split: 3 synthetic val scenes in batches of 2, the last wrap-padded.

- ``run_eval``: the same keys as JAX's, ``scenes == 3`` in both, every
  metric within 1e-6 (they are the same numpy evaluator on the same
  masks, scores and classes).
- The EMA repair: the port's eval step on the state scores the EMA weights,
  as JAX's does (floats to the tolerances of ``tests/test_torch_golden.py``:
  both sum the same products in other orders); the raw weights' outputs are
  outside those tolerances; ``state.model`` is left bit-identical.
- ``point_mask_bits`` is ``np.packbits(point_mask_logits > 0, axis=-1)``
  exactly, ``fetch_eval_outputs`` leaves out the logits and ``gt``, and
  ``gt`` agrees with JAX's.
- ``run_eval``'s one-batch lookahead, as JAX's: step i+1 is queued before
  batch i is scored, the scenes are scored in batch order, and
  ``max_batches`` and a wrap-padded ``num_scenes`` count as before.
- The eval step reads nothing back on the host, so on the card it returns
  before the card is done: on meta tensors, which carry no data, every such
  read raises. The voxel counts that replace ``torch.bincount`` and the
  voxel means are bit-equal to the ``bincount`` and ``segment_reduce``
  lengths form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts import export_jax_checkpoint as EX
from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.train import checkpoint as JCK
from sparse_rcnn_tpu.train import evaluate as JE
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.pipeline import Loader
from sparse_rcnn_tpu_torch.infer import to_host
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.ops import voxelize as V
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import evaluate as E
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_checkpoint import _jax_init
from tests.test_torch_train import OVERRIDES, SCENE

EVAL_OVERRIDES = {
    # 1020 points: the packed bits' last byte is padded
    "data": {**OVERRIDES["data"], "num_points": 1020, "val_scenes": 3},
    "model": OVERRIDES["model"],
    "train": {"lr": 0.05, "warmup_steps": 0, "total_steps": 50, "ema": 0.9},
}
TIME_KEYS = ("eval_wall_s", "eval_dev_s", "eval_fetch_s", "eval_host_s", "eval_compute_s")
# the same model with a dense tail from scale 1
DENSE_OVERRIDES = {**EVAL_OVERRIDES, "model": {
    **EVAL_OVERRIDES["model"], "backbone": {**EVAL_OVERRIDES["model"]["backbone"],
                                            "dense_from_scale": 1,
                                            "grid_extent": [64, 64, 64]}}}


def _outputs_close(got, want):
    """Eval-step floats as ``tests/test_torch_golden.py`` holds them."""
    np.testing.assert_array_equal(got["proposal_mask"], want["proposal_mask"])
    np.testing.assert_allclose(got["proposal_scores"], want["proposal_scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["cls_logits"], want["cls_logits"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["point_mask_logits"], want["point_mask_logits"],
                               rtol=1e-2, atol=1e-3)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(cfg, port state, JAX state, JAX eval step, numpy val batches)."""
    tmp = tmp_path_factory.mktemp("eval")
    jcfg = jax_load_config(overrides=EVAL_OVERRIDES)
    params, stats = _jax_init()
    jstate = JTL.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=JTL.make_optimizer(jcfg).init(params), rng=jax.random.PRNGKey(0),
        ema_params=jax.tree_util.tree_map(np.copy, params))
    kw = dict(SCENE)
    train_batch = synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    step = JTL.make_train_step(jcfg)
    for _ in range(2):
        jstate, _ = step(jstate, {k: jnp.asarray(v) for k, v in train_batch.items()})
    mgr = JCK.make_manager(str(tmp / "orbax"))
    JCK.save(mgr, jstate)
    mgr.wait_until_finished()
    npz = str(tmp / "state.npz")
    EX.export(mgr, jstate, npz)
    cfg = load_config(overrides=EVAL_OVERRIDES)
    state = CK.import_flat(cfg, npz, "cpu")
    with Loader(cfg, "val", train=False) as loader:
        batches = list(loader)
    return cfg, state, jstate, JTL.make_eval_step(jcfg), batches


def test_run_eval_matches_jax(setup):
    cfg, state, jstate, jstep, batches = setup
    assert len(batches) == 2 and len(Loader(cfg, "val", train=False, threads=False)) == 2
    np.testing.assert_array_equal(batches[1]["points"][1], batches[0]["points"][0])
    jres = JE.run_eval(cfg, jstate, [{k: jnp.asarray(v) for k, v in b.items()}
                                     for b in batches],
                       eval_step=jstep, num_scenes=3, per_class=True, per_scene=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with Loader(cfg, "val", train=False) as loader:
        res = E.run_eval(cfg, state, loader, per_class=True, per_scene=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k          # the eval leaves the model as it is
    assert sorted(res) == sorted([*jres, "eval_compute_s"])    # the port times its compute
    assert res["scenes"] == jres["scenes"] == 3
    assert "semantic_mIoU" in res and "AP@0.5/class0" in res
    assert res["per_scene_mAP@0.5"] == jres["per_scene_mAP@0.5"]
    for k in res:
        if k not in TIME_KEYS + ("per_scene_mAP@0.5", "scenes"):
            np.testing.assert_allclose(res[k], jres[k], rtol=0, atol=1e-6, err_msg=k)
    for k in TIME_KEYS:
        assert res[k] >= 0
    # without the split's size the wrap-pad duplicate is scored again
    assert E.run_eval(cfg, state, batches)["scenes"] == 4
    assert E.run_eval(cfg, state, batches, max_batches=1)["scenes"] == 2


def test_eval_scores_ema_as_jax(setup):
    """The EMA repair: given the state, the port scores ``ema_params``."""
    cfg, state, jstate, jstep, batches = setup
    jout = jax.device_get(jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    before = [p.detach().clone() for p in state.model.parameters()]
    ema = to_host(TL.eval_step(cfg, state, TL.to_device(batches[0], "cpu")))
    _outputs_close(ema, jout)
    for p, q in zip(state.model.parameters(), before):
        assert torch.equal(p, q)                     # state.model was not written
    raw = to_host(TL.eval_step(cfg, state.model, TL.to_device(batches[0], "cpu")))
    with pytest.raises(AssertionError):
        _outputs_close(raw, jout)
    assert np.abs(raw["cls_logits"] - ema["cls_logits"]).max() > 1e-3


def test_point_mask_bits_and_selective_fetch(setup):
    cfg, state, jstate, jstep, batches = setup
    raw = TL.eval_step(cfg, state, TL.to_device(batches[0], "cpu", TL.TRAIN_KEYS))
    logits = raw["point_mask_logits"].numpy()
    bits = raw["point_mask_bits"]
    assert bits.dtype == torch.uint8 and logits.shape[-1] % 8 != 0
    np.testing.assert_array_equal(bits.numpy(), np.packbits(logits > 0, axis=-1))
    out = E.fetch_eval_outputs(raw)
    assert "point_mask_logits" not in out and "gt" not in out
    assert out["point_mask_n"] == logits.shape[-1]
    assert all(isinstance(v, np.ndarray) for k, v in out.items() if k != "point_mask_n")
    host = to_host(raw)
    for b in range(cfg.data.batch_size):
        masks = E.postprocess_scene(out, b, cfg.model.num_classes)[0]
        np.testing.assert_array_equal(masks, logits[b] > 0)
        for got, want in zip(E.postprocess_scene(out, b, cfg.model.num_classes)[1:],
                             E.postprocess_scene(host, b, cfg.model.num_classes)[1:]):
            np.testing.assert_array_equal(got, want)
    # another threshold from the step's own output
    m9 = E.postprocess_scene(host, 0, cfg.model.num_classes, mask_threshold=0.9)[0]
    assert m9.sum() <= (logits[0] > 0).sum()
    # gt, as JAX's eval step gives it
    jout = jax.device_get(jstep(jstate, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    for f in ("classes", "valid", "voxel_instance", "voxel_semantic"):
        np.testing.assert_array_equal(getattr(raw["gt"], f).numpy(),
                                      np.asarray(getattr(jout["gt"], f)), err_msg=f)
    np.testing.assert_allclose(raw["gt"].boxes.numpy(), np.asarray(jout["gt"].boxes),
                               rtol=1e-6, atol=1e-5)
    assert TL.eval_step(cfg, state, TL.to_device(batches[0], "cpu"))["gt"] is None


def test_run_eval_lookahead_order(setup, monkeypatch):
    """Step i+1 is queued before batch i is scored; scoring runs in batch
    order, one batch behind, and the last batch is scored after the loop."""
    cfg, state, _, _, batches = setup
    four = batches + [{k: v.copy() for k, v in b.items()} for b in batches]
    log = []
    step, gt_classes = TL.eval_step, E._gt_classes_from_points

    def spy_step(*args):
        log.append(("step", sum(e[0] == "step" for e in log)))
        return step(*args)

    def spy_score(pinst, psem, point_valid):
        # once a scene scored; point_valid is a view of its host batch's labels
        which = [i for i, b in enumerate(four) if np.shares_memory(point_valid, b["valid"])]
        log.append(("score", *which))
        return gt_classes(pinst, psem, point_valid)

    monkeypatch.setattr(TL, "eval_step", spy_step)
    monkeypatch.setattr(E, "_gt_classes_from_points", spy_score)
    # 8 slots, the last a wrap-pad duplicate
    res = E.run_eval(cfg, state, four, num_scenes=7)
    s, c = "step", "score"
    assert log == [(s, 0), (s, 1), (c, 0), (c, 0), (s, 2), (c, 1), (c, 1), (s, 3),
                   (c, 2), (c, 2), (c, 3)]
    assert res["scenes"] == 7 and res["eval_dev_s"] > 0
    log.clear()
    res = E.run_eval(cfg, state, four, max_batches=3, num_scenes=5)
    assert log == [(s, 0), (s, 1), (c, 0), (c, 0), (s, 2), (c, 1), (c, 1), (c, 2)]
    assert res["scenes"] == 5


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_eval_step_reads_nothing_on_the_host(setup, monkeypatch, form):
    """The whole eval step, GT included, on meta tensors: ``.item()``,
    ``nonzero``, a boolean or 0-d tensor index and ``bincount`` raise on
    them, and ``torch.tensor``/``as_tensor`` onto a device (a pageable copy,
    which on the card waits for the stream) is refused. The card's own
    check is ``chip_smoke.py`` phase 9, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    cfg = setup[0] if form == "sparse" else load_config(overrides=DENSE_OVERRIDES)
    model = TL.build_model(cfg, "meta")
    batch = TL.to_device(setup[4][0], "meta", TL.TRAIN_KEYS)
    monkeypatch.setattr(sc, "conv_forward", sc.sparse_conv_reference)

    def refuse(fn):
        def to_device(data, *args, **kw):
            assert kw.get("device") is None and len(args) < 2, "a copy onto the device"
            return fn(data, *args, **kw)
        return to_device

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse(getattr(torch, name)))
    out = TL.eval_step(cfg, model, batch)
    assert out["point_mask_bits"].device.type == "meta" and out["gt"] is not None


@pytest.mark.parametrize("capacity", [300, 100])
def test_voxel_counts_and_means_unchanged(capacity):
    """Against the ``torch.bincount`` counts and the ``segment_reduce``
    lengths form they replace, on a scene of 216 cells with invalid points,
    empty capacity rows (300) and overflow victims (100): both drop points
    (``p2v == -1``)."""
    rng = np.random.default_rng(12)
    points = torch.from_numpy(rng.uniform(0, 3, (1000, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(1000, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=1000) < 0.9)
    _, vfeats, nv, p2v, ovf = V.voxelize_scene(points, feats, valid, [0.5] * 3, capacity)
    assert (p2v == -1).any() and (int(nv) < capacity) == (capacity == 300)
    assert (int(ovf) > 0) == (capacity == 100)
    seg = torch.where(p2v >= 0, p2v, capacity).to(torch.int64)
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=capacity + 1)
    assert torch.equal(V.segment_offsets(seg[order], capacity + 1).diff(), counts)
    sums = torch.segment_reduce(feats[order], "sum", lengths=counts, axis=0)
    want = sums[:capacity] / torch.clamp(counts[:capacity].to(feats.dtype), min=1.0)[:, None]
    assert torch.equal(vfeats, want)
