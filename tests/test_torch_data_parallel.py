"""The port's data parallel on the CPU: two ranks, spawned as processes on
``gloo`` with a ``file://`` store under the test's directory, on the tiny
config of ``tests/distributed/test_dp.py`` at batch 2, f32, with EMA 0.9.

* the 2-rank train step from JAX's ``init_state`` weights against JAX's
  ``make_parallel_train_step`` on a 2-device mesh: losses rtol 1e-5,
  parameters, BN statistics and EMA parameters rtol 1e-4 / atol 1e-5 (the
  tolerances of ``test_dp.py``);
* the same step against the port's single-process step on the global batch
  (same tolerances), the two ranks bit-equal to each other; with remat
  bit-equal to without, also with the backward taken outside the
  data-parallel context, as autograd's device thread takes it on the card;
  with dropout within the same tolerance (each
  scene's mask is the one the single process draws for it);
* world 1 (each rank alone in a group of its own) bit-equal to
  ``train_step``;
* the 2-rank eval step against JAX's ``make_parallel_eval_step``:
  ``point_mask_bits`` bit-equal, scores rtol 1e-5 / atol 1e-6; the 2-rank
  ``run_eval`` equal to one process's over the wrap-padded val split;
* the Loader's rank shares against one process's batches, train and eval;
  the dropout masks drawn per global scene.

The ranks import this module to find their body, so it imports JAX only
inside test functions. Every rank runs under a timeout, and its
collectives under the process group's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.pipeline import Loader
from sparse_rcnn_tpu_torch.models.layers import SparseDropout
from sparse_rcnn_tpu_torch.parallel import data_parallel as DP
from sparse_rcnn_tpu_torch.parallel.context import World, shard_context
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.train.evaluate import run_eval

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 2
RANK_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 60
# the config of tests/distributed/test_dp.py at batch 2, with EMA
OVERRIDES = {
    "data": {"num_points": 512, "voxel_capacity": 256, "batch_size": 2,
             "voxel_size": [0.2, 0.2, 0.2], "val_scenes": 3},
    "model": {
        "backbone": {"widths": [8, 16], "blocks_per_scale": 1},
        "rpn": {"hidden": 8, "num_proposals": 4, "pre_nms_topk": 16},
        "roi": {"grid_size": 3, "hidden": 8, "mask_grid": 6},
        "num_classes": 3, "max_instances": 6,
    },
    "train": {"ema": 0.9},
}
PARAMS_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
EVAL_KEYS = ("point_mask_bits", "proposal_scores", "cls_logits")


def _cfg(**backbone):
    ov = {**OVERRIDES, "model": {**OVERRIDES["model"],
                                 "backbone": {**OVERRIDES["model"]["backbone"], **backbone}}}
    return load_config(overrides=ov)


def _batch():
    cfg = _cfg()
    return synthetic.generate_batch(5, 2, num_points=cfg.data.num_points, num_instances=2,
                                    num_classes=cfg.model.num_classes)


def spawn(target: str, tmp, world: int = WORLD, args=()):
    """Run ``target`` (a function of this module) in ``world`` rank
    processes; each gets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and
    ``(tmp, *args)``. Fails if a rank fails or outlives the timeout."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            f"from tests.test_torch_data_parallel import {target}; "
            f"{target}(*sys.argv[1:])")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(tmp), *map(str, args)],
                                      cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# --------------------------------------------------------------------------
# the ranks' side


def _snapshot(state, metrics):
    return {"sd": {k: v.clone() for k, v in state.model.state_dict().items()},
            "ema": [t.clone() for t in state.ema_params],
            "metrics": {k: float(v) for k, v in metrics.items()}}


def remat_backward_elsewhere(cfg, model, world, batch) -> bool:
    """Whether gradients taken outside the data-parallel context (as on the
    card, where the backward runs on autograd's device thread) equal those
    taken inside it: remat's recompute must enter the forward's context."""
    def forward():
        st, _, scales, gt, _ = TL.prepare_inputs(cfg, batch)
        out = model.train()(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
        return TL.compute_losses(cfg, out, scales, gt, st.row_mask)[0]

    params = list(model.parameters())
    grads = []
    with TL.deterministic_on_cpu("cpu"):
        for inside in (True, False):
            with shard_context(world):
                total = forward()
                if inside:
                    grads.append(torch.autograd.grad(total, params, allow_unused=True))
            if not inside:
                grads.append(torch.autograd.grad(total, params, allow_unused=True))
    return all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*grads))


def rank_steps(tmp: str) -> None:
    """Every check of this file that needs ranks, in one spawn."""
    from torch import distributed as dist

    torch.set_num_threads(1)
    world = DP.init("gloo", "cpu", f"file://{tmp}/store", COLLECTIVE_TIMEOUT_S)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    batch = inp["batch"]
    mine = world.share(len(batch["valid"]))
    local = {k: v[mine.start:mine.stop] for k, v in batch.items()}
    out = {}

    def fresh(cfg):
        model = TL.build_model(cfg, "cpu")
        model.load_state_dict(inp["sd"])
        return TL.init_state(cfg, model=model)

    def dp_step(cfg, w, b):
        state = DP.replicate_state(fresh(cfg), w)
        _, m = DP.make_parallel_train_step(cfg, w)(state, TL.to_device(b, "cpu", TL.TRAIN_KEYS))
        return _snapshot(state, m)

    def single_step(cfg):
        state = fresh(cfg)
        _, m = TL.train_step(cfg, state, TL.to_device(batch, "cpu", TL.TRAIN_KEYS))
        return _snapshot(state, m)

    cfg = _cfg()
    out["dp"] = dp_step(cfg, world, local)
    out["single"] = single_step(cfg)
    remat = _cfg(remat=True)
    out["remat"] = dp_step(remat, world, local)
    out["remat_backward_elsewhere"] = remat_backward_elsewhere(remat, fresh(remat).model, world,
                                                               TL.to_device(local, "cpu",
                                                                            TL.TRAIN_KEYS))
    drop = _cfg(dropout=0.1)
    out["dropout_dp"] = dp_step(drop, world, local)
    out["dropout_single"] = single_step(drop)
    # world 1: each rank alone in a group of its own
    groups = [dist.new_group([r]) for r in range(world.size)]
    solo = World(rank=0, size=1, backend=world.backend, group=groups[world.rank])
    out["world1"] = dp_step(cfg, solo, batch)

    model = fresh(cfg).model
    ev = DP.make_parallel_eval_step(cfg, world)(model, TL.to_device(local, "cpu"))
    out["eval"] = {k: ev[k].numpy() for k in EVAL_KEYS}
    with Loader(cfg, "val", train=False, rank=world.rank, world=world.size) as loader, \
            shard_context(world):
        out["run_eval_dp"] = run_eval(cfg, model, loader)
    with Loader(cfg, "val", train=False) as loader:
        out["run_eval_single"] = run_eval(cfg, model, loader)
    torch.save(out, os.path.join(tmp, f"rank{world.rank}.pt"))
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the tests' side


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's 2-device parallel train and eval steps from its ``init_state``,
    and the ranks' results from the same weights and batch."""
    import jax
    import jax.numpy as jnp

    from sparse_rcnn_tpu.config import load_config as jax_load_config
    from sparse_rcnn_tpu.parallel import (make_mesh, make_parallel_eval_step,
                                          make_parallel_train_step, replicate_state,
                                          shard_batch)
    from sparse_rcnn_tpu.train import loop as JTL
    from sparse_rcnn_tpu_torch.models.transfer import from_flax

    tmp = tmp_path_factory.mktemp("dp")
    b = _batch()
    jcfg = jax_load_config(overrides=OVERRIDES)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}
    state = JTL.init_state(jcfg, jbatch)
    sd = from_flax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    torch.save({"sd": sd, "batch": b}, tmp / "inputs.pt")
    spawn("rank_steps", tmp)

    mesh = make_mesh(WORLD)
    pstate = replicate_state(jax.tree_util.tree_map(jnp.copy, state), mesh)
    pbatch = shard_batch(jbatch, mesh)
    jev = jax.device_get(make_parallel_eval_step(jcfg, mesh)(pstate, pbatch))
    s_par, m_par = make_parallel_train_step(jcfg, mesh)(pstate, pbatch)
    s_par = jax.device_get(s_par)
    jax_out = {"sd": from_flax(s_par.params, s_par.batch_stats),
               "ema": from_flax(s_par.ema_params, {}),
               "metrics": {k: float(v) for k, v in jax.device_get(m_par).items()},
               "eval": {k: np.asarray(jev[k]) for k in EVAL_KEYS}}
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return jax_out, ranks


def _assert_close(got, want, what, rtol=PARAMS_TOL["rtol"], atol=PARAMS_TOL["atol"]):
    for k in want["sd"]:
        np.testing.assert_allclose(got["sd"][k].numpy(), np.asarray(want["sd"][k]),
                                   rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


def _assert_equal(got, want, what):
    for k, v in want["sd"].items():
        assert torch.equal(got["sd"][k], v), f"{what}: {k}"
    for i, (a, b) in enumerate(zip(got["ema"], want["ema"])):
        assert torch.equal(a, b), f"{what}: ema {i}"
    assert got["metrics"] == want["metrics"], what


def test_dp_step_matches_jax_parallel_step(runs):
    jax_out, ranks = runs
    got = ranks[0]["dp"]
    for k in ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "total", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], jax_out["metrics"][k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert got["metrics"]["voxel_overflow"] == jax_out["metrics"]["voxel_overflow"]
    _assert_close(got, jax_out, "params and BN statistics against JAX")
    names = [n for n in got["sd"] if n in jax_out["ema"]]
    assert len(names) == len(got["ema"])
    for n, a in zip(names, got["ema"]):
        np.testing.assert_allclose(a.numpy(), jax_out["ema"][n], **PARAMS_TOL,
                                   err_msg=f"ema {n}")


def test_dp_step_matches_single_process_step(runs):
    _, ranks = runs
    _assert_equal(ranks[1]["dp"], ranks[0]["dp"], "rank 1 against rank 0")
    for r in ranks:
        _assert_close(r["dp"], r["single"], "2 ranks against one process")
        for k, v in r["single"]["metrics"].items():
            np.testing.assert_allclose(r["dp"]["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)


def test_dp_step_with_remat_is_bit_equal(runs):
    for r in runs[1]:
        _assert_equal(r["remat"], r["dp"], "remat under data parallel")
        assert r["remat_backward_elsewhere"]


def test_dp_dropout_masks_follow_the_global_scene(runs):
    _, ranks = runs
    _assert_equal(ranks[1]["dropout_dp"], ranks[0]["dropout_dp"], "dropout, rank 1 vs 0")
    r = ranks[0]
    assert r["dropout_dp"]["metrics"]["total"] != r["dp"]["metrics"]["total"]
    _assert_close(r["dropout_dp"], r["dropout_single"], "dropout, 2 ranks against one process")
    for k, v in r["dropout_single"]["metrics"].items():
        np.testing.assert_allclose(r["dropout_dp"]["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)


def test_world_one_is_bit_equal_to_train_step(runs):
    for r in runs[1]:
        _assert_equal(r["world1"], r["single"], "world 1 against train_step")


def test_dp_eval_matches_jax_parallel_eval(runs):
    jax_out, ranks = runs
    got = {k: np.concatenate([r["eval"][k] for r in ranks]) for k in EVAL_KEYS}
    np.testing.assert_array_equal(got["point_mask_bits"], jax_out["eval"]["point_mask_bits"])
    for k in ("proposal_scores", "cls_logits"):
        np.testing.assert_allclose(got[k], jax_out["eval"][k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_run_eval_equals_one_process(runs):
    for r in runs[1]:
        dp, single = r["run_eval_dp"], r["run_eval_single"]
        assert dp["scenes"] == single["scenes"] == 3
        for k, v in single.items():
            if not k.startswith("eval_"):
                assert dp[k] == v, k


@pytest.mark.parametrize("host_voxelize", [False, True])
def test_loader_rank_shares(host_voxelize):
    """Rank r's batches are slots [r, r+1) of one process's, train
    (augmented) and eval (the last batch wrap-padded); a rank voxelizes only
    its own scenes."""
    cfg = load_config(overrides={**OVERRIDES, "data": {
        **OVERRIDES["data"], "num_workers": 2, "host_voxelize": host_voxelize}})
    assert cfg.data.augment
    n = 3
    for split, train in (("train", True), ("val", False)):
        with Loader(cfg, split, train=train, seed=4, threads=False) as whole:
            want = [next(whole) for _ in range(n if train else len(whole))]
        for r in range(WORLD):
            with Loader(cfg, split, train=train, seed=4, threads=False, rank=r,
                        world=WORLD) as share:
                got = list(share) if not train else [next(share) for _ in range(n)]
                assert share.scenes_voxelized == (len(got) if host_voxelize else 0)
                assert share.scenes_replayed == (len(got) if train else 0)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k][r:r + 1], err_msg=k)


def test_loader_refuses_an_uneven_share():
    with pytest.raises(ValueError, match="multiple of the world size"):
        Loader(_cfg(), threads=False, rank=0, world=3)


def test_dropout_masks_are_drawn_per_global_scene():
    """A scene's mask depends only on (seed, step, global scene index): the
    masks of scenes 1..2 drawn alone equal their slots of a batch of 3."""
    cfg = _cfg(dropout=0.5)
    drop = SparseDropout(0.5).train()
    feats = torch.ones((3, 64, 4))
    whole = drop(feats, TL.dropout_generators(cfg, 5, "cpu", range(3)))
    part = drop(feats[1:], TL.dropout_generators(cfg, 5, "cpu", range(1, 3)))
    assert torch.equal(whole[1:], part)
    assert not torch.equal(whole[0], whole[1])
    other = drop(feats, TL.dropout_generators(cfg, 6, "cpu", range(3)))
    assert not torch.equal(whole, other)
