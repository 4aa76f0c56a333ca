"""Config 3 (S3DIS large rooms) on the port, cut to a tiny size with the
same keys: ``remat`` on, the dense tail from scale 3 in the eval and the
train form, 13 classes, 5 scales, bf16, batch 1; scenes written in the
ScanNet layout (one ``.npz`` a scene under ``<root>/train/``) by the
benchmark's writer and read by ``S3DISDataset`` in the ``Loader``.

* Two train steps of the port (``Loader`` → ``device_batches`` →
  ``train_step``) against the benchmark's float32 reference
  (``portbench/reference/check.py::train_reference``) from the same seeded
  weights and Loader seed: the batches equal, the losses within
  ``LOSS_GAP`` and the first clipped gradient within ``GRAD_GAP``.
* remat on against remat off in float32: the losses, every gradient and
  the BN running statistics bit for bit.
* The recompute's counters over one step: every residual block (sparse and
  dense) recomputed once, each as a span ``remat`` under ``backward``
  inside ``recording()``, one pass, and the sparse-conv forward launches
  made while recomputing equal to the convs that
  ``portbench/core/flops_remat.py`` counts for the step.
"""

import os

import numpy as np
import pytest
import torch

from portbench.core import flops_remat
from portbench.core.scenes import write_pool
from portbench.reference import check as RC
from portbench.reference.srcnn.config import load_config as ref_load_config
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data.datasets import S3DISDataset, build_dataset
from sparse_rcnn_tpu_torch.data.pipeline import Loader, device_batches
from sparse_rcnn_tpu_torch.models import layers as L
from sparse_rcnn_tpu_torch.models.unet import DenseBasicBlock
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "config3_s3dis.yaml")
RECIPE = {"layout": "scannet", "num_instances": 16, "extent": 14.0, "stretch": None}
TINY = {
    "data": {"voxel_size": [0.2, 0.2, 0.2], "num_points": 2048, "voxel_capacity": 2048},
    "model": {"backbone": {"widths": [8, 12, 16, 20, 24], "grid_extent": [128, 128, 32],
                           "capacities": [2048, 1536, 768, 256, 128]},
              "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
              "roi": {"grid_size": 3, "hidden": 16, "mask_grid": 6}},
}
SEED = 2600000017
# The port computes in bf16, the reference in f32. Over eight other seeds
# of this tiny cut the relative loss gap read at most 6.5e-4 and the worst
# parameter's gradient gap 0.249 (bf16 rounds each operand to 2^-8, and the
# deepest gradients of a bf16 backbone stand up to ~25 % off an f32 run's,
# tests/test_torch_precision.py); a step that leaves the state unchanged
# reads a gradient gap of 1.
LOSS_GAP = 2e-3
GRAD_GAP = 0.6


def _cfg(root, **backbone):
    over = {"data": {**TINY["data"], "dataset": "s3dis", "data_root": root},
            "model": {**TINY["model"], "backbone": {**TINY["model"]["backbone"], **backbone}}}
    return load_config(CONFIG, over)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("config3"))
    write_pool(RECIPE, _cfg(d), d, "train", 4)
    return d


def test_the_tiny_cut_keeps_config3s_keys(root):
    cfg = _cfg(root)
    bb = cfg.model.backbone
    assert bb.remat and bb.dense_from_scale == 3 and len(bb.widths) == 5
    assert TL.train_cfg(cfg).model.backbone.dense_from_scale == 3
    assert cfg.model.num_classes == 13 and cfg.data.batch_size == 1
    assert isinstance(build_dataset(cfg, "train"), S3DISDataset)


def test_two_loader_steps_against_the_reference(root):
    cfg = _cfg(root)
    state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(SEED))
    init = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    p0 = [p.detach().clone() for p in state.model.parameters()]
    loader = Loader(cfg, "train", seed=SEED)
    prog = {"batches": [], "losses": []}
    try:
        stream = device_batches(loader, "cpu", TL.TRAIN_KEYS)
        for t in range(2):
            host, dev = next(stream)
            prog["batches"].append({k: np.array(host[k]) for k in TL.TRAIN_KEYS})
            state, m = TL.train_step(cfg, state, dev)
            prog["losses"].append(float(m["total"]))
            if t == 0:
                prog["grad_norms"] = RC.leaf_norms(state.opt_state.mu) / (1.0 - RC.B1)
    finally:
        loader.close()
    prog["change_norms"] = RC.leaf_norms(
        [p - q for p, q in zip(state.model.parameters(), p0)])
    # the reference reads the ScanNet layout the files are written in
    rcfg = ref_load_config(CONFIG, {"data": {**TINY["data"], "dataset": "scannet",
                                             "data_root": root}, "model": TINY["model"]})
    ref = RC.train_reference(rcfg, init, SEED, "cpu", steps=2)
    got = RC.train_numbers(prog, ref)
    assert got["batch_diff"] == 0
    assert got["loss_gap"] <= LOSS_GAP, got
    assert got["grad_gap"] <= GRAD_GAP, got


def _one_step(cfg, batch):
    state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(3))
    total, parts, grads, _ = TL.loss_and_grads(cfg, state.model, batch)
    stats = {k: v for k, v in state.model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    return total, parts, grads, stats


def test_remat_changes_no_bit_in_float32(root):
    runs = {}
    for remat in (False, True):
        cfg = _cfg(root, remat=remat, dtype="float32")
        host = next(iter(Loader(cfg, "train", seed=SEED, threads=False)))
        runs[remat] = _one_step(cfg, TL.to_device(host, "cpu", TL.TRAIN_KEYS))
    (t0, p0, g0, s0), (t1, p1, g1, s1) = runs[False], runs[True]
    assert torch.equal(t0, t1) and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert len(g0) == len(g1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert sorted(s0) == sorted(s1) and s0
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_the_recompute_is_counted_and_spanned(root, monkeypatch):
    cfg = _cfg(root)
    state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(5))
    host = next(iter(Loader(cfg, "train", seed=SEED, threads=False)))
    batch = TL.to_device(host, "cpu", TL.TRAIN_KEYS)

    def forward(feats, idx, weights):         # the card's count on the plain version
        sc.KERNEL.launches += 1
        return sc.sparse_conv_reference(feats, idx, weights)
    monkeypatch.setattr(sc, "conv_forward", forward)
    before = {k: getattr(L.REMAT, k) for k in ("blocks", "launches", "ns", "passes")}
    with P.recording() as recs:
        TL.train_step(cfg, state, batch)
    moved = {k: getattr(L.REMAT, k) - v for k, v in before.items()}

    blocks = sum(isinstance(m, (L.SparseBasicBlock, DenseBasicBlock))
                 for m in state.model.modules())
    assert blocks == 3 * 2 * 2 + 3 * 2          # sparse scales 0-2; the tail's 3-4
    assert moved["blocks"] == blocks and moved["passes"] == 1
    remats = [r for r in recs if r.name == "remat"]
    backward = [r for r in recs if r.name == "backward"]
    assert len(remats) == blocks and len(backward) == 1
    assert all(r.parent == backward[0].id for r in remats)
    assert P.stage_table(recs)["remat"]["counts"] == {"remat_blocks": blocks}
    assert moved["ns"] == sum(r.ns for r in remats) > 0

    rcfg = ref_load_config(CONFIG, {"data": {**TINY["data"], "data_root": root},
                                    "model": TINY["model"]})
    n_sparse = rcfg.model.backbone.dense_from_scale_train or rcfg.model.backbone.dense_from_scale
    zero = {"sites": [0] * 5, "subm_pairs": [0] * 5, "down_pairs": [0] * 4}
    assert moved["launches"] == len(flops_remat.remat_convs(rcfg, n_sparse, zero)) == 27
