"""The port's CLIs on the CPU (``--device cpu``), as
``tests/e2e/test_cli_and_entry.py`` drives the JAX package's: ``train``
with the in-training eval and checkpoints writes ``<checkpoint_dir>_best``
and resumes; ``eval --best`` and ``--raw-params`` print an ``mAP@0.5``
line; ``infer --best`` writes ``scene0000.npz``; the pidfile guard refuses a
live trainer and reclaims a stale pidfile; ``--device cuda`` without a card
exits nonzero. Narrow widths, as the JAX CLI tests use."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu_torch import eval as eval_cli
from sparse_rcnn_tpu_torch import infer as infer_cli
from sparse_rcnn_tpu_torch.train import __main__ as train_cli
from sparse_rcnn_tpu_torch.train import checkpoint as CK

TINY = [
    "data.num_points=512", "data.voxel_capacity=256", "data.batch_size=2",
    "data.voxel_size=[0.2,0.2,0.2]", "data.val_scenes=3",
    "model.backbone.widths=[8,16]", "model.rpn.hidden=8", "model.rpn.num_proposals=4",
    "model.rpn.pre_nms_topk=16", "model.roi.grid_size=3", "model.roi.hidden=8",
    "model.roi.mask_grid=6", "model.num_classes=3", "model.max_instances=6",
    "train.ema=0.9", "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=2",
    "train.eval_scenes=3",
]


def _args(ckpt, *extra):
    return sum((["--set", s] for s in TINY + [f"train.checkpoint_dir={ckpt}", *extra]), [])


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-step run: (checkpoint dir, its jsonl lines, the final state)."""
    tmp = tmp_path_factory.mktemp("cli")
    ckpt, log = str(tmp / "ckpt"), str(tmp / "train.jsonl")
    state = train_cli.main(_args(ckpt, "train.total_steps=4")
                           + ["--device", "cpu", "--log-file", log])
    return ckpt, _lines(log), state


def test_train_evaluates_checkpoints_and_keeps_best(trained):
    ckpt, lines, state = trained
    kinds = [r["kind"] for r in lines]
    assert kinds.count("train") == 4 and kinds[-1] == "done" and state.step == 4
    evals = [r for r in lines if r["kind"] == "eval"]
    raws = [r for r in lines if r["kind"] == "eval_raw"]
    assert [r["step"] for r in evals] == [r["step"] for r in raws] == [2, 4]
    assert all(r["scenes"] == 3 and "mAP@0.5" in r for r in evals + raws)
    assert [r["step"] for r in lines if r["kind"] == "checkpoint"] == [2, 4]
    assert CK.make_manager(ckpt).all_steps() == [2, 4]
    best = [r for r in lines if r["kind"] == "checkpoint_best"]
    assert best and best[0]["step"] == 2
    with open(os.path.join(CK.best_dir(ckpt), "best.json")) as f:
        sidecar = json.load(f)
    assert sidecar["step"] == best[-1]["step"]
    assert CK.make_manager(CK.best_dir(ckpt)).all_steps() == [best[-1]["step"]]
    assert not os.path.exists(os.path.join(ckpt, "trainer.pid"))


def test_resume_continues_from_latest(trained, tmp_path):
    ckpt, _, _ = trained
    import shutil
    run = str(tmp_path / "ckpt")
    shutil.copytree(ckpt, run)
    shutil.copytree(CK.best_dir(ckpt), CK.best_dir(run))
    CK.write_best_score(run, 2.0, 4)        # no mAP beats it: _best stays as it is
    log = str(tmp_path / "resume.jsonl")
    state = train_cli.main(_args(run, "train.total_steps=6")
                           + ["--device", "cpu", "--resume", "--log-file", log])
    lines = _lines(log)
    assert [r["step"] for r in lines if r["kind"] == "resume"] == [4]
    assert [r["step"] for r in lines if r["kind"] == "train"] == [5, 6]
    assert not [r for r in lines if r["kind"] == "checkpoint_best"]
    assert state.step == 6 and CK.make_manager(run).all_steps() == [2, 4, 6]
    assert CK.read_best_score(run) == 2.0


@pytest.mark.parametrize("flags", [["--best"], ["--raw-params"], ["--step", "2", "--per-scene"]])
def test_eval_cli(trained, capsys, flags):
    ckpt, _, _ = trained
    res = eval_cli.main(_args(ckpt) + ["--device", "cpu", *flags])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["kind"] == "restored"
    assert lines[-1]["kind"] == "eval" and "mAP@0.5" in lines[-1]
    assert res["scenes"] == 3
    if "--raw-params" in flags:
        assert any(r["kind"] == "eval_params" and r["source"] == "raw" for r in lines)
    if "--step" in flags:
        assert lines[0]["step"] == 2 and len(res["per_scene_mAP@0.5"]) == 3


def test_eval_cli_without_checkpoint(tmp_path, capsys):
    eval_cli.main(_args(str(tmp_path / "none")) + ["--device", "cpu", "--max-batches", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"warning"' in lines[0] and '"mAP@0.5"' in lines[-1]
    assert not os.path.exists(tmp_path / "none")


def test_infer_cli_best(trained, tmp_path, capsys):
    ckpt, _, _ = trained
    out = str(tmp_path / "out")
    infer_cli.main(_args(ckpt) + ["--device", "cpu", "--best", "--out-dir", out,
                                  "--num-scenes", "3", "--ply"])
    assert "restored step" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == [f"scene{i:04d}.{e}" for i in range(3)
                                       for e in ("npz", "ply")]
    with np.load(os.path.join(out, "scene0000.npz")) as f:
        assert f["instance"].shape == (f["points"].shape[0],)
        assert np.isfinite(f["scores"]).all()


def test_pidfile_refuses_live_and_reclaims_stale(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    pidfile = os.path.join(ckpt, "trainer.pid")
    with open(pidfile, "w") as f:
        f.write(str(os.getpid()))                    # a live trainer: this process
    args = _args(ckpt, "train.total_steps=1", "train.eval_every=1000") + ["--device", "cpu"]
    with pytest.raises(SystemExit, match="in use by live trainer"):
        train_cli.main(args)
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    with open(pidfile, "w") as f:
        f.write(str(dead.pid))                       # a stale one
    assert train_cli.main(args).step == 1
    assert not os.path.exists(pidfile)


@pytest.mark.parametrize("cli", [train_cli, eval_cli, infer_cli])
def test_cuda_without_card_exits_nonzero(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as e:
        cli.main(_args(str(tmp_path)) + ["--device", "cuda"])
    assert e.value.code not in (0, None)
