"""The port's train CLI data-parallel on the CPU: ``python -m
sparse_rcnn_tpu_torch.train`` in two rank processes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` as a launcher sets them; ``gloo``; a
``file://`` store under the test's directory), at the tiny widths of
``tests/test_torch_cli.py``.

* 2 ranks, 2 steps with an eval and a checkpoint: rank 0 alone logs (the
  jsonl holds each line once, with the world size and backend; rank 1
  prints none) and holds the pidfile (a second claimant would refuse the
  live first); the checkpoint is the single-process format, within the
  step's tolerance of one process's 2 steps, resumed in one process to 3
  steps and from there by 2 ranks to 4;
* ``parallel.num_devices`` other than the world size fails every rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from sparse_rcnn_tpu_torch.train import __main__ as train_cli
from sparse_rcnn_tpu_torch.train import checkpoint as CK

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RANK_TIMEOUT_S = 240
TINY = [
    "data.num_points=512", "data.voxel_capacity=256", "data.batch_size=2",
    "data.voxel_size=[0.2,0.2,0.2]", "data.val_scenes=3",
    "model.backbone.widths=[8,16]", "model.rpn.hidden=8", "model.rpn.num_proposals=4",
    "model.rpn.pre_nms_topk=16", "model.roi.grid_size=3", "model.roi.hidden=8",
    "model.roi.mask_grid=6", "model.num_classes=3", "model.max_instances=6",
    "train.log_every=1", "train.eval_every=2", "train.checkpoint_every=2",
    "train.eval_scenes=3",
]


def _args(ckpt, *extra):
    return sum((["--set", s] for s in TINY + [f"train.checkpoint_dir={ckpt}", *extra]), [])


def ranks(tmp, argv, world=2):
    """The train CLI in ``world`` rank processes; (return codes, outputs)."""
    procs = []
    store = tmp / f"store{len(list(tmp.glob('store*')))}"      # one per process group
    store.touch()
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   OMP_NUM_THREADS="1")
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "sparse_rcnn_tpu_torch.train", "--device", "cpu",
             "--dist-backend", "gloo", "--dist-init", f"file://{store}", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _ok(res):
    rcs, outs = res
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
    return outs


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_two_rank_cli_checkpoint_resumes_in_one_process_and_back(tmp_path):
    ckpt, log = tmp_path / "ckpt", tmp_path / "train.jsonl"
    outs = _ok(ranks(tmp_path, _args(ckpt, "train.total_steps=2")
                     + ["--log-file", str(log)]))
    assert not [x for x in outs[1].splitlines() if x.startswith("{")], outs[1]
    lines = _lines(log)
    kinds = [r["kind"] for r in lines]
    assert kinds == ["config", "train", "train", "eval", "checkpoint_best", "checkpoint",
                     "loader", "done"], kinds
    assert (lines[0]["world_size"], lines[0]["backend"]) == (2, "gloo")
    assert lines[3]["scenes"] == 3
    assert lines[6]["scenes_replayed"] >= 2
    assert not (ckpt / "trainer.pid").exists()
    assert CK.make_manager(str(ckpt)).all_steps() == [2]

    # one process's 2 steps: the same checkpoint to the step's tolerance
    one = train_cli.main(_args(tmp_path / "one", "train.total_steps=2")
                         + ["--device", "cpu"])
    saved = CK.make_manager(str(ckpt)).load(2)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(saved["model"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)

    # resumed in one process, then by 2 ranks again
    state = train_cli.main(_args(ckpt, "train.total_steps=3")
                           + ["--device", "cpu", "--resume", "--log-file", str(log)])
    assert state.step == 3
    assert [r["step"] for r in _lines(log) if r["kind"] == "resume"] == [2]
    _ok(ranks(tmp_path, _args(ckpt, "train.total_steps=4")
              + ["--resume", "--log-file", str(log)]))
    resumes = [r["step"] for r in _lines(log) if r["kind"] == "resume"]
    assert resumes == [2, 3]
    assert CK.make_manager(str(ckpt)).latest_step() == 4
    last = CK.make_manager(str(ckpt)).load(4)
    assert last["step"] == 4 and last["opt_state"]["count"] == 4
    assert all(torch.isfinite(v).all() for v in last["model"].values())


def test_num_devices_mismatch_fails_every_rank(tmp_path):
    rcs, outs = ranks(tmp_path, _args(tmp_path / "ckpt", "train.total_steps=1",
                                      "parallel.num_devices=3"))
    assert all(rc != 0 for rc in rcs), rcs
    for out in outs:
        assert "parallel.num_devices is 3 but the world has 2 ranks" in out, out[-2000:]
