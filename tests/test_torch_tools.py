"""The port's tools against the JAX package's: ``tools/size_capacities.py``
against ``scripts/size_capacities.py`` (its ``--stretched`` sweeps against
``scripts/size_config4_bench.py``), ``tools/preprocess_scannet.py`` against
``scripts/preprocess_scannet.py``, and ``utils/profiling.py`` (``StepTimer``
against JAX's on the same clock, ``maybe_trace`` through the train CLI's
``--profile``), all on the CPU.

Tolerances: the reports are integers and floats made from them by the same
arithmetic, so equal; the preprocessed arrays are bit-equal; the timer
reads the same ticks, so equal.
"""

import json
import os
import sys

import numpy as np
import pytest

import sparse_rcnn_tpu.config as jax_config
from sparse_rcnn_tpu.utils import profiling as JP
from sparse_rcnn_tpu_torch.tools import preprocess_scannet as PP
from sparse_rcnn_tpu_torch.tools import size_capacities as SC
from sparse_rcnn_tpu_torch.train import __main__ as train_cli
from sparse_rcnn_tpu_torch.utils import profiling as PPR
from tests.e2e.test_preprocess_drill import _room_points
from tests.e2e.test_size_capacities import TINY
from tests.test_torch_cli import _args
from tests.unit.test_ply import write_binary_ply

CONFIG1 = "configs/config1_tiny_5cm.yaml"
# one worker: the JAX Loader takes whichever worker's batch is ready first,
# so only with one are its batches in a fixed order (the port's)
ONE_WORKER = ["--set", "data.num_workers=1"]


def _jax_report(monkeypatch, capsys, args):
    from scripts import size_capacities as JSC

    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["size_capacities.py", *args])
    JSC.main()
    cap = capsys.readouterr()
    return json.loads(cap.out), cap.err


@pytest.mark.parametrize("case", ["augmented", "saturated", "val"])
def test_size_capacities_matches_jax(monkeypatch, capsys, case):
    args = ["--config", CONFIG1, *TINY, *ONE_WORKER, "--margin", "1.25"]
    args += {"augmented": ["--scenes", "3"],
             "saturated": ["--set", "model.backbone.capacities=[2048,128,128]", "--scenes", "2"],
             "val": ["--split", "val", "--set", "data.val_scenes=2", "--scenes", "5"]}[case]
    want, want_err = _jax_report(monkeypatch, capsys, args)
    got = SC.main(args + ["--device", "cpu"])
    cap = capsys.readouterr()
    assert json.loads(cap.out) == got
    assert list(got) == list(want)
    assert got == want
    assert ("saturated" in cap.err) == ("saturated" in want_err) == (case == "saturated")
    if case == "val":            # a finite pass stops at the split's end
        assert got["scenes"] == 2 and "pool exhausted" in cap.err
    assert any(r["max_sites"] for r in got["scales"])


def test_stretched_matches_size_config4_bench(monkeypatch, capsys):
    """config 4's stretched sweeps at a cut size: the maxima of the port's
    ``--stretched`` against the JAX script's bench distribution."""
    from scripts import size_config4_bench as C4

    cut = {"data": {"num_points": 4096, "voxel_capacity": 4096},
           "model": {"backbone": {"capacities": [4096] * 4}}}
    real = jax_config.load_config

    def load_cut(path=None, overrides=None):
        over = dict(overrides or {})
        over["data"] = {**over.get("data", {}), **cut["data"]}
        over["model"] = cut["model"]
        return real(path, over)

    monkeypatch.setattr(jax_config, "load_config", load_cut)
    capsys.readouterr()
    C4.main()
    want = json.loads(capsys.readouterr().out)["per_distribution"]["bench"]
    got = SC.main(["--config", "configs/config4_semantic_kitti.yaml", "--stretched",
                   "--scenes", "8", "--set", "data.dataset=synthetic",
                   "--set", "data.num_points=4096", "--set", "data.voxel_capacity=4096",
                   "--set", "model.backbone.capacities=[4096,4096,4096,4096]",
                   "--device", "cpu"])
    assert got["split"] == "stretched" and got["scenes"] == 8 and not got["augmented"]
    assert [r["max_sites"] for r in got["scales"]] == want["max_sites"]
    assert got["max_span_cells"] == want["max_span"]
    assert got["voxel_overflow"] == got["hierarchy_overflow"] == 0
    # the sweeps span 100 x 100 x 6 m: far wider than deep
    assert min(want["max_span"][:2]) > 4 * want["max_span"][2]


def _raw_scannet(root, rng):
    """Two scans in the official layout, as the e2e drill writes them."""
    scenes = {"scene0000_00": "train", "scene0001_00": "val"}
    for sid in scenes:
        d = root / "scans" / sid
        d.mkdir(parents=True)
        pts, grp = _room_points(rng, instances=[((1.0, 1.0, 0.4), 5, 120),
                                                ((2.2, 2.0, 0.5), 7, 120)])
        rgb = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
        write_binary_ply(str(d / f"{sid}_vh_clean_2.ply"), pts, rgb)
        nyu = np.where(grp == 0, 5, np.where(grp == 1, 7, 2)).astype(np.uint16)
        write_binary_ply(str(d / f"{sid}_vh_clean_2.labels.ply"), pts, rgb, label=nyu)
        seg = np.where(grp < 0, 99, grp + 10).astype(int)
        with open(d / f"{sid}_vh_clean_2.0.010000.segs.json", "w") as f:
            json.dump({"segIndices": seg.tolist()}, f)
        with open(d / f"{sid}.aggregation.json", "w") as f:
            json.dump({"segGroups": [{"segments": [10], "label": "chair"},
                                     {"segments": [11], "label": "table"}]}, f)
    splits = root / "splits"
    splits.mkdir()
    for split in ("train", "val"):
        (splits / f"scannetv2_{split}.txt").write_text(
            "\n".join(s for s, sp in scenes.items() if sp == split))
    return scenes


@pytest.mark.parametrize("with_splits", [True, False])
def test_preprocess_scannet_bit_equal_to_jax(tmp_path, monkeypatch, capsys, rng, with_splits):
    from scripts import preprocess_scannet as JPP

    raw = tmp_path / "raw"
    scenes = _raw_scannet(raw, rng)
    extra = ["--splits-dir", str(raw / "splits")] if with_splits else []
    monkeypatch.setattr(sys, "argv", ["preprocess_scannet.py", "--raw", str(raw), "--out",
                                      str(tmp_path / "jax"), *extra])
    JPP.main()
    PP.main(["--raw", str(raw), "--out", str(tmp_path / "port"), *extra])
    assert capsys.readouterr().out.count(": ok") == 2 * len(scenes)
    for sid, split in scenes.items():
        split = split if with_splits else "train"
        with np.load(tmp_path / "jax" / split / f"{sid}.npz") as w, \
                np.load(tmp_path / "port" / split / f"{sid}.npz") as g:
            assert sorted(g.files) == sorted(w.files) == ["feats", "instance", "points",
                                                          "semantic"]
            for k in w.files:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (sid, k)
            assert set(np.unique(g["instance"])) == {-1, 0, 1}


def test_step_timer_matches_jax(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.5, 2.0, 2.0, 3.25, 4.0, 4.5, 6.0]
    rates = {}
    for name, mod in (("jax", JP), ("port", PPR)):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(batch_size=3, window=4)
        rates[name] = [timer.tick() for _ in ticks]
    assert rates["port"] == rates["jax"]
    assert rates["port"][0] == 0.0 and rates["port"][-1] == 3 * 3 / (6.0 - 3.25)


def test_train_profile_writes_trace(tmp_path):
    """``train.main --profile`` on the CPU: a ``profile`` line naming a
    trace in ``<checkpoint_dir>/profile/`` that parses as Chrome trace JSON
    with the step's operations in it; and no trace without the flag."""
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "train.jsonl")
    train_cli.main(_args(ckpt, "train.total_steps=2", "train.eval_every=100")
                   + ["--device", "cpu", "--log-file", log, "--profile"])
    with open(log) as f:
        lines = [json.loads(line) for line in f]
    (rec,) = [r for r in lines if r["kind"] == "profile"]
    assert os.path.dirname(rec["trace"]) == os.path.join(os.path.abspath(ckpt), "profile")
    with open(rec["trace"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert [r["scenes_per_sec"] for r in lines if r["kind"] == "train"][0] == 0.0
    with PPR.maybe_trace(False, str(tmp_path / "off")) as path:
        assert path is None
    assert not os.path.exists(tmp_path / "off")
