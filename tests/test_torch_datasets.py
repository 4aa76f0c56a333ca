"""The port's dataset readers against the JAX package's ``build_dataset``,
on files each test writes in the reader's layout: every item of every split,
every key, ``np.array_equal`` (exact: the readers decode the same bytes and
subsample with the same ``default_rng(index)``)."""

import os

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.data.datasets import build_dataset as jax_build_dataset
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import datasets as D
from sparse_rcnn_tpu_torch.data import synthetic


def _scene(seed, n):
    s = synthetic.generate_scene(seed, num_points=n, num_instances=3, num_classes=5)
    return s["points"], s["feats"], s["point_semantic"], s["point_instance"]


def _both(dataset, root, split, num_points, num_features=3):
    ov = {"data": {"dataset": dataset, "data_root": str(root), "num_points": num_points,
                   "num_features": num_features}}
    return (D.build_dataset(load_config(overrides=ov), split),
            jax_build_dataset(jax_load_config(overrides=ov), split))


def _assert_same(got, want, n_items):
    assert len(got) == len(want) == n_items
    assert [os.path.basename(f) for f in got.files] == \
        [os.path.basename(f) for f in want.files]
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, (i, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"item {i} {k}")


def test_scannet_npz_with_and_without_labels(tmp_path):
    """``<root>/<split>/`` of .npz scenes: one with labels and ``feats``, one
    with ``colors`` and no labels (all -1), one with more points than
    ``num_points`` (subsampled)."""
    (tmp_path / "train").mkdir()
    p, f, s, i = _scene(1, 180)
    np.savez(tmp_path / "train" / "scene0000_00.npz", points=p, feats=f, semantic=s, instance=i)
    p, f, _, _ = _scene(2, 150)
    np.savez(tmp_path / "train" / "scene0001_00.npz", points=p, colors=f)
    p, f, s, i = _scene(3, 400)
    np.savez(tmp_path / "train" / "scene0002_00.npz", points=p, feats=f, semantic=s, instance=i)
    got, want = _both("scannet", tmp_path, "train", 256)
    assert isinstance(got, D.ScanNetDataset)
    _assert_same(got, want, 3)
    assert (got[1]["point_semantic"] == -1).all() and got[1]["valid"].sum() == 150
    assert got[2]["valid"].all()                     # 400 points subsampled to 256
    with pytest.raises(FileNotFoundError):
        _both("scannet", tmp_path, "val", 256)


def test_scannet_pth_tuple_dict_and_split_list(tmp_path):
    """``.pth`` scenes as a (coords, colors, semantic, instance) tuple, a
    2-tuple and a dict, listed by ``<root>/val.txt``; a listed name with no
    file is skipped."""
    p, f, s, i = _scene(4, 200)
    torch.save((p, f, s, i), tmp_path / "a.pth")
    p, f, _, _ = _scene(5, 120)
    torch.save((p, f), tmp_path / "b.pt")
    p, f, s, i = _scene(6, 300)
    torch.save({"points": p, "colors": f, "semantic": s, "instance": i}, tmp_path / "c.pth")
    (tmp_path / "val.txt").write_text("a\nb\n\nmissing\nc\n")
    got, want = _both("scannet", tmp_path, "val", 256)
    _assert_same(got, want, 3)
    assert [os.path.basename(x) for x in got.files] == ["a.pth", "b.pt", "c.pth"]


def test_s3dis_area_split(tmp_path):
    """A flat directory of ``Area_{k}_*.npz``: ``train`` is every area but
    the test area 5, ``val`` the test area; one feature padded to three."""
    for area, room, n in ((1, "office_1", 200), (2, "hallway_3", 500), (5, "office_9", 150),
                          (5, "conferenceRoom_1", 260)):
        p, f, s, i = _scene(10 * area + n, n)
        np.savez(tmp_path / f"Area_{area}_{room}.npz", points=p, feats=f[:, :1],
                 semantic=s, instance=i)
    for split, n_items in (("train", 2), ("val", 2)):
        got, want = _both("s3dis", tmp_path, split, 256)
        assert isinstance(got, D.S3DISDataset)
        _assert_same(got, want, n_items)
        assert all(("Area_5" in f) == (split == "val") for f in got.files)
    assert not got[0]["feats"][:, 1:].any()


def test_semantic_kitti_bit_fields(tmp_path):
    """``sequences/NN/velodyne/*.bin`` (x, y, z, remission) with
    ``labels/*.label``: semantic class in the low 16 bits, instance in the
    high 16, instances re-indexed densely (0 = none → -1); a sweep with no
    label file reads as unlabelled."""
    rng = np.random.default_rng(0)
    for seq, n_sweeps in (("00", 2), ("08", 1)):
        vdir = tmp_path / "sequences" / seq / "velodyne"
        ldir = tmp_path / "sequences" / seq / "labels"
        vdir.mkdir(parents=True)
        ldir.mkdir(parents=True)
        for k in range(n_sweeps):
            n = 300 + 50 * k
            scan = np.concatenate([rng.uniform(-50, 50, (n, 3)),
                                   rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
            scan.tofile(vdir / f"{k:06d}.bin")
            if (seq, k) == ("00", 1):
                continue
            inst = rng.choice([0, 3, 70, 65535], n).astype(np.uint32)
            sem = rng.integers(0, 260, n).astype(np.uint32)
            ((inst << 16) | sem).tofile(ldir / f"{k:06d}.label")
    got, want = _both("semantic_kitti", tmp_path, "train", 320, num_features=1)
    assert isinstance(got, D.SemanticKITTIDataset)
    _assert_same(got, want, 2)
    item = got[0]
    assert set(np.unique(item["point_instance"][item["valid"]])) <= {-1, 0, 1, 2}
    assert (got[1]["point_semantic"] == -1).all()            # no label file
    got, want = _both("semantic_kitti", tmp_path, "val", 320, num_features=2)
    _assert_same(got, want, 1)


def test_pad_scene_subsample_draws_as_jax():
    """``_pad_scene``: a scene over capacity is subsampled by the rng it is
    given (the readers pass ``default_rng(index)``), else by
    ``default_rng(0)``; under capacity it is padded with -1 labels."""
    from sparse_rcnn_tpu.data.datasets import _pad_scene as jax_pad

    p, f, s, i = _scene(9, 1000)
    for n, rng in ((600, lambda: np.random.default_rng(7)), (600, lambda: None),
                   (1200, lambda: None)):
        got, want = D._pad_scene(p, f, s, i, n, rng()), jax_pad(p, f, s, i, n, rng())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{n} {k}")
    assert got["valid"].sum() == 1000 and (got["point_instance"][1000:] == -1).all()


def test_build_dataset_unknown_and_missing_root(tmp_path):
    with pytest.raises(ValueError, match="Unknown dataset"):
        D.build_dataset(load_config(overrides={"data": {"dataset": "nuscenes"}}), "train")
    with pytest.raises(FileNotFoundError):
        _both("semantic_kitti", tmp_path / "none", "train", 64, num_features=1)
