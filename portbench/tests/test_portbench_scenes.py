"""Scene files written by the harness read back through the port's two
readers, and through the reference's, as the scenes that were written."""

import numpy as np
import pytest

from portbench.core import common, scenes
from portbench.reference import batches as RB
from portbench.reference.srcnn.config import load_config as ref_load_config
from portbench.tests.tiny import TINY


@pytest.mark.parametrize("config", ["config2_scannet_2cm", "config4_semantic_kitti"])
def test_round_trip(config, tmp_path):
    from sparse_rcnn_tpu_torch.data.datasets import build_dataset
    conf = next(c for c in common.load_bench()["configs"] if c["name"] == config)
    cfg = common.load_cfg(conf["file"], str(tmp_path), TINY[config])
    rcfg = ref_load_config(f"{common.ROOT}/{conf['file']}",
                           common.run_overrides(str(tmp_path), TINY[config]))
    recipe = common.scene_recipe(conf["file"])
    scenes.write_pool(recipe, cfg, str(tmp_path), "train", 3)
    ds = build_dataset(cfg, "train")
    files = RB.scene_files(rcfg, "train")
    assert len(ds) == len(files) == 3
    for i in range(3):
        want = scenes.make_scene(recipe, scenes.scene_seed("train", i), cfg)
        if recipe["layout"] == "semantic_kitti":
            # outside every instance the class is the background slot
            want["point_semantic"] = np.where(want["point_semantic"] >= 0,
                                              want["point_semantic"], cfg.model.num_classes)
        got, ref = ds[i], RB.read_scene(rcfg, files[i], i)
        assert set(got) == set(want) == set(ref)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(ref[k], want[k], err_msg=k)
        assert got["valid"].all()       # every scene fills its capacity


def test_pools_are_fixed_and_disjoint_by_split():
    seeds = {scenes.scene_seed(s, i) for s in ("train", "val") for i in range(32)}
    assert len(seeds) == 64
    assert scenes.scene_seed("train", 3) == scenes.scene_seed("train", 3)
