"""The served cells' staged comparison: the capture of the RPN heads'
outputs keeps a sample of the calls, and the reference that follows its own
RPN outputs gives back its own answer, number for number."""

import os
import tempfile

import numpy as np
import pytest
import torch
from torch import nn

from portbench.core import common
from portbench.core.capture import RpnCapture
from portbench.tests.tiny import TINY


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.pred = nn.Linear(2, 7)

    def forward(self, feats, coords, mask):
        out = self.pred(feats)
        return out[..., 0], out[..., 1:], out[..., 1:]


class Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.rpn = Head()
        self.rpn_s1 = Head()

    def forward(self, tag):
        feats = torch.full((1, 3, 2), float(tag))
        mask = torch.ones(1, 3, dtype=torch.bool)
        return self.rpn(feats, None, mask), self.rpn_s1(feats, None, mask)


def _calls(seed, n=40, k=5):
    model = Model()
    cap = RpnCapture(model, k, seed)
    model(-1)
    cap.end_call()                # before start: the warm-up, not sampled
    cap.start()
    for i in range(n):
        model(i)
        cap.end_call()
    return cap.close(), model


@pytest.mark.parametrize("seed", [1, 2147483647123])
def test_capture_keeps_a_sample_of_the_window_calls(seed):
    kept, model = _calls(seed)
    assert len(kept) == 5 and all(0 <= i < 40 for i in kept)
    for i, scales in kept.items():
        assert len(scales) == 2          # the heads, not their sub-modules
        want = model.rpn.pred(torch.full((1, 3, 2), float(i)))[..., 0].detach().numpy()
        np.testing.assert_array_equal(scales[0]["obj"], want)
        assert scales[0]["mask"].all() and scales[0]["boxes"].shape == (1, 3, 6)
    assert _calls(seed)[0].keys() == kept.keys()          # drawn from the seed


def test_capture_sample_is_spread_over_the_window():
    seen = set()
    for seed in range(20):
        seen |= set(_calls(seed)[0])
    assert max(seen) >= 30 and len(seen) > 20


def test_reference_following_its_own_rpn_reads_zero():
    from portbench.core.scenes import write_pool
    from portbench.core.weights import seeded_state_dict
    from portbench.reference import check as RC
    from portbench.reference.batches import read_scene, scene_files
    from portbench.reference.srcnn.config import load_config
    from portbench.reference.srcnn.train import loop as RL

    bench = common.load_bench()
    conf = common.cell(bench, "config4-online")[1]
    with tempfile.TemporaryDirectory() as d:
        cfg = load_config(os.path.join(common.ROOT, conf["file"]),
                          common.run_overrides(d, TINY[conf["name"]]))
        write_pool(common.scene_recipe(conf["file"]), cfg, d, "val", 1)
        model = RL.build_model(RL.train_cfg(cfg), "cpu")
        init = seeded_state_dict(model, 5, "cpu")
        scene = read_scene(cfg, scene_files(cfg, "val")[0], 0)
    batches = [{k: v[None] for k, v in scene.items()}]
    own = RC.eval_reference(cfg, init, batches, "cpu")
    assert own[0]["inside"].any()
    fol = RC.eval_reference(cfg, init, batches, "cpu", follow=[own[0]["rpn"]])
    numbers = RC.answer_numbers(own, fol, [scene["valid"]])
    assert all(v == 0 for v in numbers.values()), numbers
