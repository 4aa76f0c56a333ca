"""The FLOP and byte arithmetic against a count by hand on a tiny config."""

import dataclasses

import pytest

from portbench.core import flops as F
from portbench.reference.srcnn.config import Config, BackboneConfig, DataConfig, ModelConfig


def tiny_cfg(widths=(4, 8), bps=1):
    return Config(data=DataConfig(num_features=3, batch_size=1),
                  model=ModelConfig(backbone=BackboneConfig(widths=widths, blocks_per_scale=bps,
                                                              dtype="bfloat16"),
                                    use_semantic_head=False))


STATS = {"sites": [10, 3], "subm_pairs": [40, 7], "down_pairs": [10]}


def test_useful_forward_flops_by_hand():
    cfg = tiny_cfg()
    mc = cfg.model
    # stem 3→4 over 40 pairs; enc0 2 convs 4→4 over 40; down 4→8 over 10;
    # enc1 2 convs 8→8 over 7; up 8→4 over 10; dec0 conv1 8→4 and conv2
    # 4→4 over 40, proj 8→4 over 10 sites
    conv = 2 * (40 * 3 * 4 + 2 * 40 * 4 * 4 + 10 * 4 * 8 + 2 * 7 * 8 * 8 + 10 * 8 * 4
                + 40 * 8 * 4 + 40 * 4 * 4 + 10 * 8 * 4)
    h = mc.rpn.hidden
    rpn = 2 * 10 * (4 * h + h * h + h * 7)
    p, d3, rh = mc.rpn.num_proposals, mc.roi.grid_size ** 3, mc.roi.hidden
    roi = 2 * p * (d3 * 27 * (4 * rh + rh * rh) + d3 * 8 * rh * rh
                   + (2 * mc.roi.grid_size) ** 3 * rh + rh * rh + rh * (mc.num_classes + 1))
    assert F.useful_forward_flops(cfg, STATS) == pytest.approx(conv + rpn + roi, rel=1e-12)
    assert F.train_step_flops(cfg, STATS) == pytest.approx(
        3 * (conv + rpn + roi) - 2 * 40 * 3 * 4, rel=1e-12)


def test_sparse_conv_list_and_bound_by_hand():
    cfg = tiny_cfg()
    convs = F.sparse_convs(cfg, 2, STATS)
    assert [c[0] for c in convs] == ["stem", "enc0_block0.conv1", "enc0_block0.conv2", "down0",
                                     "enc1_block0.conv1", "enc1_block0.conv2", "up0",
                                     "dec0_block0.conv1", "dec0_block0.conv2",
                                     "dec0_block0.proj"]
    # with the tail from scale 1, enc1 is dense: its convs leave the list
    assert "enc1_block0.conv1" not in [c[0] for c in F.sparse_convs(cfg, 1, STATS)]
    # the down conv: 27 is not its taps; 8 taps, 4→8, 10 rows in, 3 out, 10 pairs
    name, taps, cin, cout, rin, rout, pairs = convs[3]
    assert (taps, cin, cout, rin, rout, pairs) == (8, 4, 8, 10, 3, 10)
    fwd_bytes = 10 * 4 * 2 + 8 * 4 * 8 * 2 + 8 * 3 * 4 + 3 * 8 * 2
    dgrad_bytes = 3 * 8 * 2 + 8 * 4 * 8 * 2 + 8 * 10 * 4 + 10 * 4 * 2
    wgrad_bytes = 10 * 4 * 2 + 3 * 8 * 2 + 8 * 10 * 4 + 8 * 4 * 8 * 4
    assert F.conv_bound_s("fwd", *convs[3][1:]) == pytest.approx(fwd_bytes / 3.35e12)
    assert F.conv_bound_s("dgrad", *convs[3][1:]) == pytest.approx(dgrad_bytes / 3.35e12)
    assert F.conv_bound_s("wgrad", *convs[3][1:]) == pytest.approx(wgrad_bytes / 3.35e12)
    # a conv with many pairs is bound by its FLOPs
    big = F.conv_bound_s("fwd", 27, 64, 64, 100, 100, 10 ** 9)
    assert big == pytest.approx(2 * 10 ** 9 * 64 * 64 / 989e12)
    assert F.conv_bound_s("fwd", 27, 64, 64, 100, 100, 10 ** 9, elem=4) == pytest.approx(
        2 * 10 ** 9 * 64 * 64 / 67e12)


def test_step_bound_skips_only_the_stem_dgrad():
    cfg = tiny_cfg()
    convs = F.sparse_convs(cfg, 2, STATS)
    want = sum(F.conv_bound_s("fwd", *c[1:]) + F.conv_bound_s("wgrad", *c[1:]) for c in convs)
    want += sum(F.conv_bound_s("dgrad", *c[1:]) for c in convs[1:])
    got = F.step_conv_bound_s(dataclasses.replace(cfg), 2, STATS, train=True)
    assert got == pytest.approx(want)
    assert F.step_conv_bound_s(cfg, 2, STATS, train=False) == pytest.approx(
        sum(F.conv_bound_s("fwd", *c[1:]) for c in convs))
