"""``config3-train`` on the CPU at a tiny cut of config 3 (remat on, the
dense tail from scale 3, 13 classes, 5 scales, batch 1): a dry run prints a
valid last line with ``correct`` true; a step that leaves the state
unchanged comes out not correct (half of a batch of one is no fault that
the cell can have); on a traced run both of its new readers return
numbers, and ``remat_host_ms`` returns None where the port keeps no remat
counters, as before it kept them. The CPU has no device trace: the traced
run stands in one that gives each kernel a second."""

import contextlib
import io
import json
import time

import pytest
import torch

from portbench.core import common, runner
from portbench.core.modes import train as train_mode

WORKLOAD = "config3-train"
TINY3 = {
    "data": {"voxel_size": [0.2, 0.2, 0.2], "num_points": 4096, "voxel_capacity": 4096,
             "num_workers": 1},
    "model": {"backbone": {"widths": [8, 12, 16, 20, 24], "grid_extent": [128, 128, 32],
                           "capacities": [4096, 3072, 1536, 512, 256]},
              "rpn": {"hidden": 16, "num_proposals": 8, "pre_nms_topk": 32},
              "roi": {"grid_size": 3, "hidden": 16, "mask_grid": 6}},
}


def run(seed=987654321987, seconds=0.5, trace=False, hooks=None):
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, WORKLOAD)
    res, numbers, lims = runner.run_cell(bench, wl, conf, traffic, seed, seconds, trace, "cpu",
                                         time.perf_counter(), overrides=TINY3, hooks=hooks)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        common.emit(res, numbers, lims)
    return json.loads(out.getvalue().strip().splitlines()[-1]), numbers, lims


def test_the_cell_runs_remat_on_and_the_tail_from_scale_3():
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, WORKLOAD)
    cfg = common.load_cfg(conf["file"], "unused")
    bb = cfg.model.backbone
    assert bb.remat and bb.dense_from_scale == 3 and bb.dense_from_scale_train is None
    assert cfg.data.num_points == bb.capacities[0] == 524288 and cfg.data.batch_size == 1
    assert cfg.model.num_classes == 13 and traffic["mode"] == "train"


def test_dry_run_prints_a_valid_last_line():
    line, numbers, lims = run()
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_scenes_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(lims) == {"batch_diff", "loss_gap", "grad_gap",
                                                "change_gap"}


def test_an_unchanged_state_is_not_correct():
    from sparse_rcnn_tpu_torch.train import loop as TL

    def step(cfg, state, batch):
        total, parts, _, aux = TL.loss_and_grads(cfg, state.model, batch)
        return state, {"total": total, **parts}
    line, numbers, lims = run(hooks={"train_step": step})
    assert line["correct"] is False, numbers


class SecondEachKernel:
    """Stands in for ``DeviceTrace`` on the CPU: a one-second window in
    which every kernel the readers ask for took one second."""

    def __init__(self, device, path):
        self.busy_s = self.window_s = 1.0

    def start(self):
        pass

    def stop(self):
        pass

    def sum_kernels(self, pattern):
        return 1.0, 1

    def top_ops(self):
        return []

    def idle_by_span(self, spans):
        return []


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(train_mode, "DeviceTrace", SecondEachKernel)
    monkeypatch.setattr(runner.Context, "cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


def test_both_new_readers_read_a_traced_run(traced):
    line, numbers, lims = run(seconds=1.5, trace=True)
    got = line["metrics"]
    roof = got["sparse_conv_roofline.remat"]["value"]
    assert 0 < roof < 100 and got["sparse_conv_roofline.remat"]["unit"] == "%"
    assert got["remat_host_ms"]["value"] > 0 and got["remat_host_ms"]["unit"] == "ms"
    assert "sparse_conv_roofline.train" not in got
    assert {"loader_wait_ms.train", "train_busy_ms", "mfu.train",
            "device_idle_pct.train"} <= set(got)


def test_remat_host_ms_is_none_without_the_ports_counters(monkeypatch):
    from sparse_rcnn_tpu_torch.models import layers
    record = {"mode": "train"}
    monkeypatch.setattr(layers.REMAT, "passes", 4)
    monkeypatch.setattr(layers.REMAT, "ns", 8_000_000)
    assert common.read_metric("remat_host_ms", record) == pytest.approx(2.0)
    monkeypatch.delattr(layers, "REMAT")
    assert common.read_metric("remat_host_ms", record) is None


def test_the_recomputed_forwards_are_the_blocks_convs():
    import dataclasses
    from portbench.core import flops as F
    from portbench.core.flops_remat import remat_convs, step_conv_bound_remat_s
    from portbench.tests.test_portbench_arith import STATS, tiny_cfg
    cfg = tiny_cfg()
    bb = dataclasses.replace(cfg.model.backbone, remat=True)
    on = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone=bb))
    names = [c[0] for c in remat_convs(on, 2, STATS)]
    assert names == ["enc0_block0.conv1", "enc0_block0.conv2", "enc1_block0.conv1",
                     "enc1_block0.conv2", "dec0_block0.conv1", "dec0_block0.conv2",
                     "dec0_block0.proj"]
    fwd = sum(F.conv_bound_s("fwd", *c[1:]) for c in remat_convs(on, 2, STATS))
    assert step_conv_bound_remat_s(on, 2, STATS) == pytest.approx(
        F.step_conv_bound_s(on, 2, STATS, train=True) + fwd)
    assert remat_convs(cfg, 2, STATS) == []
    assert step_conv_bound_remat_s(cfg, 2, STATS) == F.step_conv_bound_s(cfg, 2, STATS, True)
