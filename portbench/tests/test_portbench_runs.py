"""A tiny run of each traffic mix on the CPU prints a valid last line, and
``correct`` comes out false when the timed path is broken underneath: for
training, a step that returns its state unchanged, and half of the batch
left out with the mean taken over the rest; for served answers, an answer
altered where it is produced (labels off by one; the batch before's
semantic classes, proposals and mask bits). The harness's look for a card is
skipped: the runs go through ``core/runner.py`` on the CPU at the tests'
tiny sizes."""

import contextlib
import dataclasses
import io
import json
import time

import pytest

from portbench.core import common, runner
from portbench.tests.tiny import TINY

CELLS = ["config2-train", "config4-train", "config4-online", "config2-eval"]
TRAIN = CELLS[:2]
SERVED = CELLS[2:]


def run(workload, seed=987654321987, seconds=0.5, trace=False, hooks=None):
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, workload)
    res, numbers, lims = runner.run_cell(bench, wl, conf, traffic, seed, seconds, trace, "cpu",
                                         time.perf_counter(), overrides=TINY[conf["name"]],
                                         hooks=hooks)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        common.emit(res, numbers, lims)
    return json.loads(out.getvalue().strip().splitlines()[-1]), numbers, lims


@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_a_valid_last_line(workload):
    line, numbers, lims = run(workload)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = common.load_bench()
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["checks"]) == set(lims)


def _unchanged_step():
    from sparse_rcnn_tpu_torch.train import loop as TL

    def step(cfg, state, batch):
        total, parts, _, aux = TL.loss_and_grads(cfg, state.model, batch)
        return state, {"total": total, **parts}
    return step


def _half_batch_step():
    from sparse_rcnn_tpu_torch.train import loop as TL

    def step(cfg, state, batch):
        half = batch["points"].shape[0] // 2
        cfg_half = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=half))
        return TL.train_step(cfg_half, state, {k: v[:half] for k, v in batch.items()})
    return step


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_broken_step_is_not_correct(workload, fault):
    hook = _unchanged_step() if fault == "unchanged_state" else _half_batch_step()
    line, numbers, lims = run(workload, hooks={"train_step": hook})
    assert line["correct"] is False, numbers


def _altered_answers():
    """``scene_result`` whose per-point labels are each one more than it
    computed."""
    from sparse_rcnn_tpu_torch.infer import scene_result

    def answer(out, b, nc):
        inst, *rest = scene_result(out, b, nc)
        return (inst + 1, *rest)
    return answer


def _stale_eval_outputs():
    """``eval_step`` whose answers (semantic classes, the proposals'
    objectness, validity and class logits, mask bits) are the previous
    call's."""
    from sparse_rcnn_tpu_torch.train import loop as TL
    orig = TL.eval_step
    last = []

    def step(cfg, model, batch):
        out = orig(cfg, model, batch)
        keys = ("point_semantic_pred", "proposal_scores", "proposal_mask", "cls_logits",
                "point_mask_bits")
        prev = last[0] if last else {k: out[k] for k in keys}
        last[:] = [{k: out[k] for k in keys}]
        out.update(prev)
        return out
    return step


def test_an_altered_answer_is_not_correct_online():
    line, numbers, lims = run("config4-online", seconds=1.5,
                              hooks={"scene_result": _altered_answers()})
    assert line["correct"] is False, numbers


def test_stale_answers_are_not_correct_in_eval():
    line, numbers, lims = run("config2-eval", seconds=1.5,
                              hooks={"eval_step": _stale_eval_outputs()})
    assert line["correct"] is False, numbers
