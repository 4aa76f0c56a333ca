"""The port's span recorder (``sparse_rcnn_tpu_torch/utils/profiling.py``)
and the stage spans at its layer boundaries, on the CPU.

- Spans nest: each record names its parent and the root of its step; a new
  outermost span starts a new root.
- The stack of open spans is per thread: spans opened on two threads at
  once nest each on its own.
- Outside ``recording()`` a span records nothing, counts nothing, and still
  times itself.
- A config-1 ``train_step`` and ``eval_step`` emit their named stages in
  order, each under one root; the fetch and ``scene_result`` theirs, which
  paints no more proposals than it keeps.
- ``run_eval``'s ``eval_dev_s``, ``eval_fetch_s``, ``eval_host_s`` and
  ``eval_compute_s`` are the summed durations of its ``eval.wait``,
  ``eval.fetch``, ``eval.score`` and ``eval.compute`` spans; the scenes
  scored are counted under ``eval.score``, as the stage table shows them.
"""

import threading

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.infer import scene_result
from sparse_rcnn_tpu_torch.train import evaluate as E
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.utils import profiling as P
from tests.test_torch_train import OVERRIDES, _batch

FORWARD = ["forward", "backbone", "rpn", "select", "roi_crop", "roi_head"]
PREPARE = ["prepare_inputs", "voxelize", "hierarchy", "gt"]


def tree(records):
    """[(depth, name)] in the order the spans opened."""
    by_id = {r.id: r for r in records}

    def depth(r):
        return 0 if r.parent is None else 1 + depth(by_id[r.parent])
    return [(depth(r), r.name) for r in records]


def test_spans_nest_with_parent_and_root():
    with P.recording() as recs:
        with P.span("a") as a:
            with P.span("b") as b:
                with P.span("c") as c:
                    P.count("items", 2)
                    P.count("items")
            with P.span("d") as d:
                pass
        with P.span("e") as e:
            pass
    assert recs == [a, b, c, d, e]
    assert [r.parent for r in recs] == [None, a.id, b.id, a.id, None]
    assert [r.root for r in recs] == [a.id] * 4 + [e.id]
    assert c.counts == {"items": 3} and a.counts is None
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1 <= e.t0
    assert all(r.ns == r.t1 - r.t0 >= 0 for r in recs)
    table = P.stage_table(recs)
    assert table["a"]["calls"] == 1 and table["c"]["counts"] == {"items": 3}
    assert table["a"]["self_ms"] == pytest.approx((a.ns - b.ns - d.ns) / 1e6)
    assert table["b"]["total_ms"] == pytest.approx(b.ns / 1e6)


def test_each_thread_nests_its_own_spans():
    opened = threading.Barrier(2, timeout=10)
    closing = threading.Barrier(2, timeout=10)
    got = {}

    def work(name):
        with P.span(name) as outer:
            opened.wait()                # both outer spans are open now
            with P.span(name + ".inner") as inner:
                closing.wait()
        got[name] = (outer, inner)

    with P.recording() as recs:
        threads = [threading.Thread(target=work, args=(n,)) for n in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(recs) == 4
    for name, (outer, inner) in got.items():
        assert outer.parent is None and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id
        assert inner.thread == outer.thread
    assert got["x"][0].thread != got["y"][0].thread


def test_off_records_nothing_but_times():
    with P.recording() as recs:
        pass
    with P.span("off") as s:
        P.count("n")
        sum(range(1000))
    assert recs == [] and s.ns > 0 and s.counts is None
    with P.recording() as recs:
        with P.span("on"):
            with P.recording() as inner:
                with P.span("inner"):
                    pass
            with P.span("after"):
                pass
    assert [r.name for r in inner] == ["inner"]
    assert [r.name for r in recs] == ["on", "after"]


@pytest.fixture(scope="module")
def config1():
    cfg = load_config(overrides=OVERRIDES)
    state = TL.init_state(cfg, "cpu", torch.Generator().manual_seed(0))
    return cfg, state, _batch()


def test_train_and_eval_steps_emit_their_stages(config1):
    cfg, state, host = config1
    with P.recording() as recs:
        batch = TL.to_device(host, "cpu", TL.TRAIN_KEYS)
        TL.train_step(cfg, state, batch)
        TL.eval_step(cfg, state.model, batch)
    assert tree(recs) == (
        [(0, "to_device"), (0, "train_step")]
        + [(1, PREPARE[0])] + [(2, n) for n in PREPARE[1:]]
        + [(1, FORWARD[0])] + [(2, n) for n in FORWARD[1:]]
        + [(1, "losses"), (1, "backward"), (1, "optimizer"), (0, "eval_step")]
        + [(1, PREPARE[0])] + [(2, n) for n in PREPARE[1:]]
        + [(1, FORWARD[0])] + [(2, n) for n in FORWARD[1:]]
        + [(1, "finish"), (1, "packbits")])
    roots = {r.root for r in recs if r.name not in ("to_device",)}
    assert len(roots) == 2
    step = [r for r in recs if r.name == "train_step"][0]
    assert all(step.t0 <= r.t0 <= r.t1 <= step.t1 for r in recs if r.root == step.id)


def test_run_eval_times_are_its_spans(config1):
    cfg, state, host = config1
    batches = [host, {k: v.copy() for k, v in host.items()}]
    with P.recording() as recs:
        res = E.run_eval(cfg, state.model, batches, num_scenes=3)
    assert res["scenes"] == 3
    total = {}
    for r in recs:
        total[r.name] = total.get(r.name, 0) + r.ns
    assert res["eval_dev_s"] == total["eval.wait"] / 1e9
    assert res["eval_fetch_s"] == total["eval.fetch"] / 1e9
    assert res["eval_host_s"] == total["eval.score"] / 1e9
    assert res["eval_compute_s"] == total["eval.compute"] / 1e9
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    assert names.count("eval.wait") == 2 and names.count("eval.fetch") == 2
    assert names.count("eval.score") == 2 and names.count("eval.compute") == 1
    # on the CPU the step runs inside the wait; the scoring's stages nest in it
    assert all(by_id[r.parent].name == "eval.wait" for r in recs if r.name == "eval_step")
    assert all(by_id[r.parent].name == "eval.score"
               for r in recs if r.name in ("postprocess", "add_scene"))
    assert names.count("add_scene") == 3
    assert sum((r.counts or {}).get("scenes", 0) for r in recs) == 3
    assert P.stage_table(recs)["eval.score"]["counts"] == {"scenes": 3}
    assert names[-1] == "eval.compute" and by_id[recs[-1].id].parent is None


def test_answer_spans_and_the_proposal_count(config1):
    cfg, state, host = config1
    raw = TL.eval_step(cfg, state.model, TL.to_device(host, "cpu"))
    with P.recording() as recs:
        out = E.fetch_eval_outputs(raw)
        inst, scores, pred_cls, pmask = scene_result(out, 1, cfg.model.num_classes)
    assert tree(recs) == [(0, "fetch"), (0, "scene_result"), (1, "postprocess"), (1, "paint")]
    assert all(r.counts is None for r in recs)     # the recorder counts nothing here
    assert P.stage_table(recs)["scene_result"]["calls"] == 1
    # the proposals painted: each rank names a kept proposal
    order = np.argsort(-scores)
    painted = set(inst[inst >= 0].tolist())
    assert len(painted) <= int(pmask.sum()) and all(pmask[order[r]] for r in painted)
