"""The port's ``Loader`` and copies to the device against the JAX package's
``Loader``, on the CPU.

- one worker: the batches equal JAX ``Loader(num_workers=1)``'s, every key
  ``np.array_equal``, with and without the host voxelizer;
- several workers: the consumer takes them in turn, so the order is the
  same in every run and equals the caller-thread mode's; worker 0's batches
  are a one-worker Loader's;
- an eval pass: ordered, the last batch wrap-padded, as JAX's;
- the counters, ``close`` and a worker's exception reaching the consumer;
- a host-voxelized train step equals a device-voxelized one, and the loss
  parts of JAX's host-voxelized forward in train mode (within rtol 1e-5:
  the f32 sums of one step in other orders, as ``tests/test_torch_train.py``
  holds them);
- ``data.host_voxelize`` with a library that does not build raises.

Every Loader is closed in a ``finally`` (or a ``with``), and every test runs
under its own time limit (``LIMIT_S``, an alarm in the test's thread), so no
worker thread can hang the suite. The alarm raises only where the main
thread runs the tests' code or the Loader's (``alarm``): an exception
raised at whatever line runs when the signal comes can land inside JAX,
torch or a gc callback, which swallow it or are left half-done for the
next test of the same worker. After ``GRACE_S`` more seconds it raises
wherever the main thread is, so a test spinning in a library still ends.
A test that runs past its limit fails, in that test, either way.
"""

import contextlib
import dataclasses
import gc
import os
import signal
import sysconfig
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.data import pipeline as JP
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import pipeline, synthetic
from sparse_rcnn_tpu_torch.data.pipeline import (VOXEL_KEYS, Loader, collate, device_batches,
                                                 host_voxelize_scene)
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import jax_variables

LIMIT_S = 60
RETRY_S = 0.05          # the alarm's next look when it finds a library's code running
GRACE_S = 10            # past its limit, the alarm raises wherever the main thread is
# where the alarm may raise: the tests' files and the Loader's
SAFE = (os.path.dirname(os.path.abspath(__file__)) + os.sep,
        os.path.abspath(pipeline.__file__))
STDLIB = sysconfig.get_paths()["stdlib"] + os.sep
DATA = {"num_points": 512, "voxel_capacity": 256, "batch_size": 2,
        "voxel_size": [0.2, 0.2, 0.2], "val_scenes": 3, "num_scenes": 5}
# the config of tests/parity/test_native.py::test_host_voxelize_pipeline_matches_device
MODEL = {"backbone": {"widths": [8, 16], "blocks_per_scale": 1},
         "rpn": {"hidden": 8, "num_proposals": 4, "pre_nms_topk": 16},
         "roi": {"grid_size": 3, "hidden": 8, "mask_grid": 6},
         "num_classes": 3, "max_instances": 6}


def safe_to_raise(frame) -> bool:
    """Whether an exception raised at ``frame`` lands in the tests' code or
    the Loader's (standard-library frames they called, such as a queue's
    wait, skipped), and not in a library's."""
    while frame is not None and frame.f_code.co_filename.startswith(STDLIB):
        frame = frame.f_back
    return frame is not None and frame.f_code.co_filename.startswith(SAFE)


@contextlib.contextmanager
def alarm(limit_s: float, retry_s: float = RETRY_S, grace_s: float = GRACE_S):
    """Raise ``TimeoutError`` in the block once it has run ``limit_s``
    seconds, at the first moment after that when the main thread runs the
    tests' or the Loader's code (looking again every ``retry_s``), or
    wherever it is once ``grace_s`` more seconds have passed; if the block
    ends first, raise at its end. Yields the alarm's record: ``deferred``,
    the files it found running instead. An alarm around the block (the
    test's own) is re-armed with its time left."""
    state = {"due": False, "raised": False, "deferred": []}

    def expire(signum, frame):
        now = time.monotonic()
        if not state["due"]:
            state["due"], state["due_at"] = True, now
        late = now - state["due_at"] >= grace_s
        if late or safe_to_raise(frame):
            state["raised"] = True
            where = "" if not late else (f" (raised in {frame.f_code.co_filename if frame else '?'}"
                                         f" after {grace_s} s more)")
            raise TimeoutError(f"test ran past its {limit_s} s limit{where}")
        state["deferred"].append(frame.f_code.co_filename if frame else "?")
        signal.setitimer(signal.ITIMER_REAL, retry_s)

    t0 = time.monotonic()
    old = signal.signal(signal.SIGALRM, expire)
    outer_left = signal.setitimer(signal.ITIMER_REAL, limit_s)[0]
    try:
        yield state
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        if outer_left:
            signal.setitimer(signal.ITIMER_REAL,
                             max(outer_left - (time.monotonic() - t0), 1e-3))
    if state["due"] and not state["raised"]:
        raise TimeoutError(f"test ran past its {limit_s} s limit; the alarm found only "
                           f"libraries running: {sorted(set(state['deferred']))[:3]}")


@pytest.fixture(autouse=True)
def time_limit():
    with alarm(LIMIT_S):
        yield


def _ov(**data):
    return {"data": {**DATA, **data}, "model": MODEL}


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{what} {k}")


@pytest.mark.parametrize("host_voxelize", [False, True], ids=["device_vox", "host_vox"])
def test_one_worker_matches_jax_loader(host_voxelize):
    ov = _ov(num_workers=1, host_voxelize=host_voxelize)
    jl = JP.Loader(jax_load_config(overrides=ov), "train", train=True, seed=5)
    try:
        it = iter(jl)
        want = [jax.device_get(next(it)) for _ in range(3)]
    finally:
        jl.close()
    got = _take(Loader(load_config(overrides=ov), seed=5), 3)
    for i, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"batch {i}")
    assert all(k in got[0] for k in VOXEL_KEYS) == host_voxelize


def test_several_workers_round_robin_is_fixed():
    cfg = load_config(overrides=_ov(num_workers=3, prefetch=2))
    runs = [_take(Loader(cfg, seed=9), 7) for _ in range(2)]
    inline = _take(Loader(cfg, seed=9, threads=False), 7)
    one = _take(Loader(load_config(overrides=_ov(num_workers=1)), seed=9, threads=False), 3)
    for t in range(7):
        _equal(runs[1][t], runs[0][t], f"run 2, batch {t}")
        _equal(inline[t], runs[0][t], f"caller's thread, batch {t}")
    for j in range(3):                       # worker 0 yields batches 0, 3, 6
        _equal(runs[0][3 * j], one[j], f"worker 0, batch {j}")
    assert not np.array_equal(runs[0][0]["points"], runs[0][1]["points"])


def test_eval_pass_wrap_pads_as_jax():
    ov = _ov()
    jl = JP.Loader(jax_load_config(overrides=ov), "val", train=False)
    try:
        want = [jax.device_get(b) for b in jl]
    finally:
        jl.close()
    with Loader(load_config(overrides=ov), "val", train=False) as loader:
        assert len(loader) == 2
        got = list(loader)
        assert list(loader) == []                 # one pass
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal(g, w)
    np.testing.assert_array_equal(got[1]["points"][1], got[0]["points"][0])


def test_counters_and_close():
    cfg = load_config(overrides=_ov(num_workers=2, prefetch=4, host_voxelize=True))
    loader = Loader(cfg, seed=1)
    try:
        for _ in range(4):
            next(loader)
        time.sleep(0.2)                  # the workers fill their queues
        t0 = time.perf_counter()
        next(loader)
        assert time.perf_counter() - t0 < 0.1     # a prefetched batch is waiting
    finally:
        loader.close()
    assert loader.batches_out == 5 and loader.wait_s > 0
    assert loader.scenes_voxelized >= 10 and loader.voxelize_s > 0
    assert not any(t.is_alive() for t in loader._threads)
    with pytest.raises(RuntimeError, match="closed"):
        next(loader)
    with pytest.raises(TypeError):
        len(loader)


def test_worker_exception_reaches_consumer(tmp_path):
    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "broken.npz").write_bytes(b"not a zip file")
    cfg = load_config(overrides=_ov(dataset="scannet", data_root=str(tmp_path), num_workers=2))
    loader = Loader(cfg)
    try:
        with pytest.raises(RuntimeError, match="worker 0 failed"):
            next(loader)
        with pytest.raises(StopIteration):
            next(loader)
    finally:
        loader.close()


def test_device_batches_carry_voxel_tables():
    cfg = load_config(overrides=_ov(host_voxelize=True))
    with Loader(cfg, "val", train=False) as loader:
        pairs = list(device_batches(loader, "cpu", TL.TRAIN_KEYS))
    assert len(pairs) == 2
    for host, dev in pairs:
        assert sorted(dev) == sorted(TL.TRAIN_KEYS + VOXEL_KEYS)
        for k, v in dev.items():
            assert v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), host[k])
    assert sorted(TL.to_device(pairs[0][0], "cpu")) == sorted(TL.BATCH_KEYS + VOXEL_KEYS)


def test_host_voxelize_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("#error this source does not build\n")
    monkeypatch.setattr(NL, "HOST", dataclasses.replace(NL.HOST, source=bad))
    cfg = load_config(overrides=_ov(host_voxelize=True))
    with pytest.raises(RuntimeError, match="host library build failed") as err:
        Loader(cfg)
    assert "does not build" in str(err.value)
    Loader(load_config(overrides=_ov()), threads=False)      # no host voxelizer: no build


def _jax_loss_parts(ov):
    """The loss parts of JAX's forward in train mode for the config ``ov``:
    ``tests/test_torch_pool_train.py::_jax_step_cfg`` without the gradient."""
    cfg = jax_load_config(overrides=ov)
    model = JTL.build_model(cfg)

    @jax.jit
    def parts(params, batch_stats, batch):
        st, _, scales, gt, _ = JTL.prepare_inputs(cfg, batch)
        out, _ = model.apply({"params": params, "batch_stats": batch_stats}, st.feats, scales,
                             train=True, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid,
                             mutable=["batch_stats"])
        return JTL.compute_losses(cfg, out, scales, gt, st.row_mask)[1]
    return parts


def test_host_voxelized_step_matches_device_and_jax():
    """One train step from random flax weights on two synthetic scenes: the
    port's host-voxelized step against its device-voxelized step (integer
    tables and every metric) and against the loss parts of JAX's
    host-voxelized forward in train mode (the parts its train step reports;
    no gradient, so that JAX compiles the forward alone)."""
    ov = _ov(host_voxelize=True)
    cfg, jcfg = load_config(overrides=ov), jax_load_config(overrides=ov)
    scenes = [synthetic.generate_scene(77 + i, num_points=512, num_instances=2, num_classes=3)
              for i in range(2)]
    device_batch = collate(scenes)
    host_batch = collate([host_voxelize_scene(s, cfg) for s in scenes])
    jhost = collate([JP.host_voxelize_scene(s, jcfg) for s in scenes])
    _equal(host_batch, jhost, "host tables, port vs JAX")

    params, stats = jax_variables(ov, {k: jnp.asarray(v) for k, v in device_batch.items()},
                                  np.random.default_rng(2))
    weights = from_flax(params, stats)
    jm = jax.device_get(_jax_loss_parts(ov)(params, stats, {
        k: jnp.asarray(v) for k, v in jhost.items()}))

    metrics, tables = {}, {}
    for name, batch in (("host", host_batch), ("device", device_batch)):
        model = TL.build_model(cfg, "cpu")
        model.load_state_dict(weights)
        tb = TL.to_device(batch, "cpu", TL.TRAIN_KEYS)
        with torch.no_grad():
            st, p2v, scales, _, _ = TL.prepare_inputs(cfg, tb)
        tables[name] = [st.coords, st.nvalid, p2v] + [s.subm_idx for s in scales]
        _, metrics[name] = TL.train_step(cfg, TL.init_state(cfg, model=model), tb)
    for a, b in zip(tables["host"], tables["device"]):
        assert torch.equal(a, b)
    for k in ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic"):
        for name in ("host", "device"):
            np.testing.assert_allclose(float(metrics[name][k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{name} {k}")
        np.testing.assert_allclose(float(metrics["host"][k]), float(metrics["device"][k]),
                                   rtol=1e-5, err_msg=k)
    for k in ("voxel_overflow", "hierarchy_overflow", "voxels_per_scene", "total"):
        np.testing.assert_allclose(float(metrics["host"][k]), float(metrics["device"][k]),
                                   rtol=1e-5, err_msg=k)


SPIN = """import time
def spin(s):
    end, n = time.monotonic() + s, 0
    while time.monotonic() < end:
        n += 1
    return n
def callback(phase, info):
    if phase == "start":
        spin(0.3)
"""


def library():
    """Functions whose code lies outside the tests and the Loader, as JAX's
    and torch's does."""
    ns = {}
    exec(compile(SPIN, os.path.join(os.sep, "library", "spin.py"), "exec"), ns)
    return ns


def test_alarm_raises_in_the_tests_code_not_in_a_library():
    lib = library()
    spun = None
    with pytest.raises(TimeoutError, match="past its 0.1 s limit$"):
        with alarm(0.1) as state:
            spun = lib["spin"](0.4)           # the alarm comes in here and waits
            time.sleep(5)                     # ... and raises here
    assert spun and state["deferred"]
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0     # the test's own limit runs on


def test_alarm_in_a_gc_callback_is_not_swallowed():
    """Raised inside a gc callback (JAX registers one), the exception would
    be reported as unraisable and dropped, and the test would pass past
    its limit."""
    lib = library()
    gc.callbacks.append(lib["callback"])
    try:
        with pytest.raises(TimeoutError, match="past its 0.1 s limit$"):
            with alarm(0.1) as state:
                gc.collect()
                time.sleep(5)
    finally:
        gc.callbacks.remove(lib["callback"])
    assert os.path.join(os.sep, "library", "spin.py") in state["deferred"]


def test_alarm_that_finds_only_a_library_fails_at_the_end():
    lib = library()
    with pytest.raises(TimeoutError, match="found only libraries running"):
        with alarm(0.1, retry_s=30):
            lib["spin"](0.3)


def test_alarm_raises_in_a_library_after_its_grace():
    """A test that spins in a library past its limit and the grace is
    still stopped, where it spins."""
    lib = library()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"raised in .*spin\.py after 0.3 s more"):
        with alarm(0.1, grace_s=0.3) as state:
            lib["spin"](30)
    assert time.monotonic() - t0 < 5 and state["deferred"]
