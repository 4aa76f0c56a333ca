"""The port's ``Loader`` and copies to the device against the JAX package's
``Loader``, on the CPU.

- one worker: the batches equal JAX ``Loader(num_workers=1)``'s, every key
  ``np.array_equal``, with and without the host voxelizer;
- several workers: the consumer takes them in turn, so the order is the
  same in every run and equals the caller-thread mode's; worker 0's batches
  are a one-worker Loader's;
- an eval pass: ordered, the last batch wrap-padded, as JAX's;
- the counters, ``close`` and a worker's exception reaching the consumer;
- a host-voxelized train step equals a device-voxelized one, and JAX's
  host-voxelized step (loss parts within rtol 1e-5: the f32 sums of one
  step in other orders, as ``tests/test_torch_train.py`` holds them);
- ``data.host_voxelize`` with a library that does not build raises.

Every Loader is closed in a ``finally`` (or a ``with``), and every test runs
under its own time limit (``LIMIT_S``, an alarm in the test's thread), so no
worker thread can hang the suite.
"""

import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.data import pipeline as JP
from sparse_rcnn_tpu_torch import native
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.pipeline import (VOXEL_KEYS, Loader, collate, device_batches,
                                                 host_voxelize_scene)
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_dense_tail import jax_variables
from tests.test_torch_pool_train import _jax_step_cfg

LIMIT_S = 60
DATA = {"num_points": 512, "voxel_capacity": 256, "batch_size": 2,
        "voxel_size": [0.2, 0.2, 0.2], "val_scenes": 3, "num_scenes": 5}
# the config of tests/parity/test_native.py::test_host_voxelize_pipeline_matches_device
MODEL = {"backbone": {"widths": [8, 16], "blocks_per_scale": 1},
         "rpn": {"hidden": 8, "num_proposals": 4, "pre_nms_topk": 16},
         "roi": {"grid_size": 3, "hidden": 8, "mask_grid": 6},
         "num_classes": 3, "max_instances": 6}


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past its {LIMIT_S} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


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
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    cfg = load_config(overrides=_ov(host_voxelize=True))
    with pytest.raises(RuntimeError, match="host library build failed") as err:
        Loader(cfg)
    assert "does not build" in str(err.value)
    Loader(load_config(overrides=_ov()), threads=False)      # no host voxelizer: no build


def test_host_voxelized_step_matches_device_and_jax():
    """One train step from random flax weights on two synthetic scenes: the
    port's host-voxelized step against its device-voxelized step (integer
    tables and every metric) and against the loss parts of JAX's
    host-voxelized ``train_step``."""
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
    _, jm, _, _ = jax.device_get(_jax_step_cfg(ov)(params, stats, {
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
