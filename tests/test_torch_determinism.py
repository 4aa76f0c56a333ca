"""The port's CPU training step is bit-stable from run to run, as the JAX
package's ``train_step`` is (``MIGRATING.md``: determinism is the default).

The backward of an advanced-indexing read is an ``index_put_`` accumulate,
which on the CPU adds repeated rows with parallel atomics unless
``torch.use_deterministic_algorithms`` is on; ``train/loop.py`` turns it on
around the backward of a CPU step (``deterministic_on_cpu``). The RoI crop
(``ops/roi.py::sample_trilinear``) is such a read, with most corners of its
samples missing and clamped to row 0: at the size below, its gradients
differed between runs without the mode on an 8-thread CPU.
"""

import copy

import numpy as np
import torch

from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.ops import coords as C
from sparse_rcnn_tpu_torch.ops import roi
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_train import OVERRIDES, _batch


def test_sample_trilinear_backward_bit_stable():
    rng = np.random.default_rng(0)
    m, c, p = 512, 32, 50000
    sites = torch.from_numpy(rng.integers(0, 16, size=(m, 3)).astype(np.int32))
    coords, nvalid, _, _ = C.unique_coords(sites, torch.ones(m, dtype=torch.bool), m)
    feats = torch.from_numpy(rng.normal(size=(m, c)).astype(np.float32))
    # samples over a box 6x the occupied cube: most corners miss (row 0)
    pos = torch.from_numpy(rng.uniform(-40, 56, size=(p, 3)).astype(np.float32))
    g_out = torch.from_numpy(rng.normal(size=(p, c)).astype(np.float32))
    grads = []
    for _ in range(5):
        f = feats.clone().requires_grad_(True)
        with TL.deterministic_on_cpu("cpu"):
            (roi.sample_trilinear(coords, nvalid, f, pos) * g_out).sum().backward()
        grads.append(f.grad)
    assert grads[0].abs().max() > 0
    for g in grads[1:]:
        assert torch.equal(g, grads[0])


def test_deterministic_on_cpu_restores_and_skips_the_card():
    assert not torch.are_deterministic_algorithms_enabled()
    with TL.deterministic_on_cpu(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled()
    assert not torch.are_deterministic_algorithms_enabled()
    with TL.deterministic_on_cpu("cuda"):
        assert not torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with TL.deterministic_on_cpu("cpu"):
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(False)


def test_loss_and_grads_bit_stable_on_cpu():
    """One step's loss and gradients twice from the same state, at the
    config of ``tests/test_torch_train.py`` with the port's seeded init."""
    cfg = load_config(overrides=OVERRIDES)
    init = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    runs = [TL.loss_and_grads(cfg, copy.deepcopy(init), batch) for _ in range(2)]
    assert not torch.are_deterministic_algorithms_enabled()
    (t0, p0, g0, _), (t1, p1, g1, _) = runs
    assert torch.equal(t0, t1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert len(g0) == len(g1) and any(g.abs().max() > 0 for g in g0)
    names = [n for n, _ in init.named_parameters()]
    for n, a, b in zip(names, g0, g1):
        assert torch.equal(a, b), n
