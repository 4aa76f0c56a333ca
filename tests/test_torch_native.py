"""The port's C++ host core (``sparse_rcnn_tpu_torch/native``) against the
JAX package's and against the port's device path, as
``tests/parity/test_native.py`` holds JAX's: coords, ``p2v``, ``nvalid``,
overflow and the submanifold rulebook bit-exact; voxel features equal to
JAX's C++ (the same sums) and within 1e-5 (rtol and atol) of the device
path's, whose segment sum may pair the f32 terms differently. An overflowing scene
and anisotropic voxel sizes included. Also: the build lands in ``_build/``
under a name keyed by the source, and a source that does not compile
raises with the compiler's message."""

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu import native as jax_native
from sparse_rcnn_tpu_torch import native
from sparse_rcnn_tpu_torch.ops import coords as PC
from sparse_rcnn_tpu_torch.ops import rulebook as PR
from sparse_rcnn_tpu_torch.ops import voxelize as PV


def _scene(seed, n, c, extent, valid_share=0.9):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, c)).astype(np.float32)
    valid = rng.random(n) < valid_share
    return pts, feats, valid


@pytest.mark.parametrize("case", [
    # (seed, points, channels, extent, voxel size, capacity)
    (0, 2000, 4, 3.0, [0.22, 0.3, 0.18], 2048),       # anisotropic, no overflow
    (1, 3000, 2, 2.0, [0.05, 0.05, 0.05], 64),        # overflow
    (2, 4000, 1, 40.0, [0.1, 0.1, 0.15], 4096),       # KITTI's anisotropic voxels
], ids=["aniso", "overflow", "kitti_voxels"])
def test_voxelize_matches_jax_native_and_device(case):
    seed, n, c, extent, vs, cap = case
    pts, feats, valid = _scene(seed, n, c, extent)
    got = native.voxelize_scene(pts, feats, valid, vs, cap)
    ref = jax_native.voxelize_scene(pts, feats, valid, np.asarray(vs, np.float32), cap)
    # the device path as prepare_inputs runs it (sentinel and zero padding rows)
    st, dev_p2v, dev_ovf = PV.voxelize_batch(
        torch.from_numpy(pts)[None], torch.from_numpy(feats)[None],
        torch.from_numpy(valid)[None], vs, cap)
    nc, nf, nv, p2v, ovf = got
    assert (nv, ovf) == (ref[2], ref[4]) == (int(st.nvalid[0]), int(dev_ovf[0]))
    np.testing.assert_array_equal(nc[:nv], ref[0][:nv])
    np.testing.assert_array_equal(p2v, ref[3])
    np.testing.assert_array_equal(nf[:nv], ref[1][:nv])       # the same C++ sums
    np.testing.assert_array_equal(nc, st.coords[0].numpy())   # sentinel rows too
    np.testing.assert_array_equal(p2v, dev_p2v[0].numpy())
    np.testing.assert_allclose(nf, st.feats[0].numpy(), rtol=1e-5, atol=1e-5)
    assert not nf[nv:].any()
    if cap == 64:
        assert nv == cap and ovf > 0


@pytest.mark.parametrize("kernel", [3, 5])
def test_subm_rulebook_matches_jax_native_and_device(kernel):
    rng = np.random.default_rng(kernel)
    cap = 512
    c = np.unique(rng.integers(-9, 9, (400, 3)).astype(np.int32), axis=0)
    c = c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))]
    n = len(c)
    padded = np.full((cap, 3), PC.COORD_OFFSET - 1, np.int32)
    padded[:n] = c
    got = native.subm_rulebook(padded, n, kernel)
    np.testing.assert_array_equal(got, jax_native.subm_rulebook(padded, n, kernel))
    dev = PR.submanifold_rulebook(torch.from_numpy(padded), torch.tensor(n), kernel)
    np.testing.assert_array_equal(got, dev.numpy())


def test_build_is_keyed_by_source_and_failure_raises(tmp_path, monkeypatch):
    so = native.build()
    assert so.parent == native.BUILD_DIR and so.name.startswith("libsparse_host_")
    assert native.build() == so                       # built once per source
    bad = tmp_path / "broken.cpp"
    bad.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed") as err:
        native.load()
    assert "error" in str(err.value)                  # the compiler's message
    assert not native.available()


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        native.voxelize_scene(np.zeros((5, 3), np.float32), np.zeros((4, 2), np.float32),
                              np.ones(5, bool), [0.1, 0.1, 0.1], 8)
    with pytest.raises(ValueError):
        native.subm_rulebook(np.zeros((4, 3), np.int32), 5, 3)
