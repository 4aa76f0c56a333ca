"""The port's C++ host core (``sparse_rcnn_tpu_torch/native``) against the
JAX package's and against the port's device path, as
``tests/parity/test_native.py`` holds JAX's: coords, ``p2v``, ``nvalid``,
overflow and the submanifold rulebook bit-exact; voxel features equal to
JAX's C++ (the same sums) and within 1e-5 (rtol and atol) of the device
path's, whose segment sum may pair the f32 terms differently. An overflowing scene
and anisotropic voxel sizes included. Also, for the host core and a CUDA
library through the package's one builder: the build lands in ``_build/``
under a name keyed by the source's text and the flags, and a build that
fails (a source that does not compile, or no ``nvcc`` on this machine)
raises ``RuntimeError`` naming the compiler."""

import dataclasses
import hashlib
import re

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu import native as jax_native
from sparse_rcnn_tpu_torch import native
from sparse_rcnn_tpu_torch.native import libraries as NL
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


@pytest.mark.parametrize("name", ["sparse_host", "nms"])
def test_build_is_keyed_by_source_and_failure_raises(name, tmp_path, monkeypatch):
    lib = next(x for x in NL.LIBRARIES if x.name == name)
    key = hashlib.sha1(lib.source.read_bytes() + " ".join(lib.flags).encode()).hexdigest()[:12]
    assert NL.library_path(lib) == NL.BUILD_DIR / f"lib{name}_{key}.so"
    assert NL.library_path(dataclasses.replace(lib, flags=lib.flags + ("-g",))) \
        != NL.library_path(lib)
    bad = tmp_path / f"broken{lib.source.suffix}"
    bad.write_text(lib.source.read_text() + "\nthis is not C++;\n")
    broken = dataclasses.replace(lib, source=bad)
    assert NL.library_path(broken) != NL.library_path(lib)
    if lib is NL.HOST:
        so = native.build()
        assert so == NL.library_path(lib) and native.build() == so   # built once per source
        monkeypatch.setattr(NL, "HOST", broken)
        load = native.load
    else:                        # here nvcc is missing; on the card the source fails
        load = lambda: NL.load(broken)      # noqa: E731
    with pytest.raises(RuntimeError, match=f"{name} library build failed") as err:
        load()
    assert re.search(re.escape(lib.compiler), str(err.value))   # the command
    if lib is NL.HOST:
        assert "error" in str(err.value)              # the compiler's message
        assert not native.available()


def test_bad_arguments_raise():
    with pytest.raises(ValueError):
        native.voxelize_scene(np.zeros((5, 3), np.float32), np.zeros((4, 2), np.float32),
                              np.ones(5, bool), [0.1, 0.1, 0.1], 8)
    with pytest.raises(ValueError):
        native.subm_rulebook(np.zeros((4, 3), np.int32), 5, 3)
