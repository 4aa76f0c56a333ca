"""The port's PLY reader and writer against the JAX package's ``read_ply``:
binary little-endian and ascii files, with the ``_vh_clean_2.labels.ply``
label property, read by both packages to ``np.array_equal`` on every
property (exact: both decode the same bytes)."""

import numpy as np
import pytest

from sparse_rcnn_tpu.data.ply import read_ply as jax_read_ply
from sparse_rcnn_tpu.data.ply import vertices_xyz_rgb as jax_xyz_rgb
from sparse_rcnn_tpu_torch.data.ply import read_ply, vertices_xyz_rgb, write_ply


def _props(seed, n=300):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "z": rng.normal(size=n).astype(np.float32) * 1e-3,
        "red": rng.integers(0, 256, n).astype(np.uint8),
        "green": rng.integers(0, 256, n).astype(np.uint8),
        "blue": rng.integers(0, 256, n).astype(np.uint8),
        "label": rng.integers(0, 41, n).astype(np.uint16),     # the labels.ply layout
    }


@pytest.mark.parametrize("ascii", [False, True], ids=["binary", "ascii"])
def test_ply_round_trip_matches_jax_reader(tmp_path, ascii):
    props = _props(1 + ascii)
    path = str(tmp_path / "scene_vh_clean_2.labels.ply")
    write_ply(path, props, ascii=ascii)
    got, want = read_ply(path), jax_read_ply(path)
    assert list(got) == list(want) == list(props)
    for k in props:
        assert got[k].dtype == want[k].dtype == props[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], props[k], err_msg=k)
    for a, b in zip(vertices_xyz_rgb(got), jax_xyz_rgb(want)):
        np.testing.assert_array_equal(a, b)


def test_ply_reads_a_hand_written_ascii_file(tmp_path):
    """A header with a face element after the vertices, as ScanNet meshes
    have: only the vertex element is read."""
    text = ("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
            "property float y\nproperty float z\nproperty int label\n"
            "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
            "0.0 1.0 2.0 7\n3.5 4.5 5.5 -1\n-1 -2 -3 40\n3 0 1 2\n")
    path = tmp_path / "a.ply"
    path.write_text(text)
    got, want = read_ply(str(path)), jax_read_ply(str(path))
    for k in ("x", "y", "z", "label"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["label"], [7, -1, 40])
    xyz, rgb = vertices_xyz_rgb(got)
    assert xyz.shape == (3, 3) and not rgb.any()
