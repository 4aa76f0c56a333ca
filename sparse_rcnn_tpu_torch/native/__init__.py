"""The port's native code: its libraries (:mod:`.libraries`, one builder,
one launch path and one launch count for every hand kernel) and the ctypes
binding of its C++ host core (``sparse_host.cpp``), built with ``g++`` at
first use. There is no fallback: :func:`load` raises with the compiler's
message when the build fails, and ``data.host_voxelize: true`` then fails
the Loader that asked for it.

ctypes releases the interpreter lock for the length of each call, so the
Loader's worker threads voxelize in parallel with the step.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from . import libraries as NL


def build() -> Path:
    """The host core's library, built unless one from the same text and
    flags exists. Raises ``RuntimeError`` with the compiler's output if the
    build fails."""
    return NL.build(NL.HOST)[0]


def load() -> ctypes.CDLL:
    """The host core with its two entry points typed (built on first call;
    raises ``RuntimeError`` if it cannot be)."""
    return NL.load(NL.HOST)


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def voxelize_scene(
    points: np.ndarray, feats: np.ndarray, valid: np.ndarray,
    voxel_size, capacity: int,
) -> Tuple[np.ndarray, np.ndarray, int, np.ndarray, int]:
    """Host twin of ``ops.voxelize.voxelize_scene``: (coords int32[M, 3]
    sorted and sentinel-padded, feats f32[M, C] means, n_voxels,
    p2v int32[N], overflow)."""
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    feats = np.ascontiguousarray(feats, np.float32)
    valid = np.ascontiguousarray(valid, np.uint8)
    n, c = feats.shape
    if points.shape != (n, 3) or valid.shape != (n,) or capacity < 0:
        raise ValueError(f"voxelize_scene: points {points.shape}, feats {feats.shape}, "
                         f"valid {valid.shape}, capacity {capacity}")
    vs = np.ascontiguousarray(
        np.broadcast_to(np.asarray(voxel_size, np.float32), (3,)).copy()
    )
    out_coords = np.empty((capacity, 3), np.int32)
    out_feats = np.empty((capacity, c), np.float32)
    out_p2v = np.empty((n,), np.int32)
    nv = ctypes.c_int32()
    ovf = ctypes.c_int32()
    lib.voxelize_scene(points, feats, valid, n, c, vs, capacity,
                       out_coords, out_feats, out_p2v,
                       ctypes.byref(nv), ctypes.byref(ovf))
    return out_coords, out_feats, int(nv.value), out_p2v, int(ovf.value)


def subm_rulebook(coords: np.ndarray, n_valid: int, kernel: int) -> np.ndarray:
    """Host twin of ``ops.rulebook.submanifold_rulebook``: int32[k³, M]."""
    lib = load()
    coords = np.ascontiguousarray(coords, np.int32)
    m = len(coords)
    if coords.shape != (m, 3) or not 0 <= n_valid <= m or kernel % 2 != 1:
        raise ValueError(f"subm_rulebook: coords {coords.shape}, n_valid {n_valid}, "
                         f"kernel {kernel}")
    out = np.empty((kernel ** 3, m), np.int32)
    lib.subm_rulebook(coords, m, n_valid, kernel, out)
    return out
