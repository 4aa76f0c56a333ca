"""ctypes binding of the port's C++ host core (``sparse_host.cpp``).

The library is built from the source in this directory at first use, with
``g++ -O3 -fPIC -std=c++17 -shared``, into ``sparse_rcnn_tpu_torch/_build/``
under a name keyed by a hash of the source (as ``ops/sparse_conv.py`` keys
the CUDA library), so a changed source is rebuilt and the card's machine
and a workstation each build their own. There is no fallback: :func:`load`
raises with the compiler's message when the build fails, and
``data.host_voxelize: true`` then fails the Loader that asked for it.

ctypes releases the interpreter lock for the length of each call, so the
Loader's worker threads voxelize in parallel with the step.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sparse_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile :data:`SOURCE` unless a library built from the same text and
    flags exists; returns its path. Raises ``RuntimeError`` with the
    compiler's output if the build fails."""
    key = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"libsparse_host_{key}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # processes that build at once (data-parallel ranks) take turns
    with open(so.with_name(so.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        return _compile(so)


def _compile(so: Path) -> Path:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"host library build failed: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"host library build failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """The built library with its two entry points typed (built on first
    call; raises ``RuntimeError`` if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.voxelize_scene.argtypes = [
                f32p, f32p, u8p, ctypes.c_int64, ctypes.c_int64, f32p,
                ctypes.c_int64, i32p, f32p, i32p,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.voxelize_scene.restype = None
            lib.subm_rulebook.argtypes = [
                i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p,
            ]
            lib.subm_rulebook.restype = None
            _lib = lib
        return _lib


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
