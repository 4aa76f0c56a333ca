"""The port's native libraries, and the one path that builds, loads and
launches them.

:data:`LIBRARIES` declares each library once: its name, source, compiler,
flags and typed entry points. :func:`build` compiles one at first use
(``nvcc`` for sm_90a, or ``g++``) into
``sparse_rcnn_tpu_torch/_build/lib<name>_<key>.so``, the key a hash of the
source's text and the flags, so a changed source is rebuilt and the card's
machine and a workstation each build their own. There is no fallback: a
build that fails raises ``RuntimeError`` with the command and the
compiler's message.

Every hand kernel goes through :func:`launch`, which runs it on the current
stream of its device, raises on a CUDA error and counts the launch in
:data:`LAUNCHES` under the kernel's role.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
BUILD_TIMEOUT_S = 300
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}     # the kernels' float types
_CSRC = Path(__file__).resolve().parents[1] / "ops" / "csrc"


@dataclasses.dataclass(frozen=True, eq=False)
class Library:
    """One native library: ``source`` built by ``compiler`` ("nvcc" or
    "g++") with ``flags``; ``entries`` maps each entry point to its ctypes
    argument types, and each returns ``restype`` (in a CUDA library, a CUDA
    error code)."""
    name: str
    source: Path
    compiler: str
    entries: Dict[str, list]
    flags: Tuple[str, ...] = ()
    restype: object = ctypes.c_int


_V, _I = ctypes.c_void_p, ctypes.c_int
_PTRS, _INTS = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
_I32, _F32, _U8 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                   for t in (np.int32, np.float32, np.uint8))
_I64 = ctypes.c_int64

SPARSE_CONV = Library("sparse_conv", _CSRC / "sparse_conv.cu", "nvcc", {
    "sparse_conv_forward": [_V] * 4 + [_I] * 7 + [_V],
    "sparse_conv_wgrad": [_V] * 5 + [_I] * 9 + [_V],
})
INDEX_GRAD = Library("index_grad", _CSRC / "index_grad.cu", "nvcc", {
    "roi_crop_grad": [_V] * 5 + [_I] * 4 + [_V],
    "mask_read_map": [_V] * 2 + [_I] * 4 + [_V] * 5,
    "mask_read_map_max_cells": [_I],
    "mask_read_grad": [_V] * 5 + [_I] + [_V],
})
OPTIM = Library("optim", _CSRC / "optim.cu", "nvcc", {
    "optim_layout": [_INTS],
    "global_sumsq_partial": [_PTRS, _INTS, _INTS, _I, _V, _V],
    "global_sumsq_finish": [_V, _I, _V, _V],
    "optim_apply": [_PTRS] * 5 + [_INTS, _INTS, _I, ctypes.POINTER(ctypes.c_float), _I, _I,
                                  _V, _V],
}, flags=("-fmad=false",))
NMS = Library("nms", _CSRC / "nms.cu", "nvcc", {
    "nms_3d": [_V] * 3 + [_I] * 3 + [ctypes.c_float] + [_V] * 3,
    "nms_3d_max_candidates": [],
}, flags=("-fmad=false",))
BATCH_NORM = Library("batch_norm", _CSRC / "batch_norm.cu", "nvcc", {
    "bn_stats": [_V] * 3 + [_I] * 4 + [_V] * 3,
    "bn_apply": [_V] * 8 + [_I] * 3 + [ctypes.c_float] * 3 + [_I] + [_V] * 4,
    "bn_grad_sums": [_V] * 5 + [_I] * 4 + [_V] * 3,
    "bn_grad_input": [_V] * 7 + [_I] * 3 + [_V] * 2,
}, flags=("-fmad=false",))
HOST = Library("sparse_host", Path(__file__).resolve().parent / "sparse_host.cpp", "g++", {
    "voxelize_scene": [_F32, _F32, _U8, _I64, _I64, _F32, _I64, _I32, _F32, _I32,
                       ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)],
    "subm_rulebook": [_I32, _I64, _I64, _I64, _I32],
}, flags=("-O3", "-fPIC", "-std=c++17", "-shared"), restype=None)
LIBRARIES = (SPARSE_CONV, INDEX_GRAD, OPTIM, NMS, BATCH_NORM, HOST)


def library_path(lib: Library) -> Path:
    """Where ``lib`` built from its source's text and flags lives."""
    key = hashlib.sha1(lib.source.read_bytes() + " ".join(lib.flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{lib.name}_{key}.so"


def _command(lib: Library, out: Path) -> list:
    if lib.compiler == "g++":
        return ["g++", *lib.flags, "-o", str(out), str(lib.source)]
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", *lib.flags, "-o", str(out), str(lib.source)]


def build(lib: Library) -> Tuple[Path, str]:
    """Compile ``lib`` unless a library built from the same text and flags
    exists; returns (its path, the compiler's messages). Processes that
    build at once (the ranks of a data-parallel run) take turns on a file
    lock: the first compiles, the others then find its library; a failed
    build raises ``RuntimeError`` in each of them."""
    so = library_path(lib)
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(so.with_name(so.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so, ""
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = _command(lib, tmp)
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{lib.name} library build failed: {' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{lib.name} library build failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
        return so, res.stdout + res.stderr


_loaded: Dict[Library, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load(lib: Library) -> ctypes.CDLL:
    """``lib`` built on first call and loaded once, its entry points typed;
    raises ``RuntimeError`` if it cannot be built."""
    got = _loaded.get(lib)
    if got is None:
        with _load_lock:
            if lib not in _loaded:
                cdll = ctypes.CDLL(str(build(lib)[0]))
                for fn, argtypes in lib.entries.items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = lib.restype
                _loaded[lib] = cdll
            got = _loaded[lib]
    return got


# Launches in this process by role, each a plain count that goes up by one
# for each launch and nowhere else: "forward" and "dgrad" (the gather-GEMM
# on feats or on the cotangent), "wgrad", "roi_crop_grad", "mask_read_map"
# (one a call of its four kernels), "mask_read_grad", "global_norm" (each
# partial launch and the finish), "optim_apply" (each launch of the chunk
# plan), "nms_3d", and the masked BN + ReLU's "bn_stats" (each pass of the
# statistics), "bn_apply" and "bn_grad" (the gradient's sums, the input's
# gradient).
LAUNCHES: collections.Counter = collections.Counter()


def launch(role: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` current and its current
    stream's handle last; raises ``RuntimeError`` on a CUDA error, else
    counts one launch of ``role``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{role} kernel launch failed: CUDA error {err}")
    LAUNCHES[role] += 1


def check_tensors(role: str, tensors: dict, ints: dict) -> None:
    """Refuse what a kernel cannot take: ``tensors`` and the int32 ``ints``
    (name → tensor) on one CUDA device, contiguous, each of fewer than 2^31
    entries (``ValueError``; ``TypeError`` for an index of another type)."""
    every = {**tensors, **ints}
    dev = next(iter(every.values())).device
    if dev.type != "cuda" or any(t.device != dev for t in every.values()):
        raise ValueError(f"{role} kernel: {', '.join(every)} must be on one CUDA device")
    for n, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{role} kernel takes int32 {n}, got {t.dtype}")
    for n, t in every.items():
        if not t.is_contiguous():
            raise ValueError(f"{role} kernel: {n} must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{role} kernel: {n} has 2^31 entries or more")


def dtype_code(role: str, names: tuple, a: torch.Tensor, b: torch.Tensor) -> int:
    """The kernels' code of ``a``'s type; ``TypeError`` unless ``a`` and
    ``b`` are both float32 or both bfloat16."""
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"{role} kernel takes float32 or bfloat16 {names[0]} and {names[1]} "
                        f"of one type, got {a.dtype} and {b.dtype}")
    return _DTYPE_CODE[a.dtype]
