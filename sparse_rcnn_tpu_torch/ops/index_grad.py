"""Gather-form backwards of the train step's two indexing reads, and their maps.

    RoI crop (``ops/roi.py::sample_trilinear``):
        out[s] = Σ_c feats[safe[c, s]] · live[c, s] · w[c, s]
        d_feats[j] = Σ_{e ∈ map[j]} round(g[s_e] · w[e])         e = (corner c, sample s)
    mask read (``models/heads.py::sample_mask_at_positions``):
        out[p, n] = mask[p, cell[p, n]]                          (bf16)
        d_mask[p, r] = Σ_{e ∈ map[p, r]} g[e]                    e = (proposal p, point n)

Autograd's backward of both reads is an accumulating ``index_put_``. On a
CUDA tensor the backward here runs the hand-written kernels of
``csrc/index_grad.cu`` (built with ``nvcc`` at first use into
``sparse_rcnn_tpu_torch/_build/`` beside the sparse-conv library, bound
with ``ctypes``) over a map built in the forward: the entries sorted
stably by destination row, with each row's offsets. Each kernel adds a
row's entries in the order CUDA's ``index_put_`` adds them, in f32, and
rounds once. On a CPU tensor the backward runs the plain versions
:func:`roi_crop_grad_reference` and :func:`mask_read_grad_reference`:
today's ``index_put_`` into zeros. There is no fallback: a CUDA tensor
gets the kernels or an exception. ``ROI_CROP_GRAD`` and ``MASK_READ_GRAD``
count the launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import sparse_conv as sc

_SRC = Path(__file__).resolve().parent / "csrc" / "index_grad.cu"
_LIB = sc.Library(_SRC, "index_grad", {
    "roi_crop_grad": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "mask_read_grad": [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p],
})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

RowMap = Tuple[torch.Tensor, torch.Tensor]


def wants_map(t: torch.Tensor) -> bool:
    """Whether a read of ``t`` builds its map: a gradient is wanted and the
    backward will run a kernel (``t`` is not on the CPU)."""
    return t.device.type != "cpu" and t.requires_grad and torch.is_grad_enabled()


def row_map(key: torch.Tensor, rows: int) -> RowMap:
    """(perm, offsets), both int32: the entries of the flat int32 ``key``
    sorted stably by key, and ``offsets[j]`` the first of row j's
    (``offsets[rows]`` the first entry whose key is ``rows`` or more). No
    host sync: a device sort and a device search."""
    sorted_key, perm = torch.sort(key, stable=True)
    starts = torch.arange(rows + 1, dtype=torch.int32, device=key.device)
    return perm.to(torch.int32), torch.searchsorted(sorted_key, starts, out_int32=True)


def roi_crop_map(idx: torch.Tensor, m: int) -> RowMap:
    """The crop's map: idx int32 [8, ...] (−1 = dead corner) over rows
    [0, m); dead corners sort past the last row and no row holds them."""
    return row_map(torch.where(idx >= 0, idx, m).reshape(-1), m)


def mask_read_map(cell: torch.Tensor, cells: int) -> RowMap:
    """The mask read's map: cell int32 [P, N] (each point's cell in its
    proposal's grid of ``cells``) over the rows p · cells + cell."""
    p = cell.shape[0]
    base = torch.arange(p, dtype=torch.int32, device=cell.device)[:, None] * cells
    return row_map((cell + base).reshape(-1), p * cells)


def roi_crop_grad_reference(g: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                            m: int) -> torch.Tensor:
    """The plain version, autograd's backward of the crop as the composite
    computes it: g [S, C] times w [8, S] (feats dtype), dead corners times
    0, ``index_put_`` accumulated into zeros [m, C] at the clamped rows."""
    v = (g[None] * w[..., None]) * (idx >= 0)[..., None].to(g.dtype)
    safe = idx.clamp(0, m - 1).to(torch.int64)
    out = torch.zeros((m, g.shape[-1]), dtype=g.dtype, device=g.device)
    return out.index_put_((safe,), v, accumulate=True)


def mask_read_grad_reference(g: torch.Tensor, cell: torch.Tensor, cells: int) -> torch.Tensor:
    """The plain version: g [P, N] accumulated by ``index_put_`` into zeros
    [P, cells] at (p, cell[p, n])."""
    prow = torch.arange(g.shape[0], device=g.device)[:, None]
    out = torch.zeros((g.shape[0], cells), dtype=g.dtype, device=g.device)
    return out.index_put_((prow, cell.to(torch.int64)), g, accumulate=True)


def _check(name: str, tensors: dict, ints: dict) -> None:
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda" or any(t.device != dev for t in (*tensors.values(), *ints.values())):
        raise ValueError(f"{name} kernel: {', '.join([*tensors, *ints])} must be on one "
                         "CUDA device")
    for n, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} kernel takes int32 {n}, got {t.dtype}")
    for n, t in (*tensors.items(), *ints.items()):
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {n} must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} kernel: {n} has 2^31 entries or more")


class RoICropGradKernel:
    """``roi_crop_grad`` and a count of its launches (a plain integer that
    goes up by one for each launch and nowhere else)."""

    def __init__(self):
        self.launches = 0

    def load(self):
        return _LIB.get().roi_crop_grad

    def __call__(self, g: torch.Tensor, w: torch.Tensor, rmap: RowMap, m: int) -> torch.Tensor:
        """g [S, C], w [8, S] of one type (f32 or bf16), rmap over m rows →
        d_feats [m, C]."""
        perm, offsets = rmap
        _check("roi_crop_grad", {"g": g, "w": w}, {"perm": perm, "offsets": offsets})
        if g.dtype not in _DTYPE_CODE or w.dtype != g.dtype:
            raise TypeError(f"roi_crop_grad kernel takes float32 or bfloat16 g and w of one "
                            f"type, got {g.dtype} and {w.dtype}")
        s, c = g.shape
        if w.shape != (8, s) or perm.numel() != 8 * s or offsets.shape != (m + 1,):
            raise ValueError(f"roi_crop_grad: g {tuple(g.shape)}, w {tuple(w.shape)}, perm "
                             f"{tuple(perm.shape)}, offsets {tuple(offsets.shape)}, m {m}")
        out = torch.empty((m, c), dtype=g.dtype, device=g.device)
        if m == 0 or c == 0:
            return out
        if s == 0:
            return out.zero_()
        fn = self.load()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            err = fn(g.data_ptr(), w.data_ptr(), perm.data_ptr(), offsets.data_ptr(),
                     out.data_ptr(), m, c, s, _DTYPE_CODE[g.dtype], stream)
        if err != 0:
            raise RuntimeError(f"roi_crop_grad kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


class MaskReadGradKernel:
    """``mask_read_grad`` and a count of its launches."""

    def __init__(self):
        self.launches = 0

    def load(self):
        return _LIB.get().mask_read_grad

    def __call__(self, g: torch.Tensor, rmap: RowMap, rows: int) -> torch.Tensor:
        """g bf16 [P, N] (or flat), rmap over ``rows`` rows → bf16 [rows]."""
        perm, offsets = rmap
        _check("mask_read_grad", {"g": g}, {"perm": perm, "offsets": offsets})
        if g.dtype != torch.bfloat16:
            raise TypeError(f"mask_read_grad kernel takes bfloat16 g, got {g.dtype}")
        if perm.numel() != g.numel() or offsets.shape != (rows + 1,):
            raise ValueError(f"mask_read_grad: g {tuple(g.shape)}, perm {tuple(perm.shape)}, "
                             f"offsets {tuple(offsets.shape)}, rows {rows}")
        out = torch.empty((rows,), dtype=g.dtype, device=g.device)
        if rows == 0:
            return out
        fn = self.load()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            err = fn(g.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(), rows,
                     stream)
        if err != 0:
            raise RuntimeError(f"mask_read_grad kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


ROI_CROP_GRAD = RoICropGradKernel()
MASK_READ_GRAD = MaskReadGradKernel()


def roi_crop_grad(g, w, idx, rmap: Optional[RowMap], m: int) -> torch.Tensor:
    """d_feats [m, C]: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return roi_crop_grad_reference(g, w, idx, m)
    return ROI_CROP_GRAD(g, w, rmap, m)


def mask_read_grad(g, cell, rmap: Optional[RowMap], cells: int) -> torch.Tensor:
    """d_mask [P, cells]: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return mask_read_grad_reference(g, cell, cells)
    return MASK_READ_GRAD(g, rmap, g.shape[0] * cells).reshape(g.shape[0], cells)


class _CornerGather(torch.autograd.Function):
    """The crop's trilinear sum over corners, forward by the composite's own
    ops, backward by :func:`roi_crop_grad` (and, for ``w``, the composite's
    own backward, which the model never asks for: positions carry no
    gradient)."""

    @staticmethod
    def forward(ctx, feats, idx, w, perm, offsets):
        m = feats.shape[0]
        safe = idx.clamp(0, m - 1).to(torch.int64)
        wb = w[..., None].to(feats.dtype)
        val = feats[safe] * (idx >= 0)[..., None].to(feats.dtype)
        ctx.save_for_backward(feats, idx, wb, perm, offsets)
        ctx.w_dtype = w.dtype
        return torch.sum(val * wb, dim=0)

    @staticmethod
    def backward(ctx, g):
        feats, idx, wb, perm, offsets = ctx.saved_tensors
        m, c = feats.shape
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            d_feats = roi_crop_grad(g.reshape(-1, c).contiguous(),
                                    wb.reshape(8, -1).contiguous(), idx.reshape(8, -1),
                                    (perm, offsets), m)
        if ctx.needs_input_grad[2]:
            val = feats[idx.clamp(0, m - 1).to(torch.int64)] * (idx >= 0)[..., None].to(g.dtype)
            d_w = (g[None] * val).sum(-1).to(ctx.w_dtype)
        return d_feats, None, d_w, None, None


def corner_gather(feats: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_c feats[idx[c]] · w[c] over the 8 corners (−1 = none): feats [M, C],
    idx int32 [8, ...], w [8, ...] → [..., C] in feats' dtype."""
    rmap = roi_crop_map(idx, feats.shape[0]) if wants_map(feats) else (None, None)
    return _CornerGather.apply(feats, idx, w, *rmap)


class _MaskRead(torch.autograd.Function):
    """``mask[p, cell[p, n]]``, backward by :func:`mask_read_grad`."""

    @staticmethod
    def forward(ctx, mask, cell, perm, offsets):
        ctx.save_for_backward(cell, perm, offsets)
        ctx.shape = mask.shape
        prow = torch.arange(mask.shape[0], device=mask.device)[:, None]
        return mask.reshape(mask.shape[0], -1)[prow, cell.to(torch.int64)]

    @staticmethod
    def backward(ctx, g):
        cell, perm, offsets = ctx.saved_tensors
        cells = ctx.shape[1:].numel()
        d = mask_read_grad(g.contiguous(), cell, (perm, offsets), cells)
        return d.reshape(ctx.shape), None, None, None


def mask_read(mask: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """``mask[p, cell[p, n]]``: mask [P, ...] read at cell int32 [P, N], an
    index into each proposal's flattened grid."""
    cells = mask.shape[1:].numel()
    rmap = mask_read_map(cell, cells) if wants_map(mask) else (None, None)
    return _MaskRead.apply(mask, cell, *rmap)
