"""Gather-form backwards of the train step's two indexing reads, and their maps.

    RoI crop (``ops/roi.py::sample_trilinear``):
        out[s] = Σ_c feats[safe[c, s]] · live[c, s] · w[c, s]
        d_feats[j] = Σ_{e ∈ map[j]} round(g[s_e] · w[e])         e = (corner c, sample s)
    mask read (``models/heads.py::sample_mask_at_positions``):
        out[p, n] = mask[p, cell[p, n]]                          (bf16)
        d_mask[p, r] = Σ_{e ∈ map[p, r]} g[e]                    e = (proposal p, point n)

Autograd's backward of both reads is an accumulating ``index_put_``. On a
CUDA tensor the backward here runs the hand-written kernels of
``csrc/index_grad.cu`` (the library ``native.libraries.INDEX_GRAD``) over
a map built in the forward: the entries sorted
stably by destination row, with each row's offsets. Each kernel adds a
row's entries in the order CUDA's ``index_put_`` adds them, in f32, and
rounds once. The crop's map is a device sort (:func:`roi_crop_map`). The
mask read's holds only the entries its caller keeps (``keep``: where the
cotangent can be other than 0) with each one's lane in ``index_put_``'s
pass over the whole run, and is built per proposal by the
``mask_read_map`` kernel (:func:`mask_read_map`). On a
CPU tensor the backward runs the plain versions
:func:`roi_crop_grad_reference` and :func:`mask_read_grad_reference`:
today's ``index_put_`` into zeros. There is no fallback: a CUDA tensor
gets the kernels or an exception. Their launches count as the roles
``roi_crop_grad``, ``mask_read_map`` and ``mask_read_grad``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from ..native import libraries as NL

TAIL = 32               # a mask map entry's lane in the tail of its run
MAP_UNIT = 32768        # points of one proposal a block of mask_read_map takes, at most
MAP_UNITS = 2048        # blocks the map's passes aim for, units of at least 4096 points

RowMap = Tuple[torch.Tensor, torch.Tensor]
MaskMap = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # perm, offsets, lanes


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


def mask_read_map_reference(cell: torch.Tensor, cells: int,
                            keep: Optional[torch.Tensor] = None) -> MaskMap:
    """The plain version of the mask read's map: cell int32 [P, N] (each
    point's cell in its proposal's grid of ``cells``) over the rows
    p · cells + cell, keep bool [P, N] (None: every entry). ``(perm,
    offsets)`` are :func:`row_map`'s over the keys with an entry that is
    not kept keyed ``rows``, so it sorts past the last row; ``lanes``
    uint8, aligned with ``perm``, is each entry's lane in ``index_put_``'s
    pass over the whole run of its row (kept or not): with f its rank in
    the run and n the run's length, f mod 32 where f < 32 ⌊n / 32⌋, else
    :data:`TAIL`. Two device sorts, no host sync."""
    p, n = cell.shape
    rows = p * cells
    base = torch.arange(p, dtype=torch.int32, device=cell.device)[:, None] * cells
    key = (cell + base).reshape(-1)
    full_perm, full_off = row_map(key, rows)
    pos = torch.arange(p * n, dtype=torch.int32, device=cell.device)
    rank = torch.empty_like(key).index_put_((full_perm.long(),), pos)
    rank = rank - full_off[key.long()]
    tail = torch.bitwise_and(full_off.diff(), -32)[key.long()]
    lane = torch.where(rank < tail, torch.bitwise_and(rank, 31), TAIL).to(torch.uint8)
    if keep is not None:
        key = torch.where(keep.reshape(-1), key, rows)
    perm, offsets = row_map(key, rows)
    return perm, offsets, lane[perm.long()]


def map_unit(p: int, n: int) -> int:
    """Points of one proposal that a block of the ``mask_read_map`` kernel
    takes (8 warps, each a contiguous eighth): :data:`MAP_UNIT`, halved while
    there are fewer than :data:`MAP_UNITS` units and it is above 4096. Each
    unit zeroes, writes and scans a counter per cell, so a unit of fewer
    points than a 14³ grid has cells costs more in counters than in points;
    more units run more blocks at once (config 1: 4096, config 2: 16384)."""
    unit = MAP_UNIT
    while unit > 4096 and p * -(-n // unit) < MAP_UNITS:
        unit //= 2
    return unit


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
    [P, cells] at (p, cell[p, n]), every entry, kept or not."""
    prow = torch.arange(g.shape[0], device=g.device)[:, None]
    out = torch.zeros((g.shape[0], cells), dtype=g.dtype, device=g.device)
    return out.index_put_((prow, cell.to(torch.int64)), g, accumulate=True)


def roi_crop_grad_kernel(g: torch.Tensor, w: torch.Tensor, rmap: RowMap,
                         m: int) -> torch.Tensor:
    """``roi_crop_grad``: g [S, C], w [8, S] of one type (f32 or bf16), rmap
    over m rows → d_feats [m, C]."""
    perm, offsets = rmap
    NL.check_tensors("roi_crop_grad", {"g": g, "w": w}, {"perm": perm, "offsets": offsets})
    dtype = NL.dtype_code("roi_crop_grad", ("g", "w"), g, w)
    s, c = g.shape
    if w.shape != (8, s) or perm.numel() != 8 * s or offsets.shape != (m + 1,):
        raise ValueError(f"roi_crop_grad: g {tuple(g.shape)}, w {tuple(w.shape)}, perm "
                         f"{tuple(perm.shape)}, offsets {tuple(offsets.shape)}, m {m}")
    out = torch.empty((m, c), dtype=g.dtype, device=g.device)
    if m == 0 or c == 0:
        return out
    if s == 0:
        return out.zero_()
    NL.launch("roi_crop_grad", NL.load(NL.INDEX_GRAD).roi_crop_grad, g.device, g.data_ptr(),
              w.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(), m, c, s,
              dtype)
    return out


@functools.lru_cache(maxsize=None)
def map_max_cells(device: torch.device) -> int:
    """The most cells a mask grid may have on ``device``: the place pass of
    ``mask_read_map`` holds three ints a cell in shared memory."""
    got = NL.load(NL.INDEX_GRAD).mask_read_map_max_cells(device.index)
    if got < 0:
        raise RuntimeError(f"mask_read_map: CUDA error {-got} reading the card's "
                           "shared memory size")
    return got


def mask_read_map_kernel(cell: torch.Tensor, cells: int, keep: Optional[torch.Tensor] = None,
                         unit: Optional[int] = None) -> MaskMap:
    """``mask_read_map`` (four kernels: kept counts, cell counts, scan,
    place; one launch of its role): cell int32 [P, N], keep bool [P, N] or
    None (every entry) → (perm int32 [P N], offsets int32 [P cells + 1],
    lanes uint8 [P N]), equal to :func:`mask_read_map_reference`'s up to
    ``offsets[-1]``; ``perm`` and ``lanes`` past it are not written.
    ``unit``: a fixed block size, for tests and benchmarks (None:
    :func:`map_unit`'s)."""
    if keep is None:
        keep = torch.ones_like(cell, dtype=torch.bool)
    NL.check_tensors("mask_read_map", {"keep": keep}, {"cell": cell})
    if cell.dim() != 2 or keep.shape != cell.shape or keep.dtype != torch.bool:
        raise ValueError(f"mask_read_map: cell {tuple(cell.shape)} must be [P, N] and keep "
                         f"a bool tensor of its shape, got {(tuple(keep.shape), keep.dtype)}")
    p, n = cell.shape
    dev = cell.device
    if cells > map_max_cells(dev):
        raise ValueError(f"mask_read_map kernel: a mask grid of {cells} cells needs more "
                         f"shared memory for its per-cell counters than a block may hold "
                         f"on this card (at most {map_max_cells(dev)} cells); tiling over "
                         "cells is not implemented")
    if p * n >= 2 ** 31 or p * cells >= 2 ** 31 or n >= 2 ** 26:
        raise ValueError(f"mask_read_map: P {p}, N {n}, cells {cells} too large")
    unit = unit or map_unit(p, n)
    if unit % 256 or not 256 <= unit <= MAP_UNIT:
        raise ValueError(f"mask_read_map: unit {unit} must be a multiple of 256 up to "
                         f"{MAP_UNIT}")
    perm = torch.empty((p * n,), dtype=torch.int32, device=dev)
    lanes = torch.empty((p * n,), dtype=torch.uint8, device=dev)
    offsets = torch.empty((p * cells + 1,), dtype=torch.int32, device=dev)
    if p * n * cells == 0:
        return perm, offsets.zero_(), lanes
    units = -(-n // unit)
    ws = torch.empty((2 * p * units * cells + p * units + p,), dtype=torch.int32, device=dev)
    NL.launch("mask_read_map", NL.load(NL.INDEX_GRAD).mask_read_map, dev, cell.data_ptr(),
              keep.data_ptr(), p, n, cells, unit, perm.data_ptr(), lanes.data_ptr(),
              offsets.data_ptr(), ws.data_ptr())
    return perm, offsets, lanes


def mask_read_grad_kernel(g: torch.Tensor, rmap: MaskMap, rows: int) -> torch.Tensor:
    """``mask_read_grad``: g bf16 [P, N] (or flat), the map of
    :func:`mask_read_map` over ``rows`` rows → bf16 [rows]."""
    perm, offsets, lanes = rmap
    NL.check_tensors("mask_read_grad", {"g": g, "lanes": lanes},
                     {"perm": perm, "offsets": offsets})
    if g.dtype != torch.bfloat16 or lanes.dtype != torch.uint8:
        raise TypeError(f"mask_read_grad kernel takes bfloat16 g and uint8 lanes, got "
                        f"{g.dtype} and {lanes.dtype}")
    if (perm.numel() != g.numel() or lanes.numel() != g.numel()
            or offsets.shape != (rows + 1,)):
        raise ValueError(f"mask_read_grad: g {tuple(g.shape)}, perm {tuple(perm.shape)}, "
                         f"lanes {tuple(lanes.shape)}, offsets {tuple(offsets.shape)}, "
                         f"rows {rows}")
    out = torch.empty((rows,), dtype=g.dtype, device=g.device)
    if rows == 0:
        return out
    NL.launch("mask_read_grad", NL.load(NL.INDEX_GRAD).mask_read_grad, g.device, g.data_ptr(),
              perm.data_ptr(), offsets.data_ptr(), lanes.data_ptr(), out.data_ptr(), rows)
    return out


def mask_read_map(cell: torch.Tensor, cells: int,
                  keep: Optional[torch.Tensor] = None) -> MaskMap:
    """The mask read's map (:func:`mask_read_map_reference`): the kernel on
    a CUDA tensor, the plain version on any other."""
    if cell.device.type == "cuda":
        return mask_read_map_kernel(cell, cells, keep)
    return mask_read_map_reference(cell, cells, keep)


def roi_crop_grad(g, w, idx, rmap: Optional[RowMap], m: int) -> torch.Tensor:
    """d_feats [m, C]: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return roi_crop_grad_reference(g, w, idx, m)
    return roi_crop_grad_kernel(g, w, rmap, m)


def mask_read_grad(g, cell, rmap: Optional[MaskMap], cells: int) -> torch.Tensor:
    """d_mask [P, cells]: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if g.device.type == "cpu":
        return mask_read_grad_reference(g, cell, cells)
    return mask_read_grad_kernel(g, rmap, g.shape[0] * cells).reshape(g.shape[0], cells)


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
    def forward(ctx, mask, cell, perm, offsets, lanes):
        ctx.save_for_backward(cell, perm, offsets, lanes)
        ctx.shape = mask.shape
        prow = torch.arange(mask.shape[0], device=mask.device)[:, None]
        return mask.reshape(mask.shape[0], -1)[prow, cell.to(torch.int64)]

    @staticmethod
    def backward(ctx, g):
        cell, perm, offsets, lanes = ctx.saved_tensors
        cells = ctx.shape[1:].numel()
        d = mask_read_grad(g.contiguous(), cell, (perm, offsets, lanes), cells)
        return d.reshape(ctx.shape), None, None, None, None


def mask_read(mask: torch.Tensor, cell: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mask[p, cell[p, n]]``: mask [P, ...] read at cell int32 [P, N], an
    index into each proposal's flattened grid. Every entry is read.

    ``keep`` (bool [P, N]) names the entries whose cotangent may be other
    than 0: the backward on the card adds only those, so the caller must
    give a cotangent of exactly 0 wherever ``keep`` is false (a NaN or an
    infinity there breaks it: 0 · NaN is not 0). The training loss, which
    owns the weights, passes the entries it weights (``train/loop.py::
    compute_losses``: ``mask_weight > 0``). Without ``keep`` every entry is
    added, as ``index_put_`` adds them."""
    cells = mask.shape[1:].numel()
    rmap = mask_read_map(cell, cells, keep) if wants_map(mask) else (None, None, None)
    return _MaskRead.apply(mask, cell, *rmap)
