"""Frozen copy of ``sparse_rcnn_tpu_torch/ops/rulebook.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Rulebooks in dense gather form (port of ``ops/rulebook.py``).

A rulebook is ``idx int32[K, M_out]``: for output row ``i`` and kernel tap
``k``, the input-table row that contributes through ``W[k]``, or -1. Every
sparse conv is then ``out[i] = Σ_k feats[idx[k, i]] @ W[k]`` with no
scatter (:mod:`.sparse_conv`). All functions are per scene.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import coords as coord_ops

_SENTINEL_COORD = coord_ops.COORD_OFFSET - 1


def _live(nvalid, m: int, device) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=device) < nvalid


def submanifold_rulebook(coords: torch.Tensor, nvalid: torch.Tensor,
                         kernel_size) -> torch.Tensor:
    """idx int32[K, M] for a submanifold conv on a sorted site set.

    ``idx[k, i]`` = row of ``coords[i] - offset_k``, or -1. Offsets are
    centered (odd kernel); output sites == input sites, so the centre tap
    is the identity on live rows. All K offsets go through one lookup,
    which gives the same table as the JAX package's half lookup plus
    transpose.
    """
    m = coords.shape[0]
    mask = _live(nvalid, m, coords.device)
    table = coord_ops.pack_coords(coords, mask)
    offsets = coord_ops.kernel_offsets(kernel_size, centered=True,
                                       device=coords.device)
    q = coords[None, :, :] - offsets[:, None, :]                  # [K, M, 3]
    return coord_ops.table_lookup_bulk(table, coord_ops.pack_coords(q, mask[None]))


def downsample_sites(coords: torch.Tensor, nvalid: torch.Tensor, stride: int,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coarse site set alone (no rulebooks), for scales that the dense
    tail runs: (out_coords int32[capacity, 3] sorted, n_out, overflow), the
    first three outputs of :func:`downsample_with_rulebooks`."""
    mask = _live(nvalid, coords.shape[0], coords.device)
    coarse = torch.where(mask[:, None],
                         torch.div(coords, stride, rounding_mode="floor"),
                         _SENTINEL_COORD)
    ucoords, n_out, _, overflow = coord_ops.unique_coords(coarse, mask, capacity)
    return ucoords, n_out, overflow


def downsample_with_rulebooks(
    coords: torch.Tensor, nvalid: torch.Tensor, stride: int, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse site set plus down AND up rulebooks in one pass.

    The unique-inverse map of the parents IS the fine→coarse row
    assignment, so no lookups are needed. Returns (out_coords
    int32[capacity, 3], n_out, overflow, down_idx int32[s³, capacity],
    up_idx int32[s³, M]) with the conventions of :func:`strided_rulebook`
    and :func:`inverse_rulebook`.
    """
    m = coords.shape[0]
    dev = coords.device
    mask = _live(nvalid, m, dev)
    parent = torch.where(mask[:, None],
                         torch.div(coords, stride, rounding_mode="floor"),
                         _SENTINEL_COORD)
    ucoords, n_out, inverse, overflow = coord_ops.unique_coords(
        parent, mask, capacity)
    child = coords - parent * stride                       # [m, 3] in [0, s)
    # kernel_offsets(stride, centered=False) enumerates dx outer … dz inner
    code = ((child[:, 0] * stride + child[:, 1]) * stride + child[:, 2]).to(torch.int64)
    k = stride ** 3
    ok = mask & (inverse >= 0)                              # overflow victims drop
    rows = torch.arange(m, dtype=torch.int32, device=dev)
    # distinct slots for the kept rows; the dropped ones to a scratch slot
    # past the table, cut off after
    down = torch.full((k * capacity + 1,), -1, dtype=torch.int32, device=dev)
    down[torch.where(ok, code * capacity + inverse.to(torch.int64), k * capacity)] = rows
    taps = torch.arange(k, device=dev)
    up = torch.where((code[None, :] == taps[:, None]) & ok[None, :],
                     inverse[None, :], -1)
    return ucoords, n_out, overflow, down[:k * capacity].reshape(k, capacity), up


def strided_rulebook(in_coords, in_nvalid, out_coords, out_nvalid,
                     stride: int) -> torch.Tensor:
    """idx int32[K, M_out] for a k==s downsampling conv, by lookup: the test
    oracle of :func:`downsample_with_rulebooks`' down table."""
    dev = in_coords.device
    table = coord_ops.pack_coords(in_coords, _live(in_nvalid, in_coords.shape[0], dev))
    out_mask = _live(out_nvalid, out_coords.shape[0], dev)
    offsets = coord_ops.kernel_offsets(stride, centered=False, device=dev)
    q = out_coords[None, :, :] * stride + offsets[:, None, :]
    return coord_ops.table_lookup_bulk(table, coord_ops.pack_coords(q, out_mask[None]))


def inverse_rulebook(coarse_coords, coarse_nvalid, fine_coords, fine_nvalid,
                     stride: int) -> torch.Tensor:
    """idx int32[K, M_fine] for a k==s upsampling conv, by lookup: the test
    oracle of :func:`downsample_with_rulebooks`' up table."""
    dev = fine_coords.device
    table = coord_ops.pack_coords(
        coarse_coords, _live(coarse_nvalid, coarse_coords.shape[0], dev))
    fine_mask = _live(fine_nvalid, fine_coords.shape[0], dev)
    parent = torch.where(fine_mask[:, None],
                         torch.div(fine_coords, stride, rounding_mode="floor"),
                         _SENTINEL_COORD)
    child = fine_coords - parent * stride
    parent_row = coord_ops.table_lookup_bulk(
        table, coord_ops.pack_coords(parent, fine_mask))
    offsets = coord_ops.kernel_offsets(stride, centered=False, device=dev)
    match = (child[None, :, :] == offsets[:, None, :]).all(-1) & fine_mask[None]
    return torch.where(match, parent_row[None, :], -1)


def transpose_rulebook(idx: torch.Tensor, m_in: int) -> torch.Tensor:
    """t_idx[k, j] = i where idx[k, i] == j, else -1.

    Precondition: each tap's row ``idx[k]`` is injective on its
    non-negative entries, which every conv rulebook is by construction.
    """
    k, m_out = idx.shape
    out = torch.full((k, m_in), -1, dtype=torch.int32, device=idx.device)
    tap, row = torch.nonzero(idx >= 0, as_tuple=True)
    out[tap, idx[tap, row].to(torch.int64)] = row.to(torch.int32)
    return out
